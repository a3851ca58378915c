// The parameter-server host transport of torchmpi_tpu_torch.
//
// The port's own copy of the JAX package's framework-free transport: the
// code below this comment is that file's, byte for byte, so both packages'
// servers apply the same rules in the same order and round the same way.
// torchmpi_tpu_torch/utils/native.py builds it with g++ -O2 -std=c++17
// -fPIC -Wall -Wextra -pthread -shared (no -march, no -ffast-math: the
// update rules must round the product and the sum separately, with no
// fused multiply-add) into build/torch_host/, and parallel/ps.py binds it
// with ctypes.
//
// Server: a float32 shard; a listener thread accepts loopback TCP
// connections and runs one handler thread per client; ops apply under a
// shard mutex (rules copy, add, zero, axpy and the EASGD elastic rule,
// which replies with its delta).  Client: one socket per connection, ops
// run in submission order on the connection's worker thread, futures are
// integer ids.  tm_ps_send copies its payload before it returns;
// tm_ps_receive and the elastic reply write the caller's buffer after the
// call has returned, until the future completes.
//
// Trust model: the listener binds loopback only and is unauthenticated;
// do not bind other interfaces without adding authentication.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------- protocol
enum Op : uint8_t {
  OP_SEND = 1,      // payload in; rule applied to shard
  OP_RECEIVE = 2,   // payload out
  OP_SHUTDOWN = 3,  // close this connection
  OP_PING = 4,
};

enum Rule : uint32_t {
  RULE_COPY = 0,     // shard[i]  = p[i]
  RULE_ADD = 1,      // shard[i] += p[i]
  RULE_ZERO = 2,     // shard[i]  = 0        (payload ignored but present)
  RULE_AXPY = 3,     // shard[i] += alpha * p[i]
  RULE_ELASTIC = 4,  // delta = alpha*(p[i]-shard[i]); shard += delta;
                     // response payload = delta (EASGD symmetric update)
};

struct __attribute__((packed)) Header {
  uint8_t op;
  uint32_t rule;
  float alpha;
  uint64_t offset;  // float index into the shard
  uint64_t count;   // number of floats
};

uint64_t now_ns() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count());
}

bool read_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// ------------------------------------------------------------------- server
struct Server {
  std::vector<float> shard;
  std::mutex shard_mu;
  int listen_fd = -1;
  int port = 0;
  std::thread accept_thread;
  std::vector<std::thread> handlers;
  std::vector<int> handler_fds;  // guarded by handlers_mu
  std::mutex handlers_mu;
  std::atomic<bool> stopping{false};
  std::atomic<uint64_t> ops_served{0};
  // Cycle-cost decomposition (VERDICT r4 #8): where a served op's time
  // goes, accumulated in nanoseconds across all handler threads.  The
  // blocking wait for the NEXT request header is deliberately excluded —
  // that is idle time between ops, not op cost.  recv = payload read
  // (syscall share), lock_wait = shard-mutex acquisition (contention
  // share), apply = rule loop / memcpy under the mutex, send = response
  // write.  elastic_bytes_out tracks RULE_ELASTIC response payloads
  // separately so consumers (ps_bench's apply ns/B denominator) can
  // subtract bytes the apply loop never touched as extra work.  Backs
  // benchmarks/ps_bench.py's loopback breakdown and the ROUND3_NOTES
  // scaling model with measured constants.
  //
  // Snapshot consistency (ADVICE round 5): counters update in GROUPS
  // under the existing shard mutex — the request-side group
  // (recv/lock_wait/apply/bytes_in/ops) lands inside the same critical
  // section as the rule apply, i.e. BEFORE the ok byte unblocks the
  // client, so a stats() read taken after a completed wait() sees
  // every finished op exactly; the response-side group
  // (send/bytes_out) lands after the write under a second acquire.
  // tm_ps_server_stats reads under the same mutex, so a snapshot can
  // never tear mid-group (ops ticked but its bytes_in invisible).
  std::atomic<uint64_t> recv_ns{0}, lock_wait_ns{0}, apply_ns{0},
      send_ns{0}, bytes_in{0}, bytes_out{0}, elastic_bytes_out{0};

  ~Server() { stop(); }

  bool start(uint64_t size, int want_port) {
    shard.assign(size, 0.0f);
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(want_port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0)
      return false;
    socklen_t len = sizeof(addr);
    ::getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
    if (::listen(listen_fd, 64) != 0) return false;
    accept_thread = std::thread([this] { accept_loop(); });
    return true;
  }

  void accept_loop() {
    while (!stopping.load()) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) break;
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> g(handlers_mu);
      handler_fds.push_back(fd);
      handlers.emplace_back([this, fd] { handle(fd); });
    }
  }

  void handle(int fd) {
    std::vector<float> buf;
    Header h{};
    while (!stopping.load() && read_exact(fd, &h, sizeof(h))) {
      if (h.op == OP_SHUTDOWN) break;
      if (h.op == OP_PING) {
        uint8_t ok = 1;
        if (!write_exact(fd, &ok, 1)) break;
        continue;
      }
      // Overflow-safe bounds check: `offset + count` can wrap uint64, so
      // test count against the remaining space instead (ADVICE round 1).
      if (h.count > shard.size() || h.offset > shard.size() - h.count)
        break;  // malformed; drop client
      if (h.op == OP_SEND) {
        buf.resize(h.count);  // allocation kept out of every bucket
        uint64_t t0 = now_ns();
        if (!read_exact(fd, buf.data(), h.count * sizeof(float))) break;
        uint64_t t1 = now_ns();
        uint64_t t2, t3;
        {
          std::lock_guard<std::mutex> g(shard_mu);
          t2 = now_ns();
          float* s = shard.data() + h.offset;
          switch (h.rule) {
            case RULE_COPY:
              std::memcpy(s, buf.data(), h.count * sizeof(float));
              break;
            case RULE_ADD:
              for (uint64_t i = 0; i < h.count; ++i) s[i] += buf[i];
              break;
            case RULE_ZERO:
              std::memset(s, 0, h.count * sizeof(float));
              break;
            case RULE_AXPY:
              for (uint64_t i = 0; i < h.count; ++i) s[i] += h.alpha * buf[i];
              break;
            case RULE_ELASTIC:
              for (uint64_t i = 0; i < h.count; ++i) {
                float delta = h.alpha * (buf[i] - s[i]);
                s[i] += delta;
                buf[i] = delta;  // reply with deltas
              }
              break;
            default:
              break;
          }
          t3 = now_ns();
          // Request-side counter group, inside the SAME critical
          // section as the apply: consistent under the stats mutex and
          // visible BEFORE the ok byte unblocks the client.
          recv_ns.fetch_add(t1 - t0);
          lock_wait_ns.fetch_add(t2 - t1);
          apply_ns.fetch_add(t3 - t2);
          bytes_in.fetch_add(h.count * sizeof(float));
          ops_served.fetch_add(1);
        }
        uint8_t ok = 1;
        if (!write_exact(fd, &ok, 1)) break;
        if (h.rule == RULE_ELASTIC &&
            !write_exact(fd, buf.data(), h.count * sizeof(float)))
          break;
        uint64_t t4 = now_ns();
        {
          std::lock_guard<std::mutex> g(shard_mu);
          send_ns.fetch_add(t4 - t3);
          bytes_out.fetch_add(
              1 + (h.rule == RULE_ELASTIC ? h.count * sizeof(float) : 0));
          if (h.rule == RULE_ELASTIC)
            elastic_bytes_out.fetch_add(h.count * sizeof(float));
        }
      } else if (h.op == OP_RECEIVE) {
        buf.resize(h.count);  // allocation kept out of every bucket
        uint64_t t0 = now_ns();
        uint64_t t1, t2;
        {
          std::lock_guard<std::mutex> g(shard_mu);
          t1 = now_ns();
          std::memcpy(buf.data(), shard.data() + h.offset,
                      h.count * sizeof(float));
          t2 = now_ns();
          // Request-side counter group (see OP_SEND).
          lock_wait_ns.fetch_add(t1 - t0);
          apply_ns.fetch_add(t2 - t1);
          ops_served.fetch_add(1);
        }
        uint8_t ok = 1;
        if (!write_exact(fd, &ok, 1)) break;
        if (!write_exact(fd, buf.data(), h.count * sizeof(float))) break;
        uint64_t t3 = now_ns();
        {
          std::lock_guard<std::mutex> g(shard_mu);
          send_ns.fetch_add(t3 - t2);
          bytes_out.fetch_add(1 + h.count * sizeof(float));
        }
      } else {
        break;
      }
    }
    ::close(fd);
  }

  void stop() {
    if (stopping.exchange(true)) return;
    if (listen_fd >= 0) {
      ::shutdown(listen_fd, SHUT_RDWR);
      ::close(listen_fd);
    }
    if (accept_thread.joinable()) accept_thread.join();
    std::lock_guard<std::mutex> g(handlers_mu);
    // Wake handler threads blocked in read() on idle client connections —
    // without this, join() below deadlocks on any connected-but-quiet
    // client (close() alone does not interrupt a blocked read).
    for (int fd : handler_fds) ::shutdown(fd, SHUT_RDWR);
    for (auto& t : handlers)
      if (t.joinable()) t.join();
    handlers.clear();
    handler_fds.clear();
  }
};

// ------------------------------------------------------------------- client
struct Future {
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;
  int status = 0;  // 1 ok, <0 error
};

struct Client {
  int fd = -1;
  // Set on the first failed op.  A failure no longer implies a dead TCP
  // connection (SO_RCVTIMEO can fire while the server is merely slow), and
  // a late response would desynchronize the request/response stream — the
  // next op would read the previous op's bytes as its own.  So the first
  // failure poisons the connection: the socket is shut down and every
  // subsequent op fails fast.
  std::atomic<bool> dead{false};
  // Per-connection op serialization: ops on one connection execute in
  // submission order (the reference's async-ordering guarantee, SURVEY §4.4).
  std::mutex io_mu;
  std::thread worker;
  std::deque<std::function<void()>> queue;
  std::mutex q_mu;
  std::condition_variable q_cv;
  std::atomic<bool> stopping{false};

  ~Client() { stop(); }

  bool connect_to(const char* host, int port, int timeout_ms) {
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return false;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) return false;
    if (timeout_ms > 0) {
      // The bounded-failure contract covers the connection phase too: a
      // listener with a full accept backlog drops SYNs and a blocking
      // connect() would ride the kernel retry schedule (~2 min) past any
      // socket timeout.  Non-blocking connect + poll bounds it.
      int flags = ::fcntl(fd, F_GETFL, 0);
      ::fcntl(fd, F_SETFL, flags | O_NONBLOCK);
      int rc = ::connect(fd, reinterpret_cast<sockaddr*>(&addr),
                         sizeof(addr));
      if (rc != 0) {
        if (errno != EINPROGRESS) return false;
        pollfd pfd{fd, POLLOUT, 0};
        if (::poll(&pfd, 1, timeout_ms) != 1) return false;
        int err = 0;
        socklen_t len = sizeof(err);
        if (::getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len) != 0 ||
            err != 0)
          return false;
      }
      ::fcntl(fd, F_SETFL, flags);
    } else if (::connect(fd, reinterpret_cast<sockaddr*>(&addr),
                         sizeof(addr)) != 0) {
      return false;
    }
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    if (timeout_ms > 0) {
      // A wedged (alive but unresponsive) server must surface as a failed
      // future, not a hang: response reads time out, the job completes with
      // an error, and every tm_ps_wait unblocks (ADVICE round 1).
      timeval tv{};
      tv.tv_sec = timeout_ms / 1000;
      tv.tv_usec = (timeout_ms % 1000) * 1000;
      ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    }
    worker = std::thread([this] { run(); });
    return true;
  }

  void run() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(q_mu);
        q_cv.wait(lk, [this] { return stopping.load() || !queue.empty(); });
        if (stopping.load() && queue.empty()) return;
        job = std::move(queue.front());
        queue.pop_front();
      }
      job();
    }
  }

  void enqueue(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> g(q_mu);
      queue.push_back(std::move(job));
    }
    q_cv.notify_one();
  }

  void stop() {
    if (stopping.exchange(true)) return;
    q_cv.notify_all();
    if (worker.joinable()) worker.join();
    if (fd >= 0) {
      Header h{};
      h.op = OP_SHUTDOWN;
      write_exact(fd, &h, sizeof(h));
      ::close(fd);
      fd = -1;
    }
  }
};

// ------------------------------------------------------------------ registry
std::mutex g_mu;
std::map<int64_t, std::unique_ptr<Server>> g_servers;
std::map<int64_t, std::shared_ptr<Client>> g_clients;
std::map<int64_t, std::shared_ptr<Future>> g_futures;
int64_t g_next_id = 1;

std::shared_ptr<Future> new_future(int64_t* id_out) {
  auto f = std::make_shared<Future>();
  std::lock_guard<std::mutex> g(g_mu);
  *id_out = g_next_id++;
  g_futures[*id_out] = f;
  return f;
}

void complete(const std::shared_ptr<Future>& f, int status) {
  std::lock_guard<std::mutex> g(f->mu);
  f->status = status;
  f->done = true;
  f->cv.notify_all();
}

}  // namespace

extern "C" {

// ---- server ----
int64_t tm_ps_server_create(uint64_t shard_floats, int port) {
  auto s = std::make_unique<Server>();
  if (!s->start(shard_floats, port)) return -1;
  std::lock_guard<std::mutex> g(g_mu);
  int64_t id = g_next_id++;
  g_servers[id] = std::move(s);
  return id;
}

int tm_ps_server_port(int64_t sid) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_servers.find(sid);
  return it == g_servers.end() ? -1 : it->second->port;
}

uint64_t tm_ps_server_ops(int64_t sid) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_servers.find(sid);
  return it == g_servers.end() ? 0 : it->second->ops_served.load();
}

// Cycle-cost decomposition (VERDICT r4 #8): fills out[0..n-1] (n >= 7)
// with {ops_served, bytes_in, bytes_out, recv_ns, lock_wait_ns,
// apply_ns, send_ns} and, with n >= 8, {elastic_bytes_out} — cumulative
// since server start, summed over all handler threads.  Returns the
// number of fields written, or -1 for an unknown server / too-small
// buffer.  The idle wait for each next request header is NOT in any
// bucket (see the Server field comment).  The read takes the shard
// mutex the counter groups update under (ADVICE round 5), so a
// snapshot can no longer tear mid-group: every op whose ok byte the
// client has seen is fully counted in {ops, bytes_in, recv, lock_wait,
// apply}; {send_ns, bytes_out, elastic_bytes_out} land after the
// response write and may lag by the in-flight ops only.
int tm_ps_server_stats(int64_t sid, uint64_t* out, int n) {
  if (n < 7) return -1;
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_servers.find(sid);
  if (it == g_servers.end()) return -1;
  Server& s = *it->second;
  std::lock_guard<std::mutex> g2(s.shard_mu);
  out[0] = s.ops_served.load();
  out[1] = s.bytes_in.load();
  out[2] = s.bytes_out.load();
  out[3] = s.recv_ns.load();
  out[4] = s.lock_wait_ns.load();
  out[5] = s.apply_ns.load();
  out[6] = s.send_ns.load();
  if (n >= 8) {
    out[7] = s.elastic_bytes_out.load();
    return 8;
  }
  return 7;
}

void tm_ps_server_destroy(int64_t sid) {
  std::unique_ptr<Server> s;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_servers.find(sid);
    if (it == g_servers.end()) return;
    s = std::move(it->second);
    g_servers.erase(it);
  }
  s->stop();
}

// ---- client ----
// timeout_ms > 0 arms SO_RCVTIMEO/SO_SNDTIMEO on the connection; 0 = never
// time out (the round-1 behavior).
int64_t tm_ps_client_connect(const char* host, int port, int timeout_ms) {
  auto c = std::make_shared<Client>();
  if (!c->connect_to(host, port, timeout_ms)) return -1;
  std::lock_guard<std::mutex> g(g_mu);
  int64_t id = g_next_id++;
  g_clients[id] = std::move(c);
  return id;
}

void tm_ps_client_destroy(int64_t cid) {
  std::shared_ptr<Client> c;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_clients.find(cid);
    if (it == g_clients.end()) return;
    c = std::move(it->second);
    g_clients.erase(it);
  }
  c->stop();
}

// Async SEND.  data is copied internally before returning, so the caller's
// buffer may be reused immediately.  For RULE_ELASTIC, `inout` receives the
// server's delta response and must stay alive until the future completes.
int64_t tm_ps_send(int64_t cid, uint32_t rule, float alpha, uint64_t offset,
                   const float* data, float* inout, uint64_t count) {
  // Hold shared ownership across enqueue: a concurrent
  // tm_ps_client_destroy must not free the Client under us (ping runs from
  // monitoring threads by design).
  std::shared_ptr<Client> c;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_clients.find(cid);
    if (it == g_clients.end()) return -1;
    c = it->second;
  }
  int64_t fid;
  auto fut = new_future(&fid);
  auto payload = std::make_shared<std::vector<float>>(data, data + count);
  // The job captures the shared_ptr: the Client outlives its queue entries.
  c->enqueue([c, fut, rule, alpha, offset, payload, inout, count] {
    Header h{};
    h.op = OP_SEND;
    h.rule = rule;
    h.alpha = alpha;
    h.offset = offset;
    h.count = count;
    std::lock_guard<std::mutex> g(c->io_mu);
    bool ok = !c->dead.load() &&
              write_exact(c->fd, &h, sizeof(h)) &&
              write_exact(c->fd, payload->data(), count * sizeof(float));
    uint8_t st = 0;
    ok = ok && read_exact(c->fd, &st, 1) && st == 1;
    if (ok && rule == RULE_ELASTIC)
      ok = read_exact(c->fd, inout, count * sizeof(float));
    if (!ok && !c->dead.exchange(true)) ::shutdown(c->fd, SHUT_RDWR);
    complete(fut, ok ? 1 : -1);
  });
  return fid;
}

// Async RECEIVE into `out` (must stay alive until the future completes).
int64_t tm_ps_receive(int64_t cid, uint64_t offset, float* out,
                      uint64_t count) {
  // Hold shared ownership across enqueue: a concurrent
  // tm_ps_client_destroy must not free the Client under us (ping runs from
  // monitoring threads by design).
  std::shared_ptr<Client> c;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_clients.find(cid);
    if (it == g_clients.end()) return -1;
    c = it->second;
  }
  int64_t fid;
  auto fut = new_future(&fid);
  c->enqueue([c, fut, offset, out, count] {
    Header h{};
    h.op = OP_RECEIVE;
    h.offset = offset;
    h.count = count;
    std::lock_guard<std::mutex> g(c->io_mu);
    bool ok = !c->dead.load() && write_exact(c->fd, &h, sizeof(h));
    uint8_t st = 0;
    ok = ok && read_exact(c->fd, &st, 1) && st == 1;
    ok = ok && read_exact(c->fd, out, count * sizeof(float));
    if (!ok && !c->dead.exchange(true)) ::shutdown(c->fd, SHUT_RDWR);
    complete(fut, ok ? 1 : -1);
  });
  return fid;
}

// Async liveness probe (OP_PING round-trip on the connection's queue) —
// the failure-detection hook the SPMD side cannot have (a dead peer there
// kills the gang); here a dead shard is detected and reported.
int64_t tm_ps_ping(int64_t cid) {
  // Hold shared ownership across enqueue: a concurrent
  // tm_ps_client_destroy must not free the Client under us (ping runs from
  // monitoring threads by design).
  std::shared_ptr<Client> c;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_clients.find(cid);
    if (it == g_clients.end()) return -1;
    c = it->second;
  }
  int64_t fid;
  auto fut = new_future(&fid);
  c->enqueue([c, fut] {
    Header h{};
    h.op = OP_PING;
    std::lock_guard<std::mutex> g(c->io_mu);
    uint8_t st = 0;
    bool ok = !c->dead.load() &&
              write_exact(c->fd, &h, sizeof(h)) &&
              read_exact(c->fd, &st, 1) && st == 1;
    if (!ok && !c->dead.exchange(true)) ::shutdown(c->fd, SHUT_RDWR);
    complete(fut, ok ? 1 : -1);
  });
  return fid;
}

// Blocking wait; returns status (1 ok, <0 error) and frees the future.
int tm_ps_wait(int64_t fid) {
  std::shared_ptr<Future> f;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_futures.find(fid);
    if (it == g_futures.end()) return -2;
    f = it->second;
    g_futures.erase(it);
  }
  std::unique_lock<std::mutex> lk(f->mu);
  f->cv.wait(lk, [&] { return f->done; });
  return f->status;
}

// Timed wait: like tm_ps_wait but returns -3 on timeout WITHOUT freeing the
// future (the op may still complete; caller decides to retry, wait again, or
// forget).  Lets destructors and monitors bound their blocking (ADVICE
// round 1: wait() during GC must not hang the interpreter).
int tm_ps_wait_for(int64_t fid, int timeout_ms) {
  std::shared_ptr<Future> f;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_futures.find(fid);
    if (it == g_futures.end()) return -2;
    f = it->second;
  }
  {
    std::unique_lock<std::mutex> lk(f->mu);
    if (!f->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                        [&] { return f->done; }))
      return -3;
  }
  int status;
  {
    std::lock_guard<std::mutex> lk(f->mu);
    status = f->status;
  }
  std::lock_guard<std::mutex> g(g_mu);
  g_futures.erase(fid);
  return status;
}

// Drop interest in a future without waiting (fire-and-forget sends).  The
// in-flight job holds its own shared_ptr, so completion stays safe; this
// just prevents unbounded growth of the registry for never-waited handles.
void tm_ps_forget(int64_t fid) {
  std::lock_guard<std::mutex> g(g_mu);
  g_futures.erase(fid);
}

// Non-blocking poll: 1 done, 0 pending, -2 unknown.  Does not free.
int tm_ps_test(int64_t fid) {
  std::shared_ptr<Future> f;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_futures.find(fid);
    if (it == g_futures.end()) return -2;
    f = it->second;
  }
  std::lock_guard<std::mutex> lk(f->mu);
  return f->done ? 1 : 0;
}

}  // extern "C"
