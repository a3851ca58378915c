// The asynchronous host-IO executor of torchmpi_tpu_torch: a thread pool,
// futures and atomic file writes.
//
// The port's own copy of the JAX package's framework-free executor: the
// code below this comment is that file's, byte for byte.
// torchmpi_tpu_torch/utils/native.py builds it with the same g++ flags as
// ps.cpp into build/torch_host/, and utils/aio.py binds it with ctypes.
// Its job is host IO that must not stall the train loop: checkpoint
// writes (utils/checkpoint.py save_async).
//
// Durability contract per write: data goes to `<path>.tmp.<id>`, is
// optionally fsync'd, then rename(2)'d over the final path, and the parent
// directory is fsync'd, so the final path either holds the complete
// payload or does not exist.
//
// A submitted buffer is not copied: it must stay alive until its future
// completes (the Python wrapper keeps it on the handle).
//
// C ABI (for ctypes):
//   tm_io_executor_create(nthreads)          -> eid  (<0 on failure)
//   tm_io_submit_write(eid, path, data, n, durable) -> fid (<0 on failure)
//   tm_io_wait_for(fid, timeout_ms)          -> 1 done, 0 timeout, -1 no such
//   tm_io_status(fid)   (done futures only)  -> 0 ok, else errno of the op
//   tm_io_free(fid)
//   tm_io_bytes_written(eid)                 -> completed payload bytes
//   tm_io_executor_destroy(eid)              // drains queue, joins threads

#include <fcntl.h>
#include <libgen.h>
#include <unistd.h>

#include <cerrno>

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

struct IoFuture {
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;
  int err = 0;  // errno of the failed step; 0 = success
};

struct Executor {
  // Static destruction of the registry (process exit without an explicit
  // destroy — CPython does not guarantee __del__ runs) must not run
  // ~std::thread on a joinable worker: that is std::terminate.  The
  // destructor drains and joins, same as an explicit destroy.
  ~Executor() { stop(); }

  std::vector<std::thread> threads;
  std::deque<std::function<void()>> queue;
  std::mutex mu;
  std::condition_variable cv;
  bool stopping = false;
  std::atomic<uint64_t> bytes_written{0};
  std::atomic<uint64_t> tmp_seq{0};

  void start(int nthreads) {
    for (int i = 0; i < nthreads; ++i)
      threads.emplace_back([this] { run(); });
  }

  void run() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return stopping || !queue.empty(); });
        // Drain before exit: a stop request must not drop queued writes —
        // a checkpoint the caller was told is in flight has to land.
        if (queue.empty()) return;
        job = std::move(queue.front());
        queue.pop_front();
      }
      job();
    }
  }

  void enqueue(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> g(mu);
      queue.push_back(std::move(job));
    }
    cv.notify_one();
  }

  void stop() {
    {
      std::lock_guard<std::mutex> g(mu);
      stopping = true;
    }
    cv.notify_all();
    for (auto& t : threads)
      if (t.joinable()) t.join();
    threads.clear();
  }
};

// Returns 0 on success, else the errno of the first failing step.
int write_atomic(Executor* ex, const std::string& path, const uint8_t* data,
                 uint64_t nbytes, bool durable) {
  std::string tmp = path + ".tmp." + std::to_string(::getpid()) + "." +
                    std::to_string(ex->tmp_seq.fetch_add(1));
  int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC,
                  0644);
  if (fd < 0) return errno ? errno : EIO;
  uint64_t off = 0;
  while (off < nbytes) {
    ssize_t n = ::write(fd, data + off, nbytes - off);
    if (n < 0) {
      if (errno == EINTR) continue;
      int e = errno;
      ::close(fd);
      ::unlink(tmp.c_str());
      return e;
    }
    off += static_cast<uint64_t>(n);
  }
  if (durable && ::fsync(fd) != 0) {
    int e = errno;
    ::close(fd);
    ::unlink(tmp.c_str());
    return e;
  }
  if (::close(fd) != 0) {
    int e = errno;
    ::unlink(tmp.c_str());
    return e;
  }
  if (::rename(tmp.c_str(), path.c_str()) != 0) {
    int e = errno;
    ::unlink(tmp.c_str());
    return e;
  }
  if (durable) {
    // fsync the parent directory so the rename itself survives a crash.
    std::vector<char> buf(path.begin(), path.end());
    buf.push_back('\0');
    int dfd = ::open(::dirname(buf.data()), O_RDONLY | O_DIRECTORY);
    if (dfd >= 0) {
      ::fsync(dfd);  // best-effort: some filesystems reject dir fsync
      ::close(dfd);
    }
  }
  ex->bytes_written.fetch_add(nbytes);
  return 0;
}

std::mutex g_mu;
std::map<int64_t, std::shared_ptr<Executor>> g_executors;
std::map<int64_t, std::shared_ptr<IoFuture>> g_futures;
int64_t g_next_id = 1;

}  // namespace

extern "C" {

int64_t tm_io_executor_create(int nthreads) {
  if (nthreads < 1 || nthreads > 64) return -1;
  auto ex = std::make_shared<Executor>();
  ex->start(nthreads);
  std::lock_guard<std::mutex> g(g_mu);
  int64_t id = g_next_id++;
  g_executors[id] = std::move(ex);
  return id;
}

// Does NOT copy `data`: the buffer must stay alive until the future
// completes (one memcpy of a multi-GB checkpoint is exactly what this
// module exists to avoid).
int64_t tm_io_submit_write(int64_t eid, const char* path,
                           const uint8_t* data, uint64_t nbytes,
                           int durable) {
  std::shared_ptr<Executor> ex;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_executors.find(eid);
    if (it == g_executors.end()) return -1;
    ex = it->second;
  }
  auto fut = std::make_shared<IoFuture>();
  int64_t fid;
  {
    std::lock_guard<std::mutex> g(g_mu);
    fid = g_next_id++;
    g_futures[fid] = fut;
  }
  std::string p(path);
  ex->enqueue([ex, fut, p, data, nbytes, durable] {
    int err = write_atomic(ex.get(), p, data, nbytes, durable != 0);
    std::lock_guard<std::mutex> g(fut->mu);
    fut->err = err;
    fut->done = true;
    fut->cv.notify_all();
  });
  return fid;
}

int tm_io_wait_for(int64_t fid, int timeout_ms) {
  std::shared_ptr<IoFuture> f;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_futures.find(fid);
    if (it == g_futures.end()) return -1;
    f = it->second;
  }
  std::unique_lock<std::mutex> lk(f->mu);
  if (timeout_ms < 0) {
    f->cv.wait(lk, [&] { return f->done; });
    return 1;
  }
  return f->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                        [&] { return f->done; })
             ? 1
             : 0;
}

int tm_io_status(int64_t fid) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_futures.find(fid);
  if (it == g_futures.end()) return -1;
  std::lock_guard<std::mutex> fg(it->second->mu);
  return it->second->done ? it->second->err : -2;
}

void tm_io_free(int64_t fid) {
  std::lock_guard<std::mutex> g(g_mu);
  g_futures.erase(fid);
}

uint64_t tm_io_bytes_written(int64_t eid) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_executors.find(eid);
  return it == g_executors.end() ? 0 : it->second->bytes_written.load();
}

void tm_io_executor_destroy(int64_t eid) {
  std::shared_ptr<Executor> ex;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_executors.find(eid);
    if (it == g_executors.end()) return;
    ex = std::move(it->second);
    g_executors.erase(it);
  }
  ex->stop();
}

}  // extern "C"
