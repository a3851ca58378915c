"""Elastic Downpour: asynchronous parameter-server training that survives
the loss of a worker (the counterpart of the JAX package's
``examples/downpour_elastic.py``, with ``alexnet_downpour``'s AlexNet and
step).

The reference had no elasticity (an MPI rank failure aborted the job).
Gang-scheduled training keeps that failure model and recovers through the
elastic gang or checkpoint-restart, but asynchronous parameter-server
training is where a failure is survivable as it is: no worker waits on
another, so a dead worker just stops contributing updates.  Mid-training
worker 0 "crashes" (it stops, pushing nothing more and holding no lock);
the survivors keep pushing to the shard servers and the center still
trains.  A monitor thread notices the loss by watching the per-worker
progress counters go stale (the heartbeat detection the PS client's
``ping()`` gives for server liveness, applied to workers), and a final
pass names any worker that stopped short of the run.

A worker whose PS exchange stays dead past the fault layer's retry
budget (``PeerTimeoutError`` under ``TORCHMPI_TPU_FAULTS``) is one lost
worker, not a failed job: it is retired the same way.  A worker never
exits with its prefetch in flight: it settles it on the way out, bounded
by ``Config.ps_timeout_s``.

Run: ``python -m torchmpi_tpu_torch.examples.downpour_elastic --device
cpu``.  Under an injected transient PS fault, every survivor still
finishes::

    python -m torchmpi_tpu_torch.faults.tool gen --out /tmp/chaos.json \\
        --seed 11 --rule ps.request:drop:1.0:2:0.02
    TORCHMPI_TPU_FAULTS=/tmp/chaos.json python -m \\
        torchmpi_tpu_torch.examples.downpour_elastic --device cpu
"""

import sys
import threading
import time

import torch

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch import optim
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.examples.alexnet_downpour import downpour_step
from torchmpi_tpu_torch.models import AlexNet
from torchmpi_tpu_torch.utils import data as dutil

_TICK_S = 0.25


class SimulatedCrash(Exception):
    pass


def _fault_errors() -> tuple:
    """The fault layer's give-up errors, where it is loaded."""
    mod = sys.modules.get("torchmpi_tpu_torch.faults")
    if mod is None:
        return ()
    return (mod.PeerTimeoutError, mod.RetriesExhaustedError, mod.FaultError)


def main(argv=None):
    args = common.parse_args(
        __doc__, argv,
        workers=dict(type=int, default=3),
        fetch_every=dict(type=int, default=5),
        shards=dict(type=int, default=4),
        image_size=dict(type=int, default=64),
        num_classes=dict(type=int, default=10),
        die_at=dict(type=int, default=20,
                    help="step at which worker 0 crashes"),
        stale_s=dict(type=float, default=2.0,
                     help="seconds without progress before the monitor "
                          "declares a worker lost"),
        defaults={"steps": 80, "batch_size": 32, "lr": 3e-4})
    with common.runtime(args) as dev:

        def make():
            return AlexNet(args.num_classes, dropout=0.0,
                           image_size=args.image_size, device=dev,
                           generator=torch.Generator(dev).manual_seed(
                               args.seed))

        model0 = make()
        params0 = common.params_tree(model0)
        replicas = [make() for _ in range(args.workers)]
        for m in replicas:
            common.load_params(m, params0)
        tx = optim.adam(args.lr)
        X, Y = dutil.synthetic_image_classification(
            1024, image_shape=(args.image_size, args.image_size, 3),
            num_classes=args.num_classes, seed=args.seed)
        progress = [0] * args.workers  # per-worker step counters
        losses = [[] for _ in range(args.workers)]
        ps = mpi.parameterserver.init(params0, num_shards=args.shards)

        def worker(w):
            model = replicas[w]
            names, params = zip(*model.named_parameters())
            states = [tx.init(p.detach()) for p in params]
            fetch = None
            try:
                for step, (xb, yb) in enumerate(dutil.batches(
                        X, Y, args.batch_size, steps=args.steps,
                        seed=args.seed + w + 1)):
                    if w == 0 and step == args.die_at:
                        raise SimulatedCrash(f"worker 0 dies at step {step}")
                    x, y = common.to_device(xb, yb, dev)
                    # The survivors' updates are averaged over the workers
                    # the job started with: a lost worker's share of the
                    # step is simply missing.
                    loss, _, _, fetch = downpour_step(
                        model, names, params, tx, states, ps, x, y,
                        1.0 / args.workers, fetch, step, args.fetch_every)
                    losses[w].append(loss)
                    progress[w] = step + 1
            finally:
                if fetch is not None:
                    try:
                        fetch.wait()
                    except Exception:  # noqa: BLE001 — the worker is done
                        pass

        dead = set()
        stop = threading.Event()
        stale_ticks = max(1, round(args.stale_s / _TICK_S))

        def monitor():
            last = list(progress)
            stale = [0] * args.workers
            while not stop.is_set():
                time.sleep(_TICK_S)
                for w in range(args.workers):
                    advanced = progress[w] != last[w]
                    if advanced and w in dead:
                        dead.discard(w)  # a stall, not a crash
                        print(f"monitor: worker {w} recovered at step "
                              f"{progress[w]}")
                    if w not in dead and not advanced \
                            and 0 < progress[w] < args.steps:
                        stale[w] += 1
                        if stale[w] >= stale_ticks:
                            dead.add(w)
                            print(f"monitor: worker {w} lost at step "
                                  f"{progress[w]}; continuing without it")
                    elif advanced:
                        stale[w] = 0
                    last[w] = progress[w]

        crashed, fault_lost = [], set()

        def guarded(w):
            try:
                worker(w)
            except SimulatedCrash as e:
                crashed.append(str(e))
            except _fault_errors() as e:
                fault_lost.add(w)
                crashed.append(f"worker {w} lost its PS: {e!r}")

        mon = threading.Thread(target=monitor, daemon=True)
        mon.start()
        try:
            common.run_workers(guarded, args.workers, dev)
            stop.set()
            mon.join(timeout=5)
            # The final pass: a worker that stopped short of the run is lost
            # even where the survivors finished before the monitor's window.
            for w in range(args.workers):
                if progress[w] < args.steps and w not in dead:
                    dead.add(w)
                    print(f"monitor: worker {w} stopped at step "
                          f"{progress[w]} of {args.steps}")
            common.load_params(model0, ps.receive().wait())
            ops = ps.ops_served()
        finally:
            stop.set()
            ps.shutdown()
        acc = common.evaluate(model0, X[:256], Y[:256], dev, train=False)
        survivors = [w for w in range(args.workers)
                     if w != 0 and w not in fault_lost]
        print(f"crashed: {crashed}")
        print(f"detected dead: {sorted(dead)}")
        print(f"fault-lost workers: {sorted(fault_lost)}")
        print(f"survivor steps: {[progress[w] for w in survivors]}")
        print(f"PS ops served: {ops}")
        print(f"final accuracy (PS params) {acc:.3f}  "
              f"(chance {1 / args.num_classes:.3f})")
        out = {"losses": [float(v) for v in losses[1]], "accuracy": acc,
               "ops_served": ops, "crashed": crashed, "dead": sorted(dead),
               "survivor_steps": [progress[w] for w in survivors]}
    if not crashed:
        raise AssertionError("worker 0 should have crashed")
    if 0 not in dead:
        raise AssertionError("the monitor did not detect the lost worker")
    if not survivors:
        raise AssertionError("every worker died: nothing survived")
    if not all(progress[w] == args.steps for w in survivors):
        raise AssertionError("the survivors did not finish")
    common.check_accuracy(acc, 2.0 / args.num_classes, args.steps,
                          "elastic AlexNet downpour")
    return out


if __name__ == "__main__":
    main()
