"""Run chosen phases of ``chip_smoke.py`` from checkouts in turns, on one card.

    python3 scripts/torch_phase_turns.py --phase resnet50_dp --phase hier_dp \
        OLD NEW NEW OLD

Each positional argument is the root of a checkout of this repository (an
unpacked ``git archive``).  To compare two commits, name them in the order
parent, change, change, parent: drift of the card or of the host over the
call then shows as a gap between the two turns of one tree.  Each turn runs
in a process of its own, which builds the kernels from that tree's sources,
starts the port's runtime on the card and runs that tree's own
``<phase>_phase`` functions of ``chip_smoke.py`` in the order given (a tree
without one says so and goes on).  The phase lines the tree prints are
passed through; after them comes one summary line a phase,
``{"turn": i, "tree": ..., "phase": ..., "median_step_ms": ..., ...}``,
with the step times, the throughput, the peak memory, the device time of
the profiled step and the phase's wall seconds.  The card's name and power
limit come first.  Exits 1 if a turn failed.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

# The numbers of a phase line that the summary keeps.
SUMMARY_KEYS = ("median_step_ms", "min_step_ms", "max_step_ms", "step_ms",
                "img_per_s", "tokens_per_s", "peak_mem_bytes",
                "peak_mem_bytes_step", "host_syncs_per_step")


def _device_ms(line: dict):
    """The device time of the phase's profiled step, where it has one."""
    prof = line.get("step_device_profile") or {}
    legs = line.get("leg_profile") or {}
    return prof.get("total_ms", legs.get("step_device_ms"))


def run_one(tree: str, phases) -> int:
    """One turn, in this process: ``phases`` of ``tree``'s chip_smoke.py."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.ops import _build, flash, ring, xent

    if not os.path.abspath(mpi.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"the port imported from {mpi.__file__}, not "
                           f"from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    dev = mpi.init()
    ops = {"flash": flash, "xent": xent, "ring": ring}
    try:
        for phase in phases:
            fn = getattr(cs, f"{phase}_phase", None)
            if fn is None:
                print(json.dumps({"turn_phase": phase, "missing": True}),
                      flush=True)
                continue
            t0 = time.perf_counter()
            # The phases of a slice's own path take no kernel modules.
            if len(inspect.signature(fn).parameters) == 3:
                fn(torch, mpi, dev)
            else:
                fn(torch, mpi, ops, dev)
            torch.cuda.synchronize()
            print(json.dumps({"turn_phase": phase,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            torch.cuda.empty_cache()
    finally:
        mpi.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in turn order")
    ap.add_argument("--phase", action="append", required=True,
                    help="a chip_smoke.py phase (repeatable), e.g. hier_dp")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return run_one(args.trees[0], args.phase)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    failed = 0
    for i, tree in enumerate(args.trees):
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree]
        for p in args.phase:
            cmd += ["--phase", p]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lines, seconds = {}, {}
        for raw in proc.stdout.splitlines():
            print(raw, flush=True)
            try:
                obj = json.loads(raw)
            except ValueError:
                continue
            if isinstance(obj, dict) and "phase" in obj:
                lines[obj["phase"]] = obj
            if isinstance(obj, dict) and "seconds" in obj \
                    and "turn_phase" in obj:
                seconds[obj["turn_phase"]] = obj["seconds"]
        if proc.returncode:
            failed = 1
            sys.stderr.write(proc.stderr[-4000:])
        for p in args.phase:
            line = lines.get(p)
            summary = {"turn": i, "tree": tree, "phase": p,
                       "rc": proc.returncode}
            if line is not None:
                summary.update({k: line[k] for k in SUMMARY_KEYS
                                if k in line})
                summary["step_device_ms"] = _device_ms(line)
                summary["seconds"] = seconds.get(p)
            print(json.dumps(summary), flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main())
