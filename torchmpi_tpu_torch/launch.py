"""Process launcher: the reference's ``scripts/`` and mpirun role (the JAX
package's ``launch.py``; SURVEY.md section 3, C17).

Local multi-process bring-up for development and tests::

    python -m torchmpi_tpu_torch.launch --nproc 2 script.py [args ...]

spawns ``--nproc`` processes of ``script.py`` on this host with torch's
launcher environment (``MASTER_ADDR`` / ``MASTER_PORT`` on a free
localhost port, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), so the script just calls
``torchmpi_tpu_torch.init()``.  ``--device`` lays the processes out:
``cuda`` (the default: one node, a card a process by ``LOCAL_RANK``, as
``init()`` binds it) or ``cpu`` (each process an emulated host,
``LOCAL_WORLD_SIZE`` 1, as the JAX launcher's rig, so the two-level
world's auto rule makes ``dcn`` the process count).  The launcher sets no
device: a script run with ``--device cpu`` calls
``init(device="cpu")`` itself.  Like mpirun, the first process to exit
nonzero stops the others (a survivor would otherwise wait forever in a
collective with a dead peer); the exit code is that process's.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m torchmpi_tpu_torch.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nproc", type=int, default=2,
                   help="number of processes")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the processes' layout: one node of cards, or "
                        "emulated hosts for a script that calls "
                        "init(device='cpu')")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.nproc < 1:
        p.error(f"--nproc must be >= 1, got {args.nproc}")
    per_node = args.nproc if args.device == "cuda" else 1

    port = _free_port()
    procs = []
    for rank in range(args.nproc):
        env = dict(os.environ)
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE=str(args.nproc),
                   LOCAL_RANK=str(rank % per_node),
                   LOCAL_WORLD_SIZE=str(per_node))
        procs.append(subprocess.Popen(
            [sys.executable, args.script] + args.script_args, env=env))
    rc = 0
    live = list(procs)
    while live:
        for proc in list(live):
            code = proc.poll()
            if code is None:
                continue
            live.remove(proc)
            if code != 0 and rc == 0:
                rc = code
                for other in live:
                    other.terminate()
        time.sleep(0.05)
    if rc:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
