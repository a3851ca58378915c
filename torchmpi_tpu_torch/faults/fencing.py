"""Epoch fencing of the checkpoint writers (the JAX package's
``faults/fencing.py``; docs/CHECKPOINT_TORCH.md).

A *zombie* writer (a minority rank that parked or wedged through a
partition and has not yet seen that the majority committed a newer view)
must not write against the majority's checkpoint lineage.  The write seam
is the fence: ``checkpoint.save`` / ``save_async`` / ``save_sharded``
check the writer's claimed view epoch against the board's highest
COMMITTED epoch; a writer whose epoch is behind gets the typed
:class:`FencedWriterError` and no byte lands.

The board is duck-typed: anything with ``committed_view()`` (None, or an
object with an ``epoch``) and a writable ``fence`` attribute.  The JAX
package's membership board and the elastic gang that arms the fence
are ROADMAP A10 (c).  Armed only by an explicit :func:`arm`: otherwise
this module is never imported, and ``utils/checkpoint.py`` reaches it
through one ``sys.modules`` lookup a save.  Dependency-free on purpose.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..utils import telemetry


class FencedWriterError(RuntimeError):
    """A write from a view epoch the board has already committed past.
    Carries ``what``, ``writer_epoch``, ``committed_epoch``, ``rank`` and
    ``incarnation``.  Not transient: the same stale write can never
    succeed; the writer must rejoin the committed epoch."""

    transient = False
    is_timeout = False

    def __init__(self, what: str, *, writer_epoch: int,
                 committed_epoch: int, rank: int = -1,
                 incarnation: int = 0):
        self.what = what
        self.writer_epoch = int(writer_epoch)
        self.committed_epoch = int(committed_epoch)
        self.rank = int(rank)
        self.incarnation = int(incarnation)
        super().__init__(
            f"fenced {what}: writer rank {rank} (incarnation "
            f"{incarnation}) holds view epoch {writer_epoch} but the "
            f"board has committed epoch {committed_epoch} — a majority "
            f"moved on; rejoin via the park/admit path instead of "
            f"writing")


class Fence:
    """One armed writer identity: (board, rank, view epoch, incarnation).
    ``check(epoch)`` is the seam."""

    def __init__(self, board, rank: int, *, epoch: int,
                 incarnation: int = 0):
        self.board = board
        self.rank = int(rank)
        self.epoch = int(epoch)
        self.incarnation = int(incarnation)

    def update(self, epoch: int, incarnation: Optional[int] = None):
        """The writer adopted a new committed view."""
        self.epoch = int(epoch)
        if incarnation is not None:
            self.incarnation = int(incarnation)

    def check(self, epoch: Optional[int] = None,
              what: str = "write") -> None:
        """Raise :class:`FencedWriterError` iff the board's committed
        epoch is ahead of the write's claimed ``epoch`` (default: the
        fence's view epoch).  ``epoch < 0`` (no view claimed: a waiting
        joiner's beacon) is exempt."""
        e = self.epoch if epoch is None else int(epoch)
        if e < 0:
            return
        committed = self.board.committed_view()
        if committed is not None and committed.epoch > e:
            telemetry.emit("record_elastic", "fenced",
                           epoch=committed.epoch, peer=what)
            raise FencedWriterError(
                what, writer_epoch=e, committed_epoch=committed.epoch,
                rank=self.rank, incarnation=self.incarnation)


_lock = threading.Lock()
_current: Optional[Fence] = None


def arm(board, rank: int, *, epoch: int, incarnation: int = 0) -> Fence:
    """Arm fencing for this process's writer identity: attaches the fence
    to ``board`` and publishes it for the checkpoint seam."""
    global _current
    fence = Fence(board, rank, epoch=epoch, incarnation=incarnation)
    with _lock:
        _current = fence
    board.fence = fence
    return fence


def disarm() -> None:
    global _current
    with _lock:
        if _current is not None and getattr(_current.board, "fence",
                                            None) is _current:
            _current.board.fence = None
        _current = None


def current() -> Optional[Fence]:
    return _current


def check_save(path: str) -> None:
    """The checkpoint seam: ``utils/checkpoint.py`` calls this (through
    ``sys.modules``) before committing a save."""
    fence = _current
    if fence is not None:
        fence.check(what=f"checkpoint save {path}")
