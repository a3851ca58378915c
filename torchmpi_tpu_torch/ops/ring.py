"""Ring collectives on Hopper: the "pallas" backend's eight ring kernels.

The PyTorch counterpart of ``torchmpi_tpu/ops/ring.py``.  The JAX package
runs one ring member per TPU core and reaches its neighbours by remote DMA.
Here the ring members are ``n`` ranks whose buffers sit on one card, in a
rank-major stack ``xs[i]`` = rank i's tensor (the JAX package's eager mode,
``torchmpi_tpu/collectives.py`` :772), and one kernel launch runs all of
them: the peers are device pointers, so the same kernels serve peers over
NVLink once their pointers are exchanged (ROADMAP queue B).

No kernel walks the ring (``ops/csrc/ring_direct.cu``): every rank's
value of an element is loaded and the values are added in the order the
ring would have added them, or, for the all-gathers, each shard is loaded
once and stored to every rank, so each input is read once and each output
written once:

- ``ring_allreduce_bidir_chunked`` (row 7):
  ``_ring_allreduce_bidir_chunked_kernel`` :534, the halves ``flat[:L//2]``
  and ``flat[L//2:]`` in the two rotations' orders;
- ``ring_allreduce_chunked`` (row 8): ``_ring_allreduce_chunked_kernel``
  :511;
- ``ring_reduce_scatter_chunked`` (row 9):
  ``_ring_reduce_scatter_chunked_kernel`` :707;
- ``ring_all_gather_chunked`` (row 10): ``_ring_all_gather_chunked_kernel``
  :733;
- ``ring_allreduce`` (row 11): ``_ring_allreduce_kernel`` :265, row 8's
  fold with one ring chunk of the padded ``P / n`` elements;
- ``ring_allreduce_bidir`` (row 12): ``_ring_allreduce_bidir_kernel`` :203,
  row 7's fold with each half's ring chunk that half's own padded length
  over n (the halves pad apart, so the two lengths can differ);
- ``ring_reduce_scatter`` (row 13): ``_ring_reduce_scatter_kernel`` :310,
  row 9's launch: its resident plan only pads the chunks, and zeros add
  nothing;
- ``ring_all_gather`` (row 14): ``_ring_all_gather_kernel`` :342, row 10's
  launch.

:func:`ring_allreduce`, :func:`ring_reduce_scatter` and
:func:`ring_all_gather` pick a kernel as the JAX entries do (:926-955,
:1030-1036, :1076-1079) from ``Config.chunk_bytes`` (and
``Config.pallas_bidirectional`` for the allreduce).  The layouts are the
JAX package's (``_pad_and_tile``, ``_chunk_plan``, the half split, the
per-chunk padding), and an element's ring chunk fixes the order of its adds,
so each kernel, its plain PyTorch version here and the JAX kernels agree
bitwise.  The TPU's ``_effective_plan`` coarsens the plan only under its
CPU interpreter; on a GPU the executed plan is always ``_chunk_plan``'s.

Every wrapper takes its plain version when, and only when, the tensor it
was given lies on the CPU; on a CUDA tensor it launches its kernel or
raises.  Each wrapper call that launches adds one to ``LAUNCHES[name]``.
``VECTOR_LAUNCHES`` counts the launches whose bulk took their 16-byte
path (the second half of rows 7 and 12 may start off a
16-byte boundary: its first elements are taken one by one).  The wrappers
make no host-device synchronization.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from .. import runtime

# The TPU kernels' tiling: one (8, 128) f32 tile; chunks are laid out
# [rows, 128] with rows a multiple of 8, so every buffer pads to TILE.
_LANES = 128
_SUBLANES = 8
_TILE = _LANES * _SUBLANES

# Kernel names, in kernel-table order (rows 7-14).
KERNELS = ("ring_allreduce_bidir_chunked", "ring_allreduce_chunked",
           "ring_reduce_scatter_chunked", "ring_all_gather_chunked",
           "ring_allreduce", "ring_allreduce_bidir", "ring_reduce_scatter",
           "ring_all_gather")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# The launches whose bulk ran on 16-byte vectors.
VECTOR_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def reset_launches() -> None:
    for counts in (LAUNCHES, VECTOR_LAUNCHES):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# The static plan (the JAX package's functions, on Python ints)
# ---------------------------------------------------------------------------


def _step_indices(my: int, n: int, s: int, sign: int) -> Tuple[int, int]:
    """(send chunk, recv chunk) of rank ``my`` at ring step ``s`` in
    direction ``sign`` (+1 sends right, -1 left): the reduce-scatter phase
    for ``s < n - 1``, the all-gather phase after (ring.py :147)."""
    if s < n - 1:
        return (my - sign * s) % n, (my - sign * (s + 1)) % n
    t = s - (n - 1)
    return (my + sign * (1 - t)) % n, (my - sign * t) % n


def _pad_to(flat: torch.Tensor, total: int) -> torch.Tensor:
    """``flat`` [n, L] zero-padded on the right to [n, total], contiguous."""
    n, L = flat.shape
    if total == L:
        return flat.contiguous()
    out = flat.new_zeros(n, total)
    out[:, :L] = flat
    return out


def _pad_and_tile(flat: torch.Tensor, n: int):
    """Each rank's row of ``flat`` [R, L] padded to a multiple of n * TILE
    and tiled as [R, n, rows, 128] (ring.py :162, per rank); also returns
    the pad."""
    pad = (-flat.shape[1]) % (n * _TILE)
    x = _pad_to(flat, flat.shape[1] + pad)
    return x.reshape(x.shape[0], n, -1, _LANES), pad


def _chunk_plan(nelems: int, n: int, dtype: torch.dtype, chunk_bytes: int):
    """``(sub_elems, C)`` of one rank's ``nelems`` elements (ring.py :372):
    the buffer pads to ``n * C * sub_elems`` and is viewed as [n ring
    chunks, C subchunks, sub_elems]; ``C == 1`` means a ring chunk fits one
    ``chunk_bytes`` slot and the resident kernels run."""
    ebytes = dtype.itemsize
    sub_elems = max(_TILE, (chunk_bytes // ebytes) // _TILE * _TILE)
    per = -(-nelems // n)
    C = max(1, -(-per // sub_elems))
    if C > 1:
        # Rebalance so the last subchunk isn't a sliver of padding.
        sub_elems = -(-per // C)
        sub_elems = -(-sub_elems // _TILE) * _TILE
    return sub_elems, C


def schedule(nelems: int, n: int, dtype: torch.dtype, *, chunk_bytes: int,
             bidirectional: bool):
    """(kernel name, plan arguments) the ring allreduce runs for ``n``
    ranks of ``nelems`` elements each (the JAX entry's choice, :936-952): a
    per-ring-chunk payload above ``chunk_bytes`` streams through a chunked
    kernel, bidirectional when asked and the half plan is chunked too;
    otherwise the resident bidirectional kernel when asked and the tensor
    holds at least 2 n TILE elements; otherwise the resident kernel."""
    sub_elems, C = _chunk_plan(nelems, n, dtype, chunk_bytes)
    if C > 1:
        half = _chunk_plan(-(-nelems // 2), n, dtype, chunk_bytes)
        if bidirectional and half[1] > 1:
            return "ring_allreduce_bidir_chunked", half
        return "ring_allreduce_chunked", (sub_elems, C)
    if bidirectional and nelems >= 2 * n * _TILE:
        return "ring_allreduce_bidir", ()
    return "ring_allreduce", ()


def _rs_step_indices(my: int, n: int, s: int) -> Tuple[int, int]:
    """(send chunk, recv chunk) of rank ``my`` at step ``s`` of the
    reduce-scatter: the classic ring shifted by one, so that rank i ends
    owning ring chunk i (ring.py :430)."""
    return (my - s - 1) % n, (my - s - 2) % n


def _ag_step_indices(my: int, n: int, t: int) -> Tuple[int, int]:
    """(send chunk, recv chunk) of rank ``my`` at step ``t`` of the
    all-gather: the forward schedule, the allreduce's reduce-phase formula
    (ring.py :349-366, :749-756)."""
    return _step_indices(my, n, t, +1)


def schedule_reduce_scatter(nelems: int, n: int, dtype: torch.dtype, *,
                            chunk_bytes: int):
    """(kernel name, plan arguments) of the ring reduce-scatter of ``n``
    ranks' ``nelems`` elements each (the JAX entry's choice, :1030-1036):
    a ring chunk above one ``chunk_bytes`` slot streams through the
    chunked kernel, otherwise the resident kernel runs."""
    sub_elems, C = _chunk_plan(nelems, n, dtype, chunk_bytes)
    if C > 1:
        return "ring_reduce_scatter_chunked", (sub_elems, C)
    return "ring_reduce_scatter", ()


def schedule_all_gather(nelems: int, n: int, dtype: torch.dtype, *,
                        chunk_bytes: int):
    """(kernel name, plan arguments) of the ring all-gather of ``n``
    shards of ``nelems`` elements: planned on the gathered ``n * nelems``
    elements (:1076), chunked when that plan is (:1079)."""
    sub_elems, C = _chunk_plan(nelems * n, n, dtype, chunk_bytes)
    if C > 1:
        return "ring_all_gather_chunked", (sub_elems, C)
    return "ring_all_gather", ()


# ---------------------------------------------------------------------------
# The rows: padding, and the plain schedule
# ---------------------------------------------------------------------------


def _halves(flat: torch.Tensor, bidir: bool):
    if not bidir:
        return [flat]
    half = flat.shape[1] // 2
    return [flat[:, :half], flat[:, half:]]


def _ring_plain(x: torch.Tensor, sign: int) -> torch.Tensor:
    """The ring schedule step by step over a padded rank-major stack
    [n, P]: at each step every rank's o[recv] takes its neighbour's
    o[recv], added in the reduce-scatter phase and copied in the
    all-gather phase.  A neighbour's chunk is never the one it updates in
    the same step, so updating rank by rank in place is the simultaneous
    step."""
    n = x.shape[0]
    o = x.clone().view(n, n, -1)
    for s in range(2 * (n - 1)):
        for r in range(n):
            _, recv = _step_indices(r, n, s, sign)
            src = o[(r - sign) % n, recv]
            if s < n - 1:
                o[r, recv] += src
            else:
                o[r, recv] = src
    return o.view(n, -1)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
# dtype, x, ldx, o, ldo, L, CE, n, vec, stream
_ALLREDUCE = ("tm_ring_allreduce_direct",
              [_I, _P, _LL, _P, _LL, _LL, _LL, _I, _PI, _P])
# dtype, x, ldx, o, ldo, L, CE1, CE2, n, vec, stream
_BIDIR = ("tm_ring_allreduce_bidir_direct",
          [_I, _P, _LL, _P, _LL, _LL, _LL, _LL, _I, _PI, _P])
# dtype, x, ldx, out, ldo, per, n, vec, stream
_SCATTER = ("tm_ring_reduce_scatter_direct",
            [_I, _P, _LL, _P, _LL, _LL, _I, _PI, _P])
# dtype, x, ldx, out, per, n, vec, stream
_GATHER = ("tm_ring_all_gather_direct", [_I, _P, _LL, _P, _LL, _I, _PI, _P])
_SIGNATURES = {
    "ring_allreduce": _ALLREDUCE,
    "ring_allreduce_chunked": _ALLREDUCE,
    "ring_allreduce_bidir": _BIDIR,
    "ring_allreduce_bidir_chunked": _BIDIR,
    "ring_reduce_scatter": _SCATTER,
    "ring_reduce_scatter_chunked": _SCATTER,
    "ring_all_gather": _GATHER,
    "ring_all_gather_chunked": _GATHER,
}


def _call(lib: str, name: str, args, x: torch.Tensor) -> None:
    """Call row ``name``'s C launcher (in library ``lib``) with ``args`` on
    the current stream of ``x``'s card, and count the launch."""
    sym, argtypes = _SIGNATURES[name]
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(x.device):
        _build.launch(lib, sym, argtypes, _DTYPE_CODE[x.dtype], *vals,
                      torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES[name] += 1


def _launch_direct(name: str, x: torch.Tensor, out: torch.Tensor,
                   *sizes: int) -> torch.Tensor:
    """Launch direct row ``name`` (ring_direct.cu) from ``x`` [n, L] into
    ``out``, its launcher's size arguments ``sizes`` (after x, its row
    stride and out), and return ``out``; count the launch, and whether it
    took the 16-byte path.  ``x`` may have any row stride; its elements
    must be unit-strided or are copied so."""
    if x.stride(1) != 1 and x.shape[1] > 1:
        x = x.contiguous()
    vec = ctypes.c_int(0)
    _call("ring_direct", name, (x, x.stride(0), out, *sizes, x.shape[0],
                                ctypes.byref(vec)), x)
    VECTOR_LAUNCHES[name] += vec.value
    return out


def _check(flat: torch.Tensor) -> None:
    if flat.dim() != 2 or flat.shape[0] < 2:
        raise ValueError(f"expected a rank-major stack [n >= 2, L], got "
                         f"{tuple(flat.shape)}")
    if flat.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"the ring kernels support float32 / bfloat16 / "
                        f"int32, got {flat.dtype}")
    if flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {flat.device}")


def _resident_chunk(m: int, n: int) -> int:
    """Elements of one ring chunk of a resident row's ``m`` elements a
    rank: the padded P / n, P = m rounded up to a multiple of n TILE (:162),
    at least one TILE."""
    return max(1, -(-m // (n * _TILE))) * _TILE


def _chunk_lengths(name: str, n: int, L: int, plan=()) -> Tuple[int, ...]:
    """The ring-chunk lengths allreduce row ``name`` folds ``n`` ranks' L
    elements by, one per half: a chunked row's C sub_elems (both halves of
    row 7 pad to one plan), a resident row's padded P / n (row 12's halves
    pad apart, so their lengths can differ)."""
    bidir = name.startswith("ring_allreduce_bidir")
    if plan:
        return (plan[0] * plan[1],) * (2 if bidir else 1)
    if bidir:
        return _resident_chunk(L // 2, n), _resident_chunk(L - L // 2, n)
    return (_resident_chunk(L, n),)


def _run(name: str, flat: torch.Tensor, plan=(), *,
         plain: bool) -> torch.Tensor:
    """Row ``name`` on ``flat`` [n, L]: the kernel reads the unpadded
    rows; the plain version splits into halves (bidirectional rows), pads
    each, runs the ring schedule, unpads and rejoins."""
    _check(flat)
    n, L = flat.shape
    parts = _halves(flat, name.startswith("ring_allreduce_bidir"))
    if plan and not (plan[0] > 0 and plan[1] > 0 and max(
            p.shape[1] for p in parts) <= n * plan[0] * plan[1]):
        raise ValueError(f"plan (sub_elems {plan[0]}, C {plan[1]}) does not "
                         f"fit {n} ranks of {L} elements")
    if not plain:
        if L == 0:
            return flat.new_empty(n, 0)
        # Rows 16 bytes apart, so that an aligned input takes the 16-byte
        # path; the result is the [n, L] view.
        v = 16 // flat.element_size()
        ldo = -(-L // v) * v
        out = flat.new_empty(n, ldo)
        return _launch_direct(name, flat, out, ldo, L,
                              *_chunk_lengths(name, n, L, plan))[:, :L]
    if plan:
        # Chunked: both halves pad to the plan's n C sub_elems (:631, :679).
        sub_elems, C = plan
        xs = [_pad_to(p, n * C * sub_elems) for p in parts]
    else:
        # Resident: each half pads to a multiple of n TILE (:855, :951), and
        # a slot is a whole ring chunk.
        xs = [_pad_and_tile(p, n)[0].reshape(n, -1) for p in parts]
    outs = [_ring_plain(x, sign)[:, :p.shape[1]]
            for x, sign, p in zip(xs, (1, -1), parts)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# The four wrappers (kernel on CUDA tensors, plain version on CPU tensors)
# and their plain versions (on any device).  ``flat`` is [n, L], rank i's
# elements in row i; the result has the same shape and dtype.


def allreduce_resident(flat):
    """Row 11, ``ring_allreduce``."""
    return _run("ring_allreduce", flat, plain=flat.device.type == "cpu")


def allreduce_resident_plain(flat):
    return _run("ring_allreduce", flat, plain=True)


def allreduce_bidir_resident(flat):
    """Row 12, ``ring_allreduce_bidir``."""
    return _run("ring_allreduce_bidir", flat,
                plain=flat.device.type == "cpu")


def allreduce_bidir_resident_plain(flat):
    return _run("ring_allreduce_bidir", flat, plain=True)


def allreduce_chunked(flat, sub_elems: int, C: int):
    """Row 8, ``ring_allreduce_chunked``."""
    return _run("ring_allreduce_chunked", flat, (sub_elems, C),
                plain=flat.device.type == "cpu")


def allreduce_chunked_plain(flat, sub_elems: int, C: int):
    return _run("ring_allreduce_chunked", flat, (sub_elems, C), plain=True)


def allreduce_bidir_chunked(flat, sub_elems: int, C: int):
    """Row 7, ``ring_allreduce_bidir_chunked``."""
    return _run("ring_allreduce_bidir_chunked", flat, (sub_elems, C),
                plain=flat.device.type == "cpu")


def allreduce_bidir_chunked_plain(flat, sub_elems: int, C: int):
    return _run("ring_allreduce_bidir_chunked", flat, (sub_elems, C),
                plain=True)


# ---------------------------------------------------------------------------
# Reduce-scatter and all-gather rows
# ---------------------------------------------------------------------------


def _slots(per: int, plan) -> Tuple[int, int]:
    """(E, C) of ring chunks of ``per`` elements: a chunked row's plan
    (each chunk padded to C sub_elems, :765-767, :799-801), or one slot of
    ``per`` padded to TILE for a resident row (:1037-1041, :1087-1091)."""
    E, C = plan if plan else (-(-per // _TILE) * _TILE, 1)
    if not (plan and C < 2) and (C - 1) * E < per <= C * E:
        return E, C
    raise ValueError(f"plan (sub_elems {E}, C {C}) does not fit ring chunks "
                     f"of {per} elements")


def _pad_chunks(x: torch.Tensor, total: int) -> torch.Tensor:
    """``x`` [R, m, per] zero-padded on the right to a new [R, m, total]."""
    out = x.new_zeros(*x.shape[:2], total)
    out[..., :x.shape[2]] = x
    return out


def _rs_plain(w: torch.Tensor) -> torch.Tensor:
    """The reduce-scatter schedule step by step over padded chunks ``w``
    [n, n, P] (updated in place): at step s every rank's w[recv] takes its
    left neighbour's w[recv] added to it.  No rank updates at step s a
    chunk that some rank reads at step s, so updating rank by rank is the
    simultaneous step.  Returns each rank's own chunk, [n, P]."""
    n = w.shape[0]
    for s in range(n - 1):
        for r in range(n):
            _, recv = _rs_step_indices(r, n, s)
            w[r, recv] += w[(r - 1) % n, recv]
    idx = torch.arange(n, device=w.device)
    return w[idx, idx]


def _ag_plain(x: torch.Tensor) -> torch.Tensor:
    """The all-gather schedule step by step over padded shards ``x`` [n, P]:
    rank r's shard goes to o[r, r], then at step t every rank's o[recv] is
    copied from its left neighbour's.  Returns o [n, n, P]."""
    n = x.shape[0]
    o = x.new_zeros(n, *x.shape)
    idx = torch.arange(n, device=x.device)
    o[idx, idx] = x
    for t in range(n - 1):
        for r in range(n):
            _, recv = _ag_step_indices(r, n, t)
            o[r, recv] = o[(r - 1) % n, recv]
    return o


def _run_rs(name: str, flat: torch.Tensor, plan=(), *,
            plain: bool) -> torch.Tensor:
    """Row ``name`` on ``flat`` [n, L], rank r's elements in row r, L a
    multiple of n: returns [n, L / n], row r the sum over ranks of ring
    chunk r.  The plain version pads each chunk as the TPU does; the kernel
    stores no padding (zeros add nothing)."""
    _check(flat)
    n, L = flat.shape
    if L % n:
        raise ValueError(f"reduce_scatter needs a length divisible by the "
                         f"{n} ranks, got {L}")
    per = L // n
    if per == 0:
        return flat.new_empty(n, 0)
    E, C = _slots(per, plan)
    if plain:
        return _rs_plain(_pad_chunks(flat.reshape(n, n, per), C * E))[:, :per]
    return _launch_direct(name, flat, flat.new_empty(n, per), per, per)


def _run_ag(name: str, shards: torch.Tensor, plan=(), *,
            plain: bool) -> torch.Tensor:
    """Row ``name`` on ``shards`` [n, L], rank r's shard in row r: returns
    [n, n, L], every rank's slice the stack of all shards."""
    _check(shards)
    n, per = shards.shape
    if per == 0:
        return shards.new_empty(n, n, 0)
    E, C = _slots(per, plan)
    if plain:
        return _ag_plain(_pad_to(shards, C * E))[..., :per]
    return _launch_direct(name, shards, shards.new_empty(n, n, per), per)


def reduce_scatter_resident(flat):
    """Row 13, ``ring_reduce_scatter``."""
    return _run_rs("ring_reduce_scatter", flat,
                   plain=flat.device.type == "cpu")


def reduce_scatter_resident_plain(flat):
    return _run_rs("ring_reduce_scatter", flat, plain=True)


def reduce_scatter_chunked(flat, sub_elems: int, C: int):
    """Row 9, ``ring_reduce_scatter_chunked``."""
    return _run_rs("ring_reduce_scatter_chunked", flat, (sub_elems, C),
                   plain=flat.device.type == "cpu")


def reduce_scatter_chunked_plain(flat, sub_elems: int, C: int):
    return _run_rs("ring_reduce_scatter_chunked", flat, (sub_elems, C),
                   plain=True)


def all_gather_resident(shards):
    """Row 14, ``ring_all_gather``."""
    return _run_ag("ring_all_gather", shards,
                   plain=shards.device.type == "cpu")


def all_gather_resident_plain(shards):
    return _run_ag("ring_all_gather", shards, plain=True)


def all_gather_chunked(shards, sub_elems: int, C: int):
    """Row 10, ``ring_all_gather_chunked``."""
    return _run_ag("ring_all_gather_chunked", shards, (sub_elems, C),
                   plain=shards.device.type == "cpu")


def all_gather_chunked_plain(shards, sub_elems: int, C: int):
    return _run_ag("ring_all_gather_chunked", shards, (sub_elems, C),
                   plain=True)


# The direct rows' order as torch folds, and the direct gather as a torch
# copy (tests and chip_smoke.py hold them to the ring's plain versions and
# the kernels to them; the main path never runs them).


def _fold(x: torch.Tensor, first: int, step: int = 1) -> torch.Tensor:
    """Rows first, first + step, ..., first + (n - 1) step (mod n) of ``x``
    [n, m], added left to right in x's dtype."""
    n = x.shape[0]
    acc = x[first % n].clone()
    for k in range(1, n):
        acc = acc + x[(first + step * k) % n]
    return acc


def _fold_chunks(out, flat, lo0: int, hi0: int, ce: int, step: int) -> None:
    """``out[:, lo0:hi0]`` = every ring chunk c (``[lo0 + c ce, lo0 + (c +
    1) ce)``, clipped to hi0) of ``flat`` folded from rank c in direction
    ``step``."""
    for c in range(flat.shape[0]):
        lo, hi = lo0 + c * ce, min(hi0, lo0 + (c + 1) * ce)
        if lo < hi:
            out[:, lo:hi] = _fold(flat[:, lo:hi], c, step)


def allreduce_direct_plain(flat, sub_elems: int, C: int):
    """Row 8's function in ring_direct.cu's order: each element of ring
    chunk c (``[c C sub_elems, (c + 1) C sub_elems)``) is the fold of ranks
    c, c + 1, ..., c + n - 1, on every rank; ``flat`` [n, L] unpadded."""
    _check(flat)
    out = torch.empty_like(flat)
    _fold_chunks(out, flat, 0, flat.shape[1], sub_elems * C, 1)
    return out


def allreduce_bidir_fold(flat, ce1: int, ce2: int):
    """The two-direction order of ring_direct.cu: the halves ``[0, L //
    2)`` and ``[L // 2, L)`` in ring chunks of ``ce1`` and ``ce2``
    elements, chunk c of half 1 the fold of ranks c, c + 1, ..., c + n - 1
    and chunk c of half 2 the fold of ranks c, c - 1, ..., c - n + 1 (the
    other rotation), on every rank; ``flat`` [n, L] unpadded."""
    _check(flat)
    L = flat.shape[1]
    out = torch.empty_like(flat)
    _fold_chunks(out, flat, 0, L // 2, ce1, 1)
    _fold_chunks(out, flat, L // 2, L, ce2, -1)
    return out


def allreduce_bidir_direct_plain(flat, sub_elems: int, C: int):
    """Row 7's function in ring_direct.cu's order: both halves in ring
    chunks of C sub_elems (the half plan)."""
    return allreduce_bidir_fold(flat, sub_elems * C, sub_elems * C)


def allreduce_resident_direct_plain(flat):
    """Row 11's function in ring_direct.cu's order: row 8's fold in one
    ring chunk of the padded P / n elements."""
    _check(flat)
    n, L = flat.shape
    return allreduce_direct_plain(flat, _resident_chunk(L, n), 1)


def allreduce_bidir_resident_direct_plain(flat):
    """Row 12's function in ring_direct.cu's order: the two-direction
    fold, each half in one ring chunk of its own padded length / n."""
    _check(flat)
    n, L = flat.shape
    return allreduce_bidir_fold(flat, *_chunk_lengths("ring_allreduce_bidir",
                                                      n, L))


def reduce_scatter_direct_plain(flat):
    """Row 9's function in ring_direct.cu's order: rank c's chunk is the
    fold of every rank's chunk c in the order c + 1, ..., c + n - 1, c
    (whatever the plan, which only pads the chunks)."""
    _check(flat)
    n, L = flat.shape
    if L % n:
        raise ValueError(f"reduce_scatter needs a length divisible by the "
                         f"{n} ranks, got {L}")
    per = L // n
    chunks = flat.reshape(n, n, per)
    return torch.stack([_fold(chunks[:, c], c + 1) for c in range(n)])


def all_gather_direct_plain(shards):
    """Row 10's function as ring_direct.cu computes it: slice s of every
    rank's output is rank s's shard (``shards`` [n, per] expanded to [n, n,
    per]; whatever the plan, which only pads the chunks)."""
    _check(shards)
    n, per = shards.shape
    return shards.expand(n, n, per).clone()


WRAPPERS = {
    "ring_allreduce_bidir_chunked": allreduce_bidir_chunked,
    "ring_allreduce_chunked": allreduce_chunked,
    "ring_reduce_scatter_chunked": reduce_scatter_chunked,
    "ring_all_gather_chunked": all_gather_chunked,
    "ring_allreduce": allreduce_resident,
    "ring_allreduce_bidir": allreduce_bidir_resident,
    "ring_reduce_scatter": reduce_scatter_resident,
    "ring_all_gather": all_gather_resident,
}
# The direct allreduce rows' torch folds, called as their wrappers are.
FOLDS = {
    "ring_allreduce_bidir_chunked": allreduce_bidir_direct_plain,
    "ring_allreduce_chunked": allreduce_direct_plain,
    "ring_allreduce": allreduce_resident_direct_plain,
    "ring_allreduce_bidir": allreduce_bidir_resident_direct_plain,
}
PLAINS = {
    "ring_allreduce_bidir_chunked": allreduce_bidir_chunked_plain,
    "ring_allreduce_chunked": allreduce_chunked_plain,
    "ring_reduce_scatter_chunked": reduce_scatter_chunked_plain,
    "ring_all_gather_chunked": all_gather_chunked_plain,
    "ring_allreduce": allreduce_resident_plain,
    "ring_allreduce_bidir": allreduce_bidir_resident_plain,
    "ring_reduce_scatter": reduce_scatter_resident_plain,
    "ring_all_gather": all_gather_resident_plain,
}


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------


def _check_entry_dtype(xs: torch.Tensor, what: str) -> None:
    if xs.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"ring {what} supports float32 / bfloat16 / int32, "
                        f"got {xs.dtype} (use the xla backend for other "
                        f"dtypes)")


def _allreduce(xs: torch.Tensor, op: str, rows) -> torch.Tensor:
    if op not in ("sum", "mean"):
        raise KeyError(f"ring allreduce does not support op {op!r}")
    n = xs.shape[0]
    if n == 1:
        out = xs.clone()
    else:
        _check_entry_dtype(xs, "allreduce")
        flat = xs.reshape(n, -1)
        cfg = runtime.effective_config()
        name, plan = schedule(flat.shape[1], n, xs.dtype,
                              chunk_bytes=cfg.chunk_bytes,
                              bidirectional=cfg.pallas_bidirectional)
        out = rows[name](flat, *plan).reshape(xs.shape)
    if op == "mean":
        out = out / n
    return out


def ring_allreduce(xs: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """Allreduce over the leading (rank) axis of ``xs`` [n, ...]: every
    slice of the result is the sum (or mean, ``out / n`` as in JAX, so an
    int32 mean is float32) over ranks.  The selector's ``"pallas"``
    implementation of the rank-major allreduce; the kernel is chosen by
    :func:`schedule` from the active Config.  A ring of one returns a copy
    (:926)."""
    return _allreduce(xs, op, WRAPPERS)


def ring_allreduce_plain(xs: torch.Tensor, *, op: str = "sum"):
    """:func:`ring_allreduce` through the plain versions, on any device."""
    return _allreduce(xs, op, PLAINS)


def _reduce_scatter(xs: torch.Tensor, op: str, rows) -> torch.Tensor:
    if op != "sum":
        raise KeyError(f"ring reduce_scatter supports sum, not {op!r}")
    n = xs.shape[0]
    if xs.dim() < 2 or xs.shape[1] % n:
        raise ValueError(f"reduce_scatter needs [n, k, ...] with k divisible "
                         f"by the {n} ranks, got {tuple(xs.shape)}")
    if n == 1:
        return xs.clone()
    _check_entry_dtype(xs, "reduce_scatter")
    flat = xs.reshape(n, -1)
    name, plan = schedule_reduce_scatter(
        flat.shape[1], n, xs.dtype,
        chunk_bytes=runtime.effective_config().chunk_bytes)
    return rows[name](flat, *plan).reshape(n, xs.shape[1] // n,
                                           *xs.shape[2:])


def ring_reduce_scatter(xs: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """Reduce-scatter over the leading (rank) axis of ``xs`` [n, k, ...], k
    divisible by n: slice r of the result [n, k / n, ...] is rank r's tile
    of the sum over ranks (``lax.psum_scatter(tiled=True)``, sum only, JAX
    :994).  The selector's ``"pallas"`` implementation of the rank-major
    reduce-scatter; the kernel is chosen by :func:`schedule_reduce_scatter`
    from the active Config.  A ring of one returns a copy (:1028)."""
    return _reduce_scatter(xs, op, WRAPPERS)


def ring_reduce_scatter_plain(xs: torch.Tensor, *, op: str = "sum"):
    """:func:`ring_reduce_scatter` through the plain versions, on any
    device."""
    return _reduce_scatter(xs, op, PLAINS)


def _all_gather(shards: torch.Tensor, rows) -> torch.Tensor:
    n = shards.shape[0]
    if n == 1:
        return shards[:, None].clone()
    _check_entry_dtype(shards, "all_gather")
    flat = shards.reshape(n, -1)
    name, plan = schedule_all_gather(
        flat.shape[1], n, shards.dtype,
        chunk_bytes=runtime.effective_config().chunk_bytes)
    return rows[name](flat, *plan).reshape(n, *shards.shape)


def ring_all_gather(shards: torch.Tensor) -> torch.Tensor:
    """All-gather over the leading (rank) axis of ``shards`` [n, ...]: every
    slice of the result [n, n, ...] is the stack of all ranks' shards
    (``lax.all_gather(tiled=False)``, JAX :1063).  The selector's
    ``"pallas"`` implementation of the rank-major all-gather; the kernel is
    chosen by :func:`schedule_all_gather` from the active Config."""
    return _all_gather(shards, WRAPPERS)


def ring_all_gather_plain(shards: torch.Tensor) -> torch.Tensor:
    """:func:`ring_all_gather` through the plain versions, on any device."""
    return _all_gather(shards, PLAINS)
