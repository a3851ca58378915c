"""Wire codecs for the inter-node (dcn) leg of the two-level collectives.

The PyTorch counterpart of ``torchmpi_tpu/compress.py``.  The two-level
allreduce sends only ``1 / n_ici`` of a tensor over the slow dcn links
(reduce-scatter over ici first, ``parallel/hierarchical.py``); these codecs
narrow that shard further:

- only the ici-scattered shard that crosses dcn is quantized; the ici legs
  run in the tensor's own dtype;
- ``int8`` / ``fp8`` payloads carry one float32 scale per shard (``scale =
  amax / qmax``); the dcn sum all-gathers the payloads and scales and
  every rank reduces the decoded values itself, in slice order, so every
  rank computes the same sum from the same wire bytes;
- error feedback (the gradient syncs): a float32 residual per (site,
  bucket) is added back before quantization and refilled with the new
  quantization error, threaded as explicit state through
  ``gradsync.synchronize_gradients(residuals=...)``,
  ``gradsync.make_overlapped_grad_fn(residuals=True)`` and ZeRO's
  ``dcn_residuals=``.

Opt-in through ``Config.dcn_compress`` ("off" / "bf16" / "int8" / "fp8")
and ``Config.dcn_compress_min_bytes``; with "off" this module is never
imported (each call site resolves the codec behind one string compare).
:func:`validate_wire` is also the one validation of ``gradsync_compress``.

Every collective here has two forms, as the rest of the port: across
processes, on this rank's shard and the runtime's subgroups
(``runtime.group``), and rank-major, where a stack holds every rank's
buffer on one device (``*_rank_major``, rows in global rank order
``d * n_ici + i``).  With ``Config.obs`` on, every dcn leg counts its
wire and payload bytes (:func:`note_leg`, ``tm_dcn_*``; JAX :244-256,
:343-353, :392-401).  Under an analysis check (a listener installed,
``fusion.set_trace_listener``) the legs also leave the JAX package's C2
records: :func:`note_leg` for each dcn leg, :func:`note_skipped` for a
leg that crossed uncompressed although a codec is on, and
:func:`residual_note` for every error-feedback residual binding, before
a mismatch raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import fusion, runtime
from .parallel.hierarchical import _fold, _padded

CODECS = ("bf16", "int8", "fp8")
_WIRE_DTYPES = {
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "fp8": getattr(torch, "float8_e4m3fn", None),
}
# Largest magnitude per quantized codec (the scale's denominator): int8
# symmetric [-127, 127]; e4m3fn tops out at 448.
_QMAX = {"int8": 127.0, "fp8": 448.0}
# The scale is amax times the float32 reciprocal of qmax: the JAX package
# writes ``amax / qmax``, and XLA compiles a division by a constant inside
# its jitted collectives as that product, which can be 1 ulp from the
# quotient (ROADMAP queue C note 19).
_INV_QMAX = {k: float(np.float32(1.0 / v)) for k, v in _QMAX.items()}
_SCALE_FLOOR = 1e-30


class ResidualMismatchError(ValueError):
    """Threaded residual state does not match the bucket layout (a
    ValueError for callers, a type of its own as in the JAX package)."""


def validate_wire(value, *, allowed: Sequence[str] = CODECS,
                  site: str = "compress") -> Optional[str]:
    """A wire-compression knob made canonical: None / "none" / "off" / ""
    mean uncompressed (None); anything else must name a codec in
    ``allowed`` (any case) or this raises."""
    if value is None:
        return None
    v = str(value).strip().lower()
    if v in ("none", "off", ""):
        return None
    if v not in allowed:
        raise ValueError(
            f"{site}: unknown compression {value!r} "
            f"(allowed: {', '.join(allowed)} or none)")
    if _WIRE_DTYPES.get(v) is None:
        raise ValueError(f"{site}: codec {v!r} needs torch.float8_e4m3fn, "
                         f"which this torch build lacks")
    return v


def resolve_dcn(cfg) -> Optional[str]:
    """The active dcn codec of a Config (None when off)."""
    return validate_wire(getattr(cfg, "dcn_compress", "off"),
                         site="config.dcn_compress")


def resolve_ef(dcn_compress, cfg, *, site: str, backend=None,
               explicit_compress: bool = False, compress=None,
               allow_backend: bool = False) -> str:
    """The codec of one error-feedback entry point, never None (residual
    state without a codec is an error).  The EF collective is a fixed
    two-level schedule, so an explicit ``backend=`` raises unless the
    caller routes other legs with it (``allow_backend``: ZeRO's parameter
    all-gather), and an explicit ``compress=`` always raises."""
    if dcn_compress is None and cfg is not None:
        dcn_compress = getattr(cfg, "dcn_compress", "off")
    codec = validate_wire(dcn_compress, site=f"{site}(dcn_compress)")
    if codec is None:
        raise ValueError(
            f"{site}: residual state given but no DCN codec active — "
            f"set Config.dcn_compress (or pass dcn_compress=) to "
            f"bf16|int8|fp8")
    if backend is not None and not allow_backend:
        raise ValueError(
            f"{site}: backend= does not combine with error-feedback "
            f"residuals — the EF collective is the fixed two-level "
            f"hierarchical schedule")
    if explicit_compress and compress is not None:
        raise ValueError(
            f"{site}: compress= does not combine with error-feedback "
            f"residuals — on this path the wire compression is the "
            f"DCN codec (dcn_compress)")
    return codec


def ef_axes(axis_names) -> Tuple[str, str]:
    """The ``(outer, inner)`` axis pair every error-feedback entry point
    needs (None: the world's ("dcn", "ici"))."""
    if axis_names is None:
        return "dcn", "ici"
    axes = ((axis_names,) if isinstance(axis_names, str)
            else tuple(axis_names))
    if len(axes) != 2:
        raise ValueError(
            f"DCN error feedback needs (outer, inner) axes, got {axes}")
    return axes[0], axes[1]


def init_residuals(shard_sizes: Sequence[int], n: Optional[int] = None, *,
                   device=None) -> List[torch.Tensor]:
    """Zeroed error-feedback accumulators, float32, one per bucket: [n,
    shard] for a rank-major stack of ``n`` ranks, [shard] for this
    process's rank (``n`` None).  The one place the layout is defined."""
    lead = () if n is None else (int(n),)
    return [torch.zeros(lead + (int(s),), dtype=torch.float32, device=device)
            for s in shard_sizes]


def expected_shards(extents: Sequence[int], n_inner: int) -> List[int]:
    """Per-bucket ici-scattered residual extents, ``ceil(extent /
    n_inner)``: where quantization happens."""
    n = max(1, int(n_inner))
    return [-(-int(e) // n) for e in extents]


def wire_itemsize(codec: str) -> int:
    return torch.empty((), dtype=_WIRE_DTYPES[codec]).element_size()


# The axes every dcn leg spans: the two-level grid's.
_LEG_AXES = ("dcn", "ici")


def _leg_record(op: str, codec: str, nbytes: int, wire_nbytes: int,
                **extra) -> dict:
    """The C2 record of one dcn leg (JAX :229-241)."""
    return dict(kind="dcn_compress", op=op, codec=codec, nbytes=int(nbytes),
                wire_nbytes=int(wire_nbytes),
                min_bytes=int(runtime.effective_config()
                              .dcn_compress_min_bytes),
                axes=_LEG_AXES, **extra)


def note_leg(op: str, codec: Optional[str], payload_nbytes: int,
             wire_nbytes: Optional[int] = None) -> None:
    """One dcn leg's telemetry, with obs on: ``payload_nbytes`` the
    uncompressed shard one rank sends, ``wire_nbytes`` what it puts on the
    wire (the payload itself for an uncompressed leg, ``codec`` None).
    Every call counts (JAX counts traces; ROADMAP queue C note 31).  Under
    an analysis check a compressed leg leaves its C2 record (JAX
    :244-256)."""
    wire = payload_nbytes if wire_nbytes is None else wire_nbytes
    if codec is not None and fusion._trace_listener is not None:
        fusion._emit_trace_record(_leg_record(op, codec, payload_nbytes,
                                              wire))
    if runtime.effective_config().obs == "off":
        return
    from . import obs

    obs.record_dcn(op, codec or "none", wire, payload_nbytes)


def note_skipped(op: str, codec: str, nbytes: int, *,
                 incompatible: bool = False) -> None:
    """The C2 record of a dcn leg that crossed UNCOMPRESSED although
    ``codec`` is on (JAX :260-270): an op or payload the codec cannot
    quantize (``incompatible``), or a shard below
    ``dcn_compress_min_bytes``.  Wire = payload; no telemetry (the
    uncompressed leg accounts for itself)."""
    if fusion._trace_listener is not None:
        extra = {"incompatible": True} if incompatible else {}
        fusion._emit_trace_record(_leg_record(op, codec, nbytes, nbytes,
                                              **extra))


def residual_note(expected: int, got: int, ok: bool) -> None:
    """The C2 record of one error-feedback residual binding (JAX
    :418-428): the buffers the bucket layout expects against those
    threaded, and whether their extents line up."""
    if fusion._trace_listener is not None:
        fusion._emit_trace_record(dict(
            kind="dcn_residual", expected=int(expected), got=int(got),
            ok=bool(ok), axes=_LEG_AXES))


def wire_nbytes_of(n_elems: int, codec: str) -> int:
    """Bytes one rank puts on the dcn wire for an ``n_elems`` shard: the
    payload plus the float32 scale (bf16 carries none)."""
    return int(n_elems) * wire_itemsize(codec) + (0 if codec == "bf16"
                                                  else 4)


def _encode_rows(xf: torch.Tensor, codec: str):
    """:func:`encode` of each row of ``xf`` [R, m] (float32), one scale a
    row: (payload [R, m], scale [R] or None)."""
    if codec == "bf16":
        return xf.to(torch.bfloat16), None
    qmax = _QMAX[codec]
    amax = (xf.abs().amax(dim=1) if xf.shape[1]
            else xf.new_zeros(xf.shape[0]))
    scale = torch.clamp_min(amax * _INV_QMAX[codec], _SCALE_FLOOR)
    y = xf / scale[:, None]
    if codec == "int8":
        return torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8), scale
    return y.to(_WIRE_DTYPES["fp8"]), scale


def encode(x: torch.Tensor, codec: str):
    """Quantize one bucket onto the wire: ``(payload, scale)``, ``scale``
    a 0-d float32 for int8 / fp8 (``amax`` times qmax's float32
    reciprocal, as XLA compiles the JAX package's ``amax / qmax``, floored
    at 1e-30 so an
    all-zero bucket decodes to zeros), None for bf16 (a plain cast).
    ``x`` is promoted to float32 first; int8 rounds half to even and
    clips to +-127."""
    xf = x.to(torch.float32)
    payload, scale = _encode_rows(xf.reshape(1, -1), codec)
    return payload.reshape(x.shape), (None if scale is None else scale[0])


def decode(payload: torch.Tensor, scale, dtype=torch.float32):
    """Inverse of :func:`encode` (up to the codec's rounding)."""
    if scale is None:
        return payload.to(dtype)
    return (payload.to(torch.float32) * scale).to(dtype)


def host_encode(x, codec: str):
    """Numpy twin of :func:`encode` for host payloads (the JAX package's,
    bit for bit): bf16 as the upper 16 bits of float32 rounded to nearest
    even (uint16), int8 with the same scale and rounding.  Like the JAX
    package's, it quantizes to int8 whatever the scaled codec."""
    xf = np.asarray(x, dtype=np.float32)
    if codec == "bf16":
        u = xf.view(np.uint32)
        return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16), \
            None
    qmax = _QMAX[codec]
    scale = host_scale(float(np.max(np.abs(xf))) if xf.size else 0.0, codec)
    q = np.clip(np.round(xf / scale), -qmax, qmax).astype(np.int8)
    return q, scale


def host_scale(amax: float, codec: str) -> np.float32:
    """:func:`host_encode`'s scale from a payload's absolute maximum:
    ``amax / qmax`` in float64, floored at 1e-30, rounded to float32 (the
    JAX package's).  The hot-state tier's pack on the card takes its
    scales here from maxima it reduced there."""
    return np.float32(max(float(amax) / _QMAX[codec], _SCALE_FLOOR))


def host_decode(payload, scale, dtype=np.float32):
    """Inverse of :func:`host_encode` (up to the codec's rounding)."""
    if scale is None:
        u = payload.astype(np.uint32) << 16
        return u.view(np.float32).astype(dtype)
    return (payload.astype(np.float32) * np.float32(scale)).astype(dtype)


def _decoded_sum(payloads: torch.Tensor, scales) -> torch.Tensor:
    """The float32 sum over the leading (slice) axis of the payloads
    [n_dcn, ...], a left fold in slice order, so every rank, in either
    form, adds the same values in the same order: bf16 payloads (``scales``
    None) summed in bf16 (the JAX package's ``psum`` of the cast), scaled
    ones decoded (scales [n_dcn, ...] broadcast on the right) and summed in
    float32."""
    if scales is None:
        acc = payloads[0].clone()
        for d in range(1, payloads.shape[0]):
            acc = acc + payloads[d]
        return acc.to(torch.float32)

    def dec(d):
        s = scales[d]
        q = payloads[d].to(torch.float32)
        return q * s.reshape(s.shape + (1,) * (q.dim() - s.dim()))

    acc = dec(0)
    for d in range(1, payloads.shape[0]):
        acc = acc + dec(d)
    return acc


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The bytes a payload travels as (fp8 as uint8: gloo has no fp8)."""
    return t.view(torch.uint8) if t.dtype == _WIRE_DTYPES["fp8"] else t


def dcn_allreduce(shard: torch.Tensor, codec: str, *, residual=None,
                  op: str = "sum", group=None):
    """This rank's ici-scattered ``shard`` summed over the dcn group
    (``runtime.group("dcn")`` unless given) on a quantized wire; returns
    ``(sum, new_residual)``.  bf16 rides a cast and an allreduce; int8 /
    fp8 all-gather the payloads and scales and reduce the decoded values
    here (the bf16 payloads are all-gathered too and summed in bf16 in
    slice order, so both forms give the same bits).  ``residual``
    (float32, the shard's size) arms error feedback:
    added before quantization, ``new_residual`` the new quantization error
    (None in, None out).  ``op`` must be sum (the caller owns a mean)."""
    if op != "sum":
        raise ValueError(
            f"compressed DCN leg supports op='sum', got {op!r}")
    if group is None:
        group = runtime.group("dcn")
    xf = shard.to(torch.float32)
    if residual is not None:
        xf = xf + residual.reshape(xf.shape).to(torch.float32)
    payload, scale = encode(xf, codec)
    n = dist.get_world_size(group)
    gathered = payload.new_empty((n,) + tuple(payload.shape))
    scales = None
    if scale is not None:
        scales = scale.new_empty(n)
        dist.all_gather_into_tensor(scales, scale.reshape(1), group=group)
    dist.all_gather_into_tensor(_wire(gathered).view(-1),
                                _wire(payload.contiguous()).view(-1),
                                group=group)
    tot = _decoded_sum(gathered, scales)
    new_residual = None
    if residual is not None:
        new_residual = xf - decode(payload, scale)
    return tot.to(shard.dtype), new_residual


def dcn_allreduce_rank_major(shards: torch.Tensor, codec: str, *,
                             residual=None, op: str = "sum"):
    """:func:`dcn_allreduce` of every rank at once: ``shards`` [n_dcn, ...,
    m], each row [d, ...] one rank's shard (its own scale), summed over the
    leading (dcn) axis; returns ``(sum [..., m], new_residual [n_dcn, ...,
    m] or None)``.  The same bits as :func:`dcn_allreduce` on each rank."""
    if op != "sum":
        raise ValueError(
            f"compressed DCN leg supports op='sum', got {op!r}")
    xf = shards.to(torch.float32)
    if residual is not None:
        xf = xf + residual.reshape(xf.shape).to(torch.float32)
    rows = xf.reshape(-1, xf.shape[-1])
    payload, scale = _encode_rows(rows, codec)
    payload = payload.reshape(xf.shape)
    if scale is not None:
        scale = scale.reshape(xf.shape[:-1])
    tot = _decoded_sum(payload, scale)
    new_residual = None
    if residual is not None:
        dec = (payload.to(torch.float32) if scale is None
               else payload.to(torch.float32) * scale[..., None])
        new_residual = xf - dec
    return tot.to(shards.dtype), new_residual


def ef_bucket_allreduce(flat: torch.Tensor, codec: str, residual, *,
                        op: str = "sum", min_bytes: int = 0):
    """One bucket's two-level allreduce with error feedback, across
    processes: the reduce-scatter of ``flat`` (1-D, its own dtype, padded
    to a multiple of n_ici) over this node's ici group, the shard's
    residual-corrected quantized sum over the dcn group, the all-gather
    over ici.  ``residual`` is this rank's float32 accumulator
    (``ceil(len / n_ici)`` elements).  A shard below ``min_bytes`` crosses
    uncompressed with the residual passed through.  Returns
    ``(reduced_flat, new_residual)``, the residual in the input's shape and
    dtype."""
    from . import collectives

    if op not in ("sum", "mean"):
        raise ValueError(
            f"error-feedback allreduce supports sum|mean, got {op!r}")
    n_dcn, n_ici = runtime.grid()
    gi, gd = runtime.group("ici"), runtime.group("dcn")
    length = flat.shape[0]
    padded = _padded(flat, -(-length // n_ici) * n_ici).contiguous()
    shard = flat.new_empty(padded.shape[0] // n_ici)
    collectives._reduce_scatter_single(shard, padded, group=gi)
    if min_bytes and shard.numel() * shard.element_size() < int(min_bytes):
        note_leg("allreduce", None, shard.numel() * shard.element_size())
        note_skipped("allreduce", codec,
                     shard.numel() * shard.element_size())
        dist.all_reduce(shard, group=gd)
        tot, new_res = shard, residual
    else:
        note_leg("allreduce", codec, shard.numel() * shard.element_size(),
                 wire_nbytes_of(shard.numel(), codec))
        tot, new_res = dcn_allreduce(shard, codec,
                                     residual=residual.reshape(-1),
                                     group=gd)
        new_res = new_res.reshape(residual.shape).to(residual.dtype)
    full = flat.new_empty(padded.shape[0])
    collectives._all_gather_single(full, tot.contiguous(), group=gi)
    full = full[:length]
    if op == "mean":
        full = full / (n_dcn * n_ici)
    return full, new_res


def ef_bucket_allreduce_rank_major(flat: torch.Tensor, codec: str, residual,
                                   *, op: str = "sum", min_bytes: int = 0):
    """:func:`ef_bucket_allreduce` of every rank at once: ``flat`` [n, L]
    (rank r's bucket in row r), ``residual`` [n, ceil(L / n_ici)].  Returns
    ``(reduced [n, L], new_residual [n, shard])``, every rank's row the
    same and the same bits as each rank's :func:`ef_bucket_allreduce`."""
    if op not in ("sum", "mean"):
        raise ValueError(
            f"error-feedback allreduce supports sum|mean, got {op!r}")
    n, length = flat.shape
    n_dcn, n_ici = runtime.grid(n)
    c = -(-length // n_ici)
    x = _padded(flat, c * n_ici).reshape(n_dcn, n_ici, n_ici, c)
    shards = _fold(x, 1)                      # [n_dcn, tile, c]
    if min_bytes and c * flat.element_size() < int(min_bytes):
        note_leg("allreduce", None, c * flat.element_size())
        note_skipped("allreduce", codec, c * flat.element_size())
        tot, new_res = _fold(shards, 0), residual
    else:
        note_leg("allreduce", codec, c * flat.element_size(),
                 wire_nbytes_of(c, codec))
        tot, new_res = dcn_allreduce_rank_major(
            shards, codec, residual=residual.reshape(n_dcn, n_ici, c))
        new_res = new_res.reshape(residual.shape).to(residual.dtype)
    full = tot.reshape(1, -1)[:, :length].expand(n, length)
    if op == "mean":
        full = full / (n_dcn * n_ici)
    return full.clone() if op == "sum" else full, new_res


def ef_group_reduce_scatter(g_flat: torch.Tensor, codec: str, residual, *,
                            min_bytes: int = 0):
    """One dtype group's two-level ZeRO gradient leg with error feedback,
    across processes: this rank's flat shard (global index ``d * n_ici +
    i``) of the summed group.  ``g_flat`` is the padded group flat (length
    divisible by n); it is pre-permuted so that the reduce-scatter over
    ici first still lands every rank on its dcn-major extent.  Returns
    ``(shard [len / n], new_residual)``; the residual covers the
    ici-scattered intermediate (``len / n_ici`` elements)."""
    from . import collectives

    n_dcn, n_ici = runtime.grid()
    d = runtime.axis_index("dcn")
    sub = g_flat.shape[0] // (n_dcn * n_ici)
    perm = g_flat.reshape(n_dcn, n_ici, sub).transpose(0, 1).reshape(-1)
    s = g_flat.new_empty(n_dcn * sub)
    collectives._reduce_scatter_single(s, perm, group=runtime.group("ici"))
    if min_bytes and s.numel() * s.element_size() < int(min_bytes):
        note_leg("reduce_scatter", None, s.numel() * s.element_size())
        note_skipped("reduce_scatter", codec, s.numel() * s.element_size())
        dist.all_reduce(s, group=runtime.group("dcn"))
        tot, new_res = s, residual
    else:
        note_leg("reduce_scatter", codec, s.numel() * s.element_size(),
                 wire_nbytes_of(s.numel(), codec))
        tot, new_res = dcn_allreduce(s, codec, residual=residual.reshape(-1))
        new_res = new_res.reshape(residual.shape).to(residual.dtype)
    return tot[d * sub:(d + 1) * sub].clone(), new_res


def ef_group_reduce_scatter_rank_major(g_flat: torch.Tensor, codec: str,
                                       residual, *, min_bytes: int = 0):
    """:func:`ef_group_reduce_scatter` of every rank at once: ``g_flat``
    [n, padded], ``residual`` [n, padded / n_ici]; returns ``(shards [n,
    padded / n], new_residual)``."""
    n, padded = g_flat.shape
    n_dcn, n_ici = runtime.grid(n)
    sub = padded // n
    # [rank d, rank i, block d', tile t, sub]: rank (d, t) holds the ici sum
    # of every block (d', t).
    x = g_flat.reshape(n_dcn, n_ici, n_dcn, n_ici, sub)
    s = _fold(x, 1).transpose(2, 1)          # [d, t, d', sub]
    if min_bytes and n_dcn * sub * g_flat.element_size() < int(min_bytes):
        note_leg("reduce_scatter", None, n_dcn * sub * g_flat.element_size())
        note_skipped("reduce_scatter", codec,
                     n_dcn * sub * g_flat.element_size())
        tot, new_res = _fold(s, 0), residual
    else:
        note_leg("reduce_scatter", codec,
                 n_dcn * sub * g_flat.element_size(),
                 wire_nbytes_of(n_dcn * sub, codec))
        tot, new_res = dcn_allreduce_rank_major(
            s.reshape(n_dcn, n_ici, n_dcn * sub), codec,
            residual=residual.reshape(n_dcn, n_ici, n_dcn * sub))
        new_res = new_res.reshape(residual.shape).to(residual.dtype)
    # Rank (d, t) takes block d of tile t's sum.
    tot = tot.reshape(n_ici, n_dcn, sub)
    return tot.transpose(0, 1).reshape(n, sub).contiguous(), new_res


def check_residuals(residuals, want: Sequence[int], *, site: str,
                    layout: str, init_hint: str,
                    n: Optional[int] = None) -> list:
    """The residual state of one EF entry point as a list, checked against
    the per-bucket shard extents ``want`` (:func:`expected_shards`): one
    buffer per bucket, each [shard] (this process's rank) or [n, shard]
    (a rank-major stack of ``n``); :class:`ResidualMismatchError`
    otherwise."""
    res_list = list(residuals)
    lead = 1 if n is None else int(n)

    def fits(r, w):
        return (isinstance(r, torch.Tensor) and r.numel() == lead * int(w)
                and (n is None or (r.dim() >= 1 and r.shape[0] == lead)))

    ok = (len(res_list) == len(want)
          and all(fits(r, w) for r, w in zip(res_list, want)))
    residual_note(len(want), len(res_list), ok)
    if not ok:
        got = [tuple(getattr(r, "shape", ())) for r in res_list]
        raise ResidualMismatchError(
            f"{site}: DCN residual state does not match {layout} "
            f"({len(res_list)} buffers of shapes {got} vs {len(want)} "
            f"bucket(s) needing shard sizes {list(want)}"
            f"{'' if n is None else f' for {n} ranks'}) "
            f"— build the state with {init_hint}")
    return res_list
