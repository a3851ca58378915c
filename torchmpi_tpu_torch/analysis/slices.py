"""Cache-write safety over an aten graph (the S rules' event stream; the
JAX package's ``analysis/slices.py``).

JAX walks a jaxpr's ``dynamic_update_slice`` / ``dynamic_slice`` /
``scatter``; the port builds the aten graph of a decode or serving tick
with ``torch.fx.experimental.proxy_tensor.make_fx(...,
tracing_mode="fake")`` (nothing runs on a device: the inputs are fake
tensors, the model's weights constants of the graph; serving launches no
custom kernel, so the tick traces whole) and walks that.  One
:class:`SliceEvent` per cache write or indexed read: ``index_put`` (the
per-row ``ck[rows, q_pos] = k`` write), ``index_copy``, ``scatter``,
``slice_scatter``, ``select_scatter``, ``index_select`` and ``index``,
with whether every index is *provably in range* for the target's dim.

An out-of-range index does not clamp in torch as JAX's start does: a
negative one wraps silently and one past the end faults the card
(ROADMAP queue C note 1), so the proof matters the same.  It is a
forward interval analysis over the integer tensors that feed indices:
``arange``, constants and fills, ``clamp`` / ``clamp_min`` /
``clamp_max``, ``minimum`` / ``maximum``, ``add`` / ``sub``,
``remainder``, ``mul`` by a non-negative constant, and the view ops that
keep values (``unsqueeze``, ``view``, ``expand``, ``select``, casts, ...).
Anything it cannot bound is unbounded: a clamp the checker cannot see is
a clamp a reader of the code cannot see either.  Inputs of the traced
function are data-dependent; a write into an input (or into a value written from one)
is a write into a carried cache buffer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Set, Tuple

NEG = float("-inf")
POS = float("inf")
TOP = (NEG, POS)

# Ops whose output values are the input's (the interval passes through).
_PASSTHROUGH = (
    "unsqueeze", "squeeze", "view", "reshape", "_unsafe_view", "expand",
    "expand_as", "permute", "t", "transpose", "contiguous", "clone",
    "alias", "detach", "lift_fresh_copy", "_to_copy", "to", "select",
    "slice", "flatten", "repeat", "repeat_interleave", "broadcast_to",
    "squeeze_", "unsqueeze_", "amin", "amax", "min", "max", "index_select",
)
_WRITES = ("index_put", "index_put_", "_index_put_impl_", "index_copy",
           "index_copy_", "scatter", "scatter_", "slice_scatter",
           "select_scatter")
_READS = ("index", "index_select")


@dataclass(frozen=True)
class SliceEvent:
    """One cache-write-family node of the traced graph."""

    op: str            # the aten op (index_put, index_copy, ...)
    path: str          # the node's name in the graph
    source: str        # the user line that issued it, best-effort
    write: bool        # a write (True) or an indexed read
    batched: bool      # per-row: indices over more than one row
    on_buffer: bool    # the target is an input (a carried cache)
    data_dependent: bool  # some index derives from an input
    safe: bool         # every index provably within its dim
    detail: str = ""   # the first failing dim: interval vs room


def _name(target) -> str:
    """``aten.index_put_.default`` -> ``index_put_``."""
    s = getattr(target, "__name__", str(target))
    parts = str(getattr(target, "_name", s)).split("::")[-1]
    return parts.split(".")[0]


def _num(v):
    return v if isinstance(v, (int, float)) and not isinstance(v, bool) \
        else None


class _Walker:
    def __init__(self) -> None:
        self.iv: Dict[Any, Tuple[float, float]] = {}
        self.data: Set[Any] = set()
        self.buffers: Set[Any] = set()
        self.events: List[SliceEvent] = []

    def aiv(self, a) -> Tuple[float, float]:
        n = _num(a)
        if n is not None:
            return (float(n), float(n))
        return self.iv.get(a, TOP)

    def adata(self, a) -> bool:
        return a in self.data

    def _const(self, node, gm) -> Tuple[float, float]:
        try:
            t = gm
            for part in node.target.split("."):
                t = getattr(t, part)
            if not t.dtype.is_floating_point and t.numel() and \
                    t.numel() <= 1 << 20:
                return (float(t.min()), float(t.max()))
        except Exception:  # noqa: BLE001 — unbounded is always sound
            pass
        return TOP

    def walk(self, gm) -> List[SliceEvent]:
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                self.iv[node] = TOP
                self.data.add(node)
                self.buffers.add(node)
            elif node.op == "get_attr":
                self.iv[node] = self._const(node, gm)
            elif node.op == "call_function":
                self._call(node)
        return self.events

    def _call(self, node) -> None:
        name = _name(node.target)
        args = list(node.args)
        dd = any(self.adata(a) for a in _flat(args))
        if name in _WRITES:
            self._write(node, name, args)
            if args and args[0] in self.buffers:
                self.buffers.add(node)
            self.iv[node] = TOP
            if dd:
                self.data.add(node)
            return
        if name in _READS:
            self._read(node, name, args)
        if dd:
            self.data.add(node)
        kw = node.kwargs
        if name in _PASSTHROUGH and args:
            self.iv[node] = self.aiv(args[0])
            if args[0] in self.buffers and name not in ("clone", "_to_copy",
                                                        "to"):
                self.buffers.add(node)
        elif name == "arange":
            nums = [_num(a) for a in args[:3]]
            if len(args) == 1 and nums[0] is not None:
                self.iv[node] = (0.0, float(max(0, nums[0] - 1)))
            elif len(args) >= 2 and None not in nums[:2]:
                self.iv[node] = (float(nums[0]), float(max(nums[0],
                                                           nums[1] - 1)))
            else:
                self.iv[node] = TOP
        elif name in ("full", "scalar_tensor", "full_like", "fill"):
            v = _num(args[1] if name in ("full", "full_like", "fill")
                     and len(args) > 1 else args[0] if args else None)
            self.iv[node] = (float(v), float(v)) if v is not None else TOP
        elif name in ("zeros", "zeros_like", "new_zeros"):
            self.iv[node] = (0.0, 0.0)
        elif name in ("ones", "ones_like", "new_ones"):
            self.iv[node] = (1.0, 1.0)
        elif name in ("clamp", "clip"):
            lo, hi = self.aiv(args[0])
            mn = args[1] if len(args) > 1 else kw.get("min")
            mx = args[2] if len(args) > 2 else kw.get("max")
            if mn is not None:
                lo, hi = max(lo, self.aiv(mn)[0]), max(hi, self.aiv(mn)[0])
            if mx is not None:
                lo, hi = min(lo, self.aiv(mx)[1]), min(hi, self.aiv(mx)[1])
            self.iv[node] = (lo, hi)
        elif name in ("clamp_min", "maximum"):
            (l1, h1), (l2, h2) = self.aiv(args[0]), self.aiv(args[1])
            self.iv[node] = (max(l1, l2), max(h1, h2))
        elif name in ("clamp_max", "minimum"):
            (l1, h1), (l2, h2) = self.aiv(args[0]), self.aiv(args[1])
            self.iv[node] = (min(l1, l2), min(h1, h2))
        elif name == "add":
            (l1, h1), (l2, h2) = self.aiv(args[0]), self.aiv(args[1])
            alpha = _num(kw.get("alpha", 1))
            if alpha == 1:
                self.iv[node] = (l1 + l2, h1 + h2)
            else:
                self.iv[node] = TOP
        elif name in ("sub", "rsub"):
            a, b = (args[0], args[1]) if name == "sub" else (args[1],
                                                             args[0])
            (l1, h1), (l2, h2) = self.aiv(a), self.aiv(b)
            self.iv[node] = (l1 - h2, h1 - l2) if _num(kw.get(
                "alpha", 1)) == 1 else TOP
        elif name == "mul":
            consts = [a for a in args[:2] if _num(a) is not None]
            if consts and consts[0] >= 0:
                other = args[1] if _num(args[0]) is not None else args[0]
                lo, hi = self.aiv(other)
                k = float(consts[0])
                self.iv[node] = (lo * k, hi * k)
            else:
                self.iv[node] = TOP
        elif name in ("remainder", "fmod"):
            lo, _ = self.aiv(args[0])
            dl, dh = self.aiv(args[1])
            if dl == dh and 0 < dl < POS:
                floor = 0.0 if (name == "remainder" or lo >= 0) \
                    else -(dl - 1)
                self.iv[node] = (floor, dl - 1)
            else:
                self.iv[node] = TOP
        else:
            self.iv[node] = TOP

    def _room(self, node, target, dims, idxs, widths):
        shape = list(target.meta["val"].shape) if "val" in getattr(
            target, "meta", {}) else None
        safe, detail, dd = True, "", False
        for d, ix, w in zip(dims, idxs, widths):
            if ix is None:
                continue
            dd = dd or self.adata(ix)
            lo, hi = self.aiv(ix)
            size = shape[d] if shape is not None and d < len(shape) else None
            room = None if size is None else size - int(w)
            if room is None or lo < 0 or hi > room:
                safe = False
                span = (f"[{int(lo) if lo > NEG else '-inf'}, "
                        f"{int(hi) if hi < POS else 'inf'}]")
                detail = (f"dim {d}: start in {span}, room [0, {room}] for "
                          f"width {w} in {size}")
                break
        return safe, detail, dd

    def _emit(self, node, op, target, dims, idxs, widths, write) -> None:
        safe, detail, dd = self._room(node, target, dims, idxs, widths)
        batched = any(ix is not None and _numel(ix) > 1 for ix in idxs)
        self.events.append(SliceEvent(
            op=op, path=node.name, source=_source(node), write=write,
            batched=batched and dd, on_buffer=target in self.buffers,
            data_dependent=dd, safe=safe, detail=detail))

    def _write(self, node, name, args) -> None:
        target = args[0]
        if name.startswith(("index_put", "_index_put")):
            idxs = list(args[1])
            self._emit(node, "index_put", target, list(range(len(idxs))),
                       idxs, [1] * len(idxs), True)
        elif name.startswith(("index_copy", "scatter")):
            dim = args[1] if len(args) > 1 else 0
            self._emit(node, name.rstrip("_"), target, [dim], [args[2]],
                       [1], True)
        elif name == "slice_scatter":
            dim = args[2] if len(args) > 2 else node.kwargs.get("dim", 0)
            start = args[3] if len(args) > 3 else node.kwargs.get("start")
            end = args[4] if len(args) > 4 else node.kwargs.get("end")
            s = 0 if start is None else start
            width = (0 if end is None or _num(end) is None
                     or _num(s) is None else int(end) - int(s))
            self._emit(node, name, target, [dim], [s], [max(width, 0)],
                       True)
        elif name == "select_scatter":
            self._emit(node, name, target, [args[2]], [args[3]], [1], True)

    def _read(self, node, name, args) -> None:
        if name == "index" and len(args) > 1:
            idxs = list(args[1])
            self._emit(node, name, args[0], list(range(len(idxs))), idxs,
                       [1] * len(idxs), False)
        elif name == "index_select" and len(args) > 2:
            self._emit(node, name, args[0], [args[1]], [args[2]], [1], False)


def _flat(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _flat(a)
        else:
            yield a


def _numel(a) -> int:
    val = getattr(a, "meta", {}).get("val") if hasattr(a, "meta") else None
    return int(val.numel()) if val is not None else 1


def _source(node) -> str:
    """The user line of a graph node, from its stack trace."""
    trace = node.meta.get("stack_trace") or ""
    lines = [ln.strip() for ln in trace.splitlines()
             if ln.strip().startswith("File ")]
    return lines[-1] if lines else ""


def trace_graph(fn, *args, **kwargs):
    """``fn``'s aten graph under fake tensors (``make_fx``), with the
    layout records (``slot_clamp``) its helpers emitted while tracing."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from .. import fusion
    from .events import RecordsOnly

    rec = RecordsOnly()
    prev = fusion.set_trace_listener(rec)
    try:
        gm = make_fx(lambda *a: fn(*a, **kwargs), tracing_mode="fake",
                     record_stack_traces=True,
                     _allow_non_fake_inputs=True)(*args)
    finally:
        fusion.set_trace_listener(prev)
    return gm, rec.records


def trace_slice_events(gm) -> List[SliceEvent]:
    """Every cache-write-family event of a traced graph, with the interval
    analysis' verdict."""
    return _Walker().walk(gm)


__all__ = ["SliceEvent", "trace_graph", "trace_slice_events"]
