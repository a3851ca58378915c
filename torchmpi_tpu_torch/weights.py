"""Load a JAX ``TransformerLM`` parameter tree, or its ZeRO shards and
optimizer state, into the port's module; and a JAX CNN's variables
(LeNet, AlexNet, ResNet) into the port's CNN (:func:`from_flax_cnn`).

The flax tree of ``torchmpi_tpu.models.TransformerLM`` holds
``Embed_0/embedding`` [V, E], ``pos_embed/embedding`` (learned positions),
per block ``Block_i/{LayerNorm_0, LayerNorm_1, SPAttention_0/{q, kv | qkv,
out}, Dense_0, Dense_1}``, the final ``LayerNorm_0`` and ``head`` [E, V].
Dense kernels are [in, out]; the attention projections are DenseGeneral
kernels [E, H, D] (q), [E, 2, Hkv, D] (kv, with k at index 0 of axis 1) and
[E, 3, H, D] (qkv).  PyTorch's ``nn.Linear`` keeps [out, in], so every kernel
is flattened to two axes and transposed; biases are flattened.

ZeRO state (:func:`from_flax_zero_shards`, :func:`from_optax_zero_state`):
the JAX package's ZeRO flattens the flax tree in its leaf order (dict keys
sorted at every level) into one flat vector per dtype group, each padded to
a multiple of the n ranks, and rank i holds every group's extent i
(``fusion.local_shard``).  The converters undo that layout on numpy
arrays, map each leaf as above, and lay the port's parameters
(``model.named_parameters()`` order, [out, in] kernels) out again as the
port's ZeRO shards [n, shard] (``fusion.local_shards``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from . import fusion
from .optim import AdamState, TraceState


def _linear(node: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    kernel = np.asarray(node["kernel"])
    out[f"{prefix}.weight"] = kernel.reshape(kernel.shape[0], -1).T
    out[f"{prefix}.bias"] = np.asarray(node["bias"]).reshape(-1)


def _norm(node: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = np.asarray(node["scale"])
    out[f"{prefix}.bias"] = np.asarray(node["bias"])


def from_flax_params(params: Mapping,
                     model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model`` (a port ``TransformerLM``) holding the
    values of the flax tree ``params`` (numpy or JAX arrays; a top-level
    ``{"params": ...}`` wrapper is accepted).  Tensors are float32 on the
    model's device.  Raises if a name or shape does not match the model."""
    if set(params) == {"params"}:
        params = params["params"]
    flat: Dict[str, np.ndarray] = {
        "embed.weight": np.asarray(params["Embed_0"]["embedding"]),
        "head": np.asarray(params["head"]),
    }
    if "pos_embed" in params:
        flat["pos_embed.weight"] = np.asarray(params["pos_embed"]["embedding"])
    _norm(params["LayerNorm_0"], "ln_f", flat)
    i = 0
    while f"Block_{i}" in params:
        blk, pre = params[f"Block_{i}"], f"blocks.{i}"
        _norm(blk["LayerNorm_0"], f"{pre}.ln1", flat)
        _norm(blk["LayerNorm_1"], f"{pre}.ln2", flat)
        attn = blk["SPAttention_0"]
        for name in ("q", "kv", "qkv", "out"):
            if name in attn:
                _linear(attn[name], f"{pre}.attn.{name}", flat)
        _linear(blk["Dense_0"], f"{pre}.mlp_in", flat)
        _linear(blk["Dense_1"], f"{pre}.mlp_out", flat)
        i += 1

    want = model.state_dict()
    if set(flat) != set(want):
        raise ValueError(
            "flax tree does not match the model: missing "
            f"{sorted(set(want) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(want))}")
    out = {}
    for name, arr in flat.items():
        ref = want[name]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: flax shape {tuple(arr.shape)} vs "
                             f"model shape {tuple(ref.shape)}")
        out[name] = torch.tensor(arr, dtype=torch.float32,
                                 device=ref.device)
    return out


def _flax_leaves(tree: Mapping, path: Tuple[str, ...] = ()
                 ) -> List[Tuple[Tuple[str, ...], np.ndarray]]:
    """(path, array) of every leaf, in the JAX leaf order of a nested dict
    (keys sorted at every level)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out += _flax_leaves(v, path + (k,))
        else:
            out.append((path + (k,), np.asarray(v)))
    return out


def _unflatten_flax(flat: np.ndarray, params: Mapping, n_shards: int):
    """The flax tree (nested dicts of numpy arrays) held by the JAX ZeRO
    shards ``flat`` (rank-order concatenation, [n * shard] or [n, shard])
    of ``params``' layout: dtype groups in first-seen leaf order, each padded
    to a multiple of ``n_shards`` (JAX ``FusedSpec``,
    ``fusion.unflatten_shards``)."""
    leaves = _flax_leaves(params)
    groups: Dict[np.dtype, List[int]] = {}
    for i, (_, a) in enumerate(leaves):
        groups.setdefault(a.dtype, []).append(i)
    pads = {dt: max(n_shards, -(-sum(leaves[i][1].size for i in idx)
                                // n_shards) * n_shards)
            for dt, idx in groups.items()}
    shard = sum(pads.values()) // n_shards
    rows = np.asarray(flat).reshape(n_shards, shard)
    tree: Dict = {}
    col = 0
    for dt, idx in groups.items():
        g = pads[dt] // n_shards
        gf = rows[:, col:col + g].reshape(-1)
        col += g
        off = 0
        for i in idx:
            path, a = leaves[i]
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = gf[off:off + a.size].reshape(a.shape).astype(
                a.dtype)
            off += a.size
    return tree


def from_flax_zero_shards(flat, params: Mapping, model: torch.nn.Module,
                          n_shards: int) -> torch.Tensor:
    """The port's ZeRO shards [n_shards, shard] (float32, on the model's
    device) of the values in the JAX ZeRO shards ``flat`` of the flax tree
    ``params`` (as ``zero.shard_params`` returns them, or a parameter-shaped
    optimizer-state leaf such as Adam's ``mu``).  The shards follow the
    port's layout: ``model.named_parameters()`` order, [out, in]
    kernels."""
    if set(params) == {"params"}:
        params = params["params"]
    state = from_flax_params(_unflatten_flax(flat, params, n_shards), model)
    tensors = [state[name] for name, _ in model.named_parameters()]
    return fusion.local_shards(tensors,
                               fusion.FusedSpec(tensors, n_shards,
                                                max_bytes=0))


def from_optax_zero_state(state, params: Mapping, model: torch.nn.Module,
                          n_shards: int):
    """The port's ``optim`` state over [n_shards, shard] shards from the
    optax state of the JAX package's ZeRO (``zero.init`` / ``zero.update``
    over the flat shards of ``params``): Adam's ``(count, mu, nu)`` becomes
    an :class:`AdamState`, a momentum ``trace`` a :class:`TraceState`.
    ``state`` is the optax state with numpy or JAX leaves (``optax.adam``
    and ``optax.sgd`` chain it with an empty state, which is skipped)."""
    parts = state if isinstance(state, (tuple, list)) else (state,)
    for part in parts:
        if hasattr(part, "mu") and hasattr(part, "nu"):
            return AdamState(
                int(np.asarray(part.count)),
                from_flax_zero_shards(part.mu, params, model, n_shards),
                from_flax_zero_shards(part.nu, params, model, n_shards))
        if hasattr(part, "trace"):
            return TraceState(
                from_flax_zero_shards(part.trace, params, model, n_shards))
    raise ValueError(f"no Adam or momentum state in {type(state).__name__}")


# flax module name -> the port's submodule name (models/resnet.py, lenet.py,
# alexnet.py): Conv_k -> conv{k}, BatchNorm_k -> bn{k}, Dense_k -> dense{k},
# BasicBlock_i / BottleneckBlock_i -> blocks.{i}; others keep their names.
_CNN_MODULES = ((re.compile(r"Conv_(\d+)$"), "conv{}"),
                (re.compile(r"BatchNorm_(\d+)$"), "bn{}"),
                (re.compile(r"Dense_(\d+)$"), "dense{}"),
                (re.compile(r"(?:Basic|Bottleneck)Block_(\d+)$"),
                 "blocks.{}"))
_CNN_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def _cnn_module(name: str) -> str:
    for pat, fmt in _CNN_MODULES:
        m = pat.match(name)
        if m:
            return fmt.format(m.group(1))
    return name


def _cnn_leaf(leaf: str, a: np.ndarray) -> np.ndarray:
    """A flax CNN leaf in the port's layout: conv kernels HWIO -> OIHW,
    Dense kernels [in, out] -> [out, in] (the port flattens in flax's HWC
    order, so no row permutation), everything else as it is."""
    if leaf == "kernel":
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    return a


def from_flax_cnn(variables: Mapping,
                  model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model`` (a port ``LeNet``, ``AlexNet`` or
    ``ResNet``) holding a JAX CNN's ``{"params", "batch_stats"}`` (numpy or
    JAX arrays; ``batch_stats`` only for models with BatchNorm): conv
    kernels HWIO -> OIHW, Dense kernels transposed, BN ``scale`` / ``bias``
    -> ``weight`` / ``bias`` and ``mean`` / ``var`` -> the running buffers.
    Tensors are float32 on the model's device.  A residual block whose
    flax tree has no ``conv_proj`` / ``norm_proj`` (flax's init left it
    out: the block kept its input's shape there) loses the port's, so the
    model's parameters are the tree's.  Raises if a name or shape does not
    match the model."""
    flat: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats"):
        for path, a in _flax_leaves(variables.get(coll, {})):
            name = ".".join([_cnn_module(p) for p in path[:-1]]
                            + [_CNN_LEAVES.get(path[-1], path[-1])])
            flat[name] = _cnn_leaf(path[-1], a)
    for mname, mod in list(model.named_modules()):
        pre = f"{mname}." if mname else ""
        if hasattr(mod, "conv_proj") and not any(
                k.startswith(f"{pre}conv_proj.") for k in flat):
            del mod.conv_proj, mod.norm_proj
    want = model.state_dict()
    if set(flat) != set(want):
        raise ValueError(
            "flax variables do not match the model: missing "
            f"{sorted(set(want) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(want))}")
    out = {}
    for name, ref in want.items():
        arr = flat[name]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: flax shape {tuple(arr.shape)} vs "
                             f"model shape {tuple(ref.shape)}")
        out[name] = torch.tensor(np.ascontiguousarray(arr),
                                 dtype=torch.float32, device=ref.device)
    return out
