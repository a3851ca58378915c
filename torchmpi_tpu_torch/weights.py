"""Load a JAX ``TransformerLM`` parameter tree into the port's module.

The flax tree of ``torchmpi_tpu.models.TransformerLM`` holds
``Embed_0/embedding`` [V, E], ``pos_embed/embedding`` (learned positions),
per block ``Block_i/{LayerNorm_0, LayerNorm_1, SPAttention_0/{q, kv | qkv,
out}, Dense_0, Dense_1}``, the final ``LayerNorm_0`` and ``head`` [E, V].
Dense kernels are [in, out]; the attention projections are DenseGeneral
kernels [E, H, D] (q), [E, 2, Hkv, D] (kv, with k at index 0 of axis 1) and
[E, 3, H, D] (qkv).  PyTorch's ``nn.Linear`` keeps [out, in], so every kernel
is flattened to two axes and transposed; biases are flattened.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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
