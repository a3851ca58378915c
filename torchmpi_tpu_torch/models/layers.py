"""Layers with flax's semantics, as the port's models need them.

The JAX package builds its models from ``flax.linen``; these are the
PyTorch modules that compute the same functions on NCHW tensors:

- ``Conv2d`` and ``max_pool(padding="SAME")`` take flax's ``"SAME"``
  padding for any stride, computed from the input size: ``total = max((ceil(in / s) - 1)
  * s + k - in, 0)``, ``lo = total // 2`` before and ``hi = total - lo``
  after (``F.pad``, then the unpadded conv or pool; a pool pads with
  -inf).  PyTorch's symmetric ``padding=`` gives the same output size and
  other numbers wherever ``total`` is odd (ResNet-50's 7 x 7 / 2 stem needs
  (2, 3) at 224, a 3 x 3 / 2 conv or pool (0, 1) at even sizes).  A
  ``"VALID"`` pool (flax's default) is no padding.
- ``Dense`` and ``Conv2d`` hold float32 parameters and compute in ``dtype``
  (flax's ``promote_dtype``: input, kernel and bias cast to ``dtype``).
- ``BatchNorm`` is flax's ``nn.BatchNorm`` (flax 0.12
  ``normalization._compute_stats``): momentum 0.9 as the decay of the
  running statistics, epsilon 1e-5, the batch mean and the biased variance
  E[x^2] - E[x]^2 clipped at 0, reduced in float32 even on bf16
  activations, for the running update; the normalization is
  ``F.batch_norm``'s (cuDNN on the card), in training mode with the batch
  mean and the biased batch variance, in eval mode with the running ones.
- Initializers are flax's: lecun-normal kernels (a normal truncated at two
  standard deviations, scaled to variance 1 / fan_in), zero biases, BN
  scale one (or zero where the model asks), running mean 0 and variance 1.

``BatchNorm`` never writes its running statistics in ``forward``: a
training-mode call leaves the new ones in ``new_stats`` (detached), where
:func:`new_batch_stats` reads them and :func:`commit_batch_stats` writes
them.  So a forward that runs again (``torch.utils.checkpoint`` recomputes
it in the backward) or once per rank on one module (the rank-major recipe)
starts from the same statistics every time, as flax's functional update
does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal: a unit normal truncated at +-2 has this std.
_TRUNC_STD = 0.87962566103423978


def check_device(device) -> torch.device:
    """The device a module builds its parameters on; the card unless the
    caller asks for the CPU, and never the CPU in the card's place."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r}: no CUDA device is visible; pass "
            "device='cpu' to build the module on the CPU")
    return dev


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """flax ``lecun_normal()``: ``variance_scaling(1, "fan_in",
    "truncated_normal")``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax / XLA ``"SAME"`` padding (lo, hi) of one spatial dim."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: Sequence[int], s: Sequence[int],
              value: float = 0.0) -> torch.Tensor:
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], k[0], s[0]),
                          same_pads(x.shape[3], k[1], s[1]))
    if hl == hh == wl == wh == 0:
        return x
    return F.pad(x, (wl, wh, hl, hh), value=value)


def max_pool(x: torch.Tensor, window: Tuple[int, int],
             strides: Tuple[int, int], padding: str = "VALID"
             ) -> torch.Tensor:
    """flax ``nn.max_pool`` over NCHW ``x``; ``"SAME"`` pads with -inf."""
    if padding == "SAME":
        x = _pad_same(x, window, strides, value=-math.inf)
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    return F.max_pool2d(x, window, strides)


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H * W * C] in flax's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def init_flax(model: nn.Module,
              generator: Optional[torch.Generator] = None) -> None:
    """Draw every layer's parameters as flax does (lecun-normal kernels,
    zero biases, BN scale one or zero), in module order, from
    ``generator`` or a generator seeded with 0 on the model's device."""
    if generator is None:
        dev = next(model.parameters()).device
        generator = torch.Generator(dev).manual_seed(0)
    for m in model.modules():
        if m is not model and hasattr(m, "init_flax"):
            m.init_flax(generator)


class Dense(nn.Linear):
    """``nn.Linear`` with flax's dtype promotion: float32 parameters, the
    product (input, weight and bias) computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__(in_features, out_features,
                         device=check_device(device))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))

    @torch.no_grad()
    def init_flax(self, generator: Optional[torch.Generator] = None):
        """lecun-normal weight, zero bias (flax ``nn.Dense``)."""
        lecun_normal_(self.weight, self.in_features, generator)
        self.bias.zero_()


class Conv2d(nn.Module):
    """flax ``nn.Conv(padding="SAME")`` over NCHW (every conv of the
    ported models): a float32 ``weight`` [out, in, kh, kw] (OIHW), an
    optional bias, computed in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), *, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = check_device(device)
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if use_bias else None)

    @torch.no_grad()
    def init_flax(self, generator: Optional[torch.Generator] = None):
        """lecun-normal weight (fan-in in x kh x kw), zero bias."""
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pad_same(x.to(self.dtype), self.kernel, self.strides)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, self.strides)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of NCHW inputs: float32 ``weight`` (flax's scale), ``bias`` and
    running buffers ``running_mean`` / ``running_var``, the output in
    ``dtype``.  ``use_running_average`` switches eval (running statistics)
    and train (batch statistics; the new running ones left in
    ``new_stats``, the buffers untouched)."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, zero_scale: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = check_device(device)
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))
        self.new_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.init_flax()

    @torch.no_grad()
    def init_flax(self, generator: Optional[torch.Generator] = None):
        """Scale one (zero for a block's last norm), bias zero."""
        self.weight.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor,
                use_running_average: bool = False) -> torch.Tensor:
        if use_running_average:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.dtype)
        with torch.no_grad():
            xf = x.float()
            dims = (0, 2, 3)
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
            del xf
            m = self.momentum
            self.new_stats = (m * self.running_mean + (1 - m) * mean,
                              m * self.running_var + (1 - m) * var)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        return y.to(self.dtype)


def batch_norms(model: nn.Module) -> List[BatchNorm]:
    """The model's BatchNorm layers in registration order."""
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


def batch_stats_names(model: nn.Module) -> List[str]:
    """Buffer names of the model's running statistics, in the order of
    :func:`batch_stats` (each layer's mean, then its variance)."""
    names = {id(m): n for n, m in model.named_modules()}
    return [f"{names[id(m)]}.{b}".lstrip(".") for m in batch_norms(model)
            for b in ("running_mean", "running_var")]


def batch_stats(model: nn.Module) -> List[torch.Tensor]:
    """The model's running statistics (flax's ``batch_stats``
    collection): each BatchNorm's mean and variance, in layer order."""
    return [t for m in batch_norms(model)
            for t in (m.running_mean, m.running_var)]


def new_batch_stats(model: nn.Module) -> List[torch.Tensor]:
    """The running statistics the last training-mode forward computed
    (flax's updated ``batch_stats``), in :func:`batch_stats`' order."""
    out = []
    for m in batch_norms(model):
        if m.new_stats is None:
            raise RuntimeError("no training-mode forward has run: the new "
                               "batch statistics are not set")
        out += list(m.new_stats)
    return out


@torch.no_grad()
def commit_batch_stats(model: nn.Module,
                       stats: Optional[Sequence[torch.Tensor]] = None
                       ) -> None:
    """Write ``stats`` (default: :func:`new_batch_stats`) into the running
    buffers."""
    stats = new_batch_stats(model) if stats is None else stats
    for buf, new in zip(batch_stats(model), stats, strict=True):
        buf.copy_(new)
