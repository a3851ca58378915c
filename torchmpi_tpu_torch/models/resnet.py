"""ResNet family: CIFAR ResNet-20 and ImageNet ResNet-50.

The counterpart of ``torchmpi_tpu/models/resnet.py``: ``BasicBlock`` (:23),
``BottleneckBlock`` (:47), ``ResNet`` (:74, the "imagenet" stem 7 x 7 / 2
conv + 3 x 3 / 2 "SAME" max-pool, or the "cifar" 3 x 3 conv) and the
``ResNet18/20/50/101/152`` presets (:116-148), over NCHW images.  As in
the JAX model:

- convs have no bias and "SAME" padding; each BatchNorm has momentum 0.9
  and epsilon 1e-5, and the last one of each block starts with scale 0;
- the projection ``conv_proj`` / ``norm_proj`` applies where the block
  changes the shape, decided at run time as flax decides it
  (``residual.shape != y.shape``).  A block builds it wherever it may be
  needed (the channels change or the stride is not 1); on a 1 x 1 map a
  stride-2 block with equal channels keeps its shape, flax's init leaves
  the projection out, and ``weights.from_flax_cnn`` drops the port's;
- the global mean is over H, W (:111) and the classifier runs in float32
  (:112); under ``dtype=torch.bfloat16`` parameters and statistics stay
  float32 and the convs and norms compute in bf16.

``forward(x, train)``: ``train`` uses batch statistics and leaves the new
running ones in each BatchNorm (``layers.new_batch_stats``), ``train=False``
the running statistics.  Submodule names follow flax's (``Conv_k`` ->
``conv{k}``, ``BatchNorm_k`` -> ``bn{k}``, ``BasicBlock_i`` /
``BottleneckBlock_i`` -> ``blocks.{i}``, ``Dense_0`` -> ``dense0``), which
``weights.from_flax_cnn`` relies on.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BatchNorm, Conv2d, Dense, check_device, init_flax,
                     max_pool)


def _project(block: nn.Module, x: torch.Tensor, y: torch.Tensor,
             ra: bool) -> torch.Tensor:
    """The residual of ``block``: ``x`` projected where its shape is not
    ``y``'s (flax's ``residual.shape != y.shape``, :40, :67), else ``x``."""
    if x.shape == y.shape:
        return x
    if not hasattr(block, "conv_proj"):
        raise ValueError(f"residual {tuple(x.shape)} vs {tuple(y.shape)} "
                         f"needs the projection this block was loaded "
                         f"without")
    return block.norm_proj(block.conv_proj(x), ra)


class BasicBlock(nn.Module):
    """3 x 3 + 3 x 3 residual block (ResNet-18/20/34 style)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int,
                 strides: Tuple[int, int] = (1, 1), *, conv, norm,
                 act: Callable = F.relu):
        super().__init__()
        self.act = act
        self.conv0 = conv(in_ch, filters, (3, 3), strides)
        self.bn0 = norm(filters)
        self.conv1 = conv(filters, filters, (3, 3))
        self.bn1 = norm(filters, zero_scale=True)
        if in_ch != filters or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_ch, filters, (1, 1), strides)
            self.norm_proj = norm(filters)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        ra = not train
        y = self.act(self.bn0(self.conv0(x), ra))
        y = self.bn1(self.conv1(y), ra)
        return self.act(_project(self, x, y, ra) + y)


class BottleneckBlock(nn.Module):
    """1 x 1 -> 3 x 3 -> 1 x 1 bottleneck (ResNet-50/101/152 style)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int,
                 strides: Tuple[int, int] = (1, 1), *, conv, norm,
                 act: Callable = F.relu):
        super().__init__()
        self.act = act
        self.conv0 = conv(in_ch, filters, (1, 1))
        self.bn0 = norm(filters)
        self.conv1 = conv(filters, filters, (3, 3), strides)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters * 4, (1, 1))
        self.bn2 = norm(filters * 4, zero_scale=True)
        if in_ch != filters * 4 or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_ch, filters * 4, (1, 1), strides)
            self.norm_proj = norm(filters * 4)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        ra = not train
        y = self.act(self.bn0(self.conv0(x), ra))
        y = self.act(self.bn1(self.conv1(y), ra))
        y = self.bn2(self.conv2(y), ra)
        return self.act(_project(self, x, y, ra) + y)


class ResNet(nn.Module):
    """Generic ResNet over NCHW inputs; ``stem`` "imagenet" (7 x 7 / 2
    conv + 3 x 3 / 2 max-pool) or "cifar" (3 x 3 conv).  Parameters are
    float32 on ``device`` (default the card), drawn as flax draws them from
    ``generator`` (default: seeded with 0)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int, num_filters: int = 64,
                 stem: str = "imagenet", dtype: torch.dtype = torch.float32,
                 act: Callable = F.relu, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem {stem!r}")
        device = check_device(device)
        self.stem, self.dtype, self.act = stem, dtype, act
        conv = partial(Conv2d, use_bias=False, dtype=dtype, device=device)
        norm = partial(BatchNorm, momentum=0.9, eps=1e-5, dtype=dtype,
                       device=device)
        k = (7, 7) if stem == "imagenet" else (3, 3)
        s = (2, 2) if stem == "imagenet" else (1, 1)
        self.conv_init = conv(3, num_filters, k, s)
        self.bn_init = norm(num_filters)
        blocks, ch = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2 ** i
                blocks.append(block_cls(ch, filters, strides, conv=conv,
                                        norm=norm, act=act))
                ch = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.dense0 = Dense(ch, num_classes, device=device)
        init_flax(self, generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        x = self.act(self.bn_init(self.conv_init(x), not train))
        if self.stem == "imagenet":
            x = max_pool(x, (3, 3), (2, 2), padding="SAME")
        for blk in self.blocks:
            x = blk(x, train)
        return self.dense0(x.mean((2, 3)))


def ResNet20(num_classes: int = 10, dtype=torch.float32, **kw) -> ResNet:
    """CIFAR ResNet-20: 3 stages x 3 basic blocks, 16 base filters."""
    return ResNet([3, 3, 3], BasicBlock, num_classes, num_filters=16,
                  stem="cifar", dtype=dtype, **kw)


def ResNet18(num_classes: int = 1000, dtype=torch.float32, **kw) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes, dtype=dtype, **kw)


def ResNet50(num_classes: int = 1000, dtype=torch.float32, **kw) -> ResNet:
    """ImageNet ResNet-50: [3, 4, 6, 3] bottlenecks, the headline
    workload."""
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes, dtype=dtype,
                  **kw)


def ResNet101(num_classes: int = 1000, dtype=torch.float32, **kw) -> ResNet:
    """ImageNet ResNet-101: [3, 4, 23, 3] bottlenecks."""
    return ResNet([3, 4, 23, 3], BottleneckBlock, num_classes, dtype=dtype,
                  **kw)


def ResNet152(num_classes: int = 1000, dtype=torch.float32, **kw) -> ResNet:
    """ImageNet ResNet-152: [3, 8, 36, 3] bottlenecks."""
    return ResNet([3, 8, 36, 3], BottleneckBlock, num_classes, dtype=dtype,
                  **kw)
