"""LeNet-5-style convnet for MNIST.

The counterpart of ``torchmpi_tpu/models/lenet.py`` (``LeNet`` :15): conv(32)
-> pool -> conv(64) -> pool -> dense(256) -> dense(classes), 5 x 5 "SAME"
convs and 2 x 2 / 2 "VALID" pools.  The port takes NCHW images
[B, 1, 28, 28]; the flatten before the first Dense is in HWC order, as
the JAX package's over NHWC (:30), so a flax kernel [in, out] loads as its
transpose with no row permutation (``weights.from_flax_cnn``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv2d, Dense, check_device, flatten_hwc, init_flax,
                     max_pool)


class LeNet(nn.Module):
    """conv(32) -> pool -> conv(64) -> pool -> dense(256) -> dense(classes);
    the last Dense in float32, the rest in ``dtype``."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = check_device(device)
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.conv0 = Conv2d(1, 32, (5, 5), **kw)
        self.conv1 = Conv2d(32, 64, (5, 5), **kw)
        self.dense0 = Dense(7 * 7 * 64, 256, **kw)   # 28 / 2 / 2 = 7
        self.dense1 = Dense(256, num_classes, device=device)
        init_flax(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = max_pool(F.relu(self.conv0(x)), (2, 2), (2, 2))
        x = max_pool(F.relu(self.conv1(x)), (2, 2), (2, 2))
        x = F.relu(self.dense0(flatten_hwc(x)))
        return self.dense1(x)
