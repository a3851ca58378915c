"""AlexNet, the reference's async Downpour-SGD workload.

The counterpart of ``torchmpi_tpu/models/alexnet.py`` (``AlexNet`` :15):
five "SAME" convs (11 x 11 / 4, 5 x 5, 3 x 3 x 3), three 3 x 3 / 2 "VALID"
pools, two Dense(4096) with dropout and the classifier in float32, on
NCHW images [B, 3, 224, 224].  The flatten is in HWC order, as the JAX
package's over NHWC (:37).  Dropout draws its masks from the model's own
``torch.Generator`` (``dropout_seed``); they cannot match JAX's, so
parity runs use ``train=False`` or ``dropout=0``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv2d, Dense, check_device, flatten_hwc, init_flax,
                     max_pool)


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.5,
                 *, image_size: int = 224, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        device = check_device(device)
        self.dtype, self.dropout = dtype, dropout
        kw = dict(dtype=dtype, device=device)
        self.conv0 = Conv2d(3, 96, (11, 11), (4, 4), **kw)
        self.conv1 = Conv2d(96, 256, (5, 5), **kw)
        self.conv2 = Conv2d(256, 384, (3, 3), **kw)
        self.conv3 = Conv2d(384, 384, (3, 3), **kw)
        self.conv4 = Conv2d(384, 256, (3, 3), **kw)
        side = -(-image_size // 4)
        for _ in range(3):
            side = (side - 3) // 2 + 1
        self.dense0 = Dense(side * side * 256, 4096, **kw)
        self.dense1 = Dense(4096, 4096, **kw)
        self.dense2 = Dense(4096, num_classes, device=device)
        self.dropout_generator = torch.Generator(device).manual_seed(
            dropout_seed)
        init_flax(self, generator)

    def _dropout(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability 1 - rate, scaled by
        1 / keep."""
        if not train or self.dropout == 0.0:
            return x
        keep = 1.0 - self.dropout
        mask = torch.rand(x.shape, generator=self.dropout_generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        x = max_pool(F.relu(self.conv0(x)), (3, 3), (2, 2))
        x = max_pool(F.relu(self.conv1(x)), (3, 3), (2, 2))
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        x = max_pool(F.relu(self.conv4(x)), (3, 3), (2, 2))
        x = self._dropout(F.relu(self.dense0(flatten_hwc(x))), train)
        x = self._dropout(F.relu(self.dense1(x)), train)
        return self.dense2(x)
