"""Synthetic dataset generators: the port's own copy of
``torchmpi_tpu/utils/data.py`` (numpy only), giving the same arrays bit
for bit from the same seed.

The reference's examples loaded MNIST/CIFAR/ImageNet from disk; the
examples and convergence tests use synthetic-but-learnable
class-conditional data instead: each class is a fixed random template plus
noise.  A model that learns reaches high accuracy; a broken gradient path
does not.  Images are NHWC float32, as the JAX package makes them; the
port's models take NCHW, so callers permute (``x.permute(0, 3, 1, 2)``,
which is NCHW in the channels-last memory format, no copy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_image_classification(
    n: int,
    *,
    image_shape: Tuple[int, int, int] = (28, 28, 1),
    num_classes: int = 10,
    noise: float = 0.3,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (images [n, *image_shape] float32 in ~[0,1], labels [n] int32)."""
    rng = np.random.RandomState(seed)
    templates = rng.rand(num_classes, *image_shape).astype(np.float32)
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    images = templates[labels] + noise * rng.randn(n, *image_shape).astype(
        np.float32)
    return images.astype(np.float32), labels


def synthetic_mnist(n: int, seed: int = 0):
    return synthetic_image_classification(
        n, image_shape=(28, 28, 1), num_classes=10, seed=seed)


def synthetic_cifar(n: int, seed: int = 0):
    return synthetic_image_classification(
        n, image_shape=(32, 32, 3), num_classes=10, seed=seed)


def synthetic_imagenet(n: int, image_size: int = 224, num_classes: int = 1000,
                       seed: int = 0):
    return synthetic_image_classification(
        n, image_shape=(image_size, image_size, 3), num_classes=num_classes,
        seed=seed)


def batches(images: np.ndarray, labels: np.ndarray, batch_size: int,
            *, steps: int, seed: int = 0):
    """Infinite-ish shuffled batch iterator yielding ``steps`` batches."""
    rng = np.random.RandomState(seed)
    n = images.shape[0]
    for _ in range(steps):
        idx = rng.randint(0, n, size=batch_size)
        yield images[idx], labels[idx]
