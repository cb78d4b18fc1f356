"""Host-side image decode to a fixed uint8 [size, size, 3] canvas.

Geometry follows the JAX package's `data/loader.py::decode_image`:
train=True takes RandomResizedCrop parameters drawn from a per-sample
generator seeded by `seed` and resamples bicubic; train=False squash-resizes
bilinear with no center crop. Everything is decoded through PIL; the native
libjpeg decoder of the JAX package is not part of the port yet.
"""

from __future__ import annotations

import math

import numpy as np
from PIL import Image


def _rng(seed: int) -> np.random.Generator:
    """Per-sample generator: crop geometry is a pure function of (seed, sample)."""
    return np.random.default_rng(seed)


def _rrc_params(w, h, scale, ratio, rng):
    """timm/torchvision RandomResizedCrop parameter sampling (10 tries + fallback)."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = rng.uniform(scale[0], scale[1]) * area
        ar = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        tw = int(round(math.sqrt(target_area * ar)))
        th = int(round(math.sqrt(target_area / ar)))
        if 0 < tw <= w and 0 < th <= h:
            i = int(rng.integers(0, h - th + 1))
            j = int(rng.integers(0, w - tw + 1))
            return i, j, th, tw
    in_ratio = w / h
    if in_ratio < min(ratio):
        tw = w
        th = int(round(tw / min(ratio)))
    elif in_ratio > max(ratio):
        th = h
        tw = int(round(th * max(ratio)))
    else:
        tw, th = w, h
    return (h - th) // 2, (w - tw) // 2, th, tw


def decode_image(
    path: str,
    size: int,
    train: bool,
    seed: int = 0,
    scale=(1.0, 1.0),
    ratio=(1.0, 1.0),
) -> np.ndarray:
    """Decode one image to a uint8 [size, size, 3] canvas."""
    with Image.open(path) as img:
        img = img.convert("RGB")
        if train:
            w, h = img.size
            i, j, th, tw = _rrc_params(w, h, scale, ratio, _rng(seed))
            img = img.resize((size, size), Image.BICUBIC, box=(j, i, j + tw, i + th))
        else:
            img = img.resize((size, size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)
