"""Host-side image decode to a fixed uint8 [size, size, 3] canvas, and the
batch loader that feeds the train and eval steps.

Geometry follows the JAX package's `data/loader.py::decode_image`:
train=True takes RandomResizedCrop parameters drawn from a per-sample
generator seeded by `seed` and resamples bicubic; train=False squash-resizes
bilinear with no center crop. JPEGs go through the port's copy of the JAX
package's native libjpeg decoder (`native_decode`) where it builds, as the
JAX loader routes them, so both packages feed the same pixels; every other
file, and any JPEG the native decoder refuses, is decoded through PIL.

`BatchLoader` is the port of the JAX `DeviceLoader`: a thread pool decodes
the samples of a batch, the uint8 NHWC batch is pinned and copied to the
device without blocking, and decode runs `prefetch` batches ahead of the
step that consumes them.
"""

from __future__ import annotations

import math
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch
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
    """Decode one image to a uint8 [size, size, 3] canvas: `.jpg`/`.jpeg`
    through the native decoder where it built, else (and on any native
    failure) through PIL."""
    if path.lower().endswith((".jpg", ".jpeg")):
        out = _decode_native(path, size, train, seed, scale, ratio)
        if out is not None:
            return out
    with Image.open(path) as img:
        img = img.convert("RGB")
        if train:
            w, h = img.size
            i, j, th, tw = _rrc_params(w, h, scale, ratio, _rng(seed))
            img = img.resize((size, size), Image.BICUBIC, box=(j, i, j + tw, i + th))
        else:
            img = img.resize((size, size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


def _decode_native(path, size, train, seed, scale, ratio):
    """The JAX loader's native route: the same crop box (x, y, w, h) from
    `_rrc_params`, decoded bicubic, on the train path; the whole image,
    bilinear, on the eval path. None where the library or the file fails."""
    from . import native_decode as nd

    if nd.get_lib() is None:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    dims = nd.jpeg_dims(data)
    if dims is None:
        return None
    w, h = dims
    if train:
        i, j, th, tw = _rrc_params(w, h, scale, ratio, _rng(seed))
        return nd.decode_crop_resize(data, (j, i, tw, th), size, nd.BICUBIC)
    return nd.decode_crop_resize(data, (0, 0, -1, -1), size, nd.BILINEAR)


def sample_seed(seed: int, idx: int) -> int:
    """The per-sample crop seed of the JAX loader: a collision-free mix of the
    loader seed and the sample index."""
    return int(np.random.SeedSequence([seed, idx + 1]).generate_state(1)[0])


class BatchLoader:
    """Iterate `indices [steps, batch]` as batches on `device`.

    Yields {"image": uint8 [B, H, W, 3], "label": int64 [B]}. Index -1 marks
    eval padding: the pixel slot is zero and the label is -1, which the eval
    step masks. Train crops keep decode_image's scale = ratio = (1, 1), as the
    JAX train.py does."""

    def __init__(self, dataset, indices: np.ndarray, image_size: int, train: bool,
                 device: torch.device, seed: int = 0, num_workers: int = 8,
                 prefetch: int = 2):
        self.dataset = dataset
        self.indices = indices
        self.image_size = image_size
        self.train = train
        self.device = torch.device(device)
        self.seed = seed
        self.num_workers = max(1, min(num_workers, 64))
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return len(self.indices)

    def _decode_one(self, idx: int):
        if idx < 0:
            s = self.image_size
            return np.zeros((s, s, 3), dtype=np.uint8), -1
        path, label = self.dataset.samples[idx]
        img = decode_image(path, self.image_size, self.train, sample_seed(self.seed, idx))
        return img, label

    def _host_batch(self, pool: ThreadPoolExecutor, step_indices: np.ndarray):
        results = list(pool.map(self._decode_one, step_indices.tolist()))
        images = torch.from_numpy(np.stack([r[0] for r in results]))
        labels = torch.tensor([r[1] for r in results], dtype=torch.int64)
        if self.device.type == "cuda":
            images, labels = images.pin_memory(), labels.pin_memory()
        return images, labels

    def __iter__(self) -> Iterator[dict]:
        steps = len(self.indices)
        with ThreadPoolExecutor(self.num_workers) as pool, \
                ThreadPoolExecutor(self.prefetch) as io_pool:
            pending: deque = deque(
                io_pool.submit(self._host_batch, pool, self.indices[k])
                for k in range(min(self.prefetch, steps)))
            for k in range(steps):
                images, labels = pending.popleft().result()
                if k + self.prefetch < steps:
                    pending.append(io_pool.submit(self._host_batch, pool,
                                                  self.indices[k + self.prefetch]))
                yield {"image": images.to(self.device, non_blocking=True),
                       "label": labels.to(self.device, non_blocking=True)}
