"""Host-side segmentation dataset: mmseg-style folder pairs + crop pipeline
(port of imageclassification_tpu/downstream/seg_data.py, copied: numpy and
PIL only, `np.random.Generator` draws, so from the same seed
`train_batches` and `val_batches` give the JAX package's arrays bitwise).

Layout (mmseg ADE20K convention, semantic_segmentation/README.md:24-41):

    root/images/training/*.jpg       root/annotations/training/*.png
    root/images/validation/*.jpg     root/annotations/validation/*.png

Masks are single-channel PNGs of class ids; 255 = ignore. The train pipeline
mirrors the reference recipe's pipeline (upernet_convnext_tiny_...ss.py
train_pipeline: Resize ratio_range (0.5, 2.0) → RandomCrop crop_size →
RandomFlip 0.5 → Pad with ignore-label on the mask). Eval squash-resizes the
whole image to crop_size (documented deviation: mmseg ss eval slides a
crop×crop window at full resolution — equivalent at crop-sized images, and
the val set here is resized anyway).

Kept dependency-free (PIL + numpy): masks must resample NEAREST, images
BILINEAR — PIL does both exactly.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
from PIL import Image

IGNORE = 255
_IMG_EXT = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def scan_pairs(root: str, split: str) -> List[Tuple[str, str]]:
    """[(image, mask)] for a split ('training' | 'validation'), matched by
    stem; raises on unmatched images so silent label drops can't happen."""
    img_dir = os.path.join(root, "images", split)
    ann_dir = os.path.join(root, "annotations", split)
    if not os.path.isdir(img_dir):
        raise FileNotFoundError(
            f"{img_dir} not found — expected mmseg layout "
            "images/{training,validation} + annotations/{training,validation}")
    anns = {}
    for f in os.listdir(ann_dir):
        stem, ext = os.path.splitext(f)
        if ext.lower() == ".png":
            anns[stem] = os.path.join(ann_dir, f)
    pairs = []
    for f in sorted(os.listdir(img_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() not in _IMG_EXT:
            continue
        if stem not in anns:
            raise FileNotFoundError(f"no annotation png for image {f}")
        pairs.append((os.path.join(img_dir, f), anns[stem]))
    if not pairs:
        raise FileNotFoundError(f"no images under {img_dir}")
    return pairs


def num_classes_from_masks(pairs, sample: int = 0) -> int:
    """max class id + 1 over ALL masks (255 ignored) — the segmentation
    analogue of the classifier's folder-count auto-num_classes. A sampled
    scan would silently drop any class absent from the sample, so the full
    pass is the default; `sample>0` bounds it for callers that know their
    label space is dense at the front."""
    hi = 0
    for _, ann in (pairs[:sample] if sample else pairs):
        a = np.asarray(Image.open(ann))
        a = a[a != IGNORE]
        if a.size:
            hi = max(hi, int(a.max()))
    return hi + 1


def _load(img_path: str, ann_path: str):
    img = Image.open(img_path).convert("RGB")
    ann = Image.open(ann_path)
    if ann.mode not in ("L", "P", "I"):
        ann = ann.convert("L")
    return img, ann


def photometric_distortion(x: np.ndarray, rng: np.random.Generator,
                           brightness: int = 32,
                           contrast=(0.5, 1.5), saturation=(0.5, 1.5),
                           hue_delta: int = 18) -> np.ndarray:
    """mmseg PhotoMetricDistortion (mmseg/datasets/pipelines/transforms.py):
    brightness ±32 → [contrast-first|contrast-last mode] → saturation
    U(0.5,1.5) → hue ±18° — each applied with probability 1/2. Hue/saturation
    act in HSV; PIL's HSV hue lives on a 0-255 wheel vs cv2's 0-180, so the
    delta is rescaled."""
    x = x.astype(np.float32)

    def maybe_brightness(x):
        if rng.integers(2):
            x = x + rng.uniform(-brightness, brightness)
        return x

    def maybe_contrast(x):
        if rng.integers(2):
            x = x * rng.uniform(*contrast)
        return x

    def maybe_hsv(x):
        do_sat, do_hue = rng.integers(2), rng.integers(2)
        if not (do_sat or do_hue):
            return x
        hsv = np.asarray(Image.fromarray(
            np.clip(x, 0, 255).astype(np.uint8)).convert("HSV"), np.float32)
        if do_sat:
            hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(*saturation),
                                  0, 255)
        if do_hue:
            d = rng.uniform(-hue_delta, hue_delta) * (256.0 / 180.0)
            hsv[..., 0] = (hsv[..., 0] + d) % 256
        return np.asarray(Image.fromarray(
            hsv.astype(np.uint8), "HSV").convert("RGB"), np.float32)

    x = maybe_brightness(x)
    contrast_last = rng.integers(2) == 0  # mmseg mode: 1 = contrast first
    if not contrast_last:
        x = maybe_contrast(x)
    x = maybe_hsv(x)
    if contrast_last:
        x = maybe_contrast(x)
    return np.clip(x, 0, 255).astype(np.uint8)


def train_sample(img_path: str, ann_path: str, crop: int,
                 rng: np.random.Generator, max_long: int = 2048,
                 cat_max_ratio: float = 0.75):
    """One augmented training sample, following the upstream mmseg ADE
    pipeline the reference recipes train with (the vendored snapshot omits
    the datasets base config — this is mmseg's configs/_base_/datasets/
    ade20k.py): Resize img_scale=(2048, crop) with ratio U(0.5, 2.0) and
    keep_ratio (factor = min(2048r/long, crop·r/short)) → RandomCrop with
    cat_max_ratio 0.75 (10 attempts) → hflip 0.5 → PhotoMetricDistortion →
    pad to crop² (img 0, mask IGNORE). Returns (u8 HWC, int32 HW)."""
    img, ann = _load(img_path, ann_path)
    ratio = rng.uniform(0.5, 2.0)
    long_s, short_s = max(img.size), min(img.size)
    factor = min(max_long * ratio / long_s, crop * ratio / short_s)
    w = max(1, int(img.width * factor + 0.5))
    h = max(1, int(img.height * factor + 0.5))
    img = img.resize((w, h), Image.BILINEAR)
    ann = ann.resize((w, h), Image.NEAREST)
    x = np.asarray(img, np.uint8)
    y = np.asarray(ann).astype(np.int32)

    ch, cw = min(h, crop), min(w, crop)
    for _ in range(10):  # mmseg RandomCrop cat_max_ratio retry
        r0 = rng.integers(0, h - ch + 1)
        c0 = rng.integers(0, w - cw + 1)
        yc = y[r0:r0 + ch, c0:c0 + cw]
        ids, cnt = np.unique(yc, return_counts=True)
        cnt = cnt[ids != IGNORE]
        if len(cnt) > 1 and cnt.max() / cnt.sum() < cat_max_ratio:
            break
    x = x[r0:r0 + ch, c0:c0 + cw]
    y = y[r0:r0 + ch, c0:c0 + cw]

    if rng.random() < 0.5:
        x, y = x[:, ::-1], y[:, ::-1]
    x = photometric_distortion(np.ascontiguousarray(x), rng)
    if ch < crop or cw < crop:
        x = np.pad(x, ((0, crop - ch), (0, crop - cw), (0, 0)))
        y = np.pad(y, ((0, crop - ch), (0, crop - cw)),
                   constant_values=IGNORE)
    return np.ascontiguousarray(x), np.ascontiguousarray(y)


def val_sample(img_path: str, ann_path: str, size: int):
    """Squash-resize image+mask to size² (see module docstring)."""
    img, ann = _load(img_path, ann_path)
    img = img.resize((size, size), Image.BILINEAR)
    ann = ann.resize((size, size), Image.NEAREST)
    return (np.asarray(img, np.uint8),
            np.asarray(ann).astype(np.int32))


def train_batches(pairs, crop: int, batch: int, iters: int, seed: int = 0,
                  start: int = 0, rank: int = 0, world: int = 1):
    """Yields (iteration, images, labels) for iterations [start, iters).
    Each iteration derives its own generator from (seed, iteration), so a
    resumed run sees exactly the batches the original would have — no RNG
    stream to fast-forward (the classification loader's counter-based
    randomness rule).

    `batch` is GLOBAL: every process draws the same global index vector from
    the shared (seed, it) key and takes its disjoint rank slice (rank and
    world as in the JAX package; the port's seg_train runs one process, so
    rank 0 of world 1) — per-sample augmentation keys fold in the global
    sample position, keeping augmentations identical no matter how many
    hosts run."""
    n = len(pairs)
    local = batch // world
    for it in range(start, iters):
        rng = np.random.default_rng([seed, it])
        idx = rng.integers(0, n, batch)[rank * local:(rank + 1) * local]
        out = [train_sample(*pairs[i], crop,
                            np.random.default_rng([seed, it, rank * local + k]))
               for k, i in enumerate(idx)]
        xs, ys = zip(*out)
        yield it, np.stack(xs), np.stack(ys)


def val_batches(pairs, size: int, batch: int):
    for i in range(0, len(pairs), batch):
        chunk = pairs[i:i + batch]
        xs, ys = zip(*(val_sample(p, a, size) for p, a in chunk))
        yield np.stack(xs), np.stack(ys)
