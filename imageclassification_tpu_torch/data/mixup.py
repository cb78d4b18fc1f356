"""Mixup/cutmix and soft targets on device tensors (port of the JAX package's
`data/mixup.py`, timm `Mixup` semantics):

* lam ~ Beta(alpha, alpha), applied with probability `prob`; with both mixup
  and cutmix on, cutmix is chosen with probability `switch_prob`;
* 'batch' mode: one lam for the batch, the partner of sample i is sample
  B-1-i; 'elem': one lam per sample; 'pair': one lam, choice and box per pair
  (i, B-1-i);
* cutmix: a box of side ratio sqrt(1-lam) around a uniform center, lam
  corrected to the box's area; `cutmix_minmax` draws each side's ratio in
  [min, max] instead;
* targets: one-hot with label smoothing, mixed with the same lam.

`mixup_cutmix` takes its draws as tensors and `sample_mixup` makes them; the
Beta draw goes through numpy (torch's Beta sampler takes no generator),
seeded from the explicit CPU `torch.Generator` it is given.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float = 0.0):
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels, num_classes).float() * (on - off) + off


def _rand_bbox(H: int, W: int, lam, cy, cx):
    """Box of side ratio sqrt(1-lam) centred at (cy, cx), clipped; returns
    (yl, yh, xl, xh) and lam corrected to the box's area."""
    ratio = torch.sqrt(1.0 - lam)
    cut_h = (H * ratio).to(torch.int32)
    cut_w = (W * ratio).to(torch.int32)
    yl = (cy - cut_h // 2).clamp(0, H)
    yh = (cy + cut_h // 2).clamp(0, H)
    xl = (cx - cut_w // 2).clamp(0, W)
    xh = (cx + cut_w // 2).clamp(0, W)
    lam_corrected = 1.0 - ((yh - yl) * (xh - xl)).float() / (H * W)
    return (yl, yh, xl, xh), lam_corrected


def _rand_bbox_minmax(H: int, W: int, cut_h, cut_w, yl, xl):
    """Box of the drawn sides at the drawn corner; lam from its area."""
    lam = 1.0 - (cut_h * cut_w).float() / (H * W)
    return (yl, yl + cut_h, xl, xl + cut_w), lam


def _box_mask(H: int, W: int, box, device):
    """[..., H, W, 1] mask of the box (each bound a tensor of shape [...])."""
    yl, yh, xl, xh = (t[..., None, None] for t in box)
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return ((ys >= yl) & (ys < yh) & (xs >= xl) & (xs < xh))[..., None]


class MixupConfig:
    def __init__(self, mixup_alpha=0.8, cutmix_alpha=0.0, cutmix_minmax=None,
                 prob=1.0, switch_prob=0.5, mode="batch", label_smoothing=0.1,
                 num_classes=1000):
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.cutmix_minmax = cutmix_minmax
        self.prob = prob
        self.switch_prob = switch_prob
        self.mode = mode
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes

    @property
    def active(self) -> bool:
        return (self.mixup_alpha > 0 or self.cutmix_alpha > 0
                or self.cutmix_minmax is not None)


def sample_mixup(cfg: MixupConfig, B: int, H: int, W: int,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The draws of one batch as CPU tensors: "lam" (1 where mixing is off),
    "use_cutmix", and the box: "cy", "cx" (or, with cutmix_minmax, "cut_h",
    "cut_w", "yl", "xl"). Scalars in 'batch' mode, [B] otherwise, with the
    draws of pair i mirrored onto B-1-i in 'pair' mode."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    rng = np.random.default_rng(seed)
    shape = () if cfg.mode == "batch" else (B,)
    both = cfg.mixup_alpha > 0 and (cfg.cutmix_alpha > 0 or cfg.cutmix_minmax)
    if both:
        use_cutmix = rng.random(shape) < cfg.switch_prob
        alpha = np.where(use_cutmix, cfg.cutmix_alpha, cfg.mixup_alpha)
    elif cfg.cutmix_alpha > 0 or cfg.cutmix_minmax is not None:
        use_cutmix = np.ones(shape, bool)
        alpha = np.full(shape, cfg.cutmix_alpha if cfg.cutmix_alpha > 0 else 1.0)
    else:
        use_cutmix = np.zeros(shape, bool)
        alpha = np.full(shape, cfg.mixup_alpha)
    # alpha is 0 only for cutmix by cutmix_minmax, whose lam comes from the
    # box: draw that one from Beta(1, 1) (JAX draws a NaN there, also unused)
    alpha = np.where(alpha > 0, alpha, 1.0)
    lam = rng.beta(alpha, alpha)
    enabled = rng.random(shape) < cfg.prob
    draws = {"lam": np.where(enabled, lam, 1.0).astype(np.float32),
             "use_cutmix": use_cutmix & enabled}
    if cfg.cutmix_minmax is not None:
        lo, hi = cfg.cutmix_minmax
        cut_h = rng.integers(int(H * lo), int(H * hi), shape)
        cut_w = rng.integers(int(W * lo), int(W * hi), shape)
        draws.update(cut_h=cut_h, cut_w=cut_w,
                     yl=(rng.random(shape) * (H - cut_h)).astype(np.int64),
                     xl=(rng.random(shape) * (W - cut_w)).astype(np.int64))
    else:
        draws.update(cy=rng.integers(0, H, shape), cx=rng.integers(0, W, shape))
    if cfg.mode == "pair":
        first = np.arange(B) < B // 2
        draws = {k: np.where(first, v, v[::-1]) for k, v in draws.items()}
    return {k: torch.as_tensor(np.asarray(v)) for k, v in draws.items()}


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host draw on `device` without waiting for the device: a scalar is
    filled in place, a vector goes through pinned memory (a copy from pageable
    memory would first drain the stream)."""
    if device.type != "cuda":
        return t.to(device)
    if t.dim() == 0:
        return torch.full((), t.item(), dtype=t.dtype, device=device)
    return t.pin_memory().to(device, non_blocking=True)


def mixup_cutmix(images: torch.Tensor, labels: torch.Tensor, draws: Dict[str, torch.Tensor],
                 cfg: MixupConfig):
    """(mixed images, soft targets [B, C]) from float NHWC images, int labels
    [B] and the draws of `sample_mixup`."""
    B, H, W, _ = images.shape
    d = {k: _to_device(v, images.device) for k, v in draws.items()}
    dev = images.device
    y = one_hot_smooth(labels, cfg.num_classes, cfg.label_smoothing)
    flipped = images.flip(0)
    if cfg.cutmix_minmax is not None:
        box, lam_cut = _rand_bbox_minmax(H, W, d["cut_h"], d["cut_w"], d["yl"], d["xl"])
    else:
        box, lam_cut = _rand_bbox(H, W, d["lam"], d["cy"], d["cx"])
    lam, cut = d["lam"], d["use_cutmix"]
    per_sample = lam.dim() == 1
    if per_sample:
        lam, cut, lam_cut = lam[:, None, None, None], cut[:, None, None, None], lam_cut
    cut_imgs = torch.where(_box_mask(H, W, box, dev), flipped, images)
    mix_lam = torch.where(cut, torch.ones_like(lam), lam)  # pixel mixing for mixup only
    mixed = torch.where(cut, cut_imgs, mix_lam * images + (1.0 - mix_lam) * flipped)
    lam_final = torch.where(d["use_cutmix"], lam_cut, d["lam"])
    if per_sample:
        lam_final = lam_final[:, None]
    return mixed, lam_final * y + (1.0 - lam_final) * y.flip(0)


def build_mixup(args, num_classes: int) -> Optional[MixupConfig]:
    """The mixup config of the args, or None when mixup and cutmix are off."""
    cfg = MixupConfig(
        mixup_alpha=args.mixup,
        cutmix_alpha=args.cutmix,
        cutmix_minmax=args.cutmix_minmax,
        prob=args.mixup_prob,
        switch_prob=args.mixup_switch_prob,
        mode=args.mixup_mode,
        label_smoothing=args.smoothing,
        num_classes=num_classes,
    )
    return cfg if cfg.active else None
