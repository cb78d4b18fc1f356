"""Device pixel pipeline on NHWC tensors (port of the JAX package's
`data/augment.py`).

Train order as in JAX: [host crop] -> hflip(0.5) -> vflip(0.5) -> ColorJitter
-> normalize (ImageNet mean/std) -> RandomErasing. Eval: normalize only (the
host did the squash resize). The `--aa` policies are not ported yet.

Every random function takes its draws as tensors, and `AugmentPipeline.sample`
makes them from an explicit `torch.Generator`; a test hands both packages the
same draws. JAX draws them from its keys inside the step; the two generators
give different numbers, never different semantics.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ERASE_AREA = (0.02, 1 / 3)
ERASE_ASPECT = (0.3, 10 / 3)


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device):
    """The normalisation constants on `device`, made once: a copy from the
    host at every call would wait for the device, and a captured step may
    not copy from pageable host memory."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize(images_01: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std on [0,1]-scaled float NHWC images."""
    mean, std = _mean_std(images_01.device)
    return (images_01 - mean) / std


def eval_preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """Eval pixel path: normalize only (the host did the squash resize)."""
    return normalize(images_u8.to(torch.float32) / 255.0)


def random_flips(images: torch.Tensor, do_h: torch.Tensor, do_v: torch.Tensor) -> torch.Tensor:
    """Flip sample b left-right where do_h[b], upside-down where do_v[b]."""
    images = torch.where(do_h[:, None, None, None], images.flip(2), images)
    return torch.where(do_v[:, None, None, None], images.flip(1), images)


def _gray(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114


def color_jitter_batch(images: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor,
                       fs: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter(brightness, contrast, saturation) in that fixed
    order, per-sample factors fb, fc, fs [B] (uniform in [max(0, 1-s), 1+s]),
    on float images in [0, 255]."""
    fb, fc, fs = (f.reshape(-1, 1, 1, 1) for f in (fb, fc, fs))
    b = torch.clamp(images.float() * fb, 0.0, 255.0)                    # brightness
    m = torch.round(torch.round(_gray(b)).mean(dim=(1, 2)))[:, None, None, None]
    c = torch.clamp(m + fc * (b - m), 0.0, 255.0)                        # contrast
    gray_c = _gray(c)[..., None]
    return torch.clamp(gray_c + fs * (c - gray_c), 0.0, 255.0)          # saturation


def random_erasing(images: torch.Tensor, draws: Dict[str, torch.Tensor],
                   mode: str = "pixel") -> torch.Tensor:
    """timm RandomErasing on normalized NHWC images. Per sample b where
    draws["enabled"][b], and per rectangle i < count: area fraction
    draws["area"][b, i], log aspect draws["log_aspect"][b, i], corner
    draws["top"/"left"][b, i] (clamped so the box fits), filled with
    draws["fill"][b, i] ([H, W, C] per-pixel noise for 'pixel', [C] for
    'rand'; zeros for 'const')."""
    B, H, W, C = images.shape
    count = draws["area"].shape[1]
    ys = torch.arange(H, device=images.device)[None, :, None]
    xs = torch.arange(W, device=images.device)[None, None, :]
    for i in range(count):
        target = H * W * draws["area"][:, i] / count
        aspect = torch.exp(draws["log_aspect"][:, i])
        h = torch.sqrt(target * aspect).to(torch.int32)
        w = torch.sqrt(target / aspect).to(torch.int32)
        fits = (h < H) & (w < W)
        h = h.clamp(1, H - 1)
        w = w.clamp(1, W - 1)
        top = torch.minimum(draws["top"][:, i], H - h)[:, None, None]
        left = torch.minimum(draws["left"][:, i], W - w)[:, None, None]
        h, w = h[:, None, None], w[:, None, None]
        mask = (ys >= top) & (ys < top + h) & (xs >= left) & (xs < left + w)
        mask = (mask & (fits & draws["enabled"])[:, None, None])[..., None]
        if mode == "pixel":
            fill = draws["fill"][:, i]
        elif mode == "rand":
            fill = draws["fill"][:, i][:, None, None, :]
        else:  # 'const'
            fill = torch.zeros((), device=images.device)
        images = torch.where(mask, fill, images)
    return images


def _uniform(shape, lo, hi, generator):
    return torch.rand(shape, generator=generator, device=generator.device) * (hi - lo) + lo


class AugmentPipeline:
    """The train-time pixel pipeline, configured once from the args."""

    def __init__(self, args):
        if args.aa:
            raise NotImplementedError(
                f"--aa {args.aa} is not ported to imageclassification_tpu_torch yet "
                "(ROADMAP A10)")
        self.color_jitter = args.color_jitter
        self.reprob = args.reprob
        self.remode = args.remode
        self.recount = args.recount

    def sample(self, B: int, H: int, W: int, generator: torch.Generator) -> Dict:
        """The draws of one batch, on the generator's device."""
        dev = generator.device
        draws = {"flip_h": torch.rand(B, generator=generator, device=dev) < 0.5,
                 "flip_v": torch.rand(B, generator=generator, device=dev) < 0.5}
        if self.color_jitter and self.color_jitter > 0:
            lo, hi = max(0.0, 1.0 - self.color_jitter), 1.0 + self.color_jitter
            draws["jitter"] = [_uniform(B, lo, hi, generator) for _ in range(3)]
        if self.reprob and self.reprob > 0:
            n = self.recount
            erase = {
                "enabled": torch.rand(B, generator=generator, device=dev) < self.reprob,
                "area": _uniform((B, n), *ERASE_AREA, generator),
                "log_aspect": _uniform((B, n), *map(math.log, ERASE_ASPECT), generator),
                "top": torch.randint(0, H, (B, n), generator=generator, device=dev),
                "left": torch.randint(0, W, (B, n), generator=generator, device=dev),
            }
            if self.remode == "pixel":
                erase["fill"] = torch.randn((B, n, H, W, 3), generator=generator, device=dev)
            elif self.remode == "rand":
                erase["fill"] = torch.randn((B, n, 3), generator=generator, device=dev)
            draws["erase"] = erase
        return draws

    def __call__(self, images_u8: torch.Tensor, draws: Dict) -> torch.Tensor:
        """uint8 [B, H, W, 3] -> normalized float32 [B, H, W, 3]."""
        x = random_flips(images_u8, draws["flip_h"], draws["flip_v"]).float()
        if self.color_jitter and self.color_jitter > 0:
            x = color_jitter_batch(x, *draws["jitter"])
        x = normalize(x / 255.0)
        if self.reprob and self.reprob > 0:
            x = random_erasing(x, draws["erase"], self.remode)
        return x
