"""AbelAugment on the device (port of the JAX package's `data/abel.py`, the
reference's custom op set `abel_augmentations.py`).

`--aa abel-n2`: AbelAugment(2). Per sample: with probability 0.3 the pixels
below a threshold randint(1, randint(1, 10)) (bounds inclusive) go to 0;
with probability 0.1 nothing more happens; else `n` ops drawn with
replacement from Sharpness(0.4, 1.9), ShearX(0, 0.1) and ShearY(0, 0.1)
(random sign, fill 128), each on the previous op's output. One uniform
gives both the sharpness factor and the shear magnitude, as one JAX key
(`k_v`) gives both. The two shears share one bilinear resample.

The latent public ops of the reference module, which the JAX package keeps
(`set_dark_pixels_to_zero`, `anti_solarize`, `solarize_add_abel`,
`lighting`, `lighting_gray`, `sample_pairing`, `cutout_abs`), take their
random draws as [B] or [B, 3] tensors.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..ops import image as I
from ..ops.image import _per_sample
from .randaugment import _constant, _keep

# ImageNet PCA lighting (the AlexNet eigendecomposition)
LIGHTING_EIGVAL = (0.2175, 0.0188, 0.0045)
LIGHTING_EIGVEC = ((-0.5675, 0.7192, 0.4009),
                   (-0.5808, -0.0045, -0.8140),
                   (-0.5836, -0.6948, 0.4203))
ABEL_FILL = (128.0, 128.0, 128.0)
# jax.random.uniform's span, maxval - minval in fp32
_SHARP_LO, _SHARP_SPAN = 0.4, float(np.float32(1.9) - np.float32(0.4))
_SHEAR_SPAN = 0.1


def set_dark_pixels_to_zero(img, threshold):
    """Pixels below `threshold` ([B]) go to 0 (reference :92-101)."""
    return torch.where(img < _per_sample(threshold), 0.0, img)


def anti_solarize(img, threshold):
    """Invert the pixels at or below `threshold` ([B])."""
    return torch.where(img > _per_sample(threshold), img, 255.0 - img)


def solarize_add_abel(img, threshold, addition):
    """img + addition (clipped), then solarize at `threshold` (both [B])."""
    return I.solarize(torch.clamp(img + _per_sample(addition), 0.0, 255.0), threshold)


def lighting(img, noise, alphastd=0.1):
    """PCA colour noise: img + eigvec @ (alpha * eigval) * 255 with alpha =
    noise * alphastd, `noise` [B, 3] standard normal draws."""
    eigval = _constant(LIGHTING_EIGVAL, img.device)
    eigvec = _constant(LIGHTING_EIGVEC, img.device)
    delta = ((noise.float() * alphastd) * eigval) @ eigvec.T * 255.0
    return torch.clamp(img + delta.reshape(-1, 1, 1, 3), 0.0, 255.0)


def lighting_gray(img, noise, alphastd=0.1):
    """`lighting`, then the luma (ITU-R 601) in all three channels."""
    lit = lighting(img, noise, alphastd)
    g = lit @ _constant((0.299, 0.587, 0.114), img.device)
    return torch.clamp(g[..., None].expand(lit.shape), 0.0, 255.0)


def sample_pairing(img, other, weight):
    """Blend `other` in with weight [B] (labels unchanged)."""
    w = _per_sample(weight)
    return (1.0 - w) * img + w * other


def cutout_abs(img, center_y, center_x, size: int, fill=127.0):
    """A grey square of side `size` around (center_y, center_x) ([B])."""
    return I.cutout(img, size // 2, center_y, center_x,
                    _constant((float(fill),) * img.shape[-1], img.device))


class AbelAugmentConfig:
    def __init__(self, n: int = 2):
        self.n = n

    def sample(self, B: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The draws of a batch on the generator's device: "dark" [B] and its
        threshold "thr" [B], "skip" [B], then per op "op" [n, B], "v_sharp"
        and the signed "v_shear" [n, B], both from one uniform."""
        dev, n = generator.device, self.n

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        dark = rand(B) < 0.3
        tmax = torch.randint(1, 11, (B,), generator=generator, device=dev)
        thr = 1.0 + torch.floor(rand(B) * tmax)
        skip = rand(B) < 0.1
        op = torch.randint(0, 3, (n, B), generator=generator, device=dev)
        u = rand(n, B)
        v_shear = torch.clamp(u * _SHEAR_SPAN, min=0.0)
        return {"dark": dark, "thr": thr, "skip": skip, "op": op,
                "v_sharp": torch.clamp(u * _SHARP_SPAN + _SHARP_LO, min=_SHARP_LO),
                "v_shear": torch.where(rand(n, B) < 0.5, v_shear, -v_shear)}

    def __call__(self, images: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        images = _keep(draws["dark"], set_dark_pixels_to_zero(images, draws["thr"]), images)
        fill = _constant(ABEL_FILL, images.device)
        out = images
        for i in range(self.n):
            op, v = draws["op"][i], draws["v_shear"][i]
            zero, one = torch.zeros_like(v), torch.ones_like(v)
            coeffs = torch.stack([one, torch.where(op == 1, v, zero), zero,
                                  torch.where(op == 2, v, zero), one, zero], dim=1)
            sheared = I.affine_inverse(out, coeffs, fill)
            out = _keep(op == 0, I.adjust_sharpness(out, draws["v_sharp"][i]), sheared)
        return _keep(draws["skip"], images, out)


def parse_abel_policy(aa: str) -> AbelAugmentConfig:
    """'abel' or 'abel-n2' -> AbelAugment(n)."""
    n = 2
    if m := re.search(r"n(\d+)", aa):
        n = int(m.group(1))
    return AbelAugmentConfig(n)
