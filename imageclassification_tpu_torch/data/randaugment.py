"""RandAugment and AutoAugment on the device (port of the JAX package's
`data/randaugment.py`, timm's policies and level maps).

`--aa rand-m9-mstd0.5-inc1`: `num_layers` applications a sample, each a
uniform op of the 15 at magnitude m + mstd N(0, 1) clipped to [0, mmax],
applied with probability `prob`. `--aa original` / `v0`: one of the 25
sub-policies of two (op, probability, magnitude) a sample.

Every choice is device data: a policy's `sample(B, generator)` draws the op
indices, magnitudes, apply flags and signs as tensors on the generator's
device, and applying it runs every op on the whole batch and keeps each
sample's own (JAX's `lax.switch` under `vmap` lowers to the same), so the
policy makes no host branch and no host read and runs inside a captured
step. The five geometric ops share one bilinear resample whose [B, 6]
coefficients are the identity for the others, as in JAX. Each application
draws four signs, as JAX's four keys give them: the first for shear and for
the enhance ops' factor (one key, `k_inner`), then translate-x,
translate-y and rotate (`fold_in(k_inner, 1 / 2 / 3)`).
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Dict, List

import numpy as np
import torch

from ..ops import image as I

_LEVEL_DENOM = 10.0
FILL = (124.0, 116.0, 104.0)  # round(255 * IMAGENET_MEAN), timm's default fill


def _constant(values: tuple, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A constant table on `device`, made once (before a capture: a copy
    from the host may not happen inside one)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _made(values, device, dtype)


@functools.lru_cache(maxsize=None)
def _made(values: tuple, device: torch.device, dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _level(m: torch.Tensor) -> torch.Tensor:
    """m / 10, divided on every device as JAX divides (a CUDA tensor divided
    by a number is multiplied by the number's reciprocal instead)."""
    return m / torch.full_like(m, _LEVEL_DENOM)


def _signed(sign: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(sign, v, -v)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x).to(torch.int32)


def _enhance_inc_factor(m, sign):
    return torch.clamp(1.0 + _signed(sign, _level(m) * 0.9), min=0.1)


def _enhance_factor(m, sign):
    # the non-increasing map: (m / 10) * 1.8 + 0.1, no sign
    return _level(m) * 1.8 + 0.1


# the pixel ops: (images [B, H, W, 3], magnitude [B], first sign [B]) -> images
def _autocontrast(img, m, sign):
    return I.autocontrast(img)


def _equalize(img, m, sign):
    return I.equalize(img)


def _invert(img, m, sign):
    return I.invert(img)


def _posterize_inc(img, m, sign):
    # timm PosterizeIncreasing: 4 - int(m / 10 * 4) bits, 0 (black) at 10
    return I.posterize(img, torch.clamp(4 - _bits(_level(m) * 4), 0, 8))


def _posterize(img, m, sign):
    # timm Posterize (rand non-increasing, AutoAugment v0): 0-4 bits
    return I.posterize(img, torch.clamp(_bits(_level(m) * 4), 0, 8))


def _posterize_original(img, m, sign):
    # timm PosterizeOriginal (the AutoAugment paper's ImageNet policy): 4-8 bits
    return I.posterize(img, torch.clamp(_bits(_level(m) * 4) + 4, 0, 8))


def _solarize_inc(img, m, sign):
    return I.solarize(img, 256.0 - torch.floor(_level(m) * 256.0))


def _solarize(img, m, sign):
    return I.solarize(img, torch.floor(_level(m) * 256.0))


def _solarize_add(img, m, sign):
    return I.solarize_add(img, torch.floor(_level(m) * 110.0))


def _enhance(op: Callable, factor: Callable) -> Callable:
    return lambda img, m, sign: op(img, factor(m, sign))


_GEOMETRIC = None  # a geometric op's place in an op list: the shared resample

# timm _RAND_INCREASING_TRANSFORMS order; index 3 rotate, 11-14 shear x/y,
# translate x/y
_RAND_INC_OPS: List = [
    _autocontrast, _equalize, _invert, _GEOMETRIC, _posterize_inc, _solarize_inc,
    _solarize_add, _enhance(I.adjust_saturation, _enhance_inc_factor),
    _enhance(I.adjust_contrast, _enhance_inc_factor),
    _enhance(I.adjust_brightness, _enhance_inc_factor),
    _enhance(I.adjust_sharpness, _enhance_inc_factor),
    _GEOMETRIC, _GEOMETRIC, _GEOMETRIC, _GEOMETRIC,
]

# timm _RAND_TRANSFORMS (the non-increasing level maps)
_RAND_OPS: List = [
    _autocontrast, _equalize, _invert, _GEOMETRIC, _posterize, _solarize, _solarize_add,
    _enhance(I.adjust_saturation, _enhance_factor), _enhance(I.adjust_contrast, _enhance_factor),
    _enhance(I.adjust_brightness, _enhance_factor), _enhance(I.adjust_sharpness, _enhance_factor),
    _GEOMETRIC, _GEOMETRIC, _GEOMETRIC, _GEOMETRIC,
]

_OP_NAME_TO_INDEX = {
    "AutoContrast": 0, "Equalize": 1, "Invert": 2, "Rotate": 3, "Posterize": 4,
    "Solarize": 5, "SolarizeAdd": 6, "Color": 7, "Contrast": 8,
    "Brightness": 9, "Sharpness": 10, "ShearX": 11, "ShearY": 12,
    "TranslateXRel": 13, "TranslateYRel": 14,
}


def _affine_coeffs(op: torch.Tensor, m: torch.Tensor, sign: torch.Tensor, H: int, W: int):
    """[B, 6] coefficients of each sample's geometric op (JAX
    `_affine_coeffs`): rotate (3), shear x (11) / y (12), translate x (13) /
    y (14); the identity for the pixel ops. `sign` [4, B]."""
    level = _level(m)
    sv = _signed(sign[0], level * 0.3)
    tx = _signed(sign[1], level * 0.45 * W)
    ty = _signed(sign[2], level * 0.45 * H)
    rot = I.rotate_coeffs(_signed(sign[3], level * 30.0), H, W)
    zero, one = torch.zeros_like(m), torch.ones_like(m)
    cols = [torch.where(op == 3, rot[:, i], one if i in (0, 4) else zero) for i in range(6)]
    cols[1] = torch.where(op == 11, sv, cols[1])
    cols[3] = torch.where(op == 12, sv, cols[3])
    cols[2] = torch.where(op == 13, tx, cols[2])
    cols[5] = torch.where(op == 14, ty, cols[5])
    return torch.stack(cols, dim=1)


def apply_op(img: torch.Tensor, op: torch.Tensor, m: torch.Tensor, sign: torch.Tensor,
             ops: List) -> torch.Tensor:
    """Sample b's op op[b] at magnitude m[b] with its signs sign[:, b] (JAX
    `_apply_op`): the shared resample for the geometric ops, every pixel op
    on the whole batch, each sample keeping its own."""
    H, W = img.shape[1:3]
    out = I.affine_inverse(img, _affine_coeffs(op, m, sign, H, W), _constant(FILL, img.device))
    for i, fn in enumerate(ops):
        if fn is not _GEOMETRIC:
            out = torch.where((op == i).reshape(-1, 1, 1, 1), fn(img, m, sign[0]), out)
    return out


def _keep(flag: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(flag.reshape(-1, 1, 1, 1), new, old)


class RandAugmentConfig:
    def __init__(self, magnitude=10.0, num_layers=2, mstd=0.5, increasing=False,
                 prob=0.5, mmax=10.0):
        # timm's defaults: magnitude 10 where the string has no mN token,
        # magnitude_std 0.5, magnitude_max 10 (mmaxN lifts the clip while
        # the level maps stay on the /10 scale)
        self.magnitude = magnitude
        self.num_layers = num_layers
        self.mstd = mstd
        self.increasing = increasing
        self.prob = prob
        self.mmax = mmax
        self.ops = _RAND_INC_OPS if increasing else _RAND_OPS

    def sample(self, B: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The draws of a batch on the generator's device: "op" [L, B],
        "m" [L, B] (clipped), "apply" [L, B], "sign" [L, 4, B]."""
        dev, L = generator.device, self.num_layers
        op = torch.randint(0, len(self.ops), (L, B), generator=generator, device=dev)
        if self.mstd > 0:
            m = self.magnitude + self.mstd * torch.randn((L, B), generator=generator, device=dev)
        else:
            m = torch.full((L, B), float(self.magnitude), device=dev)
        return {"op": op, "m": torch.clamp(m, 0.0, self.mmax),
                "apply": torch.rand((L, B), generator=generator, device=dev) < self.prob,
                "sign": torch.rand((L, 4, B), generator=generator, device=dev) < 0.5}

    def __call__(self, images: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        for layer in range(self.num_layers):
            out = apply_op(images, draws["op"][layer], draws["m"][layer],
                           draws["sign"][layer], self.ops)
            images = _keep(draws["apply"][layer], out, images)
        return images


def parse_policy(aa: str) -> RandAugmentConfig:
    """A timm-style 'rand-*' string as a RandAugmentConfig; another string
    or an unknown token raises ValueError."""
    if not aa.startswith("rand"):
        raise ValueError(f"Only rand-* policies parsed here, got {aa!r}")
    cfg = RandAugmentConfig()
    for tok in aa.split("-")[1:]:
        if m := re.match(r"mstd([\d.]+)$", tok):
            cfg.mstd = float(m.group(1))
        elif m := re.match(r"m(\d+)$", tok):
            cfg.magnitude = float(m.group(1))
        elif m := re.match(r"n(\d+)$", tok):
            cfg.num_layers = int(m.group(1))
        elif m := re.match(r"inc(\d+)$", tok):
            cfg.increasing = bool(int(m.group(1)))
        elif m := re.match(r"p([\d.]+)$", tok):
            cfg.prob = float(m.group(1))
        elif m := re.match(r"mmax(\d+)$", tok):
            cfg.mmax = float(m.group(1))
        elif re.match(r"w(\d+)$", tok):
            # timm's op weight sets; the ops are drawn uniformly, as in JAX
            print(f"RandAugment: token {tok!r} accepted but ignored "
                  "(uniform op sampling)")
        elif re.match(r"t(\d+)$", tok):
            print(f"RandAugment: token {tok!r} accepted but ignored")
        else:
            raise ValueError(f"unknown RandAugment token {tok!r} in {aa!r}")
    cfg.ops = _RAND_INC_OPS if cfg.increasing else _RAND_OPS
    return cfg


# The AutoAugment ImageNet policy (Cubuk et al. 2019, Table 9): 25
# sub-policies of two (op, prob, magnitude), on the non-increasing maps
_AA_ORIGINAL = [
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, 4), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, 7)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, 2)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, 8), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, 2)),
    (("Equalize", 0.0, 7), ("Equalize", 0.8, 8)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, 8)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, 9)),
    (("Color", 0.4, 0), ("Equalize", 0.6, 3)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
]

# Google's policy_v0 (the TF AutoAugment reference implementation)
_AA_V0 = [
    (("Equalize", 0.8, 1), ("ShearY", 0.8, 4)),
    (("Color", 0.4, 9), ("Equalize", 0.6, 3)),
    (("Color", 0.4, 1), ("Rotate", 0.6, 8)),
    (("Solarize", 0.8, 3), ("Equalize", 0.4, 7)),
    (("Solarize", 0.4, 2), ("Solarize", 0.6, 2)),
    (("Color", 0.2, 0), ("Equalize", 0.8, 8)),
    (("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)),
    (("ShearX", 0.2, 9), ("Rotate", 0.6, 8)),
    (("Color", 0.6, 1), ("Equalize", 1.0, 2)),
    (("Invert", 0.4, 9), ("Rotate", 0.6, 0)),
    (("Equalize", 1.0, 9), ("ShearY", 0.6, 3)),
    (("Color", 0.4, 7), ("Equalize", 0.6, 0)),
    (("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)),
    (("Solarize", 0.6, 8), ("Color", 0.6, 9)),
    (("Solarize", 0.2, 4), ("Rotate", 0.8, 9)),
    (("Rotate", 1.0, 7), ("TranslateYRel", 0.8, 9)),
    (("ShearX", 0.0, 0), ("Solarize", 0.8, 4)),
    (("ShearY", 0.8, 0), ("Color", 0.6, 4)),
    (("Color", 1.0, 0), ("Rotate", 0.6, 2)),
    (("Equalize", 0.8, 4), ("Equalize", 0.0, 8)),
    (("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)),
    (("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)),
    (("Posterize", 0.8, 2), ("Solarize", 0.6, 10)),
    (("Solarize", 0.6, 8), ("Equalize", 0.6, 1)),
    (("Color", 0.8, 6), ("Rotate", 0.4, 5)),
]


class AutoAugmentConfig:
    """An AutoAugment policy table, 'original' or 'v0'; another name raises
    ValueError (timm asserts)."""

    def __init__(self, policy: str = "original"):
        if policy not in ("original", "v0"):
            raise ValueError(
                f"unknown AutoAugment policy {policy!r} "
                "(supported: 'original', 'v0', 'rand-*', 'abel-*')"
            )
        table = _AA_ORIGINAL if policy == "original" else _AA_V0
        self.ops = list(_RAND_OPS)
        if policy == "original":
            # the original ImageNet policy's 4-8 bit map; v0 and rand: 0-4 bits
            self.ops[_OP_NAME_TO_INDEX["Posterize"]] = _posterize_original
        self.op_idx = np.array([[_OP_NAME_TO_INDEX[a[0]], _OP_NAME_TO_INDEX[b[0]]]
                                for a, b in table])
        self.probs = np.array([[a[1], b[1]] for a, b in table], np.float32)
        self.mags = np.array([[a[2], b[2]] for a, b in table], np.float32)

    def _table(self, name: str, device: torch.device) -> torch.Tensor:
        arr = getattr(self, name)
        dtype = torch.int64 if arr.dtype.kind == "i" else torch.float32
        return _constant(tuple(map(tuple, arr.tolist())), device, dtype)

    def sample(self, B: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The draws of a batch on the generator's device: "sub" [B] (the
        sub-policy), "apply" [2, B] (each slot with its table probability),
        "sign" [2, 4, B]."""
        dev = generator.device
        sub = torch.randint(0, len(self.op_idx), (B,), generator=generator, device=dev)
        u = torch.rand((2, B), generator=generator, device=dev)
        return {"sub": sub, "apply": u < self._table("probs", dev)[sub].T,
                "sign": torch.rand((2, 4, B), generator=generator, device=dev) < 0.5}

    def __call__(self, images: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        sub = draws["sub"]
        op = self._table("op_idx", images.device)[sub]
        mag = self._table("mags", images.device)[sub]
        for slot in range(2):
            out = apply_op(images, op[:, slot], mag[:, slot], draws["sign"][slot], self.ops)
            images = _keep(draws["apply"][slot], out, images)
        return images
