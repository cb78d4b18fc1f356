"""EfficientNet B0-B4 (port of imageclassification_tpu/models/efficientnet.py):
timm's `efficientnet_b{0..4}` (the non-TF variants: symmetric padding,
BatchNorm eps 1e-5).

NHWC activations as in the JAX model, the convolutions through `F.conv2d` on
channels-first views (`layers.conv2d_nhwc`) and BatchNorm with flax's rules
(`layers.BatchNorm`). Module and parameter names follow timm, so a hub
state_dict's keys are the port's (less BatchNorm's `num_batches_tracked`):
`conv_stem`, `bn1`, `blocks.{s}.{j}` (stage 0's depthwise-separable blocks
`conv_dw`, `bn1`, `se.conv_reduce`, `se.conv_expand`, `conv_pw`, `bn2`; the
inverted residuals `conv_pw`, `bn1`, `conv_dw`, `bn2`, `se.*`, `conv_pwl`,
`bn3`), `conv_head`, `bn2`, `classifier`. The squeeze-excitation's 1x1
convs run as Linears on the pooled vector, as the JAX model's Dense layers.
checkpoint/from_jax.py maps the JAX parameters and batch statistics onto
them.

Kept from the JAX model: SiLU everywhere, the SE width from the block's
input channels (x 0.25) with a sigmoid gate, stochastic depth on the
residual blocks at drop_path_rate * i / n (i the block's index), the
compound width and depth scaling with round-to-8 channels, the spatial mean
in the compute dtype, classifier dropout (`drop_rate`, 0.2) and an fp32
zero-initialised head. Init: flax's lecun_normal convs and Linears, zero
biases, BatchNorm ones/zeros.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, conv2d_nhwc, dropout, lecun_normal_, linear, make_divisible
from .mobilenetv3 import pointwise

# b0's stage table: (kernel, stride, expand ratio, out channels, repeats)
_B0_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (3, 1, 1, 16, 1),
    (3, 2, 6, 24, 2),
    (5, 2, 6, 40, 2),
    (3, 2, 6, 80, 3),
    (5, 1, 6, 112, 3),
    (5, 2, 6, 192, 4),
    (3, 1, 6, 320, 1),
)

# (width multiplier, depth multiplier)
_VARIANTS = {
    "efficientnet_b0": (1.0, 1.0),
    "efficientnet_b1": (1.0, 1.1),
    "efficientnet_b2": (1.1, 1.2),
    "efficientnet_b3": (1.2, 1.4),
    "efficientnet_b4": (1.4, 1.8),
}


def _conv(cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups, bias=False)


class SqueezeExcite(nn.Module):
    """x * sigmoid(conv_expand(silu(conv_reduce(mean of x over space))))."""

    def __init__(self, c: int, rd: int, dtype=torch.float32):
        super().__init__()
        self.conv_reduce = nn.Conv2d(c, rd, 1)
        self.conv_expand = nn.Conv2d(rd, c, 1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.silu(pointwise(x.mean(dim=(1, 2)), self.conv_reduce, self.dtype))
        return x * torch.sigmoid(pointwise(s, self.conv_expand, self.dtype))[:, None, None, :]


class MBConv(nn.Module):
    """timm's DepthwiseSeparableConv (expand 1) and InvertedResidual: [1x1
    expand, BN, SiLU] -> kxk depthwise, BN, SiLU -> SE -> 1x1 project, BN ->
    (+ the input, through stochastic depth, where stride 1 and widths
    match)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, expand: int,
                 drop_path: float = 0.0, dtype=torch.float32):
        super().__init__()
        mid = cin * expand
        self.expand, self.drop_path, self.dtype = expand, drop_path, dtype
        self.residual = stride == 1 and cin == cout
        if expand != 1:
            self.conv_pw = _conv(cin, mid)
        self.conv_dw = _conv(mid, mid, kernel, stride, groups=mid)
        self.se = SqueezeExcite(mid, max(1, int(cin * 0.25)), dtype)
        if expand != 1:  # timm's numbering: bn1 after conv_pw, bn2 after conv_dw
            self.bn1, self.bn2 = BatchNorm(mid), BatchNorm(mid)
            self.conv_pwl, self.bn3 = _conv(mid, cout), BatchNorm(cout)
        else:
            self.bn1 = BatchNorm(mid)
            self.conv_pw, self.bn2 = _conv(mid, cout), BatchNorm(cout)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        dt = self.dtype
        if self.expand != 1:
            y = F.silu(self.bn1(conv2d_nhwc(x, self.conv_pw, dt)))
            y = F.silu(self.bn2(conv2d_nhwc(y, self.conv_dw, dt)))
            y = self.bn3(conv2d_nhwc(self.se(y), self.conv_pwl, dt))
        else:
            y = F.silu(self.bn1(conv2d_nhwc(x, self.conv_dw, dt)))
            y = self.bn2(conv2d_nhwc(self.se(y), self.conv_pw, dt))
        if not self.residual:
            return y
        if self.training and self.drop_path > 0.0:
            y = dropout(y, self.drop_path, generator, (y.shape[0], 1, 1, 1))
        return y + x


class EfficientNet(nn.Module):
    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 num_classes: int = 1000, drop_rate: float = 0.2, drop_path_rate: float = 0.0,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop_rate, self.dtype = drop_rate, dtype
        stem = make_divisible(32 * width_mult)
        self.conv_stem = _conv(3, stem, 3, 2)
        self.bn1 = BatchNorm(stem)
        # each stage's (blocks, expand ratio): the weight carry's layout
        self.stage_layout = [(int(math.ceil(r * depth_mult)), e) for _, _, e, _, r in _B0_STAGES]
        stages, cin, n = [], stem, sum(r for r, _ in self.stage_layout)
        i = 0
        for (k, s, e, c, _), (repeats, _) in zip(_B0_STAGES, self.stage_layout):
            cout = make_divisible(c * width_mult)
            blocks = []
            for j in range(repeats):
                blocks.append(MBConv(cin, cout, k, s if j == 0 else 1, e,
                                     drop_path=drop_path_rate * i / n, dtype=dtype))
                cin, i = cout, i + 1
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        head = make_divisible(1280 * width_mult)
        self.conv_head = _conv(cin, head)
        self.bn2 = BatchNorm(head)
        self.classifier = nn.Linear(head, num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun_normal kernels and zero biases, BatchNorm
        ones and zeros, running mean 0 and variance 1; a zero head."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                for t, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                             (m.running_var, 1.0)):
                    nn.init.constant_(t, v)
        nn.init.zeros_(self.classifier.weight)
        nn.init.zeros_(self.classifier.bias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x: [B, H, W, 3] float (NHWC). Returns fp32 logits [B, num_classes];
        `generator` draws the stochastic-depth and dropout masks in
        training."""
        x = F.silu(self.bn1(conv2d_nhwc(x.to(self.dtype), self.conv_stem, self.dtype)))
        for stage in self.blocks:
            for blk in stage:
                x = blk(x, generator)
        x = F.silu(self.bn2(conv2d_nhwc(x, self.conv_head, self.dtype))).mean(dim=(1, 2))
        if self.training:
            x = dropout(x, self.drop_rate, generator)
        return linear(x, self.classifier, torch.float32)


def _make(name: str):
    w, d = _VARIANTS[name]

    def ctor(num_classes=1000, dtype=torch.float32, drop_rate=0.2, drop_path_rate=0.0,
             generator=None, **kw):
        del kw  # other families' kwargs, ignored as in JAX
        return EfficientNet(w, d, num_classes=num_classes, drop_rate=drop_rate,
                            drop_path_rate=drop_path_rate, dtype=dtype, generator=generator)

    ctor.__name__ = name
    return ctor


efficientnet_b0 = _make("efficientnet_b0")
efficientnet_b1 = _make("efficientnet_b1")
efficientnet_b2 = _make("efficientnet_b2")
efficientnet_b3 = _make("efficientnet_b3")
efficientnet_b4 = _make("efficientnet_b4")

NAMES = list(_VARIANTS)
