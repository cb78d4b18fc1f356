"""MobileNetV3 large and small (port of imageclassification_tpu/models/mobilenetv3.py):
torchvision's `mobilenet_v3_{large,small}`, with the timm-style names
`mobilenetv3_{large,small}_100` beside them.

NHWC activations as in the JAX model, the convolutions through `F.conv2d` on
channels-first views (`layers.conv2d_nhwc`) and BatchNorm with flax's rules
(`layers.BatchNorm`, eps 1e-3 as torchvision's, momentum 0.9 as the JAX
model's). Module and parameter names follow torchvision, so a hub
state_dict's keys are the port's (less BatchNorm's `num_batches_tracked`):
`features.0.{0,1}` the stem, `features.{i}.block.{j}.{0,1}` each inverted
residual's expand (where the block has one), depthwise and project convs
and BatchNorms, `features.{i}.block.{j}.fc{1,2}` its squeeze-excitation
(1x1 convs with bias, run as Linears on the pooled vector, as the JAX
model's Dense layers), `features.{last}.{0,1}` the last 1x1 conv,
`classifier.{0,3}` the two Linears. checkpoint/from_jax.py maps the JAX
parameters and batch statistics onto them.

Kept from the JAX model: hardswish / relu by the block table, the
hardsigmoid gate, residuals where stride 1 and widths match, the spatial
mean in the compute dtype, hardswish after the pre-head Linear, classifier
dropout (`drop_rate`, 0.2) and an fp32 zero-initialised head. Init: flax's
lecun_normal convs and Linears, zero biases, BatchNorm ones/zeros.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, conv2d_nhwc, dropout, lecun_normal_, linear, make_divisible


class BlockCfg(NamedTuple):
    in_ch: int
    kernel: int
    expanded: int
    out_ch: int
    use_se: bool
    use_hs: bool   # hardswish (True) or relu (False)
    stride: int


# torchvision's _mobilenet_v3_conf tables
_LARGE = [
    BlockCfg(16, 3, 16, 16, False, False, 1),
    BlockCfg(16, 3, 64, 24, False, False, 2),
    BlockCfg(24, 3, 72, 24, False, False, 1),
    BlockCfg(24, 5, 72, 40, True, False, 2),
    BlockCfg(40, 5, 120, 40, True, False, 1),
    BlockCfg(40, 5, 120, 40, True, False, 1),
    BlockCfg(40, 3, 240, 80, False, True, 2),
    BlockCfg(80, 3, 200, 80, False, True, 1),
    BlockCfg(80, 3, 184, 80, False, True, 1),
    BlockCfg(80, 3, 184, 80, False, True, 1),
    BlockCfg(80, 3, 480, 112, True, True, 1),
    BlockCfg(112, 3, 672, 112, True, True, 1),
    BlockCfg(112, 5, 672, 160, True, True, 2),
    BlockCfg(160, 5, 960, 160, True, True, 1),
    BlockCfg(160, 5, 960, 160, True, True, 1),
]
_SMALL = [
    BlockCfg(16, 3, 16, 16, True, False, 2),
    BlockCfg(16, 3, 72, 24, False, False, 2),
    BlockCfg(24, 3, 88, 24, False, False, 1),
    BlockCfg(24, 5, 96, 40, True, True, 2),
    BlockCfg(40, 5, 240, 40, True, True, 1),
    BlockCfg(40, 5, 240, 40, True, True, 1),
    BlockCfg(40, 5, 120, 48, True, True, 1),
    BlockCfg(48, 5, 144, 48, True, True, 1),
    BlockCfg(48, 5, 288, 96, True, True, 2),
    BlockCfg(96, 5, 576, 96, True, True, 1),
    BlockCfg(96, 5, 576, 96, True, True, 1),
]


class ConvBN(nn.Sequential):
    """A bias-free conv (`0`) and a BatchNorm (`1`, eps 1e-3), torchvision's
    Conv2dNormActivation less its activation, which the caller applies."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1, groups: int = 1,
                 eps: float = 1e-3, dtype=torch.float32):
        super().__init__(nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups,
                                   bias=False),
                         BatchNorm(cout, eps=eps))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self[1](conv2d_nhwc(x, self[0], self.dtype))


def pointwise(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A 1x1 conv with bias applied to vectors [B, C] as a Linear in `dtype`
    (the JAX model's Dense on the pooled vector)."""
    w = conv.weight.reshape(conv.out_channels, conv.in_channels)
    return F.linear(x.to(dtype), w.to(dtype), conv.bias.to(dtype))


class SqueezeExcitation(nn.Module):
    """x * hardsigmoid(fc2(relu(fc1(mean of x over space))))."""

    def __init__(self, c: int, squeeze: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = nn.Conv2d(c, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, c, 1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(pointwise(x.mean(dim=(1, 2)), self.fc1, self.dtype))
        return x * F.hardsigmoid(pointwise(s, self.fc2, self.dtype))[:, None, None, :]


class InvertedResidual(nn.Module):
    def __init__(self, c: BlockCfg, dtype=torch.float32):
        super().__init__()
        self.cfg = c
        layers = []
        if c.expanded != c.in_ch:
            layers.append(ConvBN(c.in_ch, c.expanded, dtype=dtype))
        layers.append(ConvBN(c.expanded, c.expanded, c.kernel, c.stride, groups=c.expanded,
                             dtype=dtype))
        if c.use_se:
            layers.append(SqueezeExcitation(c.expanded, make_divisible(c.expanded // 4), dtype))
        layers.append(ConvBN(c.expanded, c.out_ch, dtype=dtype))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = F.hardswish if self.cfg.use_hs else F.relu
        y = x
        for m in self.block[:-1]:
            y = m(y) if isinstance(m, SqueezeExcitation) else act(m(y))
        y = self.block[-1](y)
        if self.cfg.stride == 1 and self.cfg.in_ch == self.cfg.out_ch:
            y = y + x
        return y


class Stem(ConvBN):
    """features.0: 3x3/s2 conv to 16 channels, BatchNorm, hardswish."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.hardswish(super().forward(x))


class MobileNetV3(nn.Module):
    def __init__(self, cfgs: Sequence[BlockCfg], last_channel: int, num_classes: int = 1000,
                 drop_rate: float = 0.2, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfgs, self.drop_rate, self.dtype = list(cfgs), drop_rate, dtype
        last_conv = 6 * self.cfgs[-1].out_ch
        self.features = nn.Sequential(
            Stem(3, 16, 3, 2, dtype=dtype),
            *[InvertedResidual(c, dtype) for c in self.cfgs],
            Stem(self.cfgs[-1].out_ch, last_conv, dtype=dtype))
        self.classifier = nn.Sequential(nn.Linear(last_conv, last_channel), nn.Hardswish(),
                                        nn.Dropout(drop_rate), nn.Linear(last_channel,
                                                                         num_classes))
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
        nn.init.zeros_(self.classifier[3].weight)
        nn.init.zeros_(self.classifier[3].bias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x: [B, H, W, 3] float (NHWC). Returns fp32 logits [B, num_classes];
        `generator` draws the classifier's dropout mask in training."""
        x = self.features(x.to(self.dtype)).mean(dim=(1, 2))
        x = F.hardswish(linear(x, self.classifier[0], self.dtype))
        if self.training:
            x = dropout(x, self.drop_rate, generator)
        head = self.classifier[3]
        return F.linear(x.float(), head.weight, head.bias)


def mobilenetv3_large_100(num_classes=1000, dtype=torch.float32, drop_rate=0.2, generator=None,
                          **kw):
    del kw  # other families' kwargs, ignored as in JAX
    return MobileNetV3(_LARGE, 1280, num_classes=num_classes, drop_rate=drop_rate, dtype=dtype,
                       generator=generator)


def mobilenetv3_small_100(num_classes=1000, dtype=torch.float32, drop_rate=0.2, generator=None,
                          **kw):
    del kw
    return MobileNetV3(_SMALL, 1024, num_classes=num_classes, drop_rate=drop_rate, dtype=dtype,
                       generator=generator)


# torchvision's names
mobilenet_v3_large = mobilenetv3_large_100
mobilenet_v3_small = mobilenetv3_small_100

NAMES = ["mobilenetv3_large_100", "mobilenetv3_small_100", "mobilenet_v3_large",
         "mobilenet_v3_small"]
