"""ResNet, ResNeXt and wide ResNet (port of imageclassification_tpu/models/resnet.py).

v1.5 (the stride in the 3x3 conv of the bottleneck), NHWC activations as in
the JAX model, the convolutions through `F.conv2d` on channels-first views
that are channels_last in memory (`layers.conv2d_nhwc`, no bias), and
BatchNorm with flax's semantics (`layers.BatchNorm`: fp32 batch statistics
with the biased variance, running averages with momentum 0.9, committed by
the train step). Parameter and buffer names follow torchvision/timm (`conv1`,
`bn1`, `layer{s}.{b}.conv{1,2,3}`, `bn{1,2,3}`, `downsample.{0,1}`, `fc`);
checkpoint/from_jax.py maps the JAX parameters and batch statistics onto
them.

Numerics kept from the JAX model: the 7x7/s2/pad-3 stem (the JAX model runs
it as the exact space-to-depth re-layout of the same function on even
inputs); max pool 3x3/s2 padded with -inf; strided 1x1 downsample (flax's
SAME padding pads nothing for a 1x1 kernel); the spatial mean in the compute
dtype; the head in fp32 even in a bf16 model. Initialisation: he_normal
convs, BatchNorm ones/zeros except the zero scale of each block's last
BatchNorm, a zero head.

The 1x1 convs run `F.conv2d`, as the JAX model runs `lax.conv`; the
hand-written fused 1x1-conv + BN-statistics kernel (ops/conv1x1_bn.py) is an
op of its own, as its Pallas kernel is in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, conv2d_nhwc, he_normal_


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters)
        self.downsample = (nn.Sequential(_conv(cin, filters, 1, stride), BatchNorm(filters))
                           if stride != 1 or cin != filters else None)
        self.dtype = dtype

    def last_bn(self) -> BatchNorm:
        return self.bn2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv2d_nhwc(x, self.conv1, self.dtype)))
        y = self.bn2(conv2d_nhwc(y, self.conv2, self.dtype))
        if self.downsample is not None:
            x = self.downsample[1](conv2d_nhwc(x, self.downsample[0], self.dtype))
        return F.relu(y + x)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck with the ResNeXt / wide generalisation: the
    1x1 reduce and the grouped 3x3 run at int(filters * base_width / 64) *
    groups channels."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64, dtype=torch.float32):
        super().__init__()
        width = int(filters * (base_width / 64.0)) * groups
        out = filters * 4
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = BatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = BatchNorm(width)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = BatchNorm(out)
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride), BatchNorm(out))
                           if stride != 1 or cin != out else None)
        self.dtype = dtype

    def last_bn(self) -> BatchNorm:
        return self.bn3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv2d_nhwc(x, self.conv1, self.dtype)))
        y = F.relu(self.bn2(conv2d_nhwc(y, self.conv2, self.dtype)))
        y = self.bn3(conv2d_nhwc(y, self.conv3, self.dtype))
        if self.downsample is not None:
            x = self.downsample[1](conv2d_nhwc(x, self.downsample[0], self.dtype))
        return F.relu(y + x)


class ResNet(nn.Module):
    """`ResNet(stage_sizes, block, num_classes, width, dtype)` as the JAX
    class; `block` is BasicBlock, Bottleneck or a functools.partial of
    Bottleneck with `groups` / `base_width`."""

    def __init__(self, stage_sizes: Sequence[int], block: Callable, num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.block_name = getattr(block, "func", block).__name__
        self.dtype = dtype
        self.conv1 = _conv(3, width, 7, 2)
        self.bn1 = BatchNorm(width)
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            blocks = []
            for j in range(n_blocks):
                blk = block(cin, width * 2 ** i, stride=2 if i > 0 and j == 0 else 1, dtype=dtype)
                cin = width * 2 ** i * blk.expansion
                blocks.append(blk)
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def stages(self):
        return [getattr(self, f"layer{i + 1}") for i in range(len(self.stage_sizes))]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initializers: he_normal convs, BatchNorm scale 1
        and bias 0 (scale 0 for each block's last BatchNorm), running mean 0
        and variance 1, a zero head."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m, generator)
            elif isinstance(m, BatchNorm):
                for t, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                             (m.running_var, 1.0)):
                    nn.init.constant_(t, v)
        for stage in self.stages():
            for blk in stage:
                nn.init.zeros_(blk.last_bn().weight)
        nn.init.zeros_(self.fc.weight)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x: [B, H, W, 3] float (NHWC). Returns fp32 logits [B, num_classes].
        `generator` is accepted as the other families take it; ResNet draws
        nothing."""
        del generator
        x = F.relu(self.bn1(conv2d_nhwc(x.to(self.dtype), self.conv1, self.dtype)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for stage in self.stages():
            x = stage(x)
        x = x.mean(dim=(1, 2))
        return F.linear(x.float(), self.fc.weight, self.fc.bias)


def _make(stage_sizes, block):
    def ctor(num_classes=1000, dtype=torch.float32, generator=None, **kw):
        del kw  # img_size and other families' kwargs, ignored as in JAX
        return ResNet(stage_sizes, block, num_classes=num_classes, dtype=dtype,
                      generator=generator)
    return ctor


resnet18 = _make([2, 2, 2, 2], BasicBlock)
resnet34 = _make([3, 4, 6, 3], BasicBlock)
resnet50 = _make([3, 4, 6, 3], Bottleneck)
resnet101 = _make([3, 4, 23, 3], Bottleneck)
resnet152 = _make([3, 8, 36, 3], Bottleneck)
resnext50_32x4d = _make([3, 4, 6, 3], functools.partial(Bottleneck, groups=32, base_width=4))
resnext101_32x8d = _make([3, 4, 23, 3], functools.partial(Bottleneck, groups=32, base_width=8))
wide_resnet50_2 = _make([3, 4, 6, 3], functools.partial(Bottleneck, base_width=128))
wide_resnet101_2 = _make([3, 4, 23, 3], functools.partial(Bottleneck, base_width=128))

NAMES = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
         "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2"]
