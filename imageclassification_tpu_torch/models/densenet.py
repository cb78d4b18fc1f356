"""DenseNet 121/169/201 (port of imageclassification_tpu/models/densenet.py):
torchvision's `densenet{121,169,201}`.

NHWC activations as in the JAX model, the convolutions through `F.conv2d` on
channels-first views (`layers.conv2d_nhwc`) and BatchNorm with flax's rules
(`layers.BatchNorm`). Each dense layer is BN -> ReLU -> 1x1 conv (4 x
growth) -> BN -> ReLU -> 3x3 conv (growth), its output concatenated onto the
map along the channel (last) axis; transitions halve the channels with a
1x1 conv and average-pool 2x2. Module and parameter names follow
torchvision, so a hub state_dict's keys are the port's (less BatchNorm's
`num_batches_tracked`): `features.conv0`, `features.norm0`,
`features.denseblock{i}.denselayer{j}.{norm1,conv1,norm2,conv2}` (from 1),
`features.transition{i}.{norm,conv}`, `features.norm5`, `classifier`.
checkpoint/from_jax.py maps the JAX parameters and batch statistics onto
them. The head is fp32 and zero-initialised, as in JAX; init otherwise
flax's: lecun_normal convs, BatchNorm ones/zeros.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, conv2d_nhwc, lecun_normal_, linear

_CONFIGS = {
    "densenet121": (6, 12, 24, 16),
    "densenet169": (6, 12, 32, 32),
    "densenet201": (6, 12, 48, 32),
}
_GROWTH = 32


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = BatchNorm(cin)
        self.conv1 = _conv(cin, 4 * growth, 1)
        self.norm2 = BatchNorm(4 * growth)
        self.conv2 = _conv(4 * growth, growth, 3)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_nhwc(F.relu(self.norm1(x)), self.conv1, self.dtype)
        y = conv2d_nhwc(F.relu(self.norm2(y)), self.conv2, self.dtype)
        return torch.cat([x, y], dim=-1)


class Transition(nn.Module):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        self.norm = BatchNorm(cin)
        self.conv = _conv(cin, cin // 2, 1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_nhwc(F.relu(self.norm(x)), self.conv, self.dtype)
        return F.avg_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class DenseNet(nn.Module):
    def __init__(self, block_config: Sequence[int], growth: int = _GROWTH,
                 num_classes: int = 1000, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block_config, self.dtype = tuple(block_config), dtype
        features = nn.Module()
        features.conv0 = _conv(3, 2 * growth, 7, 2)
        c = 2 * growth
        features.norm0 = BatchNorm(c)
        for i, layers in enumerate(self.block_config):
            block = nn.Module()
            for j in range(layers):
                block.add_module(f"denselayer{j + 1}", DenseLayer(c, growth, dtype))
                c += growth
            features.add_module(f"denseblock{i + 1}", block)
            if i != len(self.block_config) - 1:
                features.add_module(f"transition{i + 1}", Transition(c, dtype))
                c //= 2
        features.norm5 = BatchNorm(c)
        self.features = features
        self.classifier = nn.Linear(c, num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun_normal kernels, BatchNorm ones and zeros,
        running mean 0 and variance 1; a zero head."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m, generator)
            elif isinstance(m, BatchNorm):
                for t, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                             (m.running_var, 1.0)):
                    nn.init.constant_(t, v)
        nn.init.zeros_(self.classifier.weight)
        nn.init.zeros_(self.classifier.bias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x: [B, H, W, 3] float (NHWC). Returns fp32 logits [B, num_classes].
        `generator` is accepted as the other families take it; DenseNet draws
        nothing."""
        del generator
        f = self.features
        x = F.relu(f.norm0(conv2d_nhwc(x.to(self.dtype), f.conv0, self.dtype)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for i, layers in enumerate(self.block_config):
            for j in range(layers):
                x = getattr(getattr(f, f"denseblock{i + 1}"), f"denselayer{j + 1}")(x)
            if i != len(self.block_config) - 1:
                x = getattr(f, f"transition{i + 1}")(x)
        x = F.relu(f.norm5(x)).mean(dim=(1, 2))
        return linear(x, self.classifier, torch.float32)


def _make(name: str):
    cfg = _CONFIGS[name]

    def ctor(num_classes=1000, dtype=torch.float32, generator=None, **kw):
        del kw  # other families' kwargs, ignored as in JAX
        return DenseNet(cfg, num_classes=num_classes, dtype=dtype, generator=generator)

    ctor.__name__ = name
    return ctor


densenet121 = _make("densenet121")
densenet169 = _make("densenet169")
densenet201 = _make("densenet201")

NAMES = list(_CONFIGS)
