"""ConvNeXt and ConvNeXt-V2 (port of imageclassification_tpu/models/convnext.py).

NHWC activations as in the JAX model: the Linears act on the trailing
(channel) axis, and the 4x4/s4 stem, the 2x2/s2 downsamples and the 7x7
depthwise convs run `F.conv2d` on a channels-first view that is
channels_last in memory (`layers.conv2d_nhwc`). Parameter names follow timm
(`stem.{0,1}`, `stages.{i}.downsample.{0,1}`,
`stages.{s}.blocks.{b}.{conv_dw,norm,mlp.fc1,mlp.grn,mlp.fc2,gamma}`,
`head.norm`, `head.fc`), plus `norm{i}` for the per-stage output norms of
`features_only`; checkpoint/from_jax.py maps the JAX parameters onto them.

The model runs `F.conv2d(groups=C)` and the fp32-statistics `layer_norm`
helper, as the JAX model runs `lax.conv` and `nn.LayerNorm`. The
hand-written kernels of the same ops (ops/dwconv.py, ops/layernorm.py) are
ops of their own, as their Pallas kernels are in the JAX package; this model
does not call them.

Numerics kept from the JAX model: exact (erf) GELU; the depthwise and other
conv biases added in the compute dtype after the convolution; GRN in fp32,
cast back; layer-scale gamma (init 1e-6, absent in V2) cast to the compute
dtype; the spatial mean before the head norm in the compute dtype; the head
in fp32 even in a bf16 model; drop-path rates rising linearly over all
blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import DropPath, conv2d_nhwc, drop_path_rates, init_conv_, layer_norm, linear, trunc_normal_


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


class DepthwiseConv7x7(nn.Conv2d):
    """7x7 depthwise conv, stride 1, pad 3; weight [C, 1, 7, 7] and bias [C]
    (the JAX kernel [7, 7, 1, C])."""

    def __init__(self, dim: int):
        super().__init__(dim, dim, 7, padding=3, groups=dim)


class GRN(nn.Module):
    """Global Response Normalization (ConvNeXt-V2) over NHWC x: per-channel
    L2 energy over the spatial axes, divided by its channel mean, with
    zero-initialised `weight`/`bias` (JAX gamma/beta) and an identity
    shortcut; fp32 inside, result in x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        gx = torch.sqrt(torch.sum(xf * xf, dim=(1, 2), keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.weight * (xf * nx) + self.bias + xf).to(x.dtype)


class ConvMlp(nn.Module):
    """fc1 -> exact GELU -> (GRN) -> fc2, in the compute dtype."""

    def __init__(self, dim: int, use_grn: bool, dtype: torch.dtype):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim) if use_grn else None
        self.fc2 = nn.Linear(4 * dim, dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(linear(x, self.fc1, self.dtype))
        if self.grn is not None:
            x = self.grn(x)
        return linear(x, self.fc2, self.dtype)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale_init: float = 1e-6,
                 use_grn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_dw = DepthwiseConv7x7(dim)
        self.norm = _ln(dim)
        self.mlp = ConvMlp(dim, use_grn, dtype)
        self.gamma = (nn.Parameter(torch.full((dim,), float(layer_scale_init)))
                      if layer_scale_init > 0 else None)
        self.layer_scale_init = layer_scale_init
        self.drop_path = DropPath(drop_path)
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_conv_(self.conv_dw, generator)
        nn.init.ones_(self.norm.weight)
        nn.init.zeros_(self.norm.bias)
        for fc in (self.mlp.fc1, self.mlp.fc2):
            trunc_normal_(fc.weight, generator=generator)
            nn.init.zeros_(fc.bias)
        if self.mlp.grn is not None:
            nn.init.zeros_(self.mlp.grn.weight)
            nn.init.zeros_(self.mlp.grn.bias)
        if self.gamma is not None:
            nn.init.constant_(self.gamma, self.layer_scale_init)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        y = conv2d_nhwc(x, self.conv_dw, self.dtype)
        y = self.mlp(layer_norm(y, self.norm, self.dtype))
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)
        return x + self.drop_path(y, generator)


class Stage(nn.Module):
    """timm's ConvNeXtStage: `downsample` (LayerNorm, 2x2/s2 conv; none in
    stage 0, where the stem stands before it) and `blocks`."""

    def __init__(self, in_dim: int, dim: int, depth: int, rates: Sequence[float],
                 downsample: bool, layer_scale_init: float, use_grn: bool, dtype: torch.dtype):
        super().__init__()
        self.downsample = (nn.Sequential(_ln(in_dim), nn.Conv2d(in_dim, dim, 2, stride=2))
                           if downsample else None)
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(dim, rates[j], layer_scale_init, use_grn, dtype) for j in range(depth))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if self.downsample is not None:
            x = layer_norm(x, self.downsample[0], self.dtype)
            x = conv2d_nhwc(x, self.downsample[1], self.dtype)
        for blk in self.blocks:
            x = blk(x, generator)
        return x


class ConvNeXt(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), num_classes: int = 1000,
                 drop_path_rate: float = 0.0, layer_scale_init: float = 1e-6,
                 use_grn: bool = False, head_init_scale: float = 1.0,
                 features_only: bool = False, out_indices: Sequence[int] = (0, 1, 2, 3),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.head_init_scale = head_init_scale
        self.features_only = features_only
        self.out_indices = tuple(out_indices)
        self.dtype = dtype
        self.stem = nn.Sequential(nn.Conv2d(3, dims[0], 4, stride=4), _ln(dims[0]))
        rates = drop_path_rates(drop_path_rate, depths)
        self.stages = nn.ModuleList(
            Stage(dims[max(i - 1, 0)], dims[i], depths[i], rates[i], i > 0, layer_scale_init,
                  use_grn, dtype)
            for i in range(len(depths)))
        if features_only:
            # per-stage output norms for FPN consumers (the JAX norm{i})
            for i in self.out_indices:
                self.add_module(f"norm{i}", _ln(dims[i]))
        else:
            self.head = nn.Module()
            self.head.norm = _ln(dims[-1])
            self.head.fc = nn.Linear(dims[-1], num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initializers: truncated normal (std 0.02) for every
        conv and Dense kernel (0.02 * head_init_scale for the head), zero
        biases, LayerNorm ones/zeros, layer scale 1e-6, GRN zeros."""
        init_conv_(self.stem[0], generator)
        for stage in self.stages:
            if stage.downsample is not None:
                init_conv_(stage.downsample[1], generator)
            for blk in stage.blocks:
                blk.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        if not self.features_only:
            trunc_normal_(self.head.fc.weight, std=0.02 * self.head_init_scale,
                          generator=generator)
            nn.init.zeros_(self.head.fc.bias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x: [B, H, W, 3] float (NHWC). Returns fp32 logits [B, num_classes],
        or with `features_only` the normed NHWC outputs of the stages in
        `out_indices`, in the compute dtype."""
        x = conv2d_nhwc(x.to(self.dtype), self.stem[0], self.dtype)
        x = layer_norm(x, self.stem[1], self.dtype)
        features = []
        for i, stage in enumerate(self.stages):
            x = stage(x, generator)
            if self.features_only and i in self.out_indices:
                features.append(layer_norm(x, getattr(self, f"norm{i}"), self.dtype))
        if self.features_only:
            return features
        x = layer_norm(x.mean(dim=(1, 2)), self.head.norm, self.dtype)
        return F.linear(x.float(), self.head.fc.weight, self.head.fc.bias)


def _make(depths, dims, v2: bool = False):
    def ctor(num_classes=1000, drop_path_rate=0.0, dtype=torch.float32, features_only=False,
             out_indices=(0, 1, 2, 3), generator=None, **kw):
        del kw  # img_size and other families' kwargs, ignored as in JAX
        return ConvNeXt(depths=depths, dims=dims, num_classes=num_classes,
                        drop_path_rate=drop_path_rate, dtype=dtype,
                        layer_scale_init=0.0 if v2 else 1e-6, use_grn=v2,
                        features_only=features_only, out_indices=tuple(out_indices),
                        generator=generator)
    return ctor


convnext_atto = _make((2, 2, 6, 2), (40, 80, 160, 320))
convnext_femto = _make((2, 2, 6, 2), (48, 96, 192, 384))
convnext_pico = _make((2, 2, 6, 2), (64, 128, 256, 512))
convnext_nano = _make((2, 2, 8, 2), (80, 160, 320, 640))
convnext_tiny = _make((3, 3, 9, 3), (96, 192, 384, 768))
convnext_small = _make((3, 3, 27, 3), (96, 192, 384, 768))
convnext_base = _make((3, 3, 27, 3), (128, 256, 512, 1024))
convnext_large = _make((3, 3, 27, 3), (192, 384, 768, 1536))
convnext_xlarge = _make((3, 3, 27, 3), (256, 512, 1024, 2048))

# ConvNeXt-V2: GRN in every block, no layer scale; stem, downsample and head as V1
convnextv2_atto = _make((2, 2, 6, 2), (40, 80, 160, 320), v2=True)
convnextv2_femto = _make((2, 2, 6, 2), (48, 96, 192, 384), v2=True)
convnextv2_pico = _make((2, 2, 6, 2), (64, 128, 256, 512), v2=True)
convnextv2_nano = _make((2, 2, 8, 2), (80, 160, 320, 640), v2=True)
convnextv2_tiny = _make((3, 3, 9, 3), (96, 192, 384, 768), v2=True)
convnextv2_base = _make((3, 3, 27, 3), (128, 256, 512, 1024), v2=True)
convnextv2_large = _make((3, 3, 27, 3), (192, 384, 768, 1536), v2=True)
convnextv2_huge = _make((3, 3, 27, 3), (352, 704, 1408, 2816), v2=True)

NAMES = ([f"convnext_{s}" for s in ("atto", "femto", "pico", "nano", "tiny", "small", "base",
                                    "large", "xlarge")]
         + [f"convnextv2_{s}" for s in ("atto", "femto", "pico", "nano", "tiny", "base",
                                        "large", "huge")])
