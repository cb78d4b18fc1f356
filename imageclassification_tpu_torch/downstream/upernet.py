"""UPerNet semantic segmentation on the ConvNeXt pyramid backbone (port of
imageclassification_tpu/downstream/upernet.py).

The model dict of the reference's
`semantic_segmentation/configs/_base_/models/upernet_convnext.py:10-49`:
UPerHead (pool scales 1, 2, 3, 6, channels 512, dropout 0.1, BN,
align_corners=False) and an FCNHead aux on stage index 2 (channels 256, one
conv, loss weight 0.4), over the port's `features_only` ConvNeXt (or Swin).

Kept from the JAX module:
* module names (`decode_head.lateral{i}`, `.ppm.pool{i}`, `.ppm.bottleneck`,
  `.fpn{i}`, `.fuse`, `.conv_seg`, `auxiliary_head.conv0`, `.conv_seg`, each
  ConvModule's `conv` and `bn`), so the weight carry maps the JAX tree one
  module to one module (checkpoint/from_jax.py `upernet_modules`);
* NHWC activations: the convs run `layers.conv2d_nhwc` on channels-last
  memory (cuDNN's favoured layout for bf16) and the BatchNorm is the port's
  `layers.BatchNorm` with flax's rules (fp32 batch statistics, momentum 0.9,
  epsilon 1e-5, the running statistics committed by the train step);
* precision: the backbone and the heads compute in the model's dtype (bf16
  under `half_precision`), the two classifier convs (`conv_seg`) and the
  logits in fp32;
* `_resize` is `jax.image.resize(..., "bilinear")`: half-pixel bilinear
  that antialiases when it shrinks. Every resize of the model path at the
  recipes' crops enlarges, where it is `F.interpolate(mode="bilinear",
  align_corners=False)`; at a crop so small that a pooled PPM grid (up to
  6 x 6) is larger than the stride-32 map (crops below 192), the PPM's
  resize shrinks and takes torch's antialiased bilinear, which is the same
  triangle filter as JAX's;
* `_adaptive_avg_pool` is torch's adaptive bins, which the JAX function
  reproduces.
Dropout before each classifier is elementwise, as flax's `nn.Dropout`, its
mask drawn from the generator the forward is given.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import BatchNorm, conv2d_nhwc, dropout, lecun_normal_
from .backbone import feature_channels


def _resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear NHWC resize with half-pixel centres (mmseg
    align_corners=False), antialiased along an axis that shrinks, as
    `jax.image.resize(..., "bilinear")`."""
    hw = (int(hw[0]), int(hw[1]))
    if tuple(x.shape[1:3]) == hw:
        return x
    xc = x.permute(0, 3, 1, 2)
    if hw[0] < x.shape[1] or hw[1] < x.shape[2]:
        # antialiased, in fp32 (torch's CPU kernel takes no bf16), back in x's dtype
        y = F.interpolate(xc.float(), size=hw, mode="bilinear", align_corners=False,
                          antialias=True).to(x.dtype)
    else:
        y = F.interpolate(xc, size=hw, mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def _adaptive_avg_pool(x: torch.Tensor, s: int) -> torch.Tensor:
    """torch AdaptiveAvgPool2d(s) on NHWC x: bin i spans
    [floor(i H / s), ceil((i + 1) H / s))."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)


class ConvModule(nn.Module):
    """mmcv ConvModule (conv without bias -> BatchNorm -> ReLU), NHWC, the
    conv padded to keep the size (flax "SAME" at stride 1)."""

    def __init__(self, in_channels: int, channels: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, channels, kernel, padding=kernel // 2, bias=False)
        self.bn = BatchNorm(channels)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(conv2d_nhwc(x, self.conv, self.dtype)))


class PPM(nn.Module):
    """Pyramid Pooling Module (UPerHead psp_modules): adaptive-average-pool the
    stride-32 map to each scale, a 1x1 ConvModule to `channels`, resize back,
    concatenate with the input, fuse with a 3x3 ConvModule (`bottleneck`)."""

    def __init__(self, in_channels: int, channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        for i in range(len(self.pool_scales)):
            self.add_module(f"pool{i}", ConvModule(in_channels, channels, 1, dtype))
        self.bottleneck = ConvModule(in_channels + len(self.pool_scales) * channels, channels, 3,
                                     dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        outs = [x]
        for i, s in enumerate(self.pool_scales):
            p = getattr(self, f"pool{i}")(_adaptive_avg_pool(x, s))
            outs.append(_resize(p, (H, W)))
        return self.bottleneck(torch.cat(outs, dim=-1))


class UPerHead(nn.Module):
    """mmseg UPerHead: PPM on the top feature, 1x1 lateral convs, top-down FPN
    sum, per-level 3x3 convs, every level resized to stride 4 and
    concatenated, a 3x3 fuse, dropout, the 1x1 classifier in fp32."""

    def __init__(self, in_channels: Sequence[int], num_classes: int, channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n = len(in_channels)
        for i in range(n - 1):
            self.add_module(f"lateral{i}", ConvModule(in_channels[i], channels, 1, dtype))
        self.ppm = PPM(in_channels[-1], channels, pool_scales, dtype)
        for i in range(n - 1):
            self.add_module(f"fpn{i}", ConvModule(channels, channels, 3, dtype))
        self.fuse = ConvModule(n * channels, channels, 3, dtype)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)
        self.dropout, self.levels = dropout, n

    def forward(self, feats: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        laterals = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats[:-1])]
        laterals.append(self.ppm(feats[-1]))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _resize(laterals[i], laterals[i - 1].shape[1:3])
        outs = [getattr(self, f"fpn{i}")(laterals[i]) for i in range(len(laterals) - 1)]
        outs.append(laterals[-1])
        hw = outs[0].shape[1:3]
        y = self.fuse(torch.cat([_resize(o, hw) for o in outs], dim=-1))
        y = dropout(y, self.dropout if self.training else 0.0, generator)
        return conv2d_nhwc(y, self.conv_seg, torch.float32)


class FCNHead(nn.Module):
    """mmseg FCNHead (one conv, concat_input False): a 3x3 ConvModule, dropout,
    the 1x1 classifier in fp32; on the stride-16 stage."""

    def __init__(self, in_channels: int, num_classes: int, channels: int = 256,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = ConvModule(in_channels, channels, 3, dtype)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        y = dropout(self.conv0(x), self.dropout if self.training else 0.0, generator)
        return conv2d_nhwc(y, self.conv_seg, torch.float32)


class UPerNet(nn.Module):
    """EncoderDecoder(backbone = a `features_only` ConvNeXt or Swin, decode =
    UPerHead, aux = FCNHead). `forward(x, generator)` on NHWC images returns
    (main logits, aux logits or None), fp32 NHWC at the input's resolution;
    `generator` draws the backbone's drop-path masks and the heads'
    dropout in training."""

    def __init__(self, backbone: nn.Module, num_classes: int = 150, channels: int = 512,
                 aux_head: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        dims = feature_channels(backbone)
        self.decode_head = UPerHead(dims, num_classes, channels, dtype=dtype)
        self.auxiliary_head = FCNHead(dims[2], num_classes, dtype=dtype) if aux_head else None
        self.reset_heads(generator or torch.Generator().manual_seed(0))

    def reset_heads(self, generator: torch.Generator) -> None:
        """flax's initializers for the heads: lecun-normal conv kernels, zero
        biases, BatchNorm scale 1 and bias 0 (the backbone keeps its own)."""
        heads = [self.decode_head] + ([self.auxiliary_head] if self.auxiliary_head else [])
        for head in heads:
            for m in head.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m, generator)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        hw = x.shape[1:3]
        feats = self.backbone(x, generator)
        main = _resize(self.decode_head(feats, generator).float(), hw)
        if self.auxiliary_head is None:
            return main, None
        aux = self.auxiliary_head(feats[2], generator)
        return main, _resize(aux.float(), hw)


def build_upernet(config_name: str, num_classes: int, half_precision: bool = False,
                  generator: Optional[torch.Generator] = None):
    """(model, config) of a recipe of `configs.SEGMENTATION_CONFIGS`, its
    weights drawn from `generator` (default: seed 0)."""
    from ..models import create_model
    from .configs import SEGMENTATION_CONFIGS

    cfg = SEGMENTATION_CONFIGS[config_name]
    generator = generator or torch.Generator().manual_seed(0)
    backbone = create_model(cfg.backbone, num_classes=0, features_only=True,
                            out_indices=(0, 1, 2, 3), drop_path_rate=cfg.drop_path_rate,
                            half_precision=half_precision, generator=generator)
    model = UPerNet(backbone, num_classes=num_classes, aux_head=cfg.aux_head,
                    dtype=torch.bfloat16 if half_precision else torch.float32,
                    generator=generator)
    return model, cfg
