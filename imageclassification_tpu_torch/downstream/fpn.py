"""Feature Pyramid Network neck (port of
imageclassification_tpu/downstream/fpn.py; the reference detection
configs' neck, mask_rcnn_convnext_fpn.py:22-26: FPN(in_channels = the
backbone's dims, out_channels 256, num_outs 5)).

mmdet's FPN as the JAX module computes it: 1x1 lateral convs with bias on
every level, a top-down nearest-neighbour resize (JAX's half-pixel rule,
source index floor((i + 0.5) * in / out)) and add, 3x3 output convs with
bias, and levels beyond the backbone's taken from the last output at stride
2 (JAX's 1x1 max pool at stride 2): P2..P5 at strides 4-32 and P6 at 64 for
num_outs 5. NHWC in and out, convs in the module's dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..models.layers import conv2d_nhwc


def _nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """`jax.image.resize(..., "nearest")` of NHWC x to `hw`."""
    for axis, n in ((1, int(hw[0])), (2, int(hw[1]))):
        m = x.shape[axis]
        if m == n:
            continue
        idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).long()
        x = x.index_select(axis, idx.to(x.device))
    return x


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", nn.Conv2d(c, out_channels, 1))
        for i in range(len(in_channels)):
            self.add_module(f"fpn{i}", nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.levels, self.num_outs, self.dtype = len(in_channels), num_outs, dtype

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: the backbone's NHWC maps, shallow to deep (strides 4-32).
        Returns `num_outs` maps of `out_channels`, strides 4, 8, ..."""
        laterals = [conv2d_nhwc(f, getattr(self, f"lateral{i}"), self.dtype)
                    for i, f in enumerate(feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _nearest(laterals[i], laterals[i - 1].shape[1:3])
        outs = [conv2d_nhwc(laterals[i], getattr(self, f"fpn{i}"), self.dtype)
                for i in range(len(laterals))]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, ::2, ::2])
        return outs


def build_detection_backbone(config_name: str, half_precision: bool = False):
    """(backbone, fpn, config) of a recipe of `configs.DETECTION_CONFIGS`:
    the backbone and neck under the reference's Mask R-CNN / Cascade heads
    (which stay configuration, as in the JAX package)."""
    from .backbone import ConvNeXtBackbone
    from .configs import DETECTION_CONFIGS

    cfg = DETECTION_CONFIGS[config_name]
    backbone = ConvNeXtBackbone(variant=cfg.backbone, out_indices=(0, 1, 2, 3),
                                drop_path_rate=cfg.drop_path_rate, half_precision=half_precision)
    fpn = FPN(backbone.feature_channels, out_channels=256, num_outs=5,
              dtype=torch.bfloat16 if half_precision else torch.float32)
    return backbone, fpn, cfg
