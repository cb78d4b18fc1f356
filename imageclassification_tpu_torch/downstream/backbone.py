"""ConvNeXt multi-scale backbone adapter (port of
imageclassification_tpu/downstream/backbone.py).

The classification model itself exposes the pyramid view (`features_only`
on the port's ConvNeXt and Swin: per-stage-normed NHWC maps at strides
4/8/16/32); this adapter adds the strides/channels metadata that FPN
consumers read and the weight transfer from a classification checkpoint,
through the port's name+shape pruning (`checkpoint/io.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..models import create_model


def feature_channels(model: torch.nn.Module) -> Sequence[int]:
    """Channels of each map a `features_only` ConvNeXt or Swin returns."""
    if hasattr(model, "dims"):  # ConvNeXt-style dim table
        dims = list(model.dims)
    else:  # Swin: embed_dim * 2^stage
        embed = model.patch_embed.proj.out_channels
        dims = [embed * 2 ** i for i in range(len(model.depths))]
    return [dims[i] for i in model.out_indices]


class ConvNeXtBackbone:
    """Pyramid-feature extractor around a registry model with
    `features_only` (ConvNeXt, or Swin: both give per-stage-normed NHWC maps
    at strides 4/8/16/32). The model (an nn.Module) is `model`."""

    def __init__(self, variant: str = "convnext_tiny", out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 drop_path_rate: float = 0.0, half_precision: bool = True,
                 generator: Optional[torch.Generator] = None):
        self.variant = variant
        self.out_indices = tuple(out_indices)
        self.model = create_model(variant, num_classes=0, features_only=True,
                                  out_indices=self.out_indices, drop_path_rate=drop_path_rate,
                                  half_precision=half_precision, generator=generator)

    @property
    def feature_strides(self) -> Sequence[int]:
        return [4 * 2 ** i for i in self.out_indices]

    @property
    def feature_channels(self) -> Sequence[int]:
        return feature_channels(self.model)

    def __call__(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """A list of NHWC feature maps at strides 4/8/16/32 of NHWC x."""
        return self.model(x, generator)


def load_backbone_from_classifier(backbone: ConvNeXtBackbone, ckpt_path: str) -> int:
    """Load the backbone's parameters from a classification checkpoint,
    pruning the classifier head and anything mismatched by name and shape.
    Returns the number of checkpoint keys skipped."""
    from ..checkpoint.io import load_checkpoint, load_params_with_pruning

    ck = load_checkpoint(ckpt_path)
    missing = load_params_with_pruning(backbone.model, ck["model"])
    print(f"backbone transfer: {missing} classifier-only keys skipped")
    return missing
