"""Layer-wise lr decay (port of the JAX package's `optim/layer_decay.py`):
each parameter's lr scale decay_rate^(num_layers - layer_id - 1), with the
stem at id 0, the blocks numbered up from it and the head at the top.

The JAX function derives the ids from flax parameter paths; this one
applies the same rules to the port's parameter names (timm's for ViT and
ConvNeXt, torchvision's for ResNet, Cream's for EfficientViT), so every
parameter gets the scale of its JAX counterpart (held equal in
tests/test_torch_layer_decay.py through the weight carry):
* ViT: patch_embed, cls_token and pos_embed 0, block i i + 1, the rest
  (final norm, head) depth + 1;
* ConvNeXt (V1 and V2): 14 slots, the stem 0, stages 0, 1 and 3 one slot
  each (1, 2, 12), stage 2 a slot every three blocks (3 + block // 3), the
  downsample before stage s at [0, 2, 3, 12][s], the rest 13;
* any other model (ResNet, EfficientViT): stage s block b at s * 4 + b + 1
  (the JAX `stage{s}_block{b}` modules: EfficientViT's stage blocks, not
  its subsample sandwiches), the stem 0 (ResNet's conv1/bn1, EfficientViT's
  patch_embed), everything else the head's slot; num_layers is 2 + the
  largest block id.
"""

from __future__ import annotations

import re
from typing import Iterable, List

import numpy as np

_HEAD = 100  # the generic rule's id for modules outside the stem and the stages


def _vit_layer_id(name: str, depth: int) -> int:
    if name.startswith(("patch_embed", "cls_token", "pos_embed")):
        return 0
    m = re.match(r"blocks\.(\d+)\.", name)
    if m:
        return int(m.group(1)) + 1
    return depth + 1  # head / final norm


def _convnext_layer_id(name: str) -> int:
    if name.startswith("stem"):
        return 0
    m = re.match(r"stages\.(\d+)\.blocks\.(\d+)\.", name)
    if m:
        stage, block = int(m.group(1)), int(m.group(2))
        return 3 + block // 3 if stage == 2 else [1, 2, 3, 12][stage]
    m = re.match(r"stages\.(\d+)\.downsample\.", name)
    if m:
        return [0, 2, 3, 12][int(m.group(1))]
    return 13


def _generic_layer_id(name: str) -> int:
    # EfficientViT: blocks{s+1}.{j}; from stage 1 on, j = 0-2 is the
    # subsample sandwich (JAX sub{s}_*), the stage's blocks follow
    m = re.match(r"blocks(\d+)\.(\d+)\.", name)
    if m:
        stage, j = int(m.group(1)) - 1, int(m.group(2))
        block = j - (3 if stage > 0 else 0)
        return stage * 4 + block + 1 if block >= 0 else _HEAD
    if name.startswith(("conv1.", "bn1.", "patch_embed.")):
        return 0
    return _HEAD  # head-ish: scale 1.0


def layer_decay_scales(names: Iterable[str], model_name: str, decay_rate: float) -> List[float]:
    """The lr scale of each parameter named in `names` (the model's
    `named_parameters()` names, in order): decay_rate^(num_layers - id - 1),
    computed in double precision and rounded to float32 as JAX does."""
    names = list(names)
    if model_name.startswith("convnext"):
        num_layers = 14  # 12 block slots + stem offset + head
        ids = [_convnext_layer_id(n) for n in names]
    elif model_name.startswith("vit"):
        depth = 1 + max([int(m.group(1)) for n in names
                         if (m := re.match(r"blocks\.(\d+)\.", n))] or [0])
        num_layers = depth + 2
        ids = [_vit_layer_id(n, depth) for n in names]
    else:
        raw = [_generic_layer_id(n) for n in names]
        num_layers = 2 + max(i for i in raw if i < _HEAD)
        ids = [min(i, num_layers - 1) for i in raw]
    return [float(np.float32(decay_rate ** (num_layers - i - 1))) for i in ids]
