"""Eval pixel path on device tensors: uint8 NHWC in, float32 NHWC out
(the JAX package's `data/augment.py::normalize` and `eval_preprocess`)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images_01: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std on [0,1]-scaled float NHWC images."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images_01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images_01.device)
    return (images_01 - mean) / std


def eval_preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """Eval pixel path: normalize only (the host did the squash resize)."""
    return normalize(images_u8.to(torch.float32) / 255.0)
