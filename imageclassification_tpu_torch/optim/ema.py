"""Model EMA (port of the JAX package's `optim/ema.py`, timm ModelEmaV3
semantics): a copy of every parameter, and of the BatchNorm running
statistics where the model has them, moved toward the model after each real
optimizer update as ema <- d*ema + (1-d)*p, updated in place."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..models.layers import batch_norm_stats


def init_ema(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A real copy of the model's parameters by name (ModelEmaV3.set)."""
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def init_ema_stats(model: nn.Module) -> Optional[Dict[str, torch.Tensor]]:
    """A real copy of the model's BatchNorm running statistics by name, or
    None for a model without BatchNorm (the JAX `ema_batch_stats`)."""
    stats = {k: b.detach().clone() for k, b in batch_norm_stats(model).items()}
    return stats or None


def warmup_decay(decay: float, n_updates: int) -> float:
    """The decay at real update t under warmup: min(decay, (1+t)/(10+t))."""
    return min(float(decay), (1.0 + n_updates) / (10.0 + n_updates))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """ema <- ema*d + t*(1-d) in place, for every parameter or buffer t of
    the model named in `ema`."""
    names = list(ema)
    tensors = model.state_dict()  # parameters and buffers, detached
    e = [ema[k] for k in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, torch._foreach_mul([tensors[k] for k in names], 1.0 - decay))
