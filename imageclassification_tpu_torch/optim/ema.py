"""Model EMA (port of the JAX package's `optim/ema.py`, timm ModelEmaV3
semantics): a copy of every parameter, moved toward the model after each
real optimizer update as ema <- d*ema + (1-d)*p, updated in place."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def init_ema(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A real copy of the model's parameters by name (ModelEmaV3.set)."""
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def warmup_decay(decay: float, n_updates: int) -> float:
    """The decay at real update t under warmup: min(decay, (1+t)/(10+t))."""
    return min(float(decay), (1.0 + n_updates) / (10.0 + n_updates))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """ema <- ema*d + p*(1-d) for every parameter, in place."""
    names = list(ema)
    params = dict(model.named_parameters())
    e = [ema[k] for k in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, torch._foreach_mul([params[k].detach() for k in names], 1.0 - decay))
