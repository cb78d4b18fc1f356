"""Model EMA (port of the JAX package's `optim/ema.py`, timm ModelEmaV3
semantics): a copy of every parameter, and of the BatchNorm running
statistics where the model has them, moved toward the model after each real
optimizer update as ema <- d*ema + (1-d)*p, updated in place. The decay may
be a 0-d device tensor (the train step's: under warmup it is computed on the
device) and a skipped step is gated on the device, so an update makes no
host read."""

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


def warmup_decay(decay: float, n_updates) -> torch.Tensor:
    """The decay at real update t under warmup, min(decay, (1+t)/(10+t)), in
    fp32 on the device of t (a number or a tensor), as JAX computes it."""
    t = torch.as_tensor(n_updates).to(torch.float32)
    return torch.clamp((1.0 + t) / (10.0 + t), max=float(decay))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay,
               do_update: Optional[torch.Tensor] = None) -> None:
    """ema <- ema*d + t*(1-d) in place, for every parameter or buffer t of
    the model named in `ema`; d a float or a 0-d tensor. With a 0-d bool
    `do_update`, only where it holds (a select on the device, as JAX's: a
    skipped step keeps the EMA even when the model holds a non-finite
    value)."""
    names = list(ema)
    tensors = model.state_dict()  # parameters and buffers, detached
    e = [ema[k] for k in names]
    new = torch._foreach_mul(e, decay)
    torch._foreach_add_(new, torch._foreach_mul([tensors[k] for k in names], 1.0 - decay))
    if do_update is not None:
        new = [torch.where(do_update, n, o) for n, o in zip(new, e)]
    torch._foreach_copy_(e, new)
