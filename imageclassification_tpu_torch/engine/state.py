"""Train state (port of the JAX package's `engine/state.py`): what the train
step mutates, in one object: the model (its parameters), the optimizer (its
moments), the EMA copy, the gradient accumulator and the micro-step counter.
The JAX state is an immutable pytree replaced each step; here the step
updates these in place."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from ..optim.ema import init_ema
from ..optim.factory import Optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None        # parameter name -> EMA tensor
    grad_accum: Optional[List[torch.Tensor]] = None      # when update_freq > 1
    step: int = 0                                        # micro-step counter


def create_train_state(model: nn.Module, optimizer: Optimizer, use_ema: bool = False,
                       update_freq: int = 1) -> TrainState:
    accum = ([torch.zeros_like(p) for p in optimizer.params] if update_freq > 1 else None)
    return TrainState(model=model, optimizer=optimizer,
                      ema=init_ema(model) if use_ema else None, grad_accum=accum)


def num_params(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
