"""Optimizer factory (port of the JAX package's `optim/factory.py` for the
optimisers this slice ports: adamw, sgd = nesterov, momentum).

The same update rules as the JAX optax chains, on torch's own optimizers:
* one parameter group: weight decay applies to every parameter;
* adamw decays decoupled (torch.optim.AdamW: p -= lr*wd*p, then the Adam
  step; optax: -lr * (adam + wd*p), the same arithmetic); sgd and momentum add
  wd*p to the gradient (coupled, torch.optim.SGD's weight_decay);
* `clip_grad` clips the gradient by its global L2 norm before the update,
  with optax's `clip_by_global_norm` rule (scale by max_norm/norm when the
  norm is at least max_norm);
* `set_hyperparams` writes the step's lr and wd from the schedule arrays into
  the parameter group.

The other names of the JAX table raise NotImplementedError (ROADMAP A16).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..config import PORTED_OPTIMIZERS

# the JAX table's other names: known, not ported yet
_NOT_YET_PORTED = {
    "adam", "nadam", "radam", "adadelta", "rmsprop", "rmsproptf", "lion", "adamp",
    "sgdp", "lamb", "adahessian", "adafactor", "nvnovograd", "fusedadam", "fusedlamb",
    "fusednovograd",
}
_ALIAS = {"fusedadamw": "adamw", "fusedsgd": "sgd", "fusedmomentum": "momentum",
          "nesterov": "sgd"}
MOMENTUM = 0.9


class Optimizer:
    """A torch optimizer plus the steps the JAX chain runs before it (global
    norm clipping). `name` is the routed base name (adamw, sgd, momentum);
    `num_updates` counts the updates taken (the optax state's `count`)."""

    def __init__(self, name: str, inner: torch.optim.Optimizer,
                 clip_grad: Optional[float] = None):
        self.name = name
        self.inner = inner
        self.clip_grad = clip_grad
        self.num_updates = 0

    @property
    def params(self):
        return self.inner.param_groups[0]["params"]

    def set_hyperparams(self, lr: float, wd: float) -> None:
        for group in self.inner.param_groups:
            group["lr"] = float(lr)
            group["weight_decay"] = float(wd)

    def step(self) -> None:
        """One update from the parameters' .grad."""
        if self.clip_grad is not None:
            grads = [p.grad for p in self.params]
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                self.clip_grad / norm)
            torch._foreach_mul_(grads, scale)
        self.inner.step()
        self.num_updates += 1


def create_optimizer(opt: str, params: Iterable[torch.nn.Parameter], lr: float,
                     weight_decay: float, opt_eps: float = 1e-8, opt_betas=None,
                     clip_grad: Optional[float] = None) -> Optimizer:
    """Name-routed factory over one parameter group."""
    opt_lower = opt.lower()
    base = opt_lower.split("_")[-1]
    if opt_lower not in PORTED_OPTIMIZERS:
        if base in _NOT_YET_PORTED or opt_lower.startswith("lookahead_"):
            raise NotImplementedError(
                f"optimizer {opt!r} is not ported to imageclassification_tpu_torch yet "
                f"(ROADMAP A16); ported: {sorted(PORTED_OPTIMIZERS)}")
        raise ValueError(f"Invalid optimizer: {opt}")
    base = _ALIAS.get(base, base)
    params = list(params)
    if base == "adamw":
        betas = tuple(opt_betas) if opt_betas else (0.9, 0.999)
        inner = torch.optim.AdamW(params, lr=lr, betas=betas, eps=opt_eps,
                                  weight_decay=weight_decay)
    else:
        inner = torch.optim.SGD(params, lr=lr, momentum=MOMENTUM, dampening=0.0,
                                weight_decay=weight_decay, nesterov=base == "sgd")
    return Optimizer(base, inner, clip_grad)
