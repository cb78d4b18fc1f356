"""Optimizer factory (port of the JAX package's `optim/factory.py` for the
optimisers this slice ports: adamw, sgd = nesterov, momentum).

The update rules of the JAX optax chains, written as foreach updates over one
parameter group:
* weight decay applies to every parameter;
* adamw decays decoupled (optax `scale_by_adam` then `add_decayed_weights`,
  p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), applied in torch's order:
  p *= 1 - lr * wd, then torch's fused Adam step p -= lr * m_hat /
  (sqrt(v_hat) + eps)); sgd and momentum add
  wd * p to the gradient (coupled) before optax's `trace` (t = g + 0.9 t;
  nesterov: g + 0.9 t);
* `clip_grad` clips the gradient by its global L2 norm before the update,
  with optax's `clip_by_global_norm` rule (scale by max_norm/norm when the
  norm is at least max_norm).

Everything the update reads or writes lives on the parameters' device: the
moments, the update count (the optax state's `count`) and the learning rate
and weight decay, 0-d tensors the train step writes from its schedules with
`copy_` (`set_hyperparams`). So an update makes no host read and can be
captured in a CUDA graph. `step(grads, keep)` takes a device bool `keep`: a
step with keep false leaves the parameters, the moments and `count` exactly
as they were, by gating the update rather than selecting between old and
new tensors (JAX selects; the results are the same): `count` adds `keep`,
the decay factor is 1, the fused Adam step skips (its `found_inf`), and the
sgd/momentum gradient reads 0, its trace's decay 1 and its learning rate 0.

The other names of the JAX table raise NotImplementedError (ROADMAP A16).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

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
# the moments of each optimizer, by their torch names (the JAX names are in
# checkpoint/to_jax.py)
MOMENTS = {"adamw": ("exp_avg", "exp_avg_sq"), "sgd": ("momentum_buffer",),
           "momentum": ("momentum_buffer",)}


class Optimizer:
    """One parameter group's update, with its state on the parameters'
    device: `moments` (name -> one tensor per parameter), `count` (int32,
    the updates applied), `lr` and `weight_decay` (fp32). `name` is the
    routed base name (adamw, sgd, momentum)."""

    def __init__(self, name: str, params: Sequence[torch.nn.Parameter], lr: float,
                 weight_decay: float, eps: float = 1e-8, betas=(0.9, 0.999),
                 clip_grad: Optional[float] = None):
        self.name = name
        self.params: List[torch.nn.Parameter] = list(params)
        self.clip_grad = clip_grad
        self.eps = float(eps)
        self.betas = tuple(float(b) for b in betas)
        device = self.params[0].device
        self.lr = torch.tensor(float(lr), dtype=torch.float32, device=device)
        self.weight_decay = torch.tensor(float(weight_decay), dtype=torch.float32,
                                         device=device)
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.moments: Dict[str, List[torch.Tensor]] = {
            k: [torch.zeros_like(p) for p in self.params]
            for k in MOMENTS[name]}

    @property
    def num_updates(self) -> int:
        """The updates applied (reads the device count: a host read)."""
        return int(self.count)

    @num_updates.setter
    def num_updates(self, n: int) -> None:
        self.count.fill_(int(n))

    def set_hyperparams(self, lr, wd) -> None:
        """Write the step's lr and wd (floats or 0-d tensors) into the device
        scalars, in place."""
        for dst, v in ((self.lr, lr), (self.weight_decay, wd)):
            if isinstance(v, torch.Tensor):
                dst.copy_(v)
            else:
                dst.fill_(float(v))

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None,
             keep: Optional[torch.Tensor] = None) -> None:
        """One update from `grads` (default: the parameters' .grad), applied
        where the 0-d bool `keep` holds (default: always). `grads` are
        clipped in place when clip_grad is set."""
        grads = list(grads) if grads is not None else [p.grad for p in self.params]
        if self.clip_grad is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                self.clip_grad / norm)
            torch._foreach_mul_(grads, scale)
        if keep is None:
            keep = torch.ones((), dtype=torch.bool, device=self.count.device)
        neg_lr = torch.where(keep, -self.lr, torch.zeros_like(self.lr))
        if self.name == "adamw":
            self._adamw(grads, keep, neg_lr)
        else:
            # coupled weight decay, then the gradient gated
            g = torch._foreach_add(grads, torch._foreach_mul(self.params, self.weight_decay))
            g = [torch.where(keep, x, torch.zeros_like(x)) for x in g]
            torch._foreach_add_(self.params, self._trace(g, keep, neg_lr))
        self.count.add_(keep.to(self.count.dtype))

    def _adamw(self, grads, keep, neg_lr):
        """The decoupled decay as a factor, p *= 1 - lr * wd (exactly 1 on a
        skipped step, which keeps even a non-finite parameter as it was),
        then torch's fused Adam step at count + 1, which reads the learning
        rate from its device scalar and leaves the parameters and both
        moments untouched when `found_inf` (not `keep`) is set: one pass
        over the parameters and one over (parameter, gradient, moments)."""
        torch._foreach_mul_(self.params, 1.0 + neg_lr * self.weight_decay)
        t = (self.count + 1).to(torch.float32)
        # the fused step walks each tensor's memory in order: a gradient laid
        # out unlike its parameter (a conv weight's, channels-last from a
        # channels-last input) is copied to the parameter's layout first
        grads = [g if g.stride() == p.stride() else torch.empty_like(p).copy_(g)
                 for g, p in zip(grads, self.params)]
        torch._fused_adamw_(
            self.params, grads, self.moments["exp_avg"], self.moments["exp_avg_sq"], [],
            [t] * len(self.params), lr=self.lr, beta1=self.betas[0], beta2=self.betas[1],
            weight_decay=0.0, eps=self.eps, amsgrad=False, maximize=False, grad_scale=None,
            found_inf=(~keep).to(torch.float32))

    def _trace(self, g, keep, neg_lr):
        """optax trace (t = g + 0.9 t, the decay gated to 1 without `keep`;
        nesterov for sgd: g + 0.9 t) times -lr."""
        buf = self.moments["momentum_buffer"]
        decay = torch.where(keep, MOMENTUM, 1.0)
        torch._foreach_mul_(buf, decay)
        torch._foreach_add_(buf, g)
        if self.name != "sgd":
            return torch._foreach_mul(buf, neg_lr)
        upd = torch._foreach_mul(buf, decay)
        torch._foreach_add_(upd, g)
        torch._foreach_mul_(upd, neg_lr)
        return upd


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
    betas = tuple(opt_betas) if opt_betas else (0.9, 0.999)
    return Optimizer(base, params, lr, weight_decay, eps=opt_eps, betas=betas,
                     clip_grad=clip_grad)
