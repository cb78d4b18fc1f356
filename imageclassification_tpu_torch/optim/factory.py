"""Optimizer factory (port of the JAX package's `optim/factory.py` and
`optim/custom.py`): the optax chains of its table, written as foreach
updates on the parameters' device.

What every optimizer shares, in the JAX chain's order:
* `clip_grad` clips the gradient by its global L2 norm (optax's
  `clip_by_global_norm`: scale by max_norm / norm when the norm is at least
  max_norm);
* coupled weight decay (sgd = nesterov, momentum, adam, nadam, radam,
  adadelta, rmsprop, rmsproptf: the JAX `_COUPLED_WD`) adds wd * p to the
  gradient; adamw, lion and lamb decay decoupled (optax
  `add_decayed_weights` after the core, so the decay is scaled as the rest
  of the update is), and adamp and sgdp decay inside their update, as
  `custom.py` does;
* the core transformation (below) gives an update u; with `--layer_decay`
  each parameter's u is multiplied by its layer scale s (`layer_decay.py`),
  and the parameter moves by -lr * s * u. Parameters are grouped by scale
  (ViT-B/16 has 14), and `set_hyperparams` derives each group's lr * s (and
  adamw's decay factor 1 - lr * s * wd) on the device from the step's lr;
* the `lookahead_` prefix wraps the update in Lookahead (`custom.lookahead`:
  every 6th update the weights move to slow + 0.5 (fast - slow), which the
  slow weights keep).

The cores (optax 0.2's formulas): adamw and adam (m, v with bias
corrections; adamw by torch's fused Adam step), nadam (optax's nesterov
m-hat), radam (the rectified update where rho_t >= 5, else m-hat: a device
select), lion (sign((1 - b1) g + b1 m) with b1 0.9, m decayed by 0.999),
lamb (adam, the decayed weights, then the trust ratio |p| / |u| of each JAX
parameter), rmsprop and rmsproptf (mean square with decay 0.9, initialised
to 0 / 1, eps outside / inside the root, then a 0.9 trace), adadelta (rho
0.9), adamp and sgdp (custom.py: the radial part of the update projected
out of a tensor of two or more dims whose gradient is near orthogonal to
it, and its decay damped by 0.01 there), sgd (nesterov trace) and momentum
(trace). The norms and projections of lamb, adamp and sgdp are taken over
each JAX parameter: ViT's fused qkv is three JAX tensors (`leaves`).

Everything an update reads or writes lives on the parameters' device: the
moments, the update count, lr, wd and the per-group scalars, written by the
train step with `copy_`; so an update makes no host read and can be
captured in a CUDA graph. `step(grads, keep)` takes a device bool `keep`: a
step with keep false leaves the parameters, every moment, the count and
Lookahead's slow weights and counter exactly as they were (adamw: its decay
factor is 1 and the fused step skips on `found_inf`; the others select
between the old and the new state, as JAX does).

nvnovograd, fusednovograd, adafactor and adahessian raise
NotImplementedError (ROADMAP A16 (rest)).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..config import NOT_YET_PORTED_OPTIMIZERS, PORTED_OPTIMIZERS

_ALIAS = {"fusedadamw": "adamw", "fusedsgd": "sgd", "fusedmomentum": "momentum",
          "nesterov": "sgd", "fusedadam": "adam", "fusedlamb": "lamb"}
# optimizers whose weight decay enters the gradient (the JAX _COUPLED_WD)
COUPLED_WD = {"sgd", "momentum", "adam", "nadam", "radam", "adadelta", "rmsprop", "rmsproptf"}
MOMENTUM = 0.9
RMS_DECAY = 0.9          # optax scale_by_rms(decay=0.9), torch RMSprop(alpha=0.9)
ADADELTA_RHO = 0.9       # optax scale_by_adadelta's default
LION_B2 = 0.999          # Lion(betas=(momentum, 0.999))
RADAM_THRESHOLD = 5.0
PROJ_DELTA, PROJ_WD_RATIO = 0.1, 0.01  # custom.adamp / sgdp
SGDP_EPS = 1e-8  # the JAX factory passes --opt_eps to adamp, not to sgdp
LOOKAHEAD_SYNC, LOOKAHEAD_ALPHA = 6, 0.5
# the moments of each optimizer by their torch names, with their initial
# value (the JAX names are in checkpoint/to_jax.py)
MOMENTS = {
    "adamw": ("exp_avg", "exp_avg_sq"), "adam": ("exp_avg", "exp_avg_sq"),
    "nadam": ("exp_avg", "exp_avg_sq"), "radam": ("exp_avg", "exp_avg_sq"),
    "lamb": ("exp_avg", "exp_avg_sq"), "adamp": ("exp_avg", "exp_avg_sq"),
    "lion": ("exp_avg",), "rmsprop": ("square_avg", "momentum_buffer"),
    "rmsproptf": ("square_avg", "momentum_buffer"), "adadelta": ("square_avg", "acc_delta"),
    "sgdp": ("momentum_buffer",), "sgd": ("momentum_buffer",), "momentum": ("momentum_buffer",),
}

Leaves = List[Tuple[int, int, int]]  # (start, length, JAX ndim) over a flattened parameter


def _select_(dst: Sequence[torch.Tensor], new: Sequence[torch.Tensor], keep: torch.Tensor):
    """dst = new where `keep`, else dst unchanged (bitwise)."""
    for d, n in zip(dst, new):
        d.copy_(torch.where(keep, n, d))


class Optimizer:
    """One update over all parameters, with its state on the parameters'
    device: `moments` (name -> one tensor per parameter), `count` (int32,
    the updates applied), `lr` and `weight_decay` (fp32), and with
    Lookahead `slow` (the slow weights) and `lookahead_count`. `name` is the
    routed base name; `groups` lists the parameters of each layer scale in
    `scales`, lowest first."""

    def __init__(self, name: str, params: Sequence[torch.nn.Parameter], lr: float,
                 weight_decay: float, eps: float = 1e-8, betas=(0.9, 0.999),
                 clip_grad: Optional[float] = None, layer_scales: Optional[Sequence[float]] = None,
                 leaves: Optional[Sequence[Leaves]] = None, lookahead: bool = False):
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
        init = 1.0 if name == "rmsproptf" else 0.0  # optax scale_by_rms(initial_scale)
        self.moments: Dict[str, List[torch.Tensor]] = {
            k: [torch.full_like(p, init if k == "square_avg" else 0.0) for p in self.params]
            for k in MOMENTS[name]}
        scales = [1.0] * len(self.params) if layer_scales is None else list(layer_scales)
        if len(scales) != len(self.params):
            raise ValueError(f"{len(scales)} layer scales for {len(self.params)} parameters")
        order = sorted(set(scales))
        self.groups = [[i for i, s in enumerate(scales) if s == v] for v in order]
        self.scales = torch.tensor(order, dtype=torch.float32, device=device)
        self.scale_bounds = (order[0], order[-1])
        # lr * s and 1 - lr * s * wd of each group, derived in set_hyperparams
        self.group_lr = self.scales * self.lr
        self.group_decay = 1.0 - self.group_lr * self.weight_decay
        self.leaves = ([[(0, p.numel(), p.dim())] for p in self.params]
                       if leaves is None else [list(x) for x in leaves])
        self.lookahead = lookahead
        if lookahead:
            self.slow = [p.detach().clone() for p in self.params]
            self.lookahead_count = torch.zeros((), dtype=torch.int32, device=device)

    @property
    def num_updates(self) -> int:
        """The updates applied (reads the device count: a host read)."""
        return int(self.count)

    @num_updates.setter
    def num_updates(self, n: int) -> None:
        self.count.fill_(int(n))

    def set_hyperparams(self, lr, wd) -> None:
        """Write the step's lr and wd (floats or 0-d tensors) into the device
        scalars, and each group's lr * s and 1 - lr * s * wd, in place."""
        for dst, v in ((self.lr, lr), (self.weight_decay, wd)):
            if isinstance(v, torch.Tensor):
                dst.copy_(v)
            else:
                dst.fill_(float(v))
        torch.mul(self.scales, self.lr, out=self.group_lr)
        self.group_decay.copy_(1.0 - self.group_lr * self.weight_decay)

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None,
             keep: Optional[torch.Tensor] = None) -> None:
        """One update from `grads` (default: the parameters' .grad), applied
        where the 0-d bool `keep` holds (default: always)."""
        grads = list(grads) if grads is not None else [p.grad for p in self.params]
        # a gradient laid out unlike its parameter (a conv weight's,
        # channels-last from a channels-last input) is copied to the
        # parameter's layout: the fused step walks each tensor's memory in
        # order, and the per-tensor norms index the parameter's elements
        grads = [g if g.stride() == p.stride() else torch.empty_like(p).copy_(g)
                 for g, p in zip(grads, self.params)]
        if self.clip_grad is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                self.clip_grad / norm)
            torch._foreach_mul_(grads, scale)
        if keep is None:
            keep = torch.ones((), dtype=torch.bool, device=self.count.device)
        if self.name == "adamw":
            self._adamw(grads, keep)
        else:
            if self.name in COUPLED_WD:
                grads = torch._foreach_add(grads, torch._foreach_mul(self.params,
                                                                     self.weight_decay))
            t = (self.count + 1).to(torch.float32)
            new, u = getattr(self, "_" + self.name)(grads, t)
            for k, ts in new.items():
                _select_(self.moments[k], ts, keep)
            for gi, idx in enumerate(self.groups):
                torch._foreach_mul_([u[i] for i in idx], -self.group_lr[gi])
            _select_(self.params, torch._foreach_add(self.params, u), keep)
        if self.lookahead:
            self._lookahead(keep)
        self.count.add_(keep.to(self.count.dtype))

    # ---- the cores: (new moments, update u before -lr * s) ----

    def _moment(self, name: str, grads, decay: float, order: int = 1):
        """optax update_moment(_per_elem_norm): (1 - decay) g^order + decay m."""
        g = grads if order == 1 else torch._foreach_mul(grads, grads)
        return torch._foreach_add(torch._foreach_mul(self.moments[name], decay), g,
                                  alpha=1.0 - decay)

    def _adam_moments(self, grads, t, nesterov: bool = False):
        """(m, v, m_hat, v_hat) of optax scale_by_adam at count t."""
        b1, b2 = self.betas
        m, v = self._moment("exp_avg", grads, b1), self._moment("exp_avg_sq", grads, b2, 2)
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        if nesterov:  # b1 m / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)
            m_hat = torch._foreach_add(
                torch._foreach_mul(m, b1 / (1.0 - b1 ** (t + 1))),
                torch._foreach_mul(grads, (1.0 - b1) / bc1))
        else:
            m_hat = torch._foreach_div(m, bc1)
        return m, v, m_hat, torch._foreach_div(v, bc2)

    def _adam_update(self, m_hat, v_hat):
        """m_hat / (sqrt(v_hat) + eps)."""
        return torch._foreach_div(m_hat, torch._foreach_add(torch._foreach_sqrt(v_hat), self.eps))

    def _adam(self, grads, t):
        m, v, m_hat, v_hat = self._adam_moments(grads, t)
        return {"exp_avg": m, "exp_avg_sq": v}, self._adam_update(m_hat, v_hat)

    def _nadam(self, grads, t):
        m, v, m_hat, v_hat = self._adam_moments(grads, t, nesterov=True)
        return {"exp_avg": m, "exp_avg_sq": v}, self._adam_update(m_hat, v_hat)

    def _radam(self, grads, t):
        b2 = self.betas[1]
        m, v, m_hat, v_hat = self._adam_moments(grads, t)
        # rho_t = rho_inf - 2 t b2^t / (1 - b2^t) cancels (1999 - 1994 at t =
        # 5 with b2 = 0.999): one fp32 ulp of b2^t moves it by ~0.02, so it
        # is taken in float64 (optax's fp32 reading is that far off)
        td = t.to(torch.float64)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2 ** td
        ro = ro_inf - 2 * td * b2t / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        r = r.to(torch.float32)
        rect = ro >= RADAM_THRESHOLD  # a device select: r is NaN below ro = 4
        rectified = torch._foreach_mul(self._adam_update(m_hat, v_hat), r)
        return ({"exp_avg": m, "exp_avg_sq": v},
                [torch.where(rect, a, b) for a, b in zip(rectified, m_hat)])

    def _lion(self, grads, t):
        u = torch._foreach_sign(torch._foreach_add(
            torch._foreach_mul(grads, 1.0 - MOMENTUM),
            torch._foreach_mul(self.moments["exp_avg"], MOMENTUM)))
        torch._foreach_add_(u, torch._foreach_mul(self.params, self.weight_decay))
        return {"exp_avg": self._moment("exp_avg", grads, LION_B2)}, u

    def _lamb(self, grads, t):
        m, v, m_hat, v_hat = self._adam_moments(grads, t)
        u = self._adam_update(m_hat, v_hat)
        torch._foreach_add_(u, torch._foreach_mul(self.params, self.weight_decay))
        # optax scale_by_trust_ratio over each JAX parameter: |p| / |u|, 1
        # where either norm is 0
        for p, x, leaves in zip(self.params, u, self.leaves):
            pf, xf = p.reshape(-1), x.view(-1)
            for a, n, _ in leaves:
                pn = torch.linalg.vector_norm(pf[a:a + n])
                un = torch.linalg.vector_norm(xf[a:a + n])
                ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                xf[a:a + n].mul_(ratio)
        return {"exp_avg": m, "exp_avg_sq": v}, u

    def _rmsprop(self, grads, t):
        nu = self._moment("square_avg", grads, RMS_DECAY, 2)
        if self.name == "rmsproptf":  # eps inside the root
            scaled = torch._foreach_mul(grads, torch._foreach_rsqrt(
                torch._foreach_add(nu, self.eps)))
        else:
            scaled = torch._foreach_div(grads, torch._foreach_add(torch._foreach_sqrt(nu),
                                                                  self.eps))
        trace = torch._foreach_add(scaled, torch._foreach_mul(self.moments["momentum_buffer"],
                                                              MOMENTUM))
        return {"square_avg": nu, "momentum_buffer": trace}, [x.clone() for x in trace]

    _rmsproptf = _rmsprop

    def _adadelta(self, grads, t):
        e_g = self._moment("square_avg", grads, ADADELTA_RHO, 2)
        u = torch._foreach_mul(torch._foreach_div(
            torch._foreach_sqrt(torch._foreach_add(self.moments["acc_delta"], self.eps)),
            torch._foreach_sqrt(torch._foreach_add(e_g, self.eps))), grads)
        return {"square_avg": e_g, "acc_delta": self._moment("acc_delta", u, ADADELTA_RHO, 2)}, u

    def _trace(self, grads, nesterov: bool):
        """optax trace: t = g + 0.9 t; nesterov: g + 0.9 t."""
        buf = torch._foreach_add(grads, torch._foreach_mul(self.moments["momentum_buffer"],
                                                           MOMENTUM))
        u = (torch._foreach_add(grads, torch._foreach_mul(buf, MOMENTUM)) if nesterov
             else [x.clone() for x in buf])
        return {"momentum_buffer": buf}, u

    def _sgd(self, grads, t):
        return self._trace(grads, nesterov=True)

    def _momentum(self, grads, t):
        return self._trace(grads, nesterov=False)

    def _project(self, pert, grads, wd_scale_decay: float, eps: float):
        """custom.py `_projection` over each JAX parameter of two or more
        dims, then its decay added: pert + wd * wd_scale * decay_factor * p,
        with wd_scale 0.01 where the radial part was projected out, else 1."""
        for p, g, x, leaves in zip(self.params, grads, pert, self.leaves):
            pf, gf, xf = p.reshape(-1), g.reshape(-1), x.view(-1)
            wd_scale = torch.ones_like(xf)
            for a, n, ndim in leaves:
                if ndim < 2:
                    continue
                ps, gs, xs = pf[a:a + n], gf[a:a + n], xf[a:a + n]
                p_n = ps / (torch.linalg.vector_norm(ps) + eps)
                g_n = gs / (torch.linalg.vector_norm(gs) + eps)
                cond = torch.abs(torch.dot(p_n, g_n)) < PROJ_DELTA / math.sqrt(n)
                xs.copy_(torch.where(cond, xs - p_n * torch.sum(p_n * xs), xs))
                wd_scale[a:a + n] = torch.where(cond, PROJ_WD_RATIO, 1.0)
            xf.add_(pf * wd_scale * (self.weight_decay * wd_scale_decay))
        return pert

    def _adamp(self, grads, t):
        b1 = self.betas[0]
        m, v, m_hat, v_hat = self._adam_moments(grads, t, nesterov=False)
        # custom.adamp (nesterov): (b1 m + (1 - b1) g) / bc1 / (sqrt(v / bc2) + eps)
        bc1 = 1.0 - b1 ** t
        num = torch._foreach_div(torch._foreach_add(torch._foreach_mul(m, b1), grads,
                                                    alpha=1.0 - b1), bc1)
        pert = torch._foreach_div(num, torch._foreach_add(torch._foreach_sqrt(v_hat), self.eps))
        return {"exp_avg": m, "exp_avg_sq": v}, self._project(pert, grads, 1.0, self.eps)

    def _sgdp(self, grads, t):
        buf = torch._foreach_add(torch._foreach_mul(self.moments["momentum_buffer"], MOMENTUM),
                                 grads)
        d_p = torch._foreach_add(grads, torch._foreach_mul(buf, MOMENTUM))  # nesterov
        return {"momentum_buffer": buf}, self._project(d_p, grads, 1.0 / (1.0 - MOMENTUM),
                                                       SGDP_EPS)

    def _adamw(self, grads, keep):
        """The decoupled decay as a factor a group, p *= 1 - lr * s * wd
        (exactly 1 on a skipped step, which keeps even a non-finite parameter
        as it was), then torch's fused Adam step at count + 1 with the
        group's lr * s, which leaves the parameters and both moments
        untouched when `found_inf` (not `keep`) is set."""
        decay = torch.where(keep, self.group_decay, torch.ones_like(self.group_decay))
        t = (self.count + 1).to(torch.float32)
        found_inf = (~keep).to(torch.float32)
        for gi, idx in enumerate(self.groups):
            params = [self.params[i] for i in idx]
            torch._foreach_mul_(params, decay[gi])
            torch._fused_adamw_(
                params, [grads[i] for i in idx], [self.moments["exp_avg"][i] for i in idx],
                [self.moments["exp_avg_sq"][i] for i in idx], [], [t] * len(idx),
                lr=self.group_lr[gi], beta1=self.betas[0], beta2=self.betas[1],
                weight_decay=0.0, eps=self.eps, amsgrad=False, maximize=False,
                grad_scale=None, found_inf=found_inf)

    def _lookahead(self, keep):
        """custom.lookahead after the inner update (the parameters are the
        fast weights): every LOOKAHEAD_SYNC-th applied update, slow += 0.5
        (fast - slow) and the parameters take the slow weights."""
        sync = keep & ((self.lookahead_count + 1) % LOOKAHEAD_SYNC == 0)
        for p, s in zip(self.params, self.slow):
            s.copy_(torch.where(sync, s + LOOKAHEAD_ALPHA * (p - s), s))
            p.copy_(torch.where(sync, s, p))
        self.lookahead_count.add_(keep.to(self.lookahead_count.dtype))


def route(opt: str) -> Tuple[str, bool]:
    """(base name, lookahead) of an --opt value, as the JAX factory routes
    it: the part after the last "_" (fused* aliases resolved), wrapped in
    Lookahead with a "lookahead_" prefix. Raises NotImplementedError for a
    name of the JAX table not ported yet, ValueError for an unknown one."""
    parts = opt.lower().split("_")
    base = parts[-1]
    if base in NOT_YET_PORTED_OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {opt!r} is not ported to imageclassification_tpu_torch yet "
            f"(ROADMAP A16 (rest)); ported: {sorted(PORTED_OPTIMIZERS)}")
    if base not in PORTED_OPTIMIZERS:
        raise ValueError(f"Invalid optimizer: {opt}")
    return _ALIAS.get(base, base), len(parts) > 1 and parts[0] == "lookahead"


def create_optimizer(opt: str, params: Iterable[torch.nn.Parameter], lr: float,
                     weight_decay: float, opt_eps: float = 1e-8, opt_betas=None,
                     clip_grad: Optional[float] = None,
                     layer_scales: Optional[Sequence[float]] = None,
                     leaves: Optional[Sequence[Leaves]] = None) -> Optimizer:
    """Name-routed factory. `layer_scales`: each parameter's lr scale
    (`layer_decay.layer_decay_scales`); `leaves`: each parameter's JAX
    tensors as (start, length, ndim) over it flattened
    (`checkpoint.to_jax.jax_leaves`), which lamb, adamp and sgdp take their
    norms over (default: each parameter one tensor of its own dims)."""
    base, lookahead = route(opt)
    betas = tuple(opt_betas) if opt_betas else (0.9, 0.999)
    return Optimizer(base, params, lr, weight_decay, eps=opt_eps, betas=betas,
                     clip_grad=clip_grad, layer_scales=layer_scales, leaves=leaves,
                     lookahead=lookahead)
