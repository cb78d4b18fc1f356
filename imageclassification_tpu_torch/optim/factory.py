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

The rest of the table (optax 0.2 and `custom.py`, each over the JAX
tensors, taken as views of the parameters in JAX axis order, `leaf_view`):
* nvnovograd (and its alias fusednovograd): optax `scale_by_novograd(b1
  0.95, b2 0.98)` with the decay inside: nu is one scalar a JAX tensor, the
  EMA of its squared gradient norm; m = 0.95 m + g / (sqrt(nu) + eps) + wd
  p; at the first update (a device select on the count) nu = |g|^2 and m
  has no decayed term;
* adafactor: optax `adafactor(lr, weight_decay_rate=wd)` with its defaults:
  the second moment factored into row and column means on a JAX tensor
  whose two largest dims are at least 128 (decided on the JAX shape), else
  kept whole, with decay 1 - t^-0.8 and eps 1e-30; the scaled gradient
  clipped to block RMS 1, times lr and max(RMS(p), 1e-3), plus wd p; lr
  is applied inside, so a layer scale multiplies the whole update;
* adahessian: `custom.scale_by_adahessian` (adam's moments over the
  gradient and the Hutchinson Hessian diagonal that the train step passes,
  `step(..., hessian=)`, averaged in |.| over the two spatial dims of a 4-D
  JAX tensor), then the decoupled decay wd p.
Their states are kept in the optax layout: nvnovograd's nu and adafactor's
v_row, v_col and v as one flat tensor a parameter of the JAX tensors'
states in turn (`leaf_states`).

Everything an update reads or writes lives on the parameters' device: the
moments, the update count, lr, wd and the per-group scalars, written by the
train step with `copy_`; so an update makes no host read and can be
captured in a CUDA graph. `step(grads, keep)` takes a device bool `keep`: a
step with keep false leaves the parameters, every moment, the count and
Lookahead's slow weights and counter exactly as they were (adamw: its decay
factor is 1 and the fused step skips on `found_inf`; the others select
between the old and the new state, as JAX does).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PORTED_OPTIMIZERS

_ALIAS = {"fusedadamw": "adamw", "fusedsgd": "sgd", "fusedmomentum": "momentum",
          "nesterov": "sgd", "fusedadam": "adam", "fusedlamb": "lamb",
          "fusednovograd": "nvnovograd"}
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
NOVOGRAD_BETAS = (0.95, 0.98)  # the JAX factory's scale_by_novograd(b1, b2)
# optax.adafactor's defaults
FACTOR_MIN_DIM, FACTOR_DECAY, FACTOR_EPS, FACTOR_CLIP, FACTOR_MIN_SCALE = 128, 0.8, 1e-30, 1.0, 1e-3
# the optimizers whose update takes each JAX tensor apart (`leaves`)
LEAFWISE = {"lamb", "adamp", "sgdp", "nvnovograd", "adafactor", "adahessian"}
# the moments of each optimizer by their torch names, with their initial
# value (the JAX names are in checkpoint/to_jax.py)
MOMENTS = {
    "adamw": ("exp_avg", "exp_avg_sq"), "adam": ("exp_avg", "exp_avg_sq"),
    "nadam": ("exp_avg", "exp_avg_sq"), "radam": ("exp_avg", "exp_avg_sq"),
    "lamb": ("exp_avg", "exp_avg_sq"), "adamp": ("exp_avg", "exp_avg_sq"),
    "lion": ("exp_avg",), "rmsprop": ("square_avg", "momentum_buffer"),
    "rmsproptf": ("square_avg", "momentum_buffer"), "adadelta": ("square_avg", "acc_delta"),
    "sgdp": ("momentum_buffer",), "sgd": ("momentum_buffer",), "momentum": ("momentum_buffer",),
    "nvnovograd": ("exp_avg", "grad_norm_sq"), "adafactor": ("v_row", "v_col", "v"),
    "adahessian": ("exp_avg", "exp_avg_hessian"),
}


class JaxLeaf(NamedTuple):
    """One JAX tensor of a parameter: its JAX name (None where unknown), and
    the offset and strides over the parameter's C-contiguous elements that
    view it in JAX axis order (`checkpoint.to_jax.jax_leaves`)."""

    key: Optional[str]
    offset: int
    shape: Tuple[int, ...]
    stride: Tuple[int, ...]

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))


Leaves = List[JaxLeaf]


def leaf_view(t: torch.Tensor, leaf: JaxLeaf) -> torch.Tensor:
    """The JAX tensor `leaf` of `t` (a C-contiguous tensor shaped like its
    parameter) as a view in JAX axis order."""
    flat = t.view(-1)
    return flat.as_strided(leaf.shape, leaf.stride, flat.storage_offset() + leaf.offset)


def own_leaves(p: torch.Tensor) -> Leaves:
    """A parameter as one JAX tensor of its own shape."""
    return [JaxLeaf(None, 0, tuple(p.shape), tuple(p.stride()))]


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's `_factored_dims`: the axes of the second largest and the
    largest dim, where the second largest is at least FACTOR_MIN_DIM."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < FACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def leaf_states(name: str, leaf: JaxLeaf) -> Dict[str, Tuple[int, ...]]:
    """The JAX shapes of a JAX tensor's per-tensor states under optimizer
    `name`: nvnovograd's nu a scalar, adafactor's v_row, v_col and v as
    optax lays them out; {} for the others (moments shaped like the
    parameter)."""
    if name == "nvnovograd":
        return {"grad_norm_sq": ()}
    if name != "adafactor":
        return {}
    dims = factored_dims(leaf.shape)
    if dims is None:
        return {"v_row": (1,), "v_col": (1,), "v": leaf.shape}
    d1, d0 = dims
    shape = list(leaf.shape)
    return {"v_row": tuple(shape[:d0] + shape[d0 + 1:]),
            "v_col": tuple(shape[:d1] + shape[d1 + 1:]), "v": (1,)}


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
    `scales`, lowest first. adamw takes a `decay_mask` (one bool a
    parameter; optax `add_decayed_weights(mask=)`): the parameters where it
    is False are not decayed, and each scale then has a group of each."""

    def __init__(self, name: str, params: Sequence[torch.nn.Parameter], lr: float,
                 weight_decay: float, eps: float = 1e-8, betas=(0.9, 0.999),
                 clip_grad: Optional[float] = None, layer_scales: Optional[Sequence[float]] = None,
                 leaves: Optional[Sequence[Leaves]] = None, lookahead: bool = False,
                 decay_mask: Optional[Sequence[bool]] = None):
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
        self.leaves = ([own_leaves(p) for p in self.params]
                       if leaves is None else [list(x) for x in leaves])
        # the per-JAX-tensor states: (offset, JAX shape) of each in its
        # parameter's flat state tensor, by state
        self.leaf_layout = {k: [] for k in MOMENTS[name]}
        for pl in self.leaves:
            sizes = [leaf_states(name, leaf) for leaf in pl]
            for k in {k for st in sizes for k in st}:
                offsets = np.cumsum([0] + [int(np.prod(st[k], dtype=np.int64)) for st in sizes])
                self.leaf_layout[k].append([(int(o), st[k]) for o, st in zip(offsets, sizes)])
        init = 1.0 if name == "rmsproptf" else 0.0  # optax scale_by_rms(initial_scale)
        self.moments: Dict[str, List[torch.Tensor]] = {
            k: ([torch.full_like(p, init if k == "square_avg" else 0.0) for p in self.params]
                if not self.leaf_layout[k] else
                [p.new_zeros(int(sum(np.prod(s, dtype=np.int64) for _, s in lay)))
                 for p, lay in zip(self.params, self.leaf_layout[k])])
            for k in MOMENTS[name]}
        scales = [1.0] * len(self.params) if layer_scales is None else list(layer_scales)
        if len(scales) != len(self.params):
            raise ValueError(f"{len(scales)} layer scales for {len(self.params)} parameters")
        masked = [True] * len(self.params) if decay_mask is None else [bool(m) for m in decay_mask]
        if len(masked) != len(self.params):
            raise ValueError(f"{len(masked)} decay mask entries for {len(self.params)} parameters")
        if decay_mask is not None and name != "adamw":
            raise ValueError(f"a weight decay mask is taken by adamw only, not {name}")
        # a group for each (scale, decayed) pair; without a mask, one a scale
        order = sorted(set(zip(scales, masked)))
        self.groups = [[i for i, key in enumerate(zip(scales, masked)) if key == v] for v in order]
        self.scales = torch.tensor([s for s, _ in order], dtype=torch.float32, device=device)
        self.decayed = torch.tensor([float(m) for _, m in order], dtype=torch.float32,
                                    device=device)
        self.scale_bounds = (order[0][0], order[-1][0])
        # lr * s and 1 - lr * s * wd (1 where the mask says no decay) of each
        # group, derived in set_hyperparams
        self.group_lr = self.scales * self.lr
        self.group_decay = 1.0 - self.group_lr * self.weight_decay * self.decayed
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
        self.group_decay.copy_(1.0 - self.group_lr * self.weight_decay * self.decayed)

    def leaf_state(self, k: str, i: int, j: int) -> torch.Tensor:
        """Parameter i's JAX tensor j's state `k` (a view in its JAX shape)."""
        offset, shape = self.leaf_layout[k][i][j]
        return self.moments[k][i][offset:offset + int(np.prod(shape, dtype=np.int64))].view(shape)

    def _like_params(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor in its parameter's layout (a conv weight's gradient
        comes channels-last from a channels-last input): the fused step walks
        each tensor's memory in order, and the per-tensor views index the
        parameter's elements."""
        return [t if t.stride() == p.stride() else torch.empty_like(p).copy_(t)
                for t, p in zip(ts, self.params)]

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None,
             keep: Optional[torch.Tensor] = None,
             hessian: Optional[Sequence[torch.Tensor]] = None) -> None:
        """One update from `grads` (default: the parameters' .grad), applied
        where the 0-d bool `keep` holds (default: always). adahessian takes
        the Hutchinson estimate of the Hessian diagonal, one tensor a
        parameter, as `hessian`."""
        grads = self._like_params(list(grads) if grads is not None
                                  else [p.grad for p in self.params])
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
            if self.name == "adahessian":
                if hessian is None:
                    raise ValueError("adahessian needs the Hessian diagonal (`hessian`), which "
                                     "the train step computes for it")
                new, u = self._adahessian(grads, t, self._like_params(hessian))
            else:
                new, u = getattr(self, "_" + self.name)(grads, t)
            for k, ts in new.items():
                _select_(self.moments[k], ts, keep)
            # adafactor applies lr inside its chain: the layer scale alone
            factor = self.scales if self.name == "adafactor" else self.group_lr
            for gi, idx in enumerate(self.groups):
                torch._foreach_mul_([u[i] for i in idx], -factor[gi])
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
            for leaf in leaves:
                pn = torch.linalg.vector_norm(leaf_view(p, leaf))
                xs = leaf_view(x, leaf)
                un = torch.linalg.vector_norm(xs)
                ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                xs.mul_(ratio)
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
            wd_scale = torch.ones_like(x)
            for leaf in leaves:
                if len(leaf.shape) < 2:
                    continue
                ps, gs, xs = (leaf_view(t, leaf) for t in (p, g, x))
                p_n = ps / (torch.linalg.vector_norm(ps) + eps)
                g_n = gs / (torch.linalg.vector_norm(gs) + eps)
                cond = torch.abs(torch.sum(p_n * g_n)) < PROJ_DELTA / math.sqrt(leaf.numel)
                xs.copy_(torch.where(cond, xs - p_n * torch.sum(p_n * xs), xs))
                leaf_view(wd_scale, leaf).copy_(
                    torch.where(cond, PROJ_WD_RATIO, 1.0).expand(leaf.shape))
            x.add_(p * wd_scale * (self.weight_decay * wd_scale_decay))
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

    def _nvnovograd(self, grads, t):
        """optax scale_by_novograd over each JAX tensor: nu its squared
        gradient norm's EMA, m = b1 m + g / (sqrt(nu) + eps) + wd p; at the
        first update nu = |g|^2 and m holds no decayed term."""
        b1, b2 = NOVOGRAD_BETAS
        first = self.count == 0
        mus, nus = [], []
        for i, (p, g, leaves) in enumerate(zip(self.params, grads, self.leaves)):
            mu_add = torch.empty_like(g)
            nu = torch.empty_like(self.moments["grad_norm_sq"][i])
            for j, leaf in enumerate(leaves):
                gs = leaf_view(g, leaf)
                sq = torch.linalg.vector_norm(gs) ** 2
                old = self.leaf_state("grad_norm_sq", i, j)
                n_j = torch.where(first, sq, (1.0 - b2) * sq + b2 * old)
                nu[self.leaf_layout["grad_norm_sq"][i][j][0]] = n_j
                leaf_view(mu_add, leaf).copy_(gs / (torch.sqrt(n_j) + self.eps))
            mu_add.add_(p * self.weight_decay)
            mus.append(torch.where(first, mu_add, b1 * self.moments["exp_avg"][i] + mu_add))
            nus.append(nu)
        return {"exp_avg": mus, "grad_norm_sq": nus}, [m.clone() for m in mus]

    def _adafactor(self, grads, t):
        """optax adafactor over each JAX tensor (module docstring); u is the
        whole update before the sign, lr included."""
        decay = 1.0 - t ** -FACTOR_DECAY
        new = {k: [torch.zeros_like(m) for m in self.moments[k]] for k in MOMENTS["adafactor"]}
        us = []
        for i, (p, g, leaves) in enumerate(zip(self.params, grads, self.leaves)):
            u = torch.empty_like(g)
            for j, leaf in enumerate(leaves):
                gs = leaf_view(g, leaf)
                sq = gs * gs + FACTOR_EPS
                dims = factored_dims(leaf.shape)
                state = {k: self.leaf_state(k, i, j) for k in MOMENTS["adafactor"]}
                out = {k: new[k][i][o:o + int(np.prod(shape, dtype=np.int64))].view(shape)
                       for k in MOMENTS["adafactor"]
                       for o, shape in [self.leaf_layout[k][i][j]]}
                if dims is not None:
                    d1, d0 = dims
                    v_row = decay * state["v_row"] + (1.0 - decay) * sq.mean(d0)
                    v_col = decay * state["v_col"] + (1.0 - decay) * sq.mean(d1)
                    row_mean = v_row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
                    x = (gs * ((v_row / row_mean) ** -0.5).unsqueeze(d0)
                         * (v_col ** -0.5).unsqueeze(d1))
                    out["v_row"].copy_(v_row)
                    out["v_col"].copy_(v_col)
                else:
                    v = decay * state["v"] + (1.0 - decay) * sq
                    x = gs * v ** -0.5
                    out["v"].copy_(v)
                # clip_by_block_rms, the lr, scale_by_param_block_rms, the decay
                x = x / torch.clamp(torch.sqrt(torch.mean(x * x)) / FACTOR_CLIP, min=1.0)
                ps = leaf_view(p, leaf)
                x = x * self.lr * torch.clamp(torch.sqrt(torch.mean(ps * ps)),
                                              min=FACTOR_MIN_SCALE)
                leaf_view(u, leaf).copy_(x + self.weight_decay * ps)
            us.append(u)
        return new, us

    def _adahessian(self, grads, t, hessian):
        """custom.scale_by_adahessian, then the decoupled decay: adam's
        moments over g and the Hessian diagonal d (|d| averaged over the
        spatial dims of a 4-D JAX tensor), (m / c1) / ((v / c2)^(1/2) + eps)
        + wd p."""
        b1, b2 = self.betas
        d = []
        for h, leaves in zip(hessian, self.leaves):
            if all(len(leaf.shape) != 4 for leaf in leaves):
                d.append(h)
                continue
            dh = h.clone()
            for leaf in leaves:
                if len(leaf.shape) == 4:  # flax HWIO: the spatial dims lead
                    hs = leaf_view(h, leaf)
                    leaf_view(dh, leaf).copy_(
                        hs.abs().mean(dim=(0, 1), keepdim=True).expand(leaf.shape))
            d.append(dh)
        m = self._moment("exp_avg", grads, b1)
        v = torch._foreach_add(torch._foreach_mul(self.moments["exp_avg_hessian"], b2),
                               torch._foreach_mul(torch._foreach_mul(d, d), 1.0 - b2))
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        u = torch._foreach_div(torch._foreach_div(m, c1), torch._foreach_add(
            torch._foreach_pow(torch._foreach_div(v, c2), 0.5), self.eps))
        torch._foreach_add_(u, torch._foreach_mul(self.params, self.weight_decay))
        return {"exp_avg": m, "exp_avg_hessian": v}, u

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
    Lookahead with a "lookahead_" prefix. Raises ValueError for a name that
    is not in the table."""
    parts = opt.lower().split("_")
    base = parts[-1]
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
    tensors as `JaxLeaf`s (`checkpoint.to_jax.jax_leaves`), which the
    `LEAFWISE` optimizers take apart (default: each parameter one tensor of
    its own shape)."""
    base, lookahead = route(opt)
    betas = tuple(opt_betas) if opt_betas else (0.9, 0.999)
    return Optimizer(base, params, lr, weight_decay, eps=opt_eps, betas=betas,
                     clip_grad=clip_grad, layer_scales=layer_scales, leaves=leaves,
                     lookahead=lookahead)
