"""Shared model building blocks (port of imageclassification_tpu/models/layers.py).

Precision plan (the JAX package's `half_precision=True`): parameters stay
fp32, compute runs in the module's `dtype` (weights cast at use, as flax's
`dtype` vs `param_dtype`), LayerNorm statistics are taken in fp32 and the
result cast back to `dtype`.

Convolutions take NHWC activations, as the JAX models do, and run on a
channels-first view of them (`conv2d_nhwc`). BatchNorm (`BatchNorm`) keeps
flax's semantics: fp32 batch statistics with the biased variance, a running
average with momentum 0.9, and no buffer update inside the forward (the
train step commits the statistics, `commit_batch_stats`, gated on the
device by the loss's finiteness).

Randomness (dropout, stochastic depth, init) takes an explicit
`torch.Generator`; a training-mode forward that needs random draws and has
no generator raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated_normal(stddev) divides by the std of a unit normal
# truncated to [-2, 2], so the truncated draw has exactly `stddev`
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax `truncated_normal(stddev, lower=-2, upper=2)` initializer."""
    s = std / _TRUNC_STD
    return nn.init.trunc_normal_(t, std=s, a=-2.0 * s, b=2.0 * s, generator=generator)


def make_divisible(v: float, divisor: int = 8) -> int:
    """Round to the nearest multiple of `divisor`, never dropping more than
    10 % (torchvision's `_make_divisible`, timm's `round_channels`)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """`layer(x)` computed in `dtype` (fp32 params cast at use)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def init_conv_(conv: nn.Conv2d, generator: torch.Generator, std: float = 0.02) -> None:
    """flax `nn.Conv(kernel_init=truncated_normal_init(std))`: a truncated
    normal kernel of std `std` (not scaled by fan-in), zero bias."""
    trunc_normal_(conv.weight, std=std, generator=generator)
    nn.init.zeros_(conv.bias)


def he_normal_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """flax `he_normal()`: a truncated normal of std sqrt(2 / fan_in), fan_in
    = kh * kw * (input channels per group)."""
    fan_in = conv.weight[0].numel()
    trunc_normal_(conv.weight, std=(2.0 / fan_in) ** 0.5, generator=generator)


def lecun_normal_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """flax `lecun_normal()` (nn.Conv's default kernel init): a truncated
    normal of std sqrt(1 / fan_in), fan_in as in `he_normal_`."""
    fan_in = conv.weight[0].numel()
    trunc_normal_(conv.weight, std=(1.0 / fan_in) ** 0.5, generator=generator)


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Conv(dtype=dtype)` on NHWC `x` with `conv`'s fp32 parameters
    cast at use: the convolution runs on a channels-first view of x (which is
    channels_last in memory, so nothing is copied), and the bias, where the
    conv has one, is added in `dtype` after it, as flax adds it. Returns NHWC."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype), None,
                 stride=conv.stride, padding=conv.padding, groups=conv.groups)
    y = y.permute(0, 2, 3, 1)
    return y if conv.bias is None else y + conv.bias.to(dtype)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)` over the
    last (channel) axis of NHWC x: fp32 `weight`/`bias` (JAX scale/bias) and
    fp32 `running_mean`/`running_var` buffers (JAX batch_stats mean/var).

    Train mode normalises with the batch statistics, taken in fp32 with the
    biased variance, and keeps them in `batch_stats` (detached) without
    touching the buffers: the train step commits them (`commit_batch_stats`)
    only on a finite step, and the exact-mode accuracy forward's are thrown
    away. Eval mode normalises with the buffers. The output is (x - mean) *
    rsqrt(var + eps) * weight + bias in fp32, returned in x's dtype."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.momentum, self.eps = momentum, eps
        self.batch_stats = None  # (mean, var) of the last train-mode forward

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.permute(0, 3, 1, 2)  # channels-first view, channels_last in memory
        if not self.training:
            y = F.batch_norm(xc, self.running_mean, self.running_var, self.weight, self.bias,
                             training=False, eps=self.eps)
            return y.permute(0, 2, 3, 1)
        # the statistics of native_batch_norm: the batch mean and the inverse
        # standard deviation of the biased variance, both fp32
        y, mean, invstd = torch.native_batch_norm(xc, self.weight, self.bias, None, None,
                                                  True, 0.0, self.eps)
        self.batch_stats = (mean.detach(), invstd.detach().pow(-2) - self.eps)
        return y.permute(0, 2, 3, 1)


def _batch_norms(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


def batch_norm_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The running statistics of every BatchNorm of `model` by state_dict
    name (the JAX `batch_stats`); empty for a model without BatchNorm."""
    return {f"{name}.{k}" if name else k: t
            for name, m in model.named_modules() if isinstance(m, BatchNorm)
            for k, t in (("running_mean", m.running_mean), ("running_var", m.running_var))}


@torch.no_grad()
def commit_batch_stats(model: nn.Module, finite: Optional[torch.Tensor] = None) -> None:
    """running <- momentum * running + (1 - momentum) * batch for every
    BatchNorm of `model` that holds the statistics of a train-mode forward
    (flax's update), then drop them. With a 0-d bool `finite` the new
    statistics are taken only where it holds, on the device (the train
    step's gate on a non-finite loss, as JAX's select): no host read."""
    bns = [m for m in _batch_norms(model) if m.batch_stats is not None]
    if not bns:
        return
    running = [t for m in bns for t in (m.running_mean, m.running_var)]
    batch = [t for m in bns for t in m.batch_stats]
    momentum = bns[0].momentum  # 0.9 in every BatchNorm of the registry's models
    new = torch._foreach_mul(running, momentum)
    torch._foreach_add_(new, torch._foreach_mul(batch, 1.0 - momentum))
    if finite is not None:
        new = [torch.where(finite, n, r) for n, r in zip(new, running)]
    torch._foreach_copy_(running, new)
    clear_batch_stats(model)


def clear_batch_stats(model: nn.Module) -> None:
    """Drop the batch statistics a train-mode forward left in the
    BatchNorms of `model`, uncommitted."""
    for m in _batch_norms(model):
        m.batch_stats = None


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with fp32 statistics and fp32 affine, result in `dtype`."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


def _need(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("a training-mode forward with dropout needs a torch.Generator")
    return generator


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            mask_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Inverted dropout with a keep mask of `mask_shape` (default: x's shape)
    broadcast over x."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = tuple(mask_shape) if mask_shape is not None else x.shape
    mask = torch.rand(shape, generator=_need(generator), device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth per sample (timm DropPath: scale kept samples by 1/keep)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        return dropout(x, self.rate, generator, (x.shape[0],) + (1,) * (x.ndim - 1))


class Mlp(nn.Module):
    """Transformer MLP: Linear -> exact (erf) GELU -> dropout -> Linear -> dropout."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: Optional[int] = None,
                 drop_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim or in_dim)
        self.drop_rate = drop_rate
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        for fc in (self.fc1, self.fc2):
            trunc_normal_(fc.weight, generator=generator)
            nn.init.zeros_(fc.bias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        rate = self.drop_rate if self.training else 0.0
        x = F.gelu(linear(x, self.fc1, self.dtype))
        x = dropout(x, rate, generator)
        x = linear(x, self.fc2, self.dtype)
        return dropout(x, rate, generator)


def drop_path_rates(drop_path_rate: float, depths: Sequence[int]):
    """Linearly increasing per-block stochastic-depth rates, split per stage."""
    total = sum(depths)
    rates = [float(drop_path_rate) * i / max(total - 1, 1) for i in range(total)]
    out, k = [], 0
    for d in depths:
        out.append(rates[k : k + d])
        k += d
    return out
