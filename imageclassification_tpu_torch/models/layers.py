"""Shared model building blocks (port of imageclassification_tpu/models/layers.py).

Precision plan (the JAX package's `half_precision=True`): parameters stay
fp32, compute runs in the module's `dtype` (weights cast at use, as flax's
`dtype` vs `param_dtype`), LayerNorm statistics are taken in fp32 and the
result cast back to `dtype`.

Randomness (dropout, stochastic depth, init) takes an explicit
`torch.Generator`; a training-mode forward that needs random draws and has
no generator raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

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


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """`layer(x)` computed in `dtype` (fp32 params cast at use)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


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
