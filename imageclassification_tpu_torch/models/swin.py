"""Swin Transformer (port of imageclassification_tpu/models/swin.py): timm's
`swin_{tiny,small,base}_patch4_window7_224`.

NHWC activations as in the JAX model. Module and parameter names follow
timm's classic layout, so a hub state_dict's keys are the port's (less its
`relative_position_index` and `attn_mask` buffers): `patch_embed.proj`,
`patch_embed.norm`, `layers.{s}.blocks.{b}.{norm1,attn.qkv,attn.proj,
attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}`,
`layers.{s}.downsample.{norm,reduction}` (the PatchMerging at the end of
stage s, the JAX `merge{s}`), `norm`, `head`, and with `features_only` the
per-stage out norms `norm{s}`. checkpoint/from_jax.py maps the JAX
parameters onto them.

One dataflow: the JAX package's default `attn_layout="merged"` is a TPU
layout of the same function as its per-window `"legacy"` path (its tests
hold them equal), so the port runs the per-window path for both and
accepts `attn_layout` only to keep the checkpoint's model_spec. The window
attention is plain torch ops (matmul, softmax), as the JAX model runs
einsums: no kernel of the port. The relative-position bias is a one-hot
matmul over the (2w-1)^2 table, as in JAX (its backward is a dense product,
not a scatter). The shift mask is static for a feature map; it is made once
a device and map size (on the first, eager, call: never inside a CUDA
graph's capture).

Kept from the JAX model: windows clamp to the map (and drop the shift)
where one window covers it, `check_input_size`'s errors for inputs whose
stages do not divide into windows, LayerNorms with fp32 statistics, exact
GELU, the spatial mean in the compute dtype and an fp32 head. A clamped
window has a smaller bias table, so the port sizes its tables from
`img_size` (the classification sizes, 224 * 2^k, clamp nowhere). Init:
truncated normal 0.02 weights and bias tables, zero biases, LayerNorm
ones/zeros, a zero head.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import (DropPath, Mlp, conv2d_nhwc, dropout, drop_path_rates, layer_norm, linear,
                     trunc_normal_)


@lru_cache(maxsize=None)
def relative_position_index(w: int) -> np.ndarray:
    """[w^2, w^2] index into the (2w-1)^2 relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return (rel[:, :, 0] * (2 * w - 1) + rel[:, :, 1]).astype(np.int64)


@lru_cache(maxsize=None)
def shift_attn_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """[nW, w^2, w^2] additive mask, -100 between positions of different
    regions of the shifted map."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return np.where(wins[:, None, :] != wins[:, :, None], -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // w, w, W // w, w, C).transpose(2, 3).reshape(-1, w * w, C)


def window_reverse(x: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    B = x.shape[0] // (H // w * W // w)
    return x.reshape(B, H // w, W // w, w, w, -1).transpose(2, 3).reshape(B, H, W, -1)


def check_input_size(size: int, window: int, n_stages: int = 4) -> None:
    """Raise ValueError unless `size` runs through every stage: each stage's
    map (size / 4, halved before stages 1..n-1) divides into windows where
    it is larger than one, and is even wherever it is merged."""

    def ok(h: int) -> bool:
        if h % 4:
            return False
        m = h // 4
        for s in range(n_stages):
            if s > 0:
                if m % 2:
                    return False
                m //= 2
            if m > window and m % window:
                return False
        return True

    if not ok(size):
        valid = [s for s in range(window * 4, 8 * 224 + 1) if ok(s)]
        raise ValueError(
            f"input size {size} unsupported by Swin with window {window}: "
            f"every stage's feature map must divide into {window}-windows "
            f"(or fit in one) and be even when PatchMerging halves it. "
            f"Supported sizes ≤ {8 * 224}: {valid}"
        )


def _window_and_shift(H: int, W: int, window: int, shift: int) -> Tuple[int, int]:
    """A block's window and shift on an H x W map: one window covering the
    map clamps to it and drops the shift."""
    if H <= window and W <= window:
        return min(H, W), 0
    if H % window or W % window:
        raise ValueError(f"feature map {H}x{W} not divisible by window {window}")
    return window, shift


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias: one qkv Linear (3C), a proj
    Linear, a [(2w-1)^2, heads] bias table."""

    def __init__(self, dim: int, num_heads: int, window: int, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.window, self.dtype = num_heads, window, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        idx = relative_position_index(window).reshape(-1)
        onehot = np.zeros((idx.size, (2 * window - 1) ** 2), np.float32)
        onehot[np.arange(idx.size), idx] = 1.0
        self.register_buffer("relative_position_onehot", torch.from_numpy(onehot),
                             persistent=False)

    def bias(self, dtype: torch.dtype) -> torch.Tensor:
        """[heads, w^2, w^2] in `dtype`: the one-hot matmul over the table."""
        n = self.window ** 2
        b = self.relative_position_onehot.to(dtype) @ self.relative_position_bias_table.to(dtype)
        return b.reshape(n, n, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B * nW, w^2, C] windows; mask: [nW, w^2, w^2] or None."""
        B_, N, C = x.shape
        h = self.num_heads
        hd = C // h
        qkv = linear(x, self.qkv, self.dtype).reshape(B_, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q * (hd ** -0.5), k.transpose(-1, -2))
        bias = self.bias(attn.dtype)
        if mask is not None:
            # the bias and the mask folded into one add, as in JAX
            nW = mask.shape[0]
            combined = bias[None] + mask.to(attn.dtype)[:, None]
            attn = (attn.reshape(B_ // nW, nW, h, N, N) + combined[None]).reshape(B_, h, N, N)
        else:
            attn = attn + bias[None]
        attn = torch.softmax(attn, dim=-1)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(B_, N, C)
        return linear(y, self.proj, self.dtype)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int = 0,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0, drop_path: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.window, self.shift, self.dtype = window, shift, dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop_rate=drop_rate, dtype=dtype)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, H: int, W: int, w: int, shift: int, device) -> torch.Tensor:
        key = (H, W, w, shift, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shift_attn_mask(H, W, w, shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        B, H, W, C = x.shape
        w, shift = _window_and_shift(H, W, self.window, self.shift)
        if w != self.attn.window:
            raise ValueError(f"a {H}x{W} map runs {w}-windows; the block was built for "
                             f"{self.attn.window} (img_size)")
        y = layer_norm(x, self.norm1, self.dtype)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = self._mask(H, W, w, shift, x.device) if shift else None
        y = window_reverse(self.attn(window_partition(y, w), mask), w, H, W)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self.drop_path(y, generator)
        y = self.mlp(layer_norm(x, self.norm2, self.dtype), generator)
        return x + self.drop_path(y, generator)


class PatchMerging(nn.Module):
    """2x2 neighbourhood concatenated (4C, timm's order) -> LayerNorm ->
    Linear 4C -> 2C without bias."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        y = layer_norm(y, self.norm, self.dtype)
        return linear(y, self.reduction, self.dtype)


class SwinStage(nn.Module):
    """A stage's blocks, then (but for the last stage) its PatchMerging."""

    def __init__(self, blocks: Sequence[SwinBlock], downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 4, stride=4)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(conv2d_nhwc(x.to(self.dtype), self.proj, self.dtype), self.norm,
                          self.dtype)


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 num_classes: int = 1000, drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 features_only: bool = False, out_indices: Sequence[int] = (0, 1, 2, 3),
                 attn_layout: str = "merged", img_size: int = 224, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attn_layout not in ("merged", "legacy"):
            raise ValueError(f"attn_layout {attn_layout!r}: 'merged' or 'legacy'")
        self.depths, self.window, self.dtype = tuple(depths), window, dtype
        self.features_only, self.out_indices = features_only, tuple(out_indices)
        self.attn_layout, self.drop_rate = attn_layout, drop_rate
        self.patch_embed = PatchEmbed(embed_dim, dtype)
        rates = drop_path_rates(drop_path_rate, self.depths)
        m = img_size // 4
        stages = []
        for s, depth in enumerate(self.depths):
            dim = embed_dim * 2 ** s
            if s > 0:
                m //= 2
            w = max(m, 1) if m <= window else window  # the clamp of `_window_and_shift`
            blocks = [SwinBlock(dim, num_heads[s], w, shift=0 if b % 2 == 0 else window // 2,
                                drop_rate=drop_rate, drop_path=rates[s][b], dtype=dtype)
                      for b in range(depth)]
            last = s == len(self.depths) - 1
            stages.append(SwinStage(blocks, None if last else PatchMerging(dim, dtype)))
        self.layers = nn.ModuleList(stages)
        dim = embed_dim * 2 ** (len(self.depths) - 1)
        if features_only:
            for s in self.out_indices:
                self.add_module(f"norm{s}", nn.LayerNorm(embed_dim * 2 ** s, eps=1e-5))
        else:
            self.norm = nn.LayerNorm(dim, eps=1e-5)
            self.head = nn.Linear(dim, num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initializers: truncated normal 0.02 kernels and
        bias tables, zero biases, LayerNorm ones and zeros, a zero head."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                trunc_normal_(m.weight, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                trunc_normal_(m.relative_position_bias_table, generator=generator)
        if not self.features_only:
            nn.init.zeros_(self.head.weight)
            nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x: [B, H, W, 3] float (NHWC). Returns fp32 logits [B, num_classes],
        or with `features_only` the out norms' NHWC maps at strides 4-32;
        `generator` draws dropout and stochastic-depth masks in training."""
        for size in (x.shape[1], x.shape[2]):
            check_input_size(size, self.window, len(self.depths))
        x = self.patch_embed(x)
        if self.training:
            x = dropout(x, self.drop_rate, generator)
        features = []
        for s, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x, generator)
            if self.features_only and s in self.out_indices:
                features.append(layer_norm(x, getattr(self, f"norm{s}"), self.dtype))
            if stage.downsample is not None:
                x = stage.downsample(x)
        if self.features_only:
            return features
        x = layer_norm(x, self.norm, self.dtype).mean(dim=(1, 2))
        return linear(x, self.head, torch.float32)


def _make(dim, depths, heads):
    def ctor(num_classes=1000, dtype=torch.float32, drop_path_rate=0.0, drop_rate=0.0,
             features_only=False, out_indices=(0, 1, 2, 3), attn_layout="merged",
             img_size=224, generator=None, **kw):
        del kw  # other families' kwargs, ignored as in JAX
        return SwinTransformer(embed_dim=dim, depths=depths, num_heads=heads,
                               num_classes=num_classes, drop_rate=drop_rate,
                               drop_path_rate=drop_path_rate, features_only=features_only,
                               out_indices=out_indices, attn_layout=attn_layout,
                               img_size=img_size, dtype=dtype, generator=generator)
    return ctor


swin_tiny_patch4_window7_224 = _make(96, (2, 2, 6, 2), (3, 6, 12, 24))
swin_small_patch4_window7_224 = _make(96, (2, 2, 18, 2), (3, 6, 12, 24))
swin_base_patch4_window7_224 = _make(128, (2, 2, 18, 2), (4, 8, 16, 32))

NAMES = ["swin_tiny_patch4_window7_224", "swin_small_patch4_window7_224",
         "swin_base_patch4_window7_224"]
