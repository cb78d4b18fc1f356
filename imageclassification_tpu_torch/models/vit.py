"""Vision Transformer (port of imageclassification_tpu/models/vit.py).

NHWC input like the JAX model; the one permute to channels-first happens at
the patch embedding. Parameter names follow timm (`patch_embed.proj`,
`blocks.{i}.norm1`, `blocks.{i}.attn.qkv`, `blocks.{i}.attn.proj`,
`blocks.{i}.mlp.fc1`, `norm`, `head`): one fused qkv Linear where the JAX
model has separate query/key/value projections. checkpoint/from_jax.py maps
the JAX parameters onto these names.

Attention with `flash_attn=True` goes through ops/flash_attention.py (a CUDA
kernel on the card); otherwise it is the plain matmul -> softmax -> matmul of
the JAX package's einsum path. The JAX package's `attn_impl="bhnd"` (set by
VIT_ATTN_IMPL) is a head-major re-layout of that same function for XLA; the
port has one attention path, so the argument is accepted and has no effect.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from .layers import DropPath, Mlp, dropout, drop_path_rates, layer_norm, linear, trunc_normal_


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.drop_rate = drop_rate
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        for fc in (self.qkv, self.proj):
            trunc_normal_(fc.weight, generator=generator)
            nn.init.zeros_(fc.bias)

    def forward(self, x: torch.Tensor, use_flash: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, N, E = x.shape
        H = self.num_heads
        # [B, N, 3, H, D]; q, k, v are strided views the kernel reads in place
        q, k, v = linear(x, self.qkv, self.dtype).view(B, N, 3, H, E // H).unbind(2)
        if use_flash:
            y = flash_attention(q, k, v)
        else:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, N, D]
            w = torch.softmax(torch.matmul(q * (E // H) ** -0.5, k.transpose(-1, -2)), dim=-1)
            if self.training:
                # flax MHA broadcast_dropout: one [N, N] mask over batch and heads
                w = dropout(w, self.drop_rate, generator, (1, 1, N, N))
            y = torch.matmul(w, v).transpose(1, 2)
        return linear(y.reshape(B, N, E), self.proj, self.dtype)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, drop_path: float = 0.0,
                 flash_attn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, drop_rate, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop_rate=drop_rate, dtype=dtype)
        self.drop_rate = drop_rate
        self.flash_attn = flash_attn
        self.dtype = dtype

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        # the flash kernel has no attention-dropout path: a training step with
        # attention dropout takes the plain attention
        use_flash = self.flash_attn and (self.drop_rate == 0.0 or not self.training)
        y = self.attn(layer_norm(x, self.norm1, self.dtype), use_flash, generator)
        x = x + self.drop_path(y, generator)
        y = self.mlp(layer_norm(x, self.norm2, self.dtype), generator)
        return x + self.drop_path(y, generator)


class ViT(nn.Module):
    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, num_classes: int = 1000,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 flash_attn: bool = False, img_size: int = 224,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size = patch_size
        self.num_heads = num_heads
        self.drop_rate = drop_rate
        self.flash_attn = flash_attn
        self.dtype = dtype
        self.patch_embed = nn.ModuleDict(
            {"proj": nn.Conv2d(3, dim, patch_size, stride=patch_size)}
        )
        num_tokens = (img_size // patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_tokens, dim))
        rates = drop_path_rates(drop_path_rate, [depth])[0]
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, num_heads, mlp_ratio, drop_rate, rates[i], flash_attn, dtype)
            for i in range(depth)
        )
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initializers: truncated normal (std 0.02) for the
        patch embedding, position embedding and every attention/MLP kernel;
        zeros for biases, the cls token and the head; ones for LayerNorm."""
        trunc_normal_(self.patch_embed["proj"].weight, generator=generator)
        nn.init.zeros_(self.patch_embed["proj"].bias)
        nn.init.zeros_(self.cls_token)
        trunc_normal_(self.pos_embed, generator=generator)
        for blk in self.blocks:
            blk.attn.reset_parameters(generator)
            blk.mlp.reset_parameters(generator)
        for ln in [self.norm] + [n for b in self.blocks for n in (b.norm1, b.norm2)]:
            nn.init.ones_(ln.weight)
            nn.init.zeros_(ln.bias)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x: [B, H, W, 3] float (NHWC). Returns fp32 logits [B, num_classes]."""
        B = x.shape[0]
        proj = self.patch_embed["proj"]
        x = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), proj.weight.to(self.dtype),
                     proj.bias.to(self.dtype), stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, tokens, dim], row-major over the grid
        cls = self.cls_token.to(self.dtype).expand(B, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        if self.training:
            x = dropout(x, self.drop_rate, generator)
        for blk in self.blocks:
            x = blk(x, generator)
        x = layer_norm(x, self.norm, self.dtype)[:, 0]
        return linear(x, self.head, torch.float32)


def _make(patch, dim, depth, heads):
    def ctor(num_classes=1000, drop_path_rate=0.0, drop_rate=0.0,
             dtype=torch.float32, flash_attn=False, attn_impl=None,
             img_size=224, generator=None, **kw):
        del attn_impl, kw  # one attention path (module docstring); extra kwargs ignored as in JAX
        return ViT(patch_size=patch, dim=dim, depth=depth, num_heads=heads,
                   num_classes=num_classes, drop_rate=drop_rate,
                   drop_path_rate=drop_path_rate, flash_attn=flash_attn,
                   img_size=img_size, dtype=dtype, generator=generator)
    ctor.num_heads = heads  # read by checkpoint/torch_convert.py without building the model
    return ctor


vit_tiny_patch16 = _make(16, 192, 12, 3)
vit_small_patch16 = _make(16, 384, 12, 6)
vit_small_patch32 = _make(32, 384, 12, 6)
vit_base_patch16 = _make(16, 768, 12, 12)
vit_base_patch32 = _make(32, 768, 12, 12)
vit_large_patch16 = _make(16, 1024, 24, 16)
