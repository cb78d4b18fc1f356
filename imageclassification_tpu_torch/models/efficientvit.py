"""EfficientViT (MSRA, "Memory Efficient Vision Transformer with Cascaded
Group Attention"), m0-m5 (port of imageclassification_tpu/models/efficientvit.py):
the CLI's default model family.

NHWC activations as in the JAX model, the convolutions through `F.conv2d`
on channels-first views (`layers.conv2d_nhwc`) and BatchNorm with flax's
rules (`layers.BatchNorm`: fp32 batch statistics, running averages with
momentum 0.9 committed by the train step). Module and parameter names
follow microsoft/Cream's classification model, so a hub state_dict's keys
are the port's (less Cream's `attention_bias_idxs` buffers and BatchNorm
`num_batches_tracked`): `patch_embed.{0,2,4,6}.{c,bn}`, `blocks{1,2,3}`
(in blocks2 and blocks3 the subsample sandwich first:
`{0,2}.{0,1}.m` and the PatchMerging `1`), `<block>.{dw0,dw1}.m`,
`<block>.{ffn0,ffn1}.m.{pw1,pw2}`, `<block>.mixer.m.attn.{qkvs,dws}.{i}`,
`.proj.1` and `.attention_biases`, `head.{bn,l}`. checkpoint/from_jax.py
maps the JAX parameters and batch statistics onto them.

Kept from the JAX model: the cascade (head i attends over the previous
head's output plus its own channel chunk), the depthwise conv on q only
with the per-head kernel size (the last one past the table's end), learned
biases over the |dx|, |dy| offsets of a window, windows of 7 padded with
zeros at the bottom and right where a stage's size is not a multiple (the
padded positions enter the qkv BatchNorm's batch statistics, as in JAX),
the attention's products accumulated in fp32 with the softmax cast to the
value dtype, and a head of BatchNorm and Linear in fp32 with classifier
dropout (`drop_rate`, which the CLI routes from --drop_path). Init: flax's
lecun_normal convs, BatchNorm scale 1 (0 for each block's depthwise convs,
the FFNs' second conv and the attention's projection), zero attention
biases and a zero head. The attention is plain torch ops, as the JAX model
runs einsums: no kernel of the port.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, conv2d_nhwc, dropout, lecun_normal_, linear


def _down(r: int) -> int:
    """The spatial size after a 3x3 stride-2 conv padded by 1."""
    return (r - 1) // 2 + 1


def _attention_bias_index(resolution: int):
    """Unique (|dx|, |dy|) offset ids of an r x r window -> (number of
    offsets, ids [N, N])."""
    points = list(itertools.product(range(resolution), range(resolution)))
    offsets, idxs = {}, []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(points)
    return len(offsets), np.asarray(idxs, dtype=np.int64).reshape(n, n)


class ConvBN(nn.Module):
    """Cream's Conv2d_BN (the JAX ConvBN): a bias-free conv `c` and a
    BatchNorm `bn` whose scale starts at `bn_weight_init`."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1, padding: int = 0,
                 groups: int = 1, bn_weight_init: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.c = nn.Conv2d(cin, cout, kernel, stride, padding, groups=groups, bias=False)
        self.bn = BatchNorm(cout)
        self.bn_weight_init = bn_weight_init
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(conv2d_nhwc(x, self.c, self.dtype))


class Residual(nn.Module):
    def __init__(self, m: nn.Module):
        super().__init__()
        self.m = m

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.m(x)


class FFN(nn.Module):
    """The JAX ConvMlp: 1x1 ConvBN -> ReLU -> 1x1 ConvBN (scale 0)."""

    def __init__(self, dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.pw1 = ConvBN(dim, hidden, dtype=dtype)
        self.pw2 = ConvBN(hidden, dim, bn_weight_init=0.0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw2(F.relu(self.pw1(x)))


class SqueezeExcite(nn.Module):
    """x * sigmoid(conv(relu(conv(mean of x over space)))), convs with bias."""

    def __init__(self, c: int, rd_ratio: float = 0.25, dtype=torch.float32):
        super().__init__()
        rd = max(1, int(c * rd_ratio))
        self.conv_reduce = nn.Conv2d(c, rd, 1)
        self.conv_expand = nn.Conv2d(rd, c, 1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        s = F.relu(conv2d_nhwc(s, self.conv_reduce, self.dtype))
        return x * torch.sigmoid(conv2d_nhwc(s, self.conv_expand, self.dtype))


class CascadedGroupAttention(nn.Module):
    """Attention over an r x r window (r = `resolution`) in `num_heads`
    cascaded heads: head i takes its channel chunk plus head i-1's output,
    projects it to q, k (key_dim each) and v (dim // num_heads) with a 1x1
    ConvBN, runs a depthwise ConvBN on q, and attends with the learned bias
    of each (|dx|, |dy|) offset; the heads' outputs are concatenated, and
    ReLU and a 1x1 ConvBN project them."""

    def __init__(self, dim: int, key_dim: int, num_heads: int, resolution: int,
                 kernels: Sequence[int], dtype=torch.float32):
        super().__init__()
        self.key_dim, self.d = key_dim, dim // num_heads
        self.scale = key_dim ** -0.5
        self.qkvs = nn.ModuleList(ConvBN(dim // num_heads, 2 * key_dim + self.d, dtype=dtype)
                                  for _ in range(num_heads))
        ks = [kernels[i] if i < len(kernels) else kernels[-1] for i in range(num_heads)]
        self.dws = nn.ModuleList(ConvBN(key_dim, key_dim, k, padding=k // 2, groups=key_dim,
                                        dtype=dtype) for k in ks)
        self.proj = nn.Sequential(nn.ReLU(), ConvBN(dim, dim, bn_weight_init=0.0, dtype=dtype))
        n_off, idxs = _attention_bias_index(resolution)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, n_off))
        self.register_buffer("attention_bias_idxs", torch.from_numpy(idxs), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        kd, d = self.key_dim, self.d
        chunk = C // len(self.qkvs)
        bias = self.attention_biases[:, self.attention_bias_idxs]  # [heads, N, N], fp32
        feats = []
        feat = x[..., :chunk]
        for i, (qkv, dw) in enumerate(zip(self.qkvs, self.dws)):
            if i > 0:
                feat = feat + x[..., i * chunk:(i + 1) * chunk]
            q, k, v = qkv(feat).split([kd, kd, d], dim=-1)
            q = dw(q)
            q, k, v = q.reshape(B, H * W, kd), k.reshape(B, H * W, kd), v.reshape(B, H * W, d)
            # products summed in fp32 (JAX's preferred_element_type), the
            # softmax in fp32 and cast to the value dtype
            attn = torch.matmul(q.float(), k.float().transpose(1, 2)) * self.scale + bias[i]
            attn = torch.softmax(attn, dim=-1).to(v.dtype)
            feat = torch.matmul(attn, v).reshape(B, H, W, d)
            feats.append(feat)
        return self.proj(torch.cat(feats, dim=-1))


class LocalWindowAttention(nn.Module):
    """`CascadedGroupAttention` over windows of min(window, stage size):
    the map is padded with zeros at the bottom and right to whole windows,
    attended window by window, and cropped back."""

    def __init__(self, dim: int, key_dim: int, num_heads: int, resolution: int,
                 window_resolution: int, kernels: Sequence[int], dtype=torch.float32):
        super().__init__()
        self.window_resolution = window_resolution
        self.attn = CascadedGroupAttention(dim, key_dim, num_heads,
                                           min(window_resolution, resolution), kernels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        wr = min(self.window_resolution, H, W)
        if H <= wr and W <= wr:
            return self.attn(x)
        pad_b, pad_r = (wr - H % wr) % wr, (wr - W % wr) % wr
        xp = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        nh, nw = Hp // wr, Wp // wr
        xw = xp.reshape(B, nh, wr, nw, wr, C).transpose(2, 3).reshape(B * nh * nw, wr, wr, C)
        xw = self.attn(xw)
        xp = xw.reshape(B, nh, nw, wr, wr, C).transpose(2, 3).reshape(B, Hp, Wp, C)
        return xp[:, :H, :W]


def _dw_ffn(dim: int, dtype) -> nn.Sequential:
    """The residual depthwise ConvBN and FFN on either side of a PatchMerging."""
    return nn.Sequential(Residual(ConvBN(dim, dim, 3, padding=1, groups=dim, dtype=dtype)),
                         Residual(FFN(dim, dim * 2, dtype)))


class EfficientVitBlock(nn.Module):
    """Residual depthwise ConvBN -> FFN -> window attention -> depthwise
    ConvBN -> FFN."""

    def __init__(self, dim: int, key_dim: int, num_heads: int, resolution: int,
                 window_resolution: int, kernels: Sequence[int], dtype=torch.float32):
        super().__init__()
        self.dw0 = Residual(ConvBN(dim, dim, 3, padding=1, groups=dim, bn_weight_init=0.0,
                                   dtype=dtype))
        self.ffn0 = Residual(FFN(dim, dim * 2, dtype))
        self.mixer = Residual(LocalWindowAttention(dim, key_dim, num_heads, resolution,
                                                   window_resolution, kernels, dtype))
        self.dw1 = Residual(ConvBN(dim, dim, 3, padding=1, groups=dim, bn_weight_init=0.0,
                                   dtype=dtype))
        self.ffn1 = Residual(FFN(dim, dim * 2, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn1(self.dw1(self.mixer(self.ffn0(self.dw0(x)))))


class PatchMerging(nn.Module):
    """1x1 ConvBN to 4x the channels -> ReLU -> 3x3 stride-2 depthwise
    ConvBN -> ReLU -> SqueezeExcite -> 1x1 ConvBN to `out_dim`."""

    def __init__(self, dim: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        hid = dim * 4
        self.conv1 = ConvBN(dim, hid, dtype=dtype)
        self.conv2 = ConvBN(hid, hid, 3, stride=2, padding=1, groups=hid, dtype=dtype)
        self.se = SqueezeExcite(hid, dtype=dtype)
        self.conv3 = ConvBN(hid, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        return self.conv3(self.se(x))


class BNLinear(nn.Module):
    """Cream's BN_Linear head in fp32: BatchNorm `bn`, dropout, Linear `l`."""

    def __init__(self, dim: int, num_classes: int, drop_rate: float = 0.0):
        super().__init__()
        self.bn = BatchNorm(dim)
        self.l = nn.Linear(dim, num_classes)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        x = self.bn(x.float()[:, None, None, :])[:, 0, 0]
        if self.training:
            x = dropout(x, self.drop_rate, generator)
        return linear(x, self.l, torch.float32)


class EfficientViT(nn.Module):
    def __init__(self, embed_dims: Sequence[int] = (64, 128, 192),
                 depths: Sequence[int] = (1, 2, 3), num_heads: Sequence[int] = (4, 4, 4),
                 window_sizes: Sequence[int] = (7, 7, 7), key_dim: int = 16,
                 kernels: Sequence[int] = (5, 5, 5, 5), num_classes: int = 1000,
                 drop_rate: float = 0.0, img_size: int = 224, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depths, self.num_heads = tuple(depths), tuple(num_heads)
        self.dtype = dtype
        d0 = embed_dims[0]
        # overlapping patch embedding: four 3x3 stride-2 ConvBNs with ReLU
        # between them, /16
        stem, cin = [], 3
        for f in (d0 // 8, d0 // 4, d0 // 2, d0):
            stem += [ConvBN(cin, f, 3, stride=2, padding=1, dtype=dtype), nn.ReLU()]
            cin = f
        self.patch_embed = nn.Sequential(*stem[:-1])
        res = img_size
        for _ in range(4):
            res = _down(res)
        for s, (dim, depth, heads, win) in enumerate(zip(embed_dims, depths, num_heads,
                                                         window_sizes)):
            blocks = []
            if s > 0:
                prev = embed_dims[s - 1]
                blocks += [_dw_ffn(prev, dtype), PatchMerging(prev, dim, dtype)]
                res = _down(res)
                blocks.append(_dw_ffn(dim, dtype))
            blocks += [EfficientVitBlock(dim, key_dim, heads, res, win, kernels, dtype)
                       for _ in range(depth)]
            self.add_module(f"blocks{s + 1}", nn.Sequential(*blocks))
        self.head = BNLinear(embed_dims[-1], num_classes, drop_rate)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initializers: lecun_normal convs with zero biases,
        BatchNorm scale `bn_weight_init` (1 in the head) and bias 0, running
        mean 0 and variance 1, zero attention biases and a zero head."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                for t, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                             (m.running_var, 1.0)):
                    nn.init.constant_(t, v)
            elif isinstance(m, CascadedGroupAttention):
                nn.init.zeros_(m.attention_biases)
        for m in self.modules():
            if isinstance(m, ConvBN):
                nn.init.constant_(m.bn.weight, m.bn_weight_init)
        nn.init.zeros_(self.head.l.weight)
        nn.init.zeros_(self.head.l.bias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x: [B, H, W, 3] float (NHWC). Returns fp32 logits [B, num_classes];
        `generator` draws the head's dropout mask in training."""
        x = self.patch_embed(x.to(self.dtype))
        x = self.blocks3(self.blocks2(self.blocks1(x)))
        return self.head(x.mean(dim=(1, 2)), generator)


_VARIANTS = {
    "m0": dict(embed_dims=(64, 128, 192), depths=(1, 2, 3), num_heads=(4, 4, 4)),
    "m1": dict(embed_dims=(128, 144, 192), depths=(1, 2, 3), num_heads=(2, 3, 3)),
    "m2": dict(embed_dims=(128, 192, 224), depths=(1, 2, 3), num_heads=(4, 3, 2)),
    "m3": dict(embed_dims=(128, 240, 320), depths=(1, 2, 3), num_heads=(4, 3, 4)),
    "m4": dict(embed_dims=(128, 256, 384), depths=(1, 2, 3), num_heads=(4, 4, 4)),
    "m5": dict(embed_dims=(192, 288, 384), depths=(1, 3, 4), num_heads=(3, 3, 4)),
}


def _make(variant: str):
    def ctor(num_classes=1000, drop_rate=0.0, dtype=torch.float32, img_size=224,
             generator=None, **kw):
        del kw  # other families' kwargs, ignored as in JAX
        return EfficientViT(num_classes=num_classes, drop_rate=drop_rate, img_size=img_size,
                            dtype=dtype, generator=generator, **_VARIANTS[variant])
    return ctor


efficientvit_m0 = _make("m0")
efficientvit_m1 = _make("m1")
efficientvit_m2 = _make("m2")
efficientvit_m3 = _make("m3")
efficientvit_m4 = _make("m4")
efficientvit_m5 = _make("m5")

NAMES = [f"efficientvit_{v}" for v in _VARIANTS]
