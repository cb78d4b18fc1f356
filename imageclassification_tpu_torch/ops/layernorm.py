"""Fused LayerNorm over the last axis: hand-written Hopper kernels (forward,
and a backward that recomputes the statistics) and their plain versions.

Replaces `imageclassification_tpu/ops/pallas_layernorm.py::fused_layer_norm`,
whose Pallas TPU kernels are `_fwd_kernel` behind `_run_fwd` (`pl.pallas_call`
at :85) and `_bwd_kernel` behind `_run_bwd` (`pl.pallas_call` at :108), tied
together by the custom VJP `_fused` that saves (x, gamma). Same function at
the public entry point: `fused_layer_norm(x, gamma, beta, eps=1e-6)` over the
last axis, fp32 statistics with var = E[x^2] - E[x]^2, the affine in fp32, the
output in x's dtype; dx in dy's dtype, dgamma and dbeta in gamma's dtype.

The Pallas kernel takes a row count only when it has a row block of at least
8 that divides it, and the JAX function falls back to jnp otherwise (and off
the TPU); these kernels take any row count and any C <= 4096, so a CUDA tensor
always launches them. What bounds them on an H100 and what the designs do
about it: see the header of `csrc/layernorm.cu` (bytes: one warp per row,
16-byte loads, statistics in registers; per-CTA dgamma/dbeta partials summed
by a second pass, no atomics).

Like the Pallas kernel this is an op of its own: the JAX ConvNeXt and ViT
run `nn.LayerNorm`, and the port's models run their `layer_norm` helper, not
this op.

`fused_layer_norm` takes the plain versions only for tensors on the CPU. For
a CUDA tensor it launches the kernels or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

KERNEL = "layernorm"
MAX_C = 4096
# CTAs of the backward: each writes one fp32 partial row of dgamma and dbeta
MAX_BWD_CTAS = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Plain version of the forward (the JAX `layer_norm_ref`): fp32
    statistics with var = E[x^2] - E[x]^2 (not clamped), fp32 affine, the
    result in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def layer_norm_bwd_ref(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                       eps: float = 1e-6):
    """Plain version of the backward (the Pallas `_bwd_kernel`'s math):
    mean and rstd recomputed from x, dx = rstd (g' - mean(g') - xhat
    mean(g' xhat)) with g' = dy gamma, dgamma = sum dy xhat and dbeta = sum dy
    over every axis but the last. Returns (dx in dy's dtype, dgamma, dbeta in
    gamma's dtype)."""
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    gp = dyf * gamma.float()
    m1 = gp.mean(-1, keepdim=True)
    m2 = (gp * xhat).mean(-1, keepdim=True)
    dx = rstd * (gp - m1 - xhat * m2)
    rows = tuple(range(x.dim() - 1))
    return (dx.to(dy.dtype), (dyf * xhat).sum(rows).to(gamma.dtype),
            dyf.sum(rows).to(gamma.dtype))


@functools.cache
def _kernels():
    lib = _build.load(KERNEL)
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fwd, bwd = lib.layer_norm_fwd, lib.layer_norm_bwd
    fwd.argtypes = [p, p, p, p, ll, i, f, i, p]
    bwd.argtypes = [p, p, p, p, p, p, p, ll, i, i, f, i, i, p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def check_kernel_inputs(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> None:
    """Raise on what the kernels do not take: NotImplementedError for dtypes
    and widths not ported, ValueError for shapes that do not fit."""
    if x.dtype not in _DTYPES or gamma.dtype not in _DTYPES:
        raise NotImplementedError(
            f"LayerNorm kernels take float32 or bfloat16, got x {x.dtype}, gamma {gamma.dtype}")
    C = x.shape[-1]
    if C > MAX_C:
        raise NotImplementedError(f"LayerNorm kernels take C <= {MAX_C}, got {C}")
    if gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"gamma and beta must be [{C}], got {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")
    if not (x.device == gamma.device == beta.device):
        raise ValueError("x, gamma and beta must be on one device")


def _launch_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Forward kernel on x viewed as [rows, C]; y in x's dtype and shape."""
    check_kernel_inputs(x, gamma, beta)
    C = x.shape[-1]
    x2 = _build.aligned(x.reshape(-1, C))
    y = torch.empty_like(x2)
    g, b = _build.aligned(gamma, torch.float32), _build.aligned(beta, torch.float32)
    with torch.cuda.device(x.device):
        err = _kernels()[0](x2.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                            x2.shape[0], C, float(eps), _DTYPES[x.dtype],
                            _build.stream(x))
    _build.raise_on(err, "layer_norm_fwd")
    fused_layer_norm.launches += 1
    return y.view(x.shape)


def _launch_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float):
    """Backward kernel (and its partial-sum pass): (dx in dy's dtype,
    dgamma, dbeta in gamma's dtype)."""
    check_kernel_inputs(x, gamma, gamma)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x's shape and dtype, got {tuple(dy.shape)} {dy.dtype}")
    C = x.shape[-1]
    x2, dy2 = _build.aligned(x.reshape(-1, C)), _build.aligned(dy.reshape(-1, C))
    rows = x2.shape[0]
    ctas = max(1, min(MAX_BWD_CTAS, math.ceil(rows / 8)))
    dx = torch.empty_like(x2)
    part = torch.empty((2, ctas, C), dtype=torch.float32, device=x.device)
    dgamma = torch.empty((C,), dtype=gamma.dtype, device=x.device)
    dbeta = torch.empty_like(dgamma)
    g = _build.aligned(gamma, torch.float32)
    with torch.cuda.device(x.device):
        err = _kernels()[1](x2.data_ptr(), g.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
                            part.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), rows, C,
                            ctas, float(eps), _DTYPES[x.dtype], _DTYPES[gamma.dtype],
                            _build.stream(x))
    _build.raise_on(err, "layer_norm_bwd")
    fused_layer_norm.launches_bwd += 1
    return dx.view(x.shape), dgamma, dbeta


def layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """(dx, dgamma, dbeta) of `fused_layer_norm`: the plain version for CPU
    tensors, the backward kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return layer_norm_bwd_ref(x, gamma, dy, eps)
    return _launch_bwd(x, gamma, dy, eps)


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, gamma)
        if x.device.type == "cpu":
            return layer_norm_ref(x, gamma, beta, eps)
        return _launch_fwd(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x, gamma, dy.to(x.dtype), ctx.eps)
        return dx, dgamma, dbeta, None


def fused_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of x, differentiable in x, gamma and
    beta; output in x's dtype, statistics in fp32.

    CPU tensors take the plain versions (`layer_norm_ref`,
    `layer_norm_bwd_ref`); CUDA tensors launch the kernels (float32 or
    bfloat16 x, C <= 4096, any row count). Counts, as plain integers on this
    function: `launches` (forward kernel) and `launches_bwd` (backward)."""
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"fused_layer_norm runs on cpu or cuda, not {x.device.type}")
    return _FusedLayerNorm.apply(x, gamma, beta, float(eps))


def reset_launches() -> None:
    """Set the launch counts of `fused_layer_norm` to 0."""
    fused_layer_norm.launches = 0
    fused_layer_norm.launches_bwd = 0


reset_launches()
