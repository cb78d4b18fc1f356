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
always launches them. What bounds them on an H100 and what the design does
about it: see the header of `csrc/layernorm.cu` (bytes: persistent CTAs
walking tiles of whole rows fed by a ring of 1-d bulk copies, a row held in
registers from its statistics to its output, dgamma/dbeta summed in
registers and then by a second pass over one partial row a CTA, no atomics).
The host plans each launch (`ln_plan`: lanes a row, rows a tile, stages,
shared memory, grid) and the kernel checks the plan, so the CPU tests check
what is launched.

The host path is kept short, since at small shapes it, not the device, sets
the time of a call: a call that needs no gradient launches without an
autograd node, the plan is cached by shape, and the C entry point makes x's
device current itself (a cudaGetDevice when it already is).

Like the Pallas kernel this is an op of its own: the JAX ConvNeXt and ViT
run `nn.LayerNorm`, and the port's models run their `layer_norm` helper, not
this op.

`fused_layer_norm` takes the plain versions only for tensors on the CPU. For
a CUDA tensor it launches the kernels or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

KERNEL = "layernorm"
MAX_C = 4096
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bulk path (csrc/layernorm.cu): CTAs of LN_THREADS threads, a lane
# holding up to LN_MAX_VECS 16-byte vectors of a row, tiles of about
# LN_TILE_BYTES of x, rings of 2 to LN_STAGES stages; up to LN_FWD_CTAS_PER_SM
# CTAs an SM in the forward and LN_BWD_CTAS_PER_SM in the backward where
# their rings fit (an H100 SM has SMEM_PER_SM bytes of shared memory, of
# which each CTA's runtime keeps 1 KB and the kernels' barriers take less
# than 256 bytes), a CTA asking for at most LN_SMEM_MAX bytes. One CTA an SM
# halves the backward's partial rows and measured no slower in its kernel;
# the forward runs faster at two (PERF.md §6, the LayerNorm redesign)
LN_THREADS, LN_MAX_VECS, LN_TILE_BYTES, LN_STAGES = 256, 4, 16384, 4
LN_FWD_CTAS_PER_SM, LN_BWD_CTAS_PER_SM = 2, 1
SMEM_PER_SM, LN_SMEM_MAX, LN_CTA_OVERHEAD = 233472, 232448 - 1024, 1024 + 256
H100_SMS = 132


class LnPlan(NamedTuple):
    """One launch of the LayerNorm kernels: the kernels' `Plan`, in its
    order. lanes = 0 marks the warp-per-row path (C not a multiple of the
    vector width), which reads only `ctas` (the backward's grid)."""
    lanes: int        # threads a row, a power of two
    vecs: int         # 16-byte vectors a lane holds
    tile_rows: int    # rows a tile (a bulk copy), a multiple of LN_THREADS // lanes
    stages: int       # stages of the ring
    x_bytes: int      # bytes of a stage's x tile, 128-aligned; the dy tile follows
    stage_bytes: int
    smem_bytes: int   # the ring (and the backward's column sums), + 128 of alignment
    ctas: int         # the grid: one partial row of [dgamma | dbeta] each


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def ln_plan(rows: int, C: int, itemsize: int, backward: bool, sms: int = H100_SMS) -> LnPlan:
    """The launch for [rows, C] of `itemsize` bytes on a card of `sms` SMs.
    A row's C / V vectors (V = 16 / itemsize) go to the fewest lanes, a power
    of two, that hold at most LN_MAX_VECS each: ConvNeXt's widths (3 * 2^k *
    V) fill 3 vectors on every lane, and a few lanes a row keep several rows
    in a warp and the shuffle trees short (measured against up to 32 lanes a
    row: PERF.md §6); LN_THREADS // lanes rows are in flight at once,
    and a tile is a multiple of that, as close to LN_TILE_BYTES of x as it
    gets. The backward's stage holds the x tile and the dy tile, and its
    column sums ([row slots][2C] fp32) reuse the ring at the end. As many
    stages as fit the CTAs an SM (fewer CTAs where 2 stages do not fit); one
    CTA a tile up to that many CTAs."""
    vec = 16 // itemsize
    if C % vec:
        return LnPlan(0, 0, 0, 0, 0, 0, 0, max(1, min(2 * sms, -(-rows // 8))))
    nv = C // vec
    lanes = _pow2(-(-nv // LN_MAX_VECS))
    slots = LN_THREADS // lanes
    row_bytes = C * itemsize
    tile_rows = slots * max(1, round(LN_TILE_BYTES / (row_bytes * slots)))
    x_bytes = _round128(tile_rows * row_bytes)
    stage = 2 * x_bytes if backward else x_bytes
    cols = slots * 2 * C * 4 if backward else 0
    for per_sm in range(LN_BWD_CTAS_PER_SM if backward else LN_FWD_CTAS_PER_SM, 0, -1):
        budget = min(LN_SMEM_MAX, SMEM_PER_SM // per_sm - LN_CTA_OVERHEAD) - 128
        stages = min(LN_STAGES, budget // stage)
        if stages >= 2 and cols <= budget:
            break
    return LnPlan(lanes, -(-nv // lanes), tile_rows, stages, x_bytes, stage,
                  max(stages * stage, cols) + 128, min(-(-rows // tile_rows), per_sm * sms))


class _Launch(ctypes.Structure):
    """The C entry points' `Launch` (csrc/layernorm.cu), field by field: what
    a call passes besides its tensors and stream. One pointer to it costs
    less on the host than these values as scalar arguments (PERF.md §6, the
    LayerNorm redesign); `_kernels` checks the size against the library's."""
    _fields_ = [("rows", ctypes.c_longlong), ("C", ctypes.c_int), ("dtype", ctypes.c_int),
                ("param_dtype", ctypes.c_int), ("device", ctypes.c_int),
                ("eps", ctypes.c_float), ("plan", ctypes.c_int * len(LnPlan._fields))]


@functools.lru_cache(maxsize=1024)
def _launch_args(rows: int, C: int, dtype: torch.dtype, param_dtype: torch.dtype, eps: float,
                 device: int, backward: bool):
    """(plan, its `_Launch`) for a call on `device`, cached: a shape seen
    before costs one lookup. The call passes the `_Launch` itself (ctypes
    hands C a pointer to it), which keeps it alive through the call."""
    plan = ln_plan(rows, C, dtype.itemsize, backward, _build.sms(device))
    return plan, _Launch(rows, C, _DTYPES[dtype], _DTYPES[param_dtype], device, eps,
                         (ctypes.c_int * len(plan))(*plan))


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
    fwd, bwd = lib.layer_norm_fwd, lib.layer_norm_bwd
    lib.layer_norm_launch_bytes.restype = ctypes.c_size_t
    if lib.layer_norm_launch_bytes() != ctypes.sizeof(_Launch):
        raise RuntimeError("ops/layernorm.py `_Launch` does not match csrc/layernorm.cu `Launch`")
    launch = ctypes.POINTER(_Launch)
    fwd.argtypes = [ctypes.c_void_p] * 4 + [launch, ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 6 + [launch, ctypes.c_void_p]
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
    """Forward kernel on x as [rows, C]; y in x's dtype and shape."""
    check_kernel_inputs(x, gamma, beta)
    x = _build.aligned(x)
    y = torch.empty_like(x)
    C = x.shape[-1]
    rows = x.numel() // max(C, 1)
    if rows:
        g, b = _build.aligned(gamma, torch.float32), _build.aligned(beta, torch.float32)
        _, launch = _launch_args(rows, C, x.dtype, gamma.dtype, eps, x.get_device(), False)
        err = _kernels()[0](x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), launch,
                            _build.stream(x))
        _build.raise_on(err, "layer_norm_fwd")
        fused_layer_norm.launches += 1
    return y


def _launch_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float):
    """Backward kernel (and its partial-sum pass): (dx in dy's dtype,
    dgamma, dbeta in gamma's dtype; dgamma and dbeta are the rows of one
    [2, C] tensor)."""
    check_kernel_inputs(x, gamma, gamma)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x's shape and dtype, got {tuple(dy.shape)} {dy.dtype}")
    x, dy = _build.aligned(x), _build.aligned(dy)
    dx = torch.empty_like(x)
    C = x.shape[-1]
    rows = x.numel() // max(C, 1)
    if not rows:
        return (dx, *torch.zeros((2, C), dtype=gamma.dtype, device=x.device).unbind())
    plan, launch = _launch_args(rows, C, x.dtype, gamma.dtype, eps, x.get_device(), True)
    part = torch.empty((plan.ctas, 2 * C), dtype=torch.float32, device=x.device)
    dgb = torch.empty((2, C), dtype=gamma.dtype, device=x.device)
    g = _build.aligned(gamma, torch.float32)
    err = _kernels()[1](x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                        part.data_ptr(), dgb.data_ptr(), launch, _build.stream(x))
    _build.raise_on(err, "layer_norm_bwd")
    fused_layer_norm.launches_bwd += 1
    return (dx, *dgb.unbind())


def layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """(dx, dgamma, dbeta) of `fused_layer_norm`: the plain version for CPU
    tensors, the backward kernel for CUDA tensors."""
    if x.is_cpu:
        return layer_norm_bwd_ref(x, gamma, dy, eps)
    return _launch_bwd(x, gamma, dy, float(eps))


def _forward(x, gamma, beta, eps):
    return layer_norm_ref(x, gamma, beta, eps) if x.is_cpu else _launch_fwd(x, gamma, beta, eps)


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, gamma)
        return _forward(x, gamma, beta, eps)

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
    bfloat16 x, C <= 4096, any row count). Only a call that needs a gradient
    builds an autograd node. Counts, as plain integers on this function:
    `launches` (forward kernel) and `launches_bwd` (backward)."""
    if not (x.is_cuda or x.is_cpu):
        raise NotImplementedError(f"fused_layer_norm runs on cpu or cuda, not {x.device.type}")
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _FusedLayerNorm.apply(x, gamma, beta, float(eps))
    return _forward(x, gamma, beta, float(eps))


def reset_launches() -> None:
    """Set the launch counts of `fused_layer_norm` to 0."""
    fused_layer_norm.launches = 0
    fused_layer_norm.launches_bwd = 0


reset_launches()
