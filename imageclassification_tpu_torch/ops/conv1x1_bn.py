"""Fused 1x1 convolution (a matmul over flattened NHWC pixels) with the
BatchNorm statistics of its output: a hand-written Hopper kernel and its
plain version.

Replaces `imageclassification_tpu/ops/pallas_conv1x1_bn.py::conv1x1_bn_stats`,
whose Pallas TPU kernels are `_kernel` (:85) and `_kernel_bn_in` (:95), called
at :174 and :192, with the statistics carried across grid steps by
`_accumulate_stats` (:64). Same function at the public entry point:
`conv1x1_bn_stats(x, w, prev_scale=None, prev_shift=None, relu_in=True)` with
x [M, K] and w [K, N] in the JAX layout returns (y = maybe_relu(x * scale +
shift) @ w in x's dtype, stats [2, N] fp32 = the column sums and sums of
squares of the fp32 product, before y is rounded). The prologue, when
prev_scale and prev_shift are given, is computed in fp32 and rounded to the
compute dtype before the product, as the Pallas kernel rounds it.

It is forward-only, as the JAX function is: no gradient, and an input that
requires one raises.

The Pallas kernel takes M only in multiples of 128; the Hopper kernel takes
any M (ResNet-50's last stage at batch 64 has M = 3136). On a CUDA tensor it
takes bf16 x and w (the model-path regime of the JAX tests) with K and N
multiples of 8, and raises NotImplementedError for any other dtype or width.
What bounds it on an H100 and what the design does about it: see the header
of `csrc/conv1x1_bn.cu` (bytes at every ResNet-50 shape but the last stage:
x and y cross device memory once, the statistics come from the accumulators,
per-CTA column partials summed by a second pass, no atomics).

Like the Pallas kernel this is an op of its own: the JAX ResNet runs
`lax.conv` and `nn.BatchNorm`, and the port's ResNet runs `F.conv2d` and its
BatchNorm, not this op.

`conv1x1_bn_stats` takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

KERNEL = "conv1x1_bn"
# rows of y a CTA computes: the M-tiles whose column partials the second
# pass sums
TILE_M = 128
# x rows and w rows are read as 16-byte vectors of 8 bf16
WIDTH_VECTOR = 8


def conv1x1_bn_ref(x: torch.Tensor, w: torch.Tensor, prev_scale: Optional[torch.Tensor] = None,
                   prev_shift: Optional[torch.Tensor] = None, relu_in: bool = True):
    """Plain version (the JAX `xla_reference`): the prologue in fp32 rounded
    to x's dtype, the product of x and w accumulated in fp32, the column sums
    and sums of squares of that fp32 product; y in x's dtype."""
    xf = x
    if prev_scale is not None:
        xf = x.float() * prev_scale.float() + prev_shift.float()
        if relu_in:
            xf = torch.relu(xf)
        xf = xf.to(x.dtype)
    y = xf.float() @ w.float()
    return y.to(x.dtype), torch.stack([y.sum(0), (y * y).sum(0)])


@functools.cache
def _kernel():
    lib = _build.load(KERNEL)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.conv1x1_bn_stats
    fn.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(x: torch.Tensor, w: torch.Tensor, prev_scale, prev_shift) -> None:
    """Raise ValueError on inputs that do not make the function: shapes,
    devices, half a prologue, an input that requires a gradient."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x must be [M, K] and w [K, N], got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[0] == 0:
        raise ValueError("x has no rows")
    if (prev_scale is None) != (prev_shift is None):
        raise ValueError("prev_scale and prev_shift go together")
    tensors = [t for t in (x, w, prev_scale, prev_shift) if t is not None]
    if prev_scale is not None and not (prev_scale.shape == prev_shift.shape == (x.shape[1],)):
        raise ValueError(f"prev_scale and prev_shift must be [{x.shape[1]}], got "
                         f"{tuple(prev_scale.shape)}, {tuple(prev_shift.shape)}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x, w, prev_scale and prev_shift must be on one device")
    if any(t.requires_grad for t in tensors):
        raise ValueError("conv1x1_bn_stats is forward-only (as the JAX function): "
                         "no input may require a gradient")


def check_kernel_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise NotImplementedError on what the kernel does not take: a dtype
    other than bf16, K or N not a multiple of 8."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the conv1x1_bn kernel takes bfloat16 x and w, got {x.dtype}, {w.dtype}")
    K, N = w.shape
    if K % WIDTH_VECTOR or N % WIDTH_VECTOR:
        raise NotImplementedError(
            f"the conv1x1_bn kernel takes K and N in multiples of {WIDTH_VECTOR}, got K={K}, N={N}")


def _launch(x, w, prev_scale, prev_shift, relu_in: bool):
    check_kernel_inputs(x, w)
    (M, K), N = x.shape, w.shape[1]
    xa, wa = _build.aligned(x), _build.aligned(w)
    scale = shift = None
    if prev_scale is not None:
        scale = _build.aligned(prev_scale, torch.float32)
        shift = _build.aligned(prev_shift, torch.float32)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    part = torch.empty((2, math.ceil(M / TILE_M), N), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(xa.data_ptr(), wa.data_ptr(), None if scale is None else scale.data_ptr(),
                        None if shift is None else shift.data_ptr(), y.data_ptr(),
                        part.data_ptr(), stats.data_ptr(), M, K, N, int(relu_in),
                        _build.stream(x))
    _build.raise_on(err, "conv1x1_bn_stats")
    if scale is None:
        conv1x1_bn_stats.launches += 1
    else:
        conv1x1_bn_stats.launches_bn_in += 1
    return y, stats


def conv1x1_bn_stats(x: torch.Tensor, w: torch.Tensor, prev_scale: Optional[torch.Tensor] = None,
                     prev_shift: Optional[torch.Tensor] = None, relu_in: bool = True):
    """(y, stats) of y = maybe_relu(x * prev_scale + prev_shift) @ w, the
    prologue only when prev_scale and prev_shift are given, and stats [2, N]
    fp32 the column sums and sums of squares of the fp32 product.

    CPU tensors take the plain version (`conv1x1_bn_ref`, fp32 or bf16);
    CUDA tensors launch the kernel (bf16 x and w, K and N multiples of 8, any
    M). Counts, as plain integers on this function: `launches` (no prologue)
    and `launches_bn_in` (with the prologue)."""
    check_inputs(x, w, prev_scale, prev_shift)
    if x.device.type == "cpu":
        return conv1x1_bn_ref(x, w, prev_scale, prev_shift, relu_in)
    if x.device.type != "cuda":
        raise NotImplementedError(f"conv1x1_bn_stats runs on cpu or cuda, not {x.device.type}")
    return _launch(x, w, prev_scale, prev_shift, relu_in)


def reset_launches() -> None:
    """Set the launch counts of `conv1x1_bn_stats` to 0."""
    conv1x1_bn_stats.launches = 0
    conv1x1_bn_stats.launches_bn_in = 0


reset_launches()
