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
persistent CTAs, one an SM, fed by a TMA ring of 64-deep x chunks (and W
chunks where W's slice does not stay in shared memory), wgmma products, the
prologue applied to the A fragments in registers, the statistics carried in
registers across every tile a CTA walks and y written by TMA stores; one
partial row a CTA summed by one second pass, no atomics). The host plans the
split and the shared-memory layout (`k2_plan`) and the kernel checks the
plan, so the CPU tests check what is launched. The host path is the
LayerNorm wrapper's: the launch's scalars are one `ctypes.Structure` cached
by shape, and the C entry point makes the tensors' device current itself.

Like the Pallas kernel this is an op of its own: the JAX ResNet runs
`lax.conv` and `nn.BatchNorm`, and the port's ResNet runs `F.conv2d` and its
BatchNorm, not this op.

`conv1x1_bn_stats` takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build

KERNEL = "conv1x1_bn"
# x rows and w rows are read as 16-byte vectors of 8 bf16
WIDTH_VECTOR = 8
# the kernel's tiles (csrc/conv1x1_bn.cu): TILE_M x TILE_N tiles of y, K in
# chunks of CHUNK_K; an x chunk and a W chunk are CHUNK_BYTES each; y staging
# Y_BYTES, the warps' column sums RED_BYTES; a ring of 2 to MAX_STAGES
# stages; one CTA an SM, asking for at most SMEM_MAX bytes
TILE_M, TILE_N, CHUNK_K = 128, 128, 64
CHUNK_BYTES, Y_BYTES, RED_BYTES = TILE_M * CHUNK_K * 2, 32768, 8192
MAX_STAGES, SMEM_MAX = 8, 232448 - 1024
H100_SMS = 132


class K2Plan(NamedTuple):
    """One launch of the kernel: its `Plan`, in its order. CTA (slot, n) of
    the grid (slots, n_tiles) computes the tiles (m, n) for m = slot, slot +
    slots, ... and writes row `slot` of the partials at its N-tile's
    columns."""
    m_tiles: int
    n_tiles: int
    k_chunks: int
    slots: int
    resident: int     # 1: W's K x TILE_N slice stays in shared memory
    stages: int
    stage_bytes: int  # the x chunk, and the W chunk when W is streamed
    w_bytes: int      # the resident W slice, else 0
    ss_bytes: int     # scale and shift in fp32 (the prologue), else 0
    smem_bytes: int   # the layout + 1024 to align it


@functools.lru_cache(maxsize=256)
def k2_plan(M: int, K: int, N: int, bn_in: bool, sms: int = H100_SMS) -> K2Plan:
    """The launch for x [M, K] and w [K, N] on a card of `sms` SMs: W's
    slice resident when it fits beside two stages, then as many stages (up to
    MAX_STAGES) as fit; one CTA an SM over all N-tiles, and as few rounds of
    M-tiles per CTA as that allows, spread over as few slots as give them."""
    m_tiles, n_tiles, k_chunks = -(-M // TILE_M), -(-N // TILE_N), -(-K // CHUNK_K)
    ss = 2 * k_chunks * CHUNK_K * 4 if bn_in else 0
    fixed = Y_BYTES + ss + RED_BYTES + 1024
    w_res = k_chunks * CHUNK_BYTES
    resident = int(w_res + 2 * CHUNK_BYTES + fixed <= SMEM_MAX)
    stage = CHUNK_BYTES * (1 if resident else 2)
    w_bytes = w_res if resident else 0
    stages = min(MAX_STAGES, (SMEM_MAX - fixed - w_bytes) // stage)
    rounds = -(-m_tiles // max(1, min(m_tiles, sms // n_tiles)))
    return K2Plan(m_tiles, n_tiles, k_chunks, -(-m_tiles // rounds), resident, stages, stage,
                  w_bytes, ss, w_bytes + stages * stage + fixed)


class _Launch(ctypes.Structure):
    """The C entry point's `Launch` (csrc/conv1x1_bn.cu), field by field:
    what a call passes besides its tensors and stream; `_kernel` checks the
    size against the library's."""
    _fields_ = [("M", ctypes.c_longlong), ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("bn_in", ctypes.c_int), ("relu", ctypes.c_int), ("device", ctypes.c_int),
                ("plan", ctypes.c_int * len(K2Plan._fields))]


@functools.lru_cache(maxsize=256)
def _launch_args(M: int, K: int, N: int, bn_in: bool, relu: bool, device: int):
    """(plan, its `_Launch`) for a call on `device`, cached: a shape seen
    before costs one lookup. The call passes the `_Launch` itself (ctypes
    hands C a pointer to it), which keeps it alive through the call."""
    plan = k2_plan(M, K, N, bn_in, _build.sms(device))
    return plan, _Launch(M, K, N, int(bn_in), int(relu), device,
                         (ctypes.c_int * len(plan))(*plan))


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
    lib.conv1x1_bn_launch_bytes.restype = ctypes.c_size_t
    if lib.conv1x1_bn_launch_bytes() != ctypes.sizeof(_Launch):
        raise RuntimeError("ops/conv1x1_bn.py `_Launch` does not match csrc/conv1x1_bn.cu "
                           "`Launch`")
    p = ctypes.c_void_p
    fn = lib.conv1x1_bn_stats
    fn.argtypes = [p] * 7 + [ctypes.POINTER(_Launch), p]
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
    bn_in = prev_scale is not None
    scale = shift = None
    if bn_in:
        scale = _build.aligned(prev_scale, torch.float32)
        shift = _build.aligned(prev_shift, torch.float32)
    plan, launch = _launch_args(M, K, N, bn_in, bool(relu_in), x.get_device())
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    part = torch.empty((plan.slots, 2 * N), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, N), dtype=torch.float32, device=x.device)
    err = _kernel()(xa.data_ptr(), wa.data_ptr(), scale.data_ptr() if bn_in else None,
                    shift.data_ptr() if bn_in else None, y.data_ptr(), part.data_ptr(),
                    stats.data_ptr(), launch, _build.stream(x))
    _build.raise_on(err, "conv1x1_bn_stats")
    if bn_in:
        conv1x1_bn_stats.launches_bn_in += 1
    else:
        conv1x1_bn_stats.launches += 1
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
