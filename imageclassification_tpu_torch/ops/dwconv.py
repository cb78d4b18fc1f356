"""7x7 depthwise convolution: hand-written Hopper kernels (the forward, which
also gives the input gradient, and the weight gradient) and their plain
versions.

Replaces `imageclassification_tpu/ops/pallas_dwconv.py::depthwise_conv7x7`:
the Pallas TPU kernel `_kernel` behind `_dwconv_pallas` (`pl.pallas_call` at
:58), run on the padded input for the forward and on the padded output
gradient with the spatially flipped kernel for dx (`_bwd`, :103-109); dw is
49 shifted reductions that the JAX package leaves to XLA (:111-120) and the
port hand-writes too, because a torch expression of it builds 49 full-size
fp32 temporaries. Same function at the public entry point:
`depthwise_conv7x7(x, w)` with x [B, H, W, C] (NHWC), w [7, 7, C], stride 1,
zero padding 3, no bias, fp32 accumulation, the output and dx in x's dtype,
dw in w's dtype.

What bounds the kernels on an H100 and what the designs do about it: see the
header of `csrc/dwconv7x7.cu`. For bf16 the forward (and dx) is bound by
bytes, since a tensor-core form exists; run on the fp32 CUDA cores, as here,
its operations take longer than its bytes. Persistent CTAs walk over bands
of output rows fed by a TMA ring of input bands with their halo (zero-filled
by the copy, not by a padded tensor), the tile's weights in fp32 loaded once
a CTA, and each thread slides along one output row with its accumulators in
registers, so each input value is loaded and converted once for each kernel
row it feeds. dw
slides a 7-pixel register window of x along a row, 7 x 4 accumulators a
thread, over bands of 8 rows fed by TMA, from per-CTA partials summed by a
second pass, no atomics.
The host computes both kernels' work splits and shared-memory layouts
(`fwd_plan`, `dw_plan`) and passes them to the kernels, which check and use
them, so the CPU tests check what is launched.

The host path is kept short, as the LayerNorm wrapper's is: a call that needs
no gradient launches without an autograd node, each launch's scalars are one
`ctypes.Structure` cached by shape, and the C entry points make the tensors'
device current themselves.

Like the Pallas kernel this is an op of its own: the JAX ConvNeXt runs
`lax.conv` and the port's ConvNeXt runs `F.conv2d(groups=C)`, not this op.

`depthwise_conv7x7` takes the plain versions only for tensors on the CPU. For
a CUDA tensor it launches the kernels or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

KERNEL = "dwconv7x7"
K, PAD = 7, 3
# the channel width of a thread: C must be a multiple of it
CHANNEL_VECTOR = 8
# the forward's work split (csrc/dwconv7x7.cu): tiles of FWD_CHANNELS
# channels (8 threads of 4), bands of at most FWD_MAX_ROWS output rows (one
# row an 8-thread group), segments of one of FWD_SEGMENTS columns, up to
# FWD_STAGES stages a CTA; CTAs an SM as FWD_THREADS_PER_SM threads allow (at
# most FWD_MAX_CTAS_PER_SM; the launch bounds give a thread 128 registers), each
# within its share of shared memory (an H100 SM has SMEM_PER_SM bytes; each
# CTA's runtime keeps 1 KB and its static part, the tile's fp32 weights and
# the barriers, FWD_STATIC_BYTES), a CTA asking for at most FWD_SMEM_MAX
FWD_CHANNELS, FWD_MAX_ROWS, FWD_SEGMENTS, FWD_STAGES = 32, 16, (14, 7), 4
FWD_THREADS_PER_SM, FWD_MAX_CTAS_PER_SM = 512, 8
SMEM_PER_SM, FWD_SMEM_MAX, FWD_STATIC_BYTES = 233472, 232448 - 8192, 49 * 32 * 4 + 64
# the weight gradient's work split (csrc/dwconv7x7.cu): bands of DW_ROWS dy
# rows, tiles of DW_CHANNELS channels, segments of at most DW_SEGMENT columns
# (a multiple of 7), up to DW_STAGES shared-memory stages a CTA;
# DW_CTAS_PER_SM CTAs of 7 warps fit an SM by registers, and by shared memory
# when each stays within DW_SMEM_PER_CTA bytes (an H100 SM has 228 KB, of
# which each CTA's runtime keeps 1 KB)
DW_ROWS, DW_CHANNELS, DW_SEGMENT, DW_STAGES = 8, 16, 28, 4
DW_CTAS_PER_SM = 3
DW_SMEM_PER_CTA = (233472 - DW_CTAS_PER_SM * 1024) // DW_CTAS_PER_SM
H100_SMS = 132
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dwconv7x7_ref(x: torch.Tensor, w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """Plain version of the forward (the Pallas `_kernel`'s math): 49 shifted
    multiply-adds of the zero-padded x in fp32, result in x's dtype. With
    `flip`, w is read flipped in both spatial axes (the input gradient when x
    is the output gradient)."""
    B, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, PAD, PAD, PAD, PAD))
    wf = w.float().flip(0, 1) if flip else w.float()
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device)
    for ky in range(K):
        for kx in range(K):
            acc += xp[:, ky:ky + H, kx:kx + W, :] * wf[ky, kx]
    return acc.to(x.dtype)


def dwconv7x7_dw_ref(x: torch.Tensor, dy: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the weight gradient (the JAX `_bwd`'s dw):
    dw[ky, kx, c] = sum over b, h, w of x_pad[b, h + ky, w + kx, c] dy[b, h, w, c]
    in fp32, as [7, 7, C] in `dtype`."""
    _, H, W, _ = x.shape
    xp = F.pad(x.float(), (0, 0, PAD, PAD, PAD, PAD))
    dyf = dy.float()
    return torch.stack([
        torch.stack([(xp[:, ky:ky + H, kx:kx + W, :] * dyf).sum((0, 1, 2)) for kx in range(K)])
        for ky in range(K)]).to(dtype)


class FwdPlan(NamedTuple):
    """The forward kernel's work split and shared-memory layout: the
    kernel's `FwdPlan`, in its order. Item i of the B * bands * segs items is
    (batch i // (bands * segs), band (i // segs) % bands, segment i % segs);
    CTA (slot, tile) computes the items slot, slot + slots, ... of channel
    tile `tile`."""
    rows: int        # output rows a band, 1 to FWD_MAX_ROWS
    seg: int         # output columns a segment, one of FWD_SEGMENTS
    bands: int
    segs: int
    tiles: int       # channel tiles of FWD_CHANNELS
    items: int
    slots: int       # CTAs a channel tile
    stages: int      # shared-memory stages a CTA: the next stages - 1 items load ahead
    row_px: int      # pixels a shared-memory row of a stage's tile (odd, >= seg + 6)
    stage_bytes: int  # (rows + 6) x row_px pixels of FWD_CHANNELS channels, 128-aligned
    smem_bytes: int  # dynamic shared memory a CTA: the stages + 128 to align them
    threads: int     # 32 x ceil(rows / 4)


@functools.lru_cache(maxsize=64)
def fwd_plan(B: int, H: int, W: int, C: int, itemsize: int, sms: int = H100_SMS) -> FwdPlan:
    """The forward's split for [B, H, W, C] inputs of `itemsize` bytes on a
    card of `sms` SMs. Segments of the width in FWD_SEGMENTS that costs a
    thread the fewest FMAs and loads along a row (a segment of s columns
    takes 28 s FMAs and s + 6 loads, of 5 issue slots each with the bf16
    conversion, a kernel row); bands of equal rows, as few as hold H at
    FWD_MAX_ROWS; the CTAs an SM that FWD_THREADS_PER_SM threads allow, fewer
    where two stages do not fit beside them; as many stages (up to
    FWD_STAGES) as fit a CTA's share of shared memory; and as few rounds of
    items per CTA as that many CTAs allow, spread over as few slots as give
    them."""
    seg = min(FWD_SEGMENTS, key=lambda s: math.ceil(W / s) * (33 * s + 30))
    segs = math.ceil(W / seg)
    bands = math.ceil(H / FWD_MAX_ROWS)
    rows = math.ceil(H / bands)
    tiles = math.ceil(C / FWD_CHANNELS)
    items = B * bands * segs
    threads = 32 * math.ceil(rows / 4)
    row_px = (seg + 2 * PAD) | 1
    stage = _round128((rows + 2 * PAD) * row_px * FWD_CHANNELS * itemsize)
    # one CTA an SM always holds two stages: a stage is at most 59 KB
    for per_sm in range(max(1, min(FWD_MAX_CTAS_PER_SM, FWD_THREADS_PER_SM // threads)), 0, -1):
        budget = min(FWD_SMEM_MAX, SMEM_PER_SM // per_sm - 1024 - FWD_STATIC_BYTES) - 128
        if budget // stage >= 2:
            break
    stages = min(FWD_STAGES, budget // stage)
    rounds = math.ceil(items / max(1, min(items, per_sm * sms // tiles)))
    return FwdPlan(rows, seg, bands, segs, tiles, items, math.ceil(items / rounds), stages,
                   row_px, stage, stages * stage + 128, threads)


class DwPlan(NamedTuple):
    """The weight-gradient kernel's work split: item i of the
    B * bands * segs items is (batch i // (bands * segs), band
    (i // segs) % bands, segment i % segs); CTA (slot, tile) sums the items
    slot, slot + slots, ... of channel tile `tile`."""
    seg: int        # columns a segment (a multiple of 7)
    segs: int
    bands: int
    tiles: int
    items: int
    slots: int      # CTAs a channel tile, each writing one fp32 partial row
    stages: int     # shared-memory stages a CTA: the next stages - 1 items load ahead
    row_x: int      # pixels a shared-memory row of the x tile (odd, >= seg + 6)
    row_dy: int     # pixels a shared-memory row of the dy tile (odd, >= seg)
    x_bytes: int    # the x tile of a stage, rounded up to 128 bytes; the dy tile follows
    stage_bytes: int
    smem_bytes: int  # dynamic shared memory a CTA: the stages + 128 to align them


@functools.lru_cache(maxsize=64)
def dw_plan(B: int, H: int, W: int, C: int, itemsize: int, sms: int = H100_SMS) -> DwPlan:
    """The split for [B, H, W, C] inputs of `itemsize` bytes on a card of `sms`
    SMs: segments as wide as DW_SEGMENT allows, split evenly and rounded up to
    7; at most DW_CTAS_PER_SM CTAs an SM over all channel tiles, and as few
    rounds of items per CTA as that allows, spread over as few slots as give
    them; as many stages (up to DW_STAGES) as fit in a CTA's share of shared
    memory. A stage holds the x tile (DW_ROWS + 6 rows of row_x pixels) and
    then the dy tile (DW_ROWS rows of row_dy pixels), each 128-byte aligned
    for TMA; odd rows keep a warp's loads free of bank conflicts."""
    segs = math.ceil(W / DW_SEGMENT)
    seg = 7 * math.ceil(math.ceil(W / segs) / 7)
    bands, tiles = math.ceil(H / DW_ROWS), math.ceil(C / DW_CHANNELS)
    items = B * bands * segs
    rounds = math.ceil(items / max(1, min(items, DW_CTAS_PER_SM * sms // tiles)))
    row_x, row_dy = (seg + 2 * PAD) | 1, seg | 1
    x_bytes = _round128((DW_ROWS + 2 * PAD) * row_x * DW_CHANNELS * itemsize)
    stage = x_bytes + _round128(DW_ROWS * row_dy * DW_CHANNELS * itemsize)
    stages = max(1, min(DW_STAGES, (DW_SMEM_PER_CTA - 128) // stage))
    return DwPlan(seg, segs, bands, tiles, items, math.ceil(items / rounds), stages, row_x,
                  row_dy, x_bytes, stage, stages * stage + 128)


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def dw_cta_work(plan: DwPlan, H: int, W: int, C: int, slot: int, tile: int):
    """What CTA (slot, tile) of `plan` sums, as the kernel indexes it: a list
    of (batch, rows, columns, channels) ranges, one per item."""
    work = []
    for i in range(slot, plan.items, plan.slots):
        b, rem = divmod(i, plan.bands * plan.segs)
        band, s = divmod(rem, plan.segs)
        work.append((b, range(band * DW_ROWS, min(H, (band + 1) * DW_ROWS)),
                     range(s * plan.seg, min(W, (s + 1) * plan.seg)),
                     range(tile * DW_CHANNELS, min(C, (tile + 1) * DW_CHANNELS))))
    return work


class _FwdLaunch(ctypes.Structure):
    """The C entry point's `FwdLaunch` (csrc/dwconv7x7.cu), field by field:
    what a forward call passes besides its tensors and stream; `_kernels`
    checks the size against the library's."""
    _fields_ = [("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
                ("C", ctypes.c_int), ("flip", ctypes.c_int), ("x_dtype", ctypes.c_int),
                ("w_dtype", ctypes.c_int), ("device", ctypes.c_int),
                ("plan", ctypes.c_int * len(FwdPlan._fields))]


class _DwLaunch(ctypes.Structure):
    """The C entry point's `DwLaunch`, field by field, for the weight
    gradient."""
    _fields_ = [("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
                ("C", ctypes.c_int), ("x_dtype", ctypes.c_int), ("w_dtype", ctypes.c_int),
                ("device", ctypes.c_int), ("plan", ctypes.c_int * len(DwPlan._fields))]


@functools.lru_cache(maxsize=256)
def _fwd_launch(B: int, H: int, W: int, C: int, flip: bool, x_dtype: torch.dtype,
                w_dtype: torch.dtype, device: int) -> _FwdLaunch:
    """The forward's `_FwdLaunch` for a call on `device`, cached: a shape
    seen before costs one lookup. The call passes it itself (ctypes hands C
    a pointer to it), which keeps it alive through the call."""
    plan = fwd_plan(B, H, W, C, x_dtype.itemsize, _build.sms(device))
    return _FwdLaunch(B, H, W, C, int(flip), _DTYPES[x_dtype], _DTYPES[w_dtype], device,
                      (ctypes.c_int * len(plan))(*plan))


@functools.lru_cache(maxsize=256)
def _dw_launch(B: int, H: int, W: int, C: int, x_dtype: torch.dtype, w_dtype: torch.dtype,
               device: int):
    """(plan, its `_DwLaunch`) for a weight-gradient call on `device`,
    cached."""
    plan = dw_plan(B, H, W, C, x_dtype.itemsize, _build.sms(device))
    return plan, _DwLaunch(B, H, W, C, _DTYPES[x_dtype], _DTYPES[w_dtype], device,
                           (ctypes.c_int * len(plan))(*plan))


@functools.cache
def _kernels():
    lib = _build.load(KERNEL)
    for name, struct in (("fwd", _FwdLaunch), ("dw", _DwLaunch)):
        size = getattr(lib, f"dwconv7x7_{name}_launch_bytes")
        size.restype = ctypes.c_size_t
        if size() != ctypes.sizeof(struct):
            raise RuntimeError(f"ops/dwconv.py `{struct.__name__}` does not match "
                               f"csrc/dwconv7x7.cu `{struct.__name__[1:]}`")
    p = ctypes.c_void_p
    fwd, dw = lib.dwconv7x7_fwd, lib.dwconv7x7_dw
    fwd.argtypes = [p, p, p, ctypes.POINTER(_FwdLaunch), p]
    dw.argtypes = [p, p, p, p, ctypes.POINTER(_DwLaunch), p]
    fwd.restype = dw.restype = ctypes.c_int
    return fwd, dw


def check_kernel_inputs(x: torch.Tensor, w_shape, w_dtype: torch.dtype) -> None:
    """Raise on what the kernels do not take, for x and a weight (or weight
    gradient) of `w_shape` and `w_dtype`: NotImplementedError for dtypes and
    channel counts not ported, ValueError for shapes that do not fit."""
    if x.dtype not in _DTYPES or w_dtype not in _DTYPES:
        raise NotImplementedError(
            f"depthwise-conv kernels take float32 or bfloat16, got x {x.dtype}, w {w_dtype}")
    if x.dim() != 4 or tuple(w_shape) != (K, K, x.shape[-1]):
        raise ValueError(f"x must be [B, H, W, C] and w [7, 7, C], got {tuple(x.shape)}, "
                         f"{tuple(w_shape)}")
    if x.shape[-1] % CHANNEL_VECTOR:
        raise NotImplementedError(
            f"depthwise-conv kernels take C a multiple of {CHANNEL_VECTOR}, got {x.shape[-1]}")


def _launch_fwd(x: torch.Tensor, w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """Forward kernel (with `flip`, the input gradient's): out in x's dtype."""
    check_kernel_inputs(x, w.shape, w.dtype)
    if x.device != w.device:
        raise ValueError("x and w must be on one device")
    x, w = _build.aligned(x), _build.aligned(w)
    out = torch.empty_like(x)
    if not out.numel():
        return out
    launch = _fwd_launch(*x.shape, flip, x.dtype, w.dtype, x.get_device())
    err = _kernels()[0](x.data_ptr(), w.data_ptr(), out.data_ptr(), launch, _build.stream(x))
    _build.raise_on(err, "dwconv7x7_fwd")
    if flip:
        depthwise_conv7x7.launches_dx += 1
    else:
        depthwise_conv7x7.launches += 1
    return out


def _launch_dw(x: torch.Tensor, dy: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Weight-gradient kernel (and its partial-sum pass): dw [7, 7, C] in
    `dtype`."""
    check_kernel_inputs(x, (K, K, x.shape[-1]), dtype)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x's shape and dtype, got {tuple(dy.shape)} {dy.dtype}")
    x, dy = _build.aligned(x), _build.aligned(dy)
    C = x.shape[-1]
    if not x.numel():
        return torch.zeros((K, K, C), dtype=dtype, device=x.device)
    plan, launch = _dw_launch(*x.shape, x.dtype, dtype, x.get_device())
    part = torch.empty((plan.slots, K * K * C), dtype=torch.float32, device=x.device)
    dw = torch.empty((K, K, C), dtype=dtype, device=x.device)
    err = _kernels()[1](x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(), launch,
                        _build.stream(x))
    _build.raise_on(err, "dwconv7x7_dw")
    depthwise_conv7x7.launches_dw += 1
    return dw


def dwconv7x7_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """(dx in x's dtype, dw in w's dtype) of `depthwise_conv7x7`: dx is the
    forward run on dy with the flipped w, dw the 49 shifted reductions; plain
    versions for CPU tensors, the kernels for CUDA tensors."""
    dy = dy.to(x.dtype)
    if x.is_cpu:
        return dwconv7x7_ref(dy, w, flip=True), dwconv7x7_dw_ref(x, dy, w.dtype)
    return _launch_fwd(dy, w, flip=True), _launch_dw(x, dy, w.dtype)


def _forward(x, w):
    return dwconv7x7_ref(x, w) if x.is_cpu else _launch_fwd(x, w)


class _DepthwiseConv7x7(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        return dwconv7x7_bwd(*ctx.saved_tensors, dy)


def depthwise_conv7x7(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """7x7 depthwise conv of NHWC x [B, H, W, C] with w [7, 7, C], stride 1,
    zero padding 3, no bias; differentiable in x and w.

    CPU tensors take the plain versions (`dwconv7x7_ref`,
    `dwconv7x7_dw_ref`); CUDA tensors launch the kernels (float32 or
    bfloat16, C a multiple of 8). Only a call that needs a gradient builds
    an autograd node. Counts, as plain integers on this function:
    `launches` (forward kernel), `launches_dx` (the same kernel run for dx)
    and `launches_dw` (weight-gradient kernel)."""
    if not (x.is_cuda or x.is_cpu):
        raise NotImplementedError(f"depthwise_conv7x7 runs on cpu or cuda, not {x.device.type}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _DepthwiseConv7x7.apply(x, w)
    return _forward(x, w)


def reset_launches() -> None:
    """Set the launch counts of `depthwise_conv7x7` to 0."""
    depthwise_conv7x7.launches = 0
    depthwise_conv7x7.launches_dx = 0
    depthwise_conv7x7.launches_dw = 0


reset_launches()
