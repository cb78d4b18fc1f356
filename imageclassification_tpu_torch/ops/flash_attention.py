"""Flash attention: hand-written Hopper kernels (forward, and the backward as a
dQ kernel and a dK/dV kernel), in bf16 and in fp32, and their plain versions.

Replaces `imageclassification_tpu/models/vit.py:25` `flash_attention_fn`,
which runs the Pallas TPU kernel `jax.experimental.pallas.ops.tpu.flash_attention`
behind ViT's `--flash_attn`, forward and (under `jax.grad`, in training) its
custom VJP. Same layout at the public function: q, k, v and the output are
[B, N, H, D], sm_scale = D ** -0.5, no bias and no mask. The TPU version pads
the token axis to a multiple of 128 and masks the padded keys by segment ids;
that padding is a TPU tiling detail, so here nothing is padded and the
kernels mask the ragged tail themselves.

The JAX function hands the Pallas kernel the model's own dtype: bf16 under
`--half_precision true`, fp32 under `--half_precision false`. So there are
two sets of kernels, chosen by the inputs' dtype in `_launch`, `_launch_dq`
and `_launch_dkv` (and so in `_FlashAttention` and the two operators): the
bf16 ones (`csrc/flash_attention_fwd.cu`, `csrc/flash_attention_bwd.cu`)
and the fp32 ones (`csrc/flash_attention_f32.cu`, the forward, and
`csrc/flash_attention_f32_bwd.cu`, dQ and dK/dV: every product as three
TF32 products on wgmma, hi*hi + hi*lo + lo*hi of each operand's tf32 head
and tail, q, k, v, o and dO read through tensor maps). Both take the same
arguments (`_Launch`) and write the same outputs (o, lse, di, dq, dk, dv) in
their inputs' dtype, lse and di fp32.

What bounds the kernels on an H100 and what their designs do about it:
see the headers of `csrc/flash_attention_fwd.cu`,
`csrc/flash_attention_bwd.cu`, `csrc/flash_attention_f32.cu` and
`csrc/flash_attention_f32_bwd.cu`. In short, for bf16:
memory-bound at ViT's N = 197, compute-bound from a few hundred tokens up;
the N x N products kept in registers, all products on tensor cores (bf16,
fp32 accumulation). The forward: persistent CTAs walking over (batch, head,
128-row query block) items, K/V tiles loaded by TMA into a 4-stage ring from
tensor maps of the strided [B, N, H, 64] view (`tensor_map_layout`),
products on the warpgroup tensor cores (wgmma). The backward is two
launches and no torch work between them: the dQ kernel runs first and also
computes di = rowsum(dO * O) from its tiles of O and dO, which it writes for
the dK/dV kernel; each walks persistently over (batch, head, row block)
items, one CTA an SM, the other axis's tiles streamed through a TMA ring from
tensor maps of q, k, v, o and dO as they lie, products on wgmma (the fp32
backward the same, in 64-row items and 32-row ring tiles). The
forward writes the row log-sum-exp (fp32 [B, H, N]) only when autograd will
run the backward, which recomputes P from it.

The host path is the other wrappers' (the LayerNorm wrapper's): a call that
needs no gradient launches without an autograd node, the call's scalars go
to C as one cached `ctypes.Structure` (`_Launch`, its size checked against
both libraries at load), and the C entry points make the tensors' device
current themselves. The kernels launch on torch's current stream and
allocate nothing, so a CUDA graph captures them (the captured ViT steps,
`engine/compiled.py`): their tensor maps are encoded on the host at capture,
over the graph pool's fixed addresses, and travel in the captured launches.

`flash_attention` takes the plain version only for tensors on the CPU (where
autograd differentiates it as plain torch code). For a CUDA tensor it
launches the kernels or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from . import _build

KERNEL = "flash_attention_fwd"
KERNEL_BWD = "flash_attention_bwd"
KERNEL_F32 = "flash_attention_f32"
KERNEL_F32_BWD = "flash_attention_f32_bwd"
HEAD_DIM = 64
# the kernels' dtypes, and the suffix of each one's launch counts
_COUNT_SUFFIX = {torch.bfloat16: "", torch.float32: "_f32"}


def _heads_first(*ts):
    return (t.float().transpose(1, 2) for t in ts)  # [B, H, N, D] fp32


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 matmul -> softmax -> matmul, [B, N, H, D] in and
    out, result in the input dtype."""
    d = q.shape[-1]
    qf, kf, vf = _heads_first(q, k, v)
    w = torch.softmax(torch.matmul(qf * d ** -0.5, kf.transpose(-1, -2)), dim=-1)
    return torch.matmul(w, vf).transpose(1, 2).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward's residual: logsumexp over keys of the
    fp32 scores q k^T * D^-0.5, fp32 [B, H, N]."""
    qf, kf = _heads_first(q, k)
    return torch.logsumexp(torch.matmul(qf * q.shape[-1] ** -0.5, kf.transpose(-1, -2)), -1)


def flash_attention_di_ref(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Plain version of the di that the dQ kernel writes: rowsum(do * o) over
    the head dimension in fp32, [B, N, H, D] in, fp32 [B, H, N] out."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2)


def flash_attention_bwd_ref(q, k, v, o, lse, do):
    """Plain version of the backward, explicit fp32 math: (dq, dk, dv) of
    softmax(q k^T * D^-0.5) v given the output o, its row log-sum-exp `lse`
    ([B, H, N]) and the output gradient do, [B, N, H, D] in and out, results
    in q's dtype."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = _heads_first(q, k, v, do)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse.float()[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    di = flash_attention_di_ref(o, do)[..., None]
    ds = p * (dp - di)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise on what the kernels do not take: NotImplementedError for the
    dtypes and head sizes not ported yet, ValueError for a layout the kernels
    cannot read. q, k and v are all bf16 (the bf16 kernels) or all fp32 (the
    fp32 kernels). Returns the layout of the kernels' tensor maps
    (`tensor_map_layout`), which both dtypes' kernels read q, k and v
    through."""
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _COUNT_SUFFIX):
        raise NotImplementedError(
            f"flash-attention kernels take bfloat16 or float32 q, k, v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one [B, N, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[-1] != HEAD_DIM:
        raise NotImplementedError(
            f"flash-attention kernel takes head_dim {HEAD_DIM} only, got {q.shape[-1]}"
        )
    if not (q.stride() == k.stride() == v.stride()):
        raise ValueError(
            f"q, k, v must share strides, got {q.stride()}, {k.stride()}, {v.stride()}"
        )
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("kernel needs 16-byte aligned q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    return tensor_map_layout(q)


def tensor_map_layout(t: torch.Tensor):
    """(dims, byte strides) of the kernels' TMA tensor maps over a
    [B, N, H, D] view: dims (D, H, N, B) innermost first, and the byte strides
    of H, N and B. TMA needs a unit stride on D and the other byte strides
    multiples of 16 below 2^40; raises ValueError for a view it cannot take."""
    if t.dim() != 4:
        raise ValueError(f"tensor map over [B, N, H, D] only, got {tuple(t.shape)}")
    B, N, H, D = t.shape
    sb, sn, sh, sd = (s * t.element_size() for s in t.stride())
    if sd != t.element_size() or any(s % 16 or s >= 2 ** 40 for s in (sh, sn, sb)):
        raise ValueError(f"TMA needs unit stride on D and 16-byte multiples on H, N, B; "
                         f"got strides {t.stride()} of {t.element_size()}-byte elements")
    return (D, H, N, B), (sh, sn, sb)


class _Launch(ctypes.Structure):
    """The C entry points' `FlashLaunch` (csrc/flash_attention_common.cuh),
    field by field: what a call passes besides its tensors and stream.
    `_kernels` checks its size against both libraries'."""
    _fields_ = [("B", ctypes.c_int), ("N", ctypes.c_int), ("H", ctypes.c_int),
                ("device", ctypes.c_int), ("qkv_stride", ctypes.c_longlong * 3),
                ("o_stride", ctypes.c_longlong * 3), ("do_stride", ctypes.c_longlong * 3),
                ("sm_scale", ctypes.c_float)]


@functools.lru_cache(maxsize=256)
def _launch_args(B: int, N: int, H: int, D: int, device: int, qkv_strides: tuple,
                 o_strides: tuple = (0, 0, 0), do_strides: tuple = (0, 0, 0)) -> _Launch:
    """The `_Launch` of a call on `device`, cached: a shape and layout seen
    before cost one lookup. The call passes it itself (ctypes hands C a
    pointer to it), which keeps it alive through the call."""
    three = ctypes.c_longlong * 3
    return _Launch(B, N, H, device, three(*qkv_strides), three(*o_strides), three(*do_strides),
                   D ** -0.5)


@functools.cache
def _kernels(dtype: torch.dtype = torch.bfloat16):
    """(forward, dQ, dK/dV) C entry points of the kernels for `dtype` (bf16
    or fp32), their argument types set: the forward from one library, dQ and
    dK/dV from another, each checked against `_Launch`."""
    names, tag = ((KERNEL_F32, KERNEL_F32_BWD), "f32") if dtype == torch.float32 else \
        ((KERNEL, KERNEL_BWD), "bf16")
    fwd_lib, bwd_lib = libs = tuple(_build.load(name) for name in names)
    for lib, name in zip(libs, names):
        size = getattr(lib, f"{name}_launch_bytes")
        size.restype = ctypes.c_size_t
        if size() != ctypes.sizeof(_Launch):
            raise RuntimeError(f"ops/flash_attention.py `_Launch` does not match "
                               f"csrc/flash_attention_common.cuh `FlashLaunch` ({name})")
    p, launch = ctypes.c_void_p, ctypes.POINTER(_Launch)
    fwd = getattr(fwd_lib, f"flash_attention_fwd_{tag}")
    dq = getattr(bwd_lib, f"flash_attention_bwd_dq_{tag}")
    dkv = getattr(bwd_lib, f"flash_attention_bwd_dkv_{tag}")
    fwd.argtypes = [p] * 5 + [launch, p]
    dq.argtypes = dkv.argtypes = [p] * 8 + [launch, p]
    fwd.restype = dq.restype = dkv.restype = ctypes.c_int
    return fwd, dq, dkv


def _count(name: str, dtype: torch.dtype) -> None:
    """One more launch of the `dtype` kernel counted as `name`."""
    key = name + _COUNT_SUFFIX[dtype]
    setattr(flash_attention, key, getattr(flash_attention, key) + 1)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool = False):
    """Forward kernel of q's dtype: (out, lse), lse None unless `with_lse`."""
    _, strides = check_kernel_inputs(q, k, v)  # k and v share q's strides
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if with_lse else None
    err = _kernels(q.dtype)[0](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        _launch_args(B, N, H, D, q.get_device(), strides), _build.stream(q))
    _build.raise_on(err, KERNEL + _COUNT_SUFFIX[q.dtype])
    _count("launches", q.dtype)
    if with_lse:
        _count("launches_lse", q.dtype)
    return out, lse


def _tma_readable(t: torch.Tensor) -> bool:
    """Whether a tensor map reads t in place: a 16-byte aligned base, unit
    stride on D, the other strides positive multiples of 16 bytes."""
    try:
        _, strides = tensor_map_layout(t)
    except ValueError:
        return False
    return t.data_ptr() % 16 == 0 and min(strides) > 0


def _bwd_inputs(q, k, v, o, lse, do):
    """Checks shared by the two backward kernels. Returns (do, strides): do
    as given when a tensor map reads it in place, else a contiguous copy
    (autograd may hand over any layout); strides: the byte strides of the
    tensor maps of q (shared by k and v), o and do. o must be readable as it
    is: the forward kernel writes it contiguous."""
    _, qkv_strides = check_kernel_inputs(q, k, v)
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype or o.dtype != q.dtype:
        raise ValueError(f"do and o must match q's shape and dtype, got do "
                         f"{tuple(do.shape)} {do.dtype}, o {tuple(o.shape)} {o.dtype}")
    if not (o.device == do.device == lse.device == q.device):
        raise ValueError("o, do and lse must be on q's device")
    B, N, H, _ = q.shape
    if lse.shape != (B, H, N) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {(B, H, N)}, got {tuple(lse.shape)}")
    if not _tma_readable(o):
        raise ValueError(f"o must be readable by a tensor map (16-byte aligned, unit stride "
                         f"on D, the other strides positive multiples of 16 bytes), got "
                         f"strides {o.stride()}")
    if not _tma_readable(do):
        do = do.contiguous()
    return do, (qkv_strides, tensor_map_layout(o)[1], tensor_map_layout(do)[1])


def _launch_dq(q, k, v, o, do, lse, strides):
    """dQ kernel on checked inputs (see `_bwd_inputs`): (dq, di), di =
    rowsum(do * o) fp32 [B, H, N] as the kernel writes it for the dK/dV
    kernel."""
    B, N, H, D = q.shape
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    di = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    err = _kernels(q.dtype)[1](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        _launch_args(B, N, H, D, q.get_device(), *strides), _build.stream(q))
    _build.raise_on(err, "flash_attention_bwd_dq" + _COUNT_SUFFIX[q.dtype])
    _count("launches_dq", q.dtype)
    return dq, di


def _launch_dkv(q, k, v, do, lse, di, strides):
    """dK/dV kernel on checked inputs (see `_bwd_inputs`) and the di of
    `_launch_dq`: (dk, dv)."""
    B, N, H, D = q.shape
    dk = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    err = _kernels(q.dtype)[2](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _launch_args(B, N, H, D, q.get_device(), *strides), _build.stream(q))
    _build.raise_on(err, "flash_attention_bwd_dkv" + _COUNT_SUFFIX[q.dtype])
    _count("launches_dkv", q.dtype)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) through the two backward kernels of q's dtype, dQ first
    (it writes di for dK/dV); CUDA tensors only."""
    do, strides = _bwd_inputs(q, k, v, o, lse, do)
    dq, di = _launch_dq(q, k, v, o, do, lse, strides)
    dk, dv = _launch_dkv(q, k, v, do, lse, di, strides)
    return dq, dk, dv


# The launches as torch operators with fake implementations, so that
# torch.export (which traces with fake tensors) records them in a program
# instead of running the ctypes launches, and the reloaded program launches
# the kernels (modelchange.py's export of a --flash_attn model on the card).
# FlopCounterMode counts the forward's products through its operator too.
# Otherwise the calls launch directly (`_fwd`, `_bwd`): an operator's
# dispatch adds ~23 us of host time a call, which the eager paths would pay.
@torch.library.custom_op("imageclassification_tpu_torch::flash_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (out, lse); lse is empty unless `with_lse`."""
    out, lse = _launch(q, k, v, with_lse)
    return out, lse if with_lse else q.new_empty((0,), dtype=torch.float32)


@_fwd_op.register_fake
def _(q, k, v, with_lse):
    B, N, H, D = q.shape
    return (q.new_empty((B, N, H, D)),
            q.new_empty((B, H, N) if with_lse else (0,), dtype=torch.float32))


@torch.library.custom_op("imageclassification_tpu_torch::flash_attention_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
            lse: torch.Tensor, do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two backward kernels: (dq, dk, dv)."""
    return flash_attention_bwd(q, k, v, o, lse, do)


@_bwd_op.register_fake
def _(q, k, v, o, lse, do):
    return tuple(q.new_empty(q.shape) for _ in range(3))


@register_flop_formula(torch.ops.imageclassification_tpu_torch.flash_attention_fwd)
def _fwd_flops(q_shape, *args, **kwargs) -> int:
    """FlopCounterMode's count of a forward launch: the two products."""
    B, N, H, D = q_shape
    return 4 * B * H * N * N * D


def _watched() -> bool:
    """Whether torch traces the call (torch.export, torch.compile) or a
    dispatch mode sees it (fake tensors, FlopCounterMode)."""
    return torch.compiler.is_compiling() or _get_current_dispatch_mode() is not None


def _fwd(q, k, v, with_lse: bool):
    """(out, lse) of the forward kernel: through its operator where
    `_watched`, else launched directly."""
    if _watched():
        return _fwd_op(q, k, v, with_lse)
    return _launch(q, k, v, with_lse)


def _bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of the two backward kernels, as `_fwd` launches."""
    if _watched():
        return _bwd_op(q, k, v, o, lse, do)
    return flash_attention_bwd(q, k, v, o, lse, do)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        needs_grad = any(ctx.needs_input_grad)
        out, lse = _fwd(q, k, v, needs_grad)
        if needs_grad:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        return _bwd(*ctx.saved_tensors, grad_out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T * D^-0.5) v over [B, N, H, D] tensors, differentiable.

    CPU tensors take `flash_attention_ref`; CUDA tensors launch the kernels
    of their dtype (bf16 or fp32, D = 64), through the operators `_fwd_op`
    and `_bwd_op` where torch traces or a dispatch mode watches; only a call
    that needs a gradient builds an autograd node.
    Counts, as plain integers on this function: `launches` (forward kernel),
    `launches_lse` (of those, the ones that wrote lse for a backward),
    `launches_dkv` and `launches_dq` (one each per backward) of the bf16
    kernels, and the same names with `_f32` of the fp32 kernels."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_attention runs on cpu or cuda, not {q.device.type}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return _fwd(q, k, v, False)[0]


LAUNCH_COUNTS = tuple(f"launches{part}{suffix}" for suffix in _COUNT_SUFFIX.values()
                      for part in ("", "_lse", "_dkv", "_dq"))


def reset_launches() -> None:
    """Set every launch count of `flash_attention` to 0."""
    for name in LAUNCH_COUNTS:
        setattr(flash_attention, name, 0)


reset_launches()
