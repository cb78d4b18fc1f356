"""Flash attention: hand-written Hopper kernels (forward, and the backward as a
dK/dV kernel and a dQ kernel) and their plain versions.

Replaces `imageclassification_tpu/models/vit.py:25` `flash_attention_fn`,
which runs the Pallas TPU kernel `jax.experimental.pallas.ops.tpu.flash_attention`
behind ViT's `--flash_attn`, forward and (under `jax.grad`, in training) its
custom VJP. Same layout at the public function: q, k, v and the output are
[B, N, H, D], sm_scale = D ** -0.5, no bias and no mask. The TPU version pads
the token axis to a multiple of 128 and masks the padded keys by segment ids;
that padding is a TPU tiling detail, so here nothing is padded and the
kernels mask the ragged tail themselves.

What bounds them on an H100 and what the designs do about it: see the headers
of `csrc/flash_attention_fwd.cu` and `csrc/flash_attention_bwd.cu`. In short:
memory-bound at ViT's N = 197, compute-bound from a few hundred tokens up;
one CTA per (batch, head, 64-row tile) looping over the other axis, tiles
streamed through shared memory with cp.async, the N x N products kept in
registers, all products on tensor cores (mma.sync bf16, fp32 accumulation).
The forward writes the row log-sum-exp (fp32 [B, H, N]) only when autograd
will run the backward, which recomputes P from it.

`flash_attention` takes the plain version only for tensors on the CPU (where
autograd differentiates it as plain torch code). For a CUDA tensor it
launches the kernels or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

KERNEL = "flash_attention_fwd"
KERNEL_BWD = "flash_attention_bwd"
HEAD_DIM = 64


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


def flash_attention_bwd_ref(q, k, v, o, lse, do):
    """Plain version of the backward, explicit fp32 math: (dq, dk, dv) of
    softmax(q k^T * D^-0.5) v given the output o, its row log-sum-exp `lse`
    ([B, H, N]) and the output gradient do, [B, N, H, D] in and out, results
    in q's dtype."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = _heads_first(q, k, v, o, do)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse.float()[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    di = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - di)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernels do not take: NotImplementedError for the
    dtypes and head sizes not ported yet, ValueError for a layout the kernels
    cannot read."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise NotImplementedError(
            f"flash-attention kernel takes bfloat16 only, got {q.dtype}/{k.dtype}/{v.dtype}"
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
    if not _readable(q):
        raise ValueError(
            f"kernel needs unit stride on D and other strides a multiple of 8, got {q.stride()}"
        )
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel needs 16-byte aligned q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def _readable(t: torch.Tensor) -> bool:
    """The kernels read 16-byte chunks along D: unit stride there, the other
    strides a multiple of 8 elements."""
    return t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3])


def _fn(lib: str, name: str, n_ptrs: int, n_ints: int, n_strides: int):
    fn = getattr(_build.load(lib), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_longlong] * n_strides + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    return _fn(KERNEL, "flash_attention_fwd_bf16", 5, 3, 3)


@functools.cache
def _kernel_dkv():
    return _fn(KERNEL_BWD, "flash_attention_bwd_dkv_bf16", 8, 3, 6)


@functools.cache
def _kernel_dq():
    return _fn(KERNEL_BWD, "flash_attention_bwd_dq_bf16", 7, 3, 6)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool = False):
    """Forward kernel: (out, lse), lse None unless `with_lse`."""
    check_kernel_inputs(q, k, v)
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if with_lse else None
    sb, sn, sh, _ = q.stride()
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            B, N, H, sb, sn, sh, D ** -0.5, _stream(q),
        )
    _raise_on(err, KERNEL)
    flash_attention.launches += 1
    if with_lse:
        flash_attention.launches_lse += 1
    return out, lse


def _bwd_inputs(q, k, v, o, lse, do):
    """Checks shared by the two backward kernels; returns (do, di) with do in a
    layout the kernels read and di = rowsum(do * o) fp32 [B, H, N], the jnp
    expression outside Pallas in the TPU version (flash_attention.py:273-275)."""
    check_kernel_inputs(q, k, v)
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do and o must match q's shape and dtype, got do "
                         f"{tuple(do.shape)} {do.dtype}, o {tuple(o.shape)}")
    B, N, H, _ = q.shape
    if lse.shape != (B, H, N) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {(B, H, N)}, got {tuple(lse.shape)}")
    if not _readable(do) or do.data_ptr() % 16:
        do = do.contiguous()
    di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return do, di


def _launch_dkv(q, k, v, do, lse, di):
    """dK/dV kernel on checked inputs (see `_bwd_inputs`): (dk, dv)."""
    B, N, H, D = q.shape
    dk = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        err = _kernel_dkv()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, N, H, *q.stride()[:3],
            *do.stride()[:3], D ** -0.5, _stream(q),
        )
    _raise_on(err, "flash_attention_bwd_dkv")
    flash_attention.launches_dkv += 1
    return dk, dv


def _launch_dq(q, k, v, do, lse, di):
    """dQ kernel on checked inputs (see `_bwd_inputs`): dq."""
    B, N, H, D = q.shape
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel_dq()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq.data_ptr(), B, N, H, *q.stride()[:3], *do.stride()[:3],
            D ** -0.5, _stream(q),
        )
    _raise_on(err, "flash_attention_bwd_dq")
    flash_attention.launches_dq += 1
    return dq


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) through the two backward kernels; CUDA tensors only."""
    do, di = _bwd_inputs(q, k, v, o, lse, do)
    dk, dv = _launch_dkv(q, k, v, do, lse, di)
    return _launch_dq(q, k, v, do, lse, di), dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        needs_grad = any(ctx.needs_input_grad)
        out, lse = _launch(q, k, v, with_lse=needs_grad)
        if needs_grad:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        return flash_attention_bwd(*ctx.saved_tensors, grad_out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T * D^-0.5) v over [B, N, H, D] tensors, differentiable.

    CPU tensors take `flash_attention_ref`; CUDA tensors launch the kernels
    (bf16, D = 64). Counts, as plain integers on this function: `launches`
    (forward kernel), `launches_lse` (of those, the ones that wrote lse for a
    backward), `launches_dkv` and `launches_dq` (one each per backward)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_attention runs on cpu or cuda, not {q.device.type}")
    return _FlashAttention.apply(q, k, v)


def reset_launches() -> None:
    """Set every launch count of `flash_attention` to 0."""
    flash_attention.launches = 0
    flash_attention.launches_lse = 0
    flash_attention.launches_dkv = 0
    flash_attention.launches_dq = 0


reset_launches()
