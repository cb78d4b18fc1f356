"""Flash-attention forward: a hand-written Hopper kernel and its plain version.

Replaces `imageclassification_tpu/models/vit.py:25` `flash_attention_fn`,
which runs the Pallas TPU kernel `jax.experimental.pallas.ops.tpu.flash_attention`
behind ViT's `--flash_attn`. Same layout at the public function: q, k, v and
the output are [B, N, H, D], sm_scale = D ** -0.5, no bias and no mask. The
TPU version pads the token axis to a multiple of 128 and masks the padded keys
by segment ids; that padding is a TPU tiling detail, so here nothing is padded
and the kernel masks the ragged tail itself.

What bounds it on an H100 and what the design does about it: see the header
of `csrc/flash_attention_fwd.cu`. In short: memory-bound at ViT's N = 197
(q, k, v read once and o written once dominate), compute-bound from about
N = 600 up; one CTA per (batch, head, 64 query rows), K/V tiles streamed
through shared memory with cp.async, S and P kept in registers, both products
on tensor cores (mma.sync bf16, fp32 accumulation), online softmax in fp32.

`flash_attention` takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

KERNEL = "flash_attention_fwd"
HEAD_DIM = 64


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 matmul -> softmax -> matmul, [B, N, H, D] in and
    out, result in the input dtype."""
    d = q.shape[-1]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B, H, N, D]
    w = torch.softmax(torch.matmul(qf * d ** -0.5, kf.transpose(-1, -2)), dim=-1)
    return torch.matmul(w, vf).transpose(1, 2).to(q.dtype)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take: NotImplementedError for the
    dtypes and head sizes not ported yet, ValueError for a layout the kernel
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
    if q.stride(-1) != 1 or any(s % 8 for s in q.stride()[:3]):
        raise ValueError(
            f"kernel needs unit stride on D and other strides a multiple of 8, got {q.stride()}"
        )
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel needs 16-byte aligned q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


@functools.cache
def _kernel():
    fn = _build.load(KERNEL).flash_attention_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    check_kernel_inputs(q, k, v)
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    sb, sn, sh, _ = q.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, N, H, sb, sn, sh, D ** -0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


class _FlashAttentionFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the flash-attention backward kernel is not ported yet (training slice); "
            "train with flash_attn=False"
        )


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T * D^-0.5) v over [B, N, H, D] tensors.

    CPU tensors take `flash_attention_ref`; CUDA tensors launch the kernel
    (bf16, D = 64) and count one launch in `flash_attention.launches`."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_attention runs on cpu or cuda, not {q.device.type}")
    return _FlashAttentionFwd.apply(q, k, v)


flash_attention.launches = 0
