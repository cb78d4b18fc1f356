#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (imageclassification_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing its lines; any failure ends the script with a non-zero
exit before the last line:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build every kernel of the port from csrc/ (nvcc, sm_90a), timed;
3. each kernel against its plain PyTorch version on the same seeded inputs,
   in the layout the main path gives it (q, k, v strided out of one fused
   qkv tensor), at the main path's shape and larger ones, with the kernel's,
   the plain version's and one PyTorch library call's times (CUDA events,
   median, host cost of each call included) beside the least time the card
   could take (the bound): 3a the forward, 3b the backward (dK/dV and dQ
   kernels, and the forward's lse), each kernel's device time from a trace;
4. the serving path: a seeded JAX-format ViT-B/16 checkpoint trained with
   --flash_attn (random weights) and a seeded 5-class image folder go through
   `val_precision` and `val_move` on cuda at batch 64, with every kernel's
   launch count read around each run; the probabilities are held against the
   same model on the plain attention path; a torch.profiler trace of the
   forward with the flash path on and off gives device time by kernel;
5. the training path: `imageclassification_tpu_torch.train.main` trains
   ViT-B/16 --flash_attn at 224x224, batch 64, with the default training
   flags, for 2 epochs of 10 steps on a seeded 5-class folder of 750 images;
   every step's loss must be finite, each optimizer step must launch the
   forward 12 times with lse, 12 times without (the exact-mode accuracy
   forward) and each backward kernel 12 times, and checkpoint-1.pth must be
   in the JAX layout and load in the port's val.py;
   5b. on the trained weights: ms per train step and img/s (CUDA events over
   one fixed batch), a torch.profiler trace of train steps with flash on and
   off, and the flash path's gradients of one step held against the plain
   attention path and fp32 on the same weights, batch and draws;
6. one JSON line with every kernel's numbers, then the result line
   {"ok": true, "device": {...}}.

It exits non-zero without the result line when no CUDA device is visible.
The JAX package is not imported.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16
# tensor-core flop/s, the denominators of `bound_ms`
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

ATTN_SHAPES = [(64, 197, 12, 64), (16, 577, 12, 64), (2, 4097, 12, 64)]
MAIN_SHAPE = ATTN_SHAPES[0]  # ViT-B/16 at 224x224, batch 64
# bf16 output against the fp32 plain version: a tolerance of ATTN_RTOL times
# max|reference| at each shape. bf16 keeps 8 significant bits, so rounding the
# output costs up to 2^-8 of the largest value and rounding P before P.V about
# as much again; 2^-7 covers both.
ATTN_RTOL = 2.0 ** -7
# backward kernels (bf16 dq, dk, dv) against the fp32 plain version: a
# tolerance of ATTN_BWD_RTOL times max|reference| per gradient. On top of the
# output's rounding (2^-8 of the largest value), P and dS are rounded to bf16
# before their products, and dS = P (dP - di) takes a difference whose terms
# each carry the inputs' rounding; 2^-6 covers those, and each check proves
# the tolerance lies below what dropping the last key changes.
ATTN_BWD_RTOL = 2.0 ** -6
# the forward's lse (fp32 sums of exp2) against logsumexp of the fp32 scores
LSE_ATOL = 1e-3
# bf16 model (flash path) against the same weights in fp32 on the plain
# attention path: bf16 rounding over 12 blocks of activations, 5-class
# probabilities
PROBS_ATOL = 5e-2
# one train step's gradients, bf16 flash path against the same weights, batch
# and draws in fp32 (plain attention) and in bf16 on the plain attention path:
# relative global L2 error ||g - ref|| / ||ref||. bf16 keeps 8 bits (2^-8 ~
# 4e-3 per rounding), and the roundings of activations over 12 blocks forward
# and back partly cancel in the global norm: 1.8e-3 flash vs fp32 and 3.2e-4
# flash vs plain on the H100 after 20 steps; 1e-2 leaves a margin of 5x
GRAD_RTOL = 1e-2

# the training path: ViT-B/16, 224x224, batch 64, 2 epochs of 10 steps on a
# 5-class folder of 150 images per class (the default 0.9 split keeps 135 per
# class for training: 675 // 64 = 10 steps)
TRAIN = dict(img=224, batch=64, epochs=2, num_classes=5, per_class=150)

VIT_B16 = dict(name="vit_base_patch16", dim=768, depth=12, heads=12, patch=16)


def log(msg: str) -> None:
    print(msg, flush=True)


def jax_vit_params(rng: np.random.Generator, dim: int, depth: int, heads: int,
                   patch: int, img: int, num_classes: int, head_std: float = 0.1):
    """Flat parameters in the JAX package's ViT checkpoint layout
    ("block{i}/MultiHeadDotProductAttention_0/query/kernel" [E, H, hd], ...),
    drawn from `rng`: kernels N(0, 0.02), biases N(0, 0.01), LayerNorm
    scales 1 + N(0, 0.01), a head of std `head_std`."""
    hd = dim // heads
    tokens = (img // patch) ** 2 + 1
    shapes = {
        "cls_token": (1, 1, dim),
        "pos_embed": (1, tokens, dim),
        "patch_embed/kernel": (patch, patch, 3, dim),
        "patch_embed/bias": (dim,),
        "norm/scale": (dim,), "norm/bias": (dim,),
        "head/kernel": (dim, num_classes), "head/bias": (num_classes,),
    }
    for i in range(depth):
        b = f"block{i}"
        a = f"{b}/MultiHeadDotProductAttention_0"
        for p in ("query", "key", "value"):
            shapes[f"{a}/{p}/kernel"] = (dim, heads, hd)
            shapes[f"{a}/{p}/bias"] = (heads, hd)
        shapes[f"{a}/out/kernel"] = (heads, hd, dim)
        shapes[f"{a}/out/bias"] = (dim,)
        for ln in ("LayerNorm_0", "LayerNorm_1"):
            shapes[f"{b}/{ln}/scale"] = (dim,)
            shapes[f"{b}/{ln}/bias"] = (dim,)
        shapes[f"{b}/Mlp_0/Dense_0/kernel"] = (dim, 4 * dim)
        shapes[f"{b}/Mlp_0/Dense_0/bias"] = (4 * dim,)
        shapes[f"{b}/Mlp_0/Dense_1/kernel"] = (4 * dim, dim)
        shapes[f"{b}/Mlp_0/Dense_1/bias"] = (dim,)
    flat = {}
    for k, shape in shapes.items():
        std = head_std if k == "head/kernel" else (0.01 if k.endswith("bias") else 0.02)
        flat[k] = (std * rng.standard_normal(shape)).astype(np.float32)
        if k.endswith("scale"):
            flat[k] += 1.0
    return flat


def write_checkpoint(out_dir: str, rng, model: dict, img: int, num_classes: int) -> str:
    """A checkpoint as the JAX train.py writes it for --flash_attn, plus the
    class_indices.json it writes beside it."""
    os.makedirs(out_dir, exist_ok=True)
    ck = {
        "format_version": 1,
        "model_spec": {"name": model["name"],
                       "kwargs": {"num_classes": num_classes, "flash_attn": True}},
        "step": 0, "epoch": 0, "input_shape": [1, img, img, 3],
        "num_classes": num_classes, "args": {},
        "model": jax_vit_params(rng, model["dim"], model["depth"], model["heads"],
                                model["patch"], img, num_classes),
    }
    path = os.path.join(out_dir, "checkpoint-0.pth")
    with open(path, "wb") as f:
        pickle.dump(ck, f, protocol=pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(out_dir, "class_indices.json"), "w") as f:
        json.dump({str(i): f"class_{i}" for i in range(num_classes)}, f)
    return path


def write_image_folder(root: str, rng, num_classes: int, per_class: int) -> int:
    """root/class_{c}/img_{i}.{jpg,png}: a per-class tint plus noise, sizes
    160-320 px, alternating JPEG and PNG."""
    from PIL import Image

    for c in range(num_classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d)
        tint = rng.integers(0, 256, 3)
        for i in range(per_class):
            h, w = rng.integers(160, 321, 2)
            arr = np.clip(tint + rng.normal(0, 60, (h, w, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"img_{i}.{'jpg' if i % 2 else 'png'}"))
    return num_classes * per_class


def time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    from CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def attention_bound(B, N, H, D):
    """(bound_ms, bound_by): q, k, v read once and o written once in bf16,
    against 4*B*H*N^2*D flops (two products) on the bf16 tensor cores."""
    t_bytes = 4 * B * N * H * D * 2 / HBM_BYTES_PER_S
    t_flops = 4 * B * H * N * N * D / BF16_FLOPS_PER_S
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def compare_attention(out, q, k, v):
    """Hold `out` against the fp32 plain version on the same inputs, with a
    tolerance of ATTN_RTOL * max|reference|. Also checks that the tolerance
    lies below what leaving out the last key changes in the reference: a
    ragged tail of one key is the tail a kernel masks wrongly most easily, and
    a tolerance above that change could not see the fault. Returns
    (max_abs_err, tol, tail_change); raises when either check fails."""
    from imageclassification_tpu_torch.ops.flash_attention import flash_attention_ref

    qf, kf, vf = (t.float() for t in (q, k, v))
    ref = flash_attention_ref(qf, kf, vf)
    tail = (flash_attention_ref(qf, kf[:, :-1], vf[:, :-1]) - ref).abs().max().item()
    tol = ATTN_RTOL * ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    if not tail > tol:
        raise AssertionError(f"attention shape {tuple(q.shape)}: tolerance {tol} does not "
                             f"see a dropped last key (changes the output by {tail})")
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"attention shape {tuple(q.shape)}: max|d|={err} > {tol}")
    return err, tol, tail


def check_attention(shape, device):
    """Kernel vs plain version (and the SDPA yardstick) at one shape, on q, k, v
    read strided out of one [B, N, 3, H, D] tensor as ViT's fused qkv gives
    them."""
    import torch
    import torch.nn.functional as F

    from imageclassification_tpu_torch.ops import flash_attention as fa

    B, N, H, D = shape
    g = torch.Generator(device=device).manual_seed(N)
    qkv = torch.randn((B, N, 3, H, D), generator=g, device=device).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    err, tol, tail = compare_attention(out, q, k, v)
    iters = max(5, min(200, int(2e9 // (B * H * N * N * D))))
    ms = time_ms(lambda: fa.flash_attention(q, k, v), iters)
    plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v), max(3, iters // 10))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
    bound_ms, bound_by = attention_bound(B, N, H, D)
    row = dict(shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"flash_attention_fwd B,N,H,D={shape} (strided qkv): max|d| vs fp32 plain "
        f"{err:.3e} (tol {tol:.3e} = 2^-7 of max|ref|; dropping the last key moves "
        f"the reference by {tail:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"bound/kernel {bound_ms / ms:.3f}")
    return row


def backward_bound(B, N, H, D, part="all"):
    """(bound_ms, bound_by) of the attention backward. 'all': q, k, v, o, dO
    read and dq, dk, dv written in bf16, lse and di in fp32, and the five
    products S, dP, dV, dK, dQ (10*B*H*N^2*D flops); 'dkv': q, k, v, dO, lse,
    di in and dk, dv out, products S, dP, dV, dK; 'dq': q, k, v, dO, lse, di
    in and dq out, products S, dP, dQ."""
    tensors, products = {"all": (8, 5), "dkv": (6, 4), "dq": (5, 3)}[part]
    t_bytes = (tensors * B * N * H * D * 2 + 2 * B * H * N * 4) / HBM_BYTES_PER_S
    t_flops = products * 2 * B * H * N * N * D / BF16_FLOPS_PER_S
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def compare_backward(grads, q, k, v, do):
    """Hold the kernels' (dq, dk, dv) against the fp32 plain backward on the
    same inputs, each with a tolerance of ATTN_BWD_RTOL * max|reference|, and
    check that each tolerance lies below what leaving out the last key
    changes in that reference gradient: every row of dq moves through the
    softmax, and dk and dv lose the last key's row (counted as zeros, as a
    kernel that drops the key leaves it; their other rows barely move at
    large N). Returns {name: (max_abs_err, tol, tail_change)}; raises when a
    check fails."""
    import torch

    from imageclassification_tpu_torch.ops import flash_attention as fa

    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))

    def plain(kk, vv):
        return fa.flash_attention_bwd_ref(qf, kk, vv, fa.flash_attention_ref(qf, kk, vv),
                                          fa.flash_attention_lse_ref(qf, kk), dof)

    ref, tail = plain(kf, vf), plain(kf[:, :-1], vf[:, :-1])
    out = {}
    for name, g, r, t in zip(("dq", "dk", "dv"), grads, ref, tail):
        dropped = torch.zeros_like(r)
        dropped[:, : t.shape[1]] = t
        tail_change = (dropped - r).abs().max().item()
        tol = ATTN_BWD_RTOL * r.abs().max().item()
        err = (g.float() - r).abs().max().item()
        if not tail_change > tol:
            raise AssertionError(f"attention backward {tuple(q.shape)} {name}: tolerance {tol} "
                                 f"does not see a dropped last key (changes it by {tail_change})")
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"attention backward {tuple(q.shape)} {name}: "
                                 f"max|d|={err} > {tol}")
        out[name] = (err, tol, tail_change)
    return out


def check_backward(shape, device):
    """The backward kernels (and the forward's lse) against their plain
    versions at one shape, on q, k, v read strided out of one fused qkv
    tensor; kernel ms (both, and each alone), plain ms, the SDPA backward's
    ms (forward + backward less forward) and the bounds."""
    import torch
    import torch.nn.functional as F

    from imageclassification_tpu_torch.ops import flash_attention as fa

    B, N, H, D = shape
    g = torch.Generator(device=device).manual_seed(N + 1)
    qkv = torch.randn((B, N, 3, H, D), generator=g, device=device).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn((B, N, H, D), generator=g, device=device).to(torch.bfloat16)
    o, lse = fa._launch(q, k, v, with_lse=True)
    lse_err = (lse - fa.flash_attention_lse_ref(q, k)).abs().max().item()
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"forward lse {shape}: max|d| {lse_err} > {LSE_ATOL}")
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    errs = compare_backward(grads, q, k, v, do)

    iters = max(5, min(200, int(1e9 // (B * H * N * N * D))))
    ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), iters)
    dob, di = fa._bwd_inputs(q, k, v, o, lse, do)
    ms_dkv = time_ms(lambda: fa._launch_dkv(q, k, v, dob, lse, di), iters)
    ms_dq = time_ms(lambda: fa._launch_dq(q, k, v, dob, lse, di), iters)
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do),
                       max(3, iters // 10))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
    sdpa_fwd_bwd = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), dot), iters)
    row = dict(shape=list(shape), lse_err=lse_err, errs=errs, ms=ms, ms_dkv=ms_dkv,
               ms_dq=ms_dq, plain_ms=plain_ms, library_ms=sdpa_fwd_bwd - sdpa_fwd,
               bounds={part: backward_bound(B, N, H, D, part) for part in ("all", "dkv", "dq")})
    if shape == MAIN_SHAPE:
        _, _, kernels = trace(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))
        row["trace_ms"] = {part: next(ms for name, (ms, n) in kernels.items()
                                      if f"flash_attention_bwd_{part}_kernel" in name)
                           for part in ("dkv", "dq")}
    log(f"flash_attention_bwd B,N,H,D={shape} (strided qkv): forward lse max|d| {lse_err:.3e} "
        f"(tol {LSE_ATOL}); " + "; ".join(
            f"{n} max|d| {e:.3e} (tol {t:.3e} = 2^-6 of max|ref|; dropping the last key "
            f"moves it by {c:.3e})" for n, (e, t, c) in errs.items()))
    log(f"flash_attention_bwd B,N,H,D={shape}: kernels {ms:.4f} ms (dK/dV {ms_dkv:.4f}, "
        f"dQ {ms_dq:.4f}; di and checks included in the first), plain {plain_ms:.4f} ms, "
        f"sdpa backward {row['library_ms']:.4f} ms (fwd+bwd {sdpa_fwd_bwd:.4f} - fwd "
        f"{sdpa_fwd:.4f}), bound " + ", ".join(
            f"{p} {b:.4f} ms ({by})" for p, (b, by) in row["bounds"].items())
        + (f"; device ms per launch from the trace: dK/dV {row['trace_ms']['dkv']:.4f}, "
           f"dQ {row['trace_ms']['dq']:.4f}" if "trace_ms" in row else ""))
    return row


def trace(fn, steps: int = 10):
    """Trace `steps` calls of fn() with torch.profiler, after one untraced
    call. Returns (wall ms per call from CUDA events, device ms per call
    summed over kernels, {kernel name: (ms per call, launches per call)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        # device-side ranges of user annotations (Optimizer.step#AdamW.step)
        # span kernels that are counted on their own
        if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False):
            us, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    per_call = {name: (us / 1e3 / steps, n / steps) for name, (us, n) in kernels.items()}
    return (start.elapsed_time(end) / steps, sum(ms for ms, _ in per_call.values()),
            per_call)


def run_main_path(work: str, device: str, model: dict, img: int, num_classes: int,
                  per_class: int, batch: int, seed: int = 0):
    """The serving path through the port's val.py on `device`. Returns a dict
    of launch counts per run, timings and the probability check."""
    import torch

    from imageclassification_tpu_torch import val
    from imageclassification_tpu_torch.models import create_model
    from imageclassification_tpu_torch.ops.flash_attention import flash_attention, reset_launches

    rng = np.random.default_rng(seed)
    ckpt = write_checkpoint(os.path.join(work, "ckpt"), rng, model, img, num_classes)
    images = os.path.join(work, "images")
    n_images = write_image_folder(images, rng, num_classes, per_class)
    n_batches = math.ceil(n_images / batch)
    res = {"n_images": n_images, "n_batches": n_batches}

    reset_launches()
    t0 = time.perf_counter()
    tp, fp, fn = val.val_precision(images, ckpt, img, model_ema=True, batch_size=batch,
                                   device=device)
    res["val_precision_s"] = time.perf_counter() - t0
    res["launches_val_precision"] = flash_attention.launches
    if not (tp.sum() + fp.sum() == n_images and tp.sum() + fn.sum() == n_images):
        raise AssertionError(f"val_precision counts do not cover {n_images} images: "
                             f"tp={tp} fp={fp} fn={fn}")

    move_src = os.path.join(work, "triage", "incoming")
    os.makedirs(move_src)
    for d in sorted(os.listdir(images)):
        for f in sorted(os.listdir(os.path.join(images, d))):
            shutil.copy(os.path.join(images, d, f), os.path.join(move_src, f"{d}_{f}"))
    reset_launches()
    t0 = time.perf_counter()
    val.val_move(move_src, ckpt, img, model_ema=True, batch_size=batch, device=device)
    res["val_move_s"] = time.perf_counter() - t0
    res["launches_val_move"] = flash_attention.launches
    moved = sum(len(os.listdir(os.path.join(work, "triage", d))) for d in ("Empty", "NonEmpty"))
    if os.listdir(move_src) or moved != n_images:
        raise AssertionError(f"val_move moved {moved} of {n_images} images")

    # steady-state forward of one full batch; the flash path held against the
    # plain attention path of the same weights, in bf16 and in fp32
    m_flash, _ = val.initialize_model(ckpt, True, device=device)
    predict = {"flash": val._predict_fn(m_flash)}
    for name, half in (("plain", True), ("fp32", False)):
        m = create_model(model["name"], num_classes=num_classes, half_precision=half,
                         img_size=img).to(device).eval()
        m.load_state_dict(m_flash.state_dict())
        predict[name] = val._predict_fn(m)
    paths = [os.path.join(images, d, f) for d in sorted(os.listdir(images))
             for f in sorted(os.listdir(os.path.join(images, d)))][:batch]
    _, imgs = next(val._batched(paths, img, batch, torch.device(device)))
    p = {name: fn(imgs) for name, fn in predict.items()}
    if p["flash"].shape != (batch, num_classes) or not torch.isfinite(p["flash"]).all():
        raise AssertionError(f"bad probabilities: shape {tuple(p['flash'].shape)}")
    res["probs_flash_vs_plain"] = (p["flash"] - p["plain"]).abs().max().item()
    res["probs_flash_vs_fp32"] = (p["flash"] - p["fp32"]).abs().max().item()
    res["probs_plain_vs_fp32"] = (p["plain"] - p["fp32"]).abs().max().item()
    res["argmax_agree_fp32"] = (p["flash"].argmax(-1) == p["fp32"].argmax(-1)).float().mean().item()
    if res["probs_flash_vs_fp32"] > PROBS_ATOL:
        raise AssertionError(f"flash-path probabilities differ from fp32 by "
                             f"{res['probs_flash_vs_fp32']} > {PROBS_ATOL}")
    if device == "cuda":
        res["ms_per_batch"] = time_ms(lambda: predict["flash"](imgs), iters=10)
        res["img_per_s"] = batch / (res["ms_per_batch"] / 1e3)
        res["trace"] = {name: trace(lambda: predict[name](imgs)) for name in ("flash", "plain")}
    return res


def log_trace(label: str, tr, per: str) -> None:
    wall_ms, device_ms, kernels = tr
    log(f"trace, {label}: wall {wall_ms:.3f} ms/{per} (profiler on), device {device_ms:.3f} "
        f"ms/{per}, idle share {1 - device_ms / wall_ms:.3f}; device time by kernel per {per}:")
    for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  {ms:8.4f} ms {ms / device_ms:6.1%} {n:5.1f} launches  {k[:100]}")


def _launch_counts():
    from imageclassification_tpu_torch.ops.flash_attention import flash_attention as f

    return {"fwd": f.launches, "fwd_lse": f.launches_lse, "bwd_dkv": f.launches_dkv,
            "bwd_dq": f.launches_dq}


def run_training(work: str, device: str, model: dict, img: int, num_classes: int,
                 per_class: int, batch: int, epochs: int, seed: int = 0):
    """The training path through the port's train.main on `device`, on a
    seeded image folder, with the default training flags. Every step's
    metrics and kernel launches are recorded by wrapping the step that main
    builds. Returns a dict: the trained state, the args, the per-step records,
    the launch totals of the run, the checkpoint checks and timings."""
    import torch

    from imageclassification_tpu_torch import train as port_train
    from imageclassification_tpu_torch import val
    from imageclassification_tpu_torch.ops.flash_attention import reset_launches

    rng = np.random.default_rng(seed)
    images = os.path.join(work, "train_images")
    write_image_folder(images, rng, num_classes, per_class)
    out = os.path.join(work, "train_cls", "output")
    args = port_train.parse_args([
        "--data_path", images, "--model", model["name"], "--flash_attn", "true",
        "--input_size", str(img), "--batch_size", str(batch), "--epochs", str(epochs),
        "--warmup_epochs", "1", "--pretrained", "false", "--device", device,
        "--output_dir", out, "--log_dir", os.path.join(work, "train_cls", "log_dir"),
        "--num_workers", "8",
    ])
    records = []
    build = port_train.build_train_step

    def recording_build(*a, **kw):
        step = build(*a, **kw)

        def recorded(state, batch, draws=None):
            before = _launch_counts()
            m = step(state, batch, draws)
            after = _launch_counts()
            records.append({"loss": float(m["loss"]), "skipped": m["skipped"],
                            "launches": {k: after[k] - before[k] for k in after}})
            return m

        recorded.__dict__.update(step.__dict__)
        return recorded

    port_train.build_train_step = recording_build
    try:
        reset_launches()
        t0 = time.perf_counter()
        state = port_train.main(args)
        wall_s = time.perf_counter() - t0
        totals = _launch_counts()
    finally:
        port_train.build_train_step = build

    losses = [r["loss"] for r in records]
    if not (losses and all(math.isfinite(x) for x in losses)
            and not any(r["skipped"] for r in records)):
        raise AssertionError(f"training losses not all finite: {losses}")
    # per optimizer step: the forward with lse and the exact-mode accuracy
    # forward without, one backward; on the CPU the plain versions, no kernel
    depth = model["depth"] if device == "cuda" else 0
    expected = {"fwd": 2 * depth, "fwd_lse": depth, "bwd_dkv": depth, "bwd_dq": depth}
    for i, r in enumerate(records):
        if r["launches"] != expected:
            raise AssertionError(f"train step {i}: launches {r['launches']}, expected {expected}")

    # the last epoch's checkpoint: the JAX layout, and the port's val.py reads
    # it back to the very weights the run ended with
    path = os.path.join(out, f"checkpoint-{epochs - 1}.pth")
    with open(path, "rb") as f:
        ck = pickle.load(f)
    want = jax_vit_params(np.random.default_rng(0), model["dim"], model["depth"],
                          model["heads"], model["patch"], img, num_classes)
    got = {k: v.shape for k, v in ck["model"].items()}
    if got != {k: v.shape for k, v in want.items()}:
        raise AssertionError(f"{path}: parameters not in the JAX layout")
    mu = {k[len("inner_state/0/mu/"):]: v.shape for k, v in ck["optimizer"].items()
          if k.startswith("inner_state/0/mu/")}
    if mu != got or int(ck["optimizer"]["count"]) != len(records):
        raise AssertionError(f"{path}: optimizer state not in the JAX adamw layout")
    loaded, _ = val.initialize_model(path, model_ema=False, device=device)
    carried = max((loaded.state_dict()[k] - v).abs().max().item()
                  for k, v in state.model.state_dict().items())
    if carried != 0.0:
        raise AssertionError(f"{path}: reloaded weights differ from the run's by {carried}")
    return {"state": state, "args": args, "records": records, "totals": totals,
            "wall_s": wall_s, "checkpoint": path, "images": images,
            "steps_per_epoch": len(records) // epochs}


def _rel_l2(grads, ref):
    import torch

    num = sum(torch.sum((g.float() - r.float()) ** 2) for g, r in zip(grads, ref))
    den = sum(torch.sum(r.float() ** 2) for r in ref)
    return math.sqrt(num.item() / den.item())


def train_step_checks(run: dict, model: dict, device: str, timed: bool = True):
    """On the trained weights of `run`: one step's gradients through the bf16
    flash path against the plain attention path (bf16) and fp32, on the same
    batch and draws; then (when `timed`) ms per step with flash on and off
    over one fixed batch, and a torch.profiler trace of each."""
    import torch

    from imageclassification_tpu_torch.data.folder import scan_folder
    from imageclassification_tpu_torch.data.loader import BatchLoader
    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.state import create_train_state
    from imageclassification_tpu_torch.engine.step import build_train_step
    from imageclassification_tpu_torch.models import create_model
    from imageclassification_tpu_torch.optim.factory import create_optimizer

    args, state = run["args"], run["state"]
    num_classes = state.model.head.out_features
    dataset = scan_folder(run["images"])
    idx = np.arange(args.batch_size)[None]
    batch = next(iter(BatchLoader(dataset, idx, args.input_size, train=True, device=device,
                                  seed=args.seed, num_workers=8)))
    mixup_cfg = build_mixup(args, num_classes)

    def make(flash: bool, half: bool):
        m = create_model(model["name"], num_classes=num_classes, half_precision=half,
                         img_size=args.input_size, flash_attn=flash).to(device)
        m.load_state_dict(state.model.state_dict())
        opt = create_optimizer(args.opt, m.parameters(), lr=args.lr,
                               weight_decay=args.weight_decay)
        step = build_train_step(m, args, num_classes, mixup_cfg, [args.lr], [args.weight_decay],
                                seed=args.seed)
        return create_train_state(m, opt), step

    flash, step = make(True, True)
    plain, plain_step = make(False, True)
    fp32, _ = make(False, False)
    draws = step.sample_draws(*batch["image"].shape[:3])
    grads = {name: step.loss_and_grads(st.model, batch, draws)
             for name, st in (("flash", flash), ("plain", plain), ("fp32", fp32))}
    res = {"loss": {n: g[0].item() for n, g in grads.items()},
           "grad_flash_vs_fp32": _rel_l2(grads["flash"][3], grads["fp32"][3]),
           "grad_flash_vs_plain": _rel_l2(grads["flash"][3], grads["plain"][3]),
           "grad_plain_vs_fp32": _rel_l2(grads["plain"][3], grads["fp32"][3])}
    log(f"train step gradients on the trained {model['name']}, relative global L2: bf16 flash vs "
        f"fp32 {res['grad_flash_vs_fp32']:.4e}, bf16 flash vs bf16 plain "
        f"{res['grad_flash_vs_plain']:.4e}, bf16 plain vs fp32 {res['grad_plain_vs_fp32']:.4e} "
        f"(tol {GRAD_RTOL}); losses {res['loss']}")
    for key in ("grad_flash_vs_fp32", "grad_flash_vs_plain"):
        if not res[key] <= GRAD_RTOL:
            raise AssertionError(f"{key} = {res[key]} > {GRAD_RTOL}")
    del grads, fp32
    if timed:
        for name, st, fn in (("flash", flash, step), ("plain", plain, plain_step)):
            res[f"ms_per_step_{name}"] = time_ms(lambda: fn(st, batch), iters=10, reps=3)
            res[f"trace_{name}"] = trace(lambda: fn(st, batch), steps=5)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1

    from imageclassification_tpu_torch.ops import _build
    from imageclassification_tpu_torch.ops import flash_attention as fa

    sources = (fa.KERNEL, fa.KERNEL_BWD)
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build: one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        nvcc_logs = dict(zip(sources, pool.map(_build.build, sources)))
    log(f"build: {', '.join(f'imageclassification_tpu_torch/csrc/{n}.cu' for n in sources)} "
        f"({' '.join(_build.NVCC_FLAGS[:2])}) in {time.perf_counter() - t0:.1f} s")
    for name, nvcc_log in nvcc_logs.items():
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                log(f"ptxas {name}: {line.strip()[:160]}")

    # 3a. the forward kernel against its plain version
    rows = [check_attention(s, "cuda") for s in ATTN_SHAPES]
    main_row = rows[ATTN_SHAPES.index(MAIN_SHAPE)]
    # 3b. the backward kernels (and the forward's lse) against theirs
    bwd_rows = [check_backward(s, "cuda") for s in ATTN_SHAPES]
    bwd_main = bwd_rows[ATTN_SHAPES.index(MAIN_SHAPE)]

    # 4. the serving path
    with tempfile.TemporaryDirectory() as work:
        res = run_main_path(work, "cuda", VIT_B16, img=224, num_classes=5,
                            per_class=26, batch=64)
    expected = VIT_B16["depth"] * res["n_batches"]
    for run in ("val_precision", "val_move"):
        got = res[f"launches_{run}"]
        log(f"serving path {run}: flash_attention_fwd launches {got} "
            f"(expected {VIT_B16['depth']} x {res['n_batches']} batches = {expected}), "
            f"{res[f'{run}_s']:.2f} s for {res['n_images']} images incl. model load")
        if got != expected:
            raise AssertionError(f"{run}: {got} kernel launches, expected {expected}")
    log(f"serving path ViT-B/16 224x224 bf16 batch 64: {res['ms_per_batch']:.3f} ms/batch, "
        f"{res['img_per_s']:.1f} img/s (forward + softmax, CUDA events)")
    log(f"serving path probabilities, max|d|: bf16 flash vs bf16 plain attention "
        f"{res['probs_flash_vs_plain']:.3e}; bf16 flash vs fp32 plain "
        f"{res['probs_flash_vs_fp32']:.3e} (tol {PROBS_ATOL}); bf16 plain vs fp32 "
        f"{res['probs_plain_vs_fp32']:.3e}; argmax agreement flash vs fp32 "
        f"{res['argmax_agree_fp32']:.3f}")
    for name, tr in res["trace"].items():
        log_trace(f"ViT-B/16 batch 64 bf16 forward, {name} attention", tr, "batch")
    fa_ms, fa_n = next(v for k, v in res["trace"]["flash"][2].items()
                       if "flash_attention_fwd" in k)
    log(f"flash_attention_fwd device time from the trace: {fa_ms / fa_n:.4f} ms per launch "
        f"at {MAIN_SHAPE}, bound/kernel {main_row['bound_ms'] / (fa_ms / fa_n):.3f}")

    # 5. the training path
    cfg = TRAIN
    with tempfile.TemporaryDirectory() as work:
        run = run_training(work, "cuda", VIT_B16, cfg["img"], cfg["num_classes"],
                           cfg["per_class"], cfg["batch"], cfg["epochs"])
        losses = [r["loss"] for r in run["records"]]
        log(f"training path: {len(losses)} steps ({cfg['epochs']} epochs x "
            f"{run['steps_per_epoch']}) of ViT-B/16 --flash_attn 224x224 batch "
            f"{cfg['batch']}, {run['wall_s']:.1f} s for train.main (decode, evals and "
            f"checkpoints included); losses {', '.join(f'{x:.4f}' for x in losses)}")
        log(f"training path launches per optimizer step: {run['records'][0]['launches']} "
            f"(every step the same); totals of the run {run['totals']} (the evals' "
            f"forwards included); {run['checkpoint'].split('/')[-1]} in the JAX layout, "
            f"reloaded by val.initialize_model to the run's exact weights")
        # 5b. steady state, traces and gradient agreement on the trained weights
        chk = train_step_checks(run, VIT_B16, "cuda")
    for name in ("flash", "plain"):
        ms = chk[f"ms_per_step_{name}"]
        log(f"train step ViT-B/16 224x224 bf16 batch {cfg['batch']}, {name} attention: "
            f"{ms:.3f} ms/step, {cfg['batch'] / (ms / 1e3):.1f} img/s (CUDA events, one "
            f"fixed batch, exact-mode accuracy forward included)")
        log_trace(f"ViT-B/16 batch {cfg['batch']} bf16 train step, {name} attention",
                  chk[f"trace_{name}"], "step")

    # 6. results
    totals = run["totals"]
    replaces_bwd = ("jax/experimental/pallas/ops/tpu/flash_attention.py:{} (the backward of "
                    "imageclassification_tpu/models/vit.py:25)")
    kernels = [{
        "name": fa.KERNEL, "route": "cuda",
        "source": f"imageclassification_tpu_torch/csrc/{fa.KERNEL}.cu",
        "replaces": "imageclassification_tpu/models/vit.py:25",
        "launches": totals["fwd"],
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"],
    }]
    for part, line, errs in (("dkv", 1121, ("dk", "dv")), ("dq", 1456, ("dq",))):
        kernels.append({
            "name": f"flash_attention_bwd_{part}", "route": "cuda",
            "source": f"imageclassification_tpu_torch/csrc/{fa.KERNEL_BWD}.cu",
            "replaces": replaces_bwd.format(line),
            "launches": totals[f"bwd_{part}"],
            "max_abs_err": max(bwd_main["errs"][e][0] for e in errs),
            "ms": bwd_main[f"ms_{part}"], "plain_ms": bwd_main["plain_ms"],
            "bound_ms": bwd_main["bounds"][part][0], "bound_by": bwd_main["bounds"][part][1],
            "library_ms": bwd_main["library_ms"],
        })
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on the training path")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
