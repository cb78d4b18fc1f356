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
   could take (the bound);
4. the main path: a seeded JAX-format ViT-B/16 checkpoint trained with
   --flash_attn (random weights) and a seeded 5-class image folder go through
   `val_precision` and `val_move` on cuda at batch 64, with every kernel's
   launch count read around each run; the probabilities are held against the
   same model on the plain attention path; a torch.profiler trace of the
   forward with the flash path on and off gives device time by kernel;
5. one JSON line with every kernel's numbers, then the result line
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
# bf16 model (flash path) against the same weights in fp32 on the plain
# attention path: bf16 rounding over 12 blocks of activations, 5-class
# probabilities
PROBS_ATOL = 5e-2

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


def trace_forward(predict, imgs, steps: int = 10):
    """Trace `steps` calls of predict(imgs) with torch.profiler. Returns
    (wall ms per call from CUDA events, device ms per call summed over
    kernels, {kernel name: (ms per call, launches per call)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    predict(imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            predict(imgs)
        end.record()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
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
    from imageclassification_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(seed)
    ckpt = write_checkpoint(os.path.join(work, "ckpt"), rng, model, img, num_classes)
    images = os.path.join(work, "images")
    n_images = write_image_folder(images, rng, num_classes, per_class)
    n_batches = math.ceil(n_images / batch)
    res = {"n_images": n_images, "n_batches": n_batches}

    flash_attention.launches = 0
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
    flash_attention.launches = 0
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
        res["trace"] = {name: trace_forward(predict[name], imgs) for name in ("flash", "plain")}
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1

    from imageclassification_tpu_torch.ops import _build
    from imageclassification_tpu_torch.ops import flash_attention as fa

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    nvcc_log = _build.build(fa.KERNEL)
    log(f"build: {fa.KERNEL} from imageclassification_tpu_torch/csrc/{fa.KERNEL}.cu "
        f"({' '.join(_build.NVCC_FLAGS[:2])}) in {time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    # 3. kernels against their plain versions
    rows = [check_attention(s, "cuda") for s in ATTN_SHAPES]
    main_row = rows[ATTN_SHAPES.index(MAIN_SHAPE)]

    # 4. the main path
    with tempfile.TemporaryDirectory() as work:
        res = run_main_path(work, "cuda", VIT_B16, img=224, num_classes=5,
                            per_class=26, batch=64)
    expected = VIT_B16["depth"] * res["n_batches"]
    for run in ("val_precision", "val_move"):
        got = res[f"launches_{run}"]
        log(f"main path {run}: flash_attention_fwd launches {got} "
            f"(expected {VIT_B16['depth']} x {res['n_batches']} batches = {expected}), "
            f"{res[f'{run}_s']:.2f} s for {res['n_images']} images incl. model load")
        if got != expected:
            raise AssertionError(f"{run}: {got} kernel launches, expected {expected}")
    log(f"main path ViT-B/16 224x224 bf16 batch 64: {res['ms_per_batch']:.3f} ms/batch, "
        f"{res['img_per_s']:.1f} img/s (forward + softmax, CUDA events)")
    log(f"main path probabilities, max|d|: bf16 flash vs bf16 plain attention "
        f"{res['probs_flash_vs_plain']:.3e}; bf16 flash vs fp32 plain "
        f"{res['probs_flash_vs_fp32']:.3e} (tol {PROBS_ATOL}); bf16 plain vs fp32 "
        f"{res['probs_plain_vs_fp32']:.3e}; argmax agreement flash vs fp32 "
        f"{res['argmax_agree_fp32']:.3f}")
    for name, (wall_ms, device_ms, kernels) in res["trace"].items():
        log(f"trace, ViT-B/16 batch 64 bf16, {name} attention: wall {wall_ms:.3f} ms/batch "
            f"(profiler on), device {device_ms:.3f} ms/batch, idle share "
            f"{1 - device_ms / wall_ms:.3f}; device time by kernel per batch:")
        for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
            log(f"  {ms:8.4f} ms {ms / device_ms:6.1%} {n:5.1f} launches  {k[:100]}")
    fa_ms, fa_n = next(v for k, v in res["trace"]["flash"][2].items()
                       if "flash_attention_fwd" in k)
    log(f"flash_attention_fwd device time from the trace: {fa_ms / fa_n:.4f} ms per launch "
        f"at {MAIN_SHAPE}, bound/kernel {main_row['bound_ms'] / (fa_ms / fa_n):.3f}")

    # 5. results
    kernels = [{
        "name": fa.KERNEL, "route": "cuda",
        "source": f"imageclassification_tpu_torch/csrc/{fa.KERNEL}.cu",
        "replaces": "imageclassification_tpu/models/vit.py:25",
        "launches": res["launches_val_precision"],
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
