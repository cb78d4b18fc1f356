"""Training throughput of the port: ResNet-50 train steps per second on one
card, the same step that the root bench.py times for the JAX package.

    python -m imageclassification_tpu_torch.bench [--batch 128] [--size 224]
        [--device cuda|cpu]

The step is `engine.step.build_train_step` as `train.py` builds and runs it:
on a card replayed from a CUDA graph (`engine.compiled.CapturedTrainStep`),
on the CPU eager. ResNet-50, 1000 classes, bf16 compute with fp32 parameters,
AdamW, mixup 0.8, label smoothing 0.1, random erasing 0.25, colour jitter
0.3, the exact-mode train accuracy (a second forward on the un-mixed batch),
no drop path, a constant lr of 1e-3 and weight decay of 5e-4, on one seeded
uint8 batch. It is timed with CUDA events after a warm-up (which includes
the eager steps before the capture): the median over 5 reps of the mean of
10 back-to-back steps, with no host synchronisation inside a rep (a step
reads nothing back from the device).

Prints one JSON line shaped like bench.py's: `metric`, `value` (img/s),
`unit`, `vs_baseline`, plus `ms_per_step` and the device. `vs_baseline` is
bench.py's composite roofline (the larger of the tensor-core time of four
forward-equivalents of 8.2 GFLOP an image and the time of the least traffic
of activations, AdamW state and input) with an H100's peaks, 989 TFLOP/s
bf16 and 3.35 TB/s, at 0.9 of it at batch 128; it is given at 224x224 only,
where those constants hold. `--device cpu` runs the same step on the CPU at a
small size for the tests; its numbers are CPU times, not a device metric.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from .config import TrainConfig
from .data.mixup import build_mixup
from .device import DEVICES, resolve_device
from .engine.compiled import CapturedTrainStep
from .engine.state import create_train_state
from .engine.step import build_train_step
from .models import create_model
from .optim.factory import create_optimizer

MODEL, NUM_CLASSES = "resnet50", 1000
METRIC = f"{MODEL}_train_images_per_sec_per_chip"
# H100 SXM data sheet, dense: bf16 tensor-core flop/s and HBM bytes/s
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
# bench.py's ResNet-50 constants at 224x224
FWD_FLOPS_PER_IMG = 8.2e9                 # 2 flops per MAC
ACT_BYTES_PER_IMG = 11.4e6 * 2            # bf16 activation elements
PARAM_BYTES = 25.6e6 * 4                  # fp32 parameters
INPUT_BYTES_PER_IMG = 224 * 224 * 3 * (1 + 2 * 4)


def roofline_img_s(batch: int) -> float:
    """bench.py's composite roofline of the default train step (exact-mode
    accuracy forward included) with the H100's peaks: img/s at `batch`."""
    t_flops = batch * 4 * FWD_FLOPS_PER_IMG / BF16_FLOPS_PER_S
    step_bytes = (7 * ACT_BYTES_PER_IMG * batch + 8 * PARAM_BYTES
                  + INPUT_BYTES_PER_IMG * batch)
    return batch / max(t_flops, step_bytes / HBM_BYTES_PER_S)


TARGET_IMG_S = 0.9 * roofline_img_s(128)


def build(batch: int, size: int, device: torch.device, seed: int = 0):
    """(train_step, state, batch) of the benchmarked step: captured on a
    card (its eager step is `train_step.step`)."""
    cfg = TrainConfig(model=MODEL, input_size=size, batch_size=batch, mixup=0.8, smoothing=0.1,
                      reprob=0.25, color_jitter=0.3, half_precision=True,
                      train_acc_mode="exact", drop_path=0.0, device=device.type)
    net = create_model(MODEL, num_classes=NUM_CLASSES, half_precision=True,
                       generator=torch.Generator().manual_seed(seed)).to(device)
    opt = create_optimizer(cfg.opt, net.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)
    state = create_train_state(net, opt)
    step = build_train_step(net, cfg, NUM_CLASSES, build_mixup(cfg, NUM_CLASSES), [1e-3], [5e-4],
                            seed=seed)
    rng = np.random.default_rng(seed)
    data = {"image": torch.from_numpy(rng.integers(0, 255, (batch, size, size, 3), dtype=np.uint8)),
            "label": torch.from_numpy(rng.integers(0, NUM_CLASSES, (batch,)))}
    if device.type == "cuda":
        step = CapturedTrainStep(step, device)
    return step, state, {k: v.to(device) for k, v in data.items()}


def time_steps(step, state, data, warmup: int, iters: int, reps: int) -> float:
    """Median over `reps` of the mean ms of `iters` steps: CUDA events on a
    card, the host clock on the CPU."""
    cuda = data["image"].is_cuda
    for _ in range(warmup):
        step(state, data)
    times = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            step(state, data)
        if cuda:
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times)


def run(batch: int = 128, size: int = 224, device: str = "cuda",
        warmup: int = 5, iters: int = 10, reps: int = 5) -> dict:
    """The bench's result line as a dict."""
    dev = resolve_device(device)
    step, state, data = build(batch, size, dev)
    ms = time_steps(step, state, data, warmup, iters, reps)
    img_s = batch / (ms / 1e3)
    return {"metric": METRIC, "value": round(img_s, 1), "unit": "images/sec",
            "vs_baseline": (round(img_s / TARGET_IMG_S, 4)
                            if size == 224 and dev.type == "cuda" else None),
            "ms_per_step": ms, "batch": batch, "size": size,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("ResNet-50 training throughput of the port")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--device", default="cuda", choices=list(DEVICES))
    a = parser.parse_args(argv)
    out = run(a.batch, a.size, a.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
