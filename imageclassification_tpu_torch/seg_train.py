"""UPerNet + ConvNeXt semantic-segmentation fine-tuning (port of the root
seg_train.py), in one process on one device:

    python -m imageclassification_tpu_torch.seg_train --data_path /data/ade_like \\
        --config upernet_convnext_tiny_512_160k \\
        --pretrained_path train_cls/output/checkpoint-best.pth [--device cuda|cpu]

The recipe of the JAX CLI: UPerHead + FCN aux over the ConvNeXt pyramid,
AdamW with the recipe's stage-wise lr decay and no decay on vectors, poly LR
with linear warmup, iteration-based running, whole / slide / ms eval.
Dataset layout and pipeline: downstream/seg_data.py (the mmseg folder
layout; the same batches as the JAX package from the same seed).
Checkpoints (checkpoint-iter{N}.pth, checkpoint-best.pth, auto-resume from
the highest iteration with the step restored unconditionally) are the JAX
package's files: either CLI resumes the other's.

The step runs eager on `--device` (cuda by default, which raises without a
card; `--device cpu` runs on the CPU). A launch of more than one process
(torchrun's WORLD_SIZE, SLURM_NTASKS), `--dist_on_itp` and a
`--mesh_shape` over more than one device raise NotImplementedError:
multi-process training and the rank-strided eval are ROADMAP A9.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .config import _launcher_processes, _mesh_devices
from .device import DEVICES, resolve_device
from .downstream.configs import SEGMENTATION_CONFIGS
from .downstream.seg_data import IGNORE, num_classes_from_masks, scan_pairs, train_batches
from .downstream.seg_engine import (_normalize, build_seg_eval_step, build_seg_train_step,
                                    create_seg_optimizer, miou_from_confusion, seg_decay_scales,
                                    sharded_whole_eval, slide_logits, transfer_backbone)
from .downstream.upernet import build_upernet
from .engine.state import TrainState
from .optim.schedules import poly_scheduler

MS_RATIOS = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)


def get_args_parser():
    p = argparse.ArgumentParser("UPerNet segmentation (PyTorch/CUDA port)", add_help=False)
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--config", type=str, default="upernet_convnext_tiny_512_160k",
                   choices=sorted(SEGMENTATION_CONFIGS))
    p.add_argument("--num_classes", type=int, default=0,
                   help="0 = auto from the training masks")
    p.add_argument("--batch_size", type=int, default=0,
                   help="global; 0 = the recipe's 16 (2 img x 8 GPUs)")
    p.add_argument("--crop_size", type=int, default=0,
                   help="0 = the recipe's crop (512/640)")
    p.add_argument("--total_iters", type=int, default=0, help="0 = the recipe's 160k")
    p.add_argument("--warmup_iters", type=int, default=-1)
    p.add_argument("--lr", type=float, default=0.0, help="0 = recipe lr")
    p.add_argument("--pretrained_path", type=str, default="",
                   help="classification checkpoint to seed the backbone")
    p.add_argument("--output_dir", type=str, default="train_seg/output")
    p.add_argument("--eval_mode", type=str, default="whole", choices=["whole", "slide", "ms"],
                   help="whole: squash-resize to crop (fast); slide: full-resolution "
                        "crop x crop windows at the recipe stride; ms: slide at 6 scales x "
                        "hflip with softmax averaging")
    p.add_argument("--eval_interval", type=int, default=0, help="0 = eval only at the end")
    p.add_argument("--save_ckpt_interval", type=int, default=0,
                   help="0 = save only at the end")
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--half_precision", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--mesh_shape", type=str, default="")
    p.add_argument("--dist_on_itp", action="store_true")
    p.add_argument("--dist_url", default="env://")
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES)
    return p


def check_single_process(args) -> None:
    """NotImplementedError naming ROADMAP A9 for what needs more than one
    process or device."""
    processes, variable = _launcher_processes()
    for is_set, what in ((args.dist_on_itp, "--dist_on_itp"),
                         (processes > 1, f"a launch of {processes} processes ({variable})"),
                         (_mesh_devices(args.mesh_shape) > 1, f"--mesh_shape {args.mesh_shape}")):
        if is_set:
            raise NotImplementedError(
                f"{what}: multi-process segmentation is not ported to imageclassification_tpu_torch "
                "yet (ROADMAP A9 (distributed)); the port's seg_train runs one process")


def step_generator(seed: int, it: int, device: torch.device) -> torch.Generator:
    """The generator of iteration `it`'s drop-path and dropout draws, a pure
    function of (seed, it), so a resumed run draws what the original would."""
    state = np.random.SeedSequence([seed, it]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def window_logits_fn(model, device: torch.device):
    """uint8 windows [n, crop, crop, 3] (numpy) -> the model's main logits
    (fp32 NHWC on the device), eval mode."""

    @torch.inference_mode()
    def fn(windows_u8):
        model.eval()
        main, _ = model(_normalize(torch.from_numpy(np.ascontiguousarray(windows_u8)).to(device)))
        return main

    return fn


def slide_probabilities(window_fn, pil, hw, num_classes: int, crop: int, stride: int,
                        ms: bool = False) -> np.ndarray:
    """The summed softmax probabilities [H, W, C] (float64) of one PIL image
    by windowed inference at full resolution (`slide_logits`); with `ms`
    summed over 6 scales x hflip (the reference *_ms configs' aug-test),
    each resized back to the label's size `hw` with bilinear antialiased
    where it shrinks, as the JAX CLI resizes each class's map with PIL's
    BILINEAR (torch's antialiased bilinear is PIL's filter). Everything after
    the windows runs where the logits lie (on the card for the model's
    window function); one host copy at the end."""
    from PIL import Image

    import torch.nn.functional as F

    H, W = hw
    prob = None
    for r in MS_RATIOS if ms else (1.0,):
        im = pil if r == 1.0 else pil.resize(
            (max(1, round(pil.width * r)), max(1, round(pil.height * r))), Image.BILINEAR)
        arr = np.asarray(im, np.uint8)
        for flip in (False, True) if ms else (False,):
            a = arr[:, ::-1] if flip else arr
            logits = slide_logits(window_fn, np.ascontiguousarray(a), num_classes, crop, stride)
            if flip:
                logits = logits.flip(1)
            p = torch.softmax(logits, dim=-1)
            if p.shape[:2] != (H, W):  # back to the label's resolution
                p = F.interpolate(p.permute(2, 0, 1)[None], size=(H, W), mode="bilinear",
                                  align_corners=False, antialias=True)[0].permute(1, 2, 0)
            prob = p.double() if prob is None else prob + p.double()
    return prob.cpu().numpy()


def evaluate_slide(model, val_pairs, crop: int, stride: int, num_classes: int,
                   device: torch.device, ms: bool = False):
    """(miou, iou, acc) of `slide_probabilities` over `val_pairs`, argmax
    against the full-resolution labels."""
    from PIL import Image

    window_fn = window_logits_fn(model, device)
    conf = np.zeros((num_classes, num_classes), np.float64)
    for img_p, ann_p in val_pairs:
        lab = np.asarray(Image.open(ann_p)).astype(np.int64)
        prob = slide_probabilities(window_fn, Image.open(img_p).convert("RGB"), lab.shape[:2],
                                   num_classes, crop, stride, ms)
        pred = prob.argmax(-1)
        valid = (lab != IGNORE) & (lab >= 0) & (lab < num_classes)
        idx = lab[valid] * num_classes + pred[valid]
        conf += np.bincount(idx.ravel(), minlength=num_classes * num_classes).reshape(
            num_classes, num_classes)
    return miou_from_confusion(conf)


def main(args):
    check_single_process(args)
    device = resolve_device(args.device)
    cfg = SEGMENTATION_CONFIGS[args.config]
    crop = args.crop_size or cfg.crop_size
    batch = args.batch_size or cfg.batch_per_host
    total_iters = args.total_iters or cfg.total_iters
    warmup = cfg.warmup_iters if args.warmup_iters < 0 else args.warmup_iters
    warmup = min(warmup, max(total_iters - 1, 0))
    lr = args.lr or cfg.lr

    train_pairs = scan_pairs(args.data_path, "training")
    val_pairs = scan_pairs(args.data_path, "validation")
    num_classes = args.num_classes or num_classes_from_masks(train_pairs)
    print(f"{len(train_pairs)} train / {len(val_pairs)} val pairs, {num_classes} classes, "
          f"crop {crop}, batch {batch}, {total_iters} iters")

    model, _ = build_upernet(args.config, num_classes, half_precision=args.half_precision,
                             generator=torch.Generator().manual_seed(args.seed))
    if args.pretrained_path:
        transfer_backbone(model, args.pretrained_path)
    model = model.to(device)
    # the recipe's backbone lr decay (stage_wise 0.9; tiny: paramwise
    # num_layers 6, the others 12)
    scales = seg_decay_scales(model, cfg.decay_type, cfg.layer_decay_rate,
                              cfg.layer_decay_num_layers)
    state = TrainState(model=model, optimizer=create_seg_optimizer(
        model, lr, cfg.weight_decay, decay_scales=scales))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"UPerNet({cfg.backbone}): {n_params / 1e6:.1f}M params")

    start_iter = resume(state, args.output_dir)
    lr_values = poly_scheduler(lr, total_iters, power=cfg.power, min_value=cfg.min_lr,
                               warmup_iters=warmup)
    train_step = build_seg_train_step(model, lr_values, cfg.weight_decay)
    eval_step = build_seg_eval_step(model, num_classes)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    log_path = out_dir.parent / "log.txt"
    from .utils.loggers import TensorboardLogger

    tb = TensorboardLogger(str(out_dir.parent / "log_dir"))
    save_args = SimpleNamespace(output_dir=str(out_dir), model_ema=False, save_ckpt_num=3,
                                save_ckpt_freq=1)
    model_spec = {"task": "segmentation", "config": args.config, "num_classes": num_classes,
                  "crop_size": crop}
    # the recipe's stride 341 at crop 512, scaled with a crop override so
    # that stride <= crop always holds (mmseg asserts the same)
    stride = max(1, round(cfg.eval_stride * crop / cfg.crop_size))

    def evaluate():
        if args.eval_mode in ("slide", "ms"):
            return evaluate_slide(model, val_pairs, crop, stride, num_classes, device,
                                  ms=args.eval_mode == "ms")
        conf = sharded_whole_eval(eval_step, val_pairs, crop, batch, num_classes, device)
        return miou_from_confusion(conf)

    t0 = time.time()
    best_miou = -1.0
    loss_sum, n_since = None, 0
    for it, xs, ys in train_batches(train_pairs, crop, batch, total_iters, args.seed,
                                    start=start_iter):
        loss = train_step(state, torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device),
                          step_generator(args.seed + 1, it, device))
        loss_sum = loss if loss_sum is None else loss_sum + loss
        n_since += 1
        last = it + 1 == total_iters
        if (it + 1) % args.log_interval == 0 or last:
            avg = float(loss_sum) / n_since
            lr_it = lr_values[min(it, len(lr_values) - 1)]
            print(f"iter {it + 1}/{total_iters} loss {avg:.4f} lr {lr_it:.2e} "
                  f"({(time.time() - t0) / (it + 1 - start_iter):.2f}s/iter)")
            tb.update(head="loss", step=it + 1, loss=avg)
            tb.update(head="opt", step=it + 1, lr=float(lr_it))
            loss_sum, n_since = None, 0
        if args.eval_interval and (it + 1) % args.eval_interval == 0 and not last:
            miou, _, acc = evaluate()
            print(f"iter {it + 1}: mIoU {miou * 100:.2f} aAcc {acc * 100:.2f}")
            tb.update(head="perf", step=it + 1, miou=miou, aacc=acc)
            if miou > best_miou:
                _save_best(miou, state, save_args, crop, num_classes, model_spec)
                best_miou = miou
            with open(log_path, "a") as f:
                f.write(json.dumps({"iter": it + 1, "miou": miou, "aacc": acc}) + "\n")
        if args.save_ckpt_interval and (it + 1) % args.save_ckpt_interval == 0:
            from .checkpoint.io import save_model

            save_model(save_args, (1, crop, crop, 3), f"iter{it + 1}", state, num_classes,
                       model_spec)
            _prune_iter_ckpts(args.output_dir, keep=save_args.save_ckpt_num)

    miou, iou, acc = evaluate()
    if miou > best_miou:
        _save_best(miou, state, save_args, crop, num_classes, model_spec)
        best_miou = miou
    per_class = {f"iou_{i}": (None if np.isnan(v) else round(float(v), 4))
                 for i, v in enumerate(iou)}
    row = {"iter": total_iters, "miou": miou, "aacc": acc,
           "wall_clock_s": round(time.time() - t0, 1), **per_class}
    print(f"final: mIoU {miou * 100:.2f} aAcc {acc * 100:.2f} (best {best_miou * 100:.2f})")
    tb.update(head="perf", step=total_iters, miou=miou, aacc=acc)
    tb.flush()
    with open(log_path, "a") as f:
        f.write(json.dumps(row) + "\n")
    from .checkpoint.io import save_model

    save_model(save_args, (1, crop, crop, 3), f"iter{total_iters}", state, num_classes,
               model_spec)
    return row


def resume(state: TrainState, output_dir: str) -> int:
    """Auto-resume from the highest checkpoint-iter{N}.pth in `output_dir`:
    the parameters and BatchNorm statistics (pruned by name and shape), the
    step restored unconditionally (a step left at 0 would restart the poly
    schedule's warmup mid-run), the optimizer when every parameter matched.
    Returns the iteration to start from (0 without a checkpoint)."""
    latest = _find_latest_iter_ckpt(output_dir)
    if latest is None:
        return 0
    from .checkpoint.io import load_checkpoint, load_params_with_pruning
    from .checkpoint.to_jax import carry_for, optimizer_from_jax

    path, start_iter = latest
    print(f"Auto resume checkpoint: {path}")
    ck = load_checkpoint(path)
    missing = load_params_with_pruning(state.model, ck["model"])
    if ck.get("batch_stats"):
        load_params_with_pruning(state.model, ck["batch_stats"], verbose=False)
    state.step = int(ck.get("step", start_iter))
    if missing == 0 and "optimizer" in ck:
        optimizer_from_jax(ck["optimizer"], state.optimizer, state.model, carry_for(state.model))
        print("With optim & sched!")
    return start_iter


def _find_latest_iter_ckpt(output_dir):
    """(path, iter) of the highest checkpoint-iter{N}.pth, or None."""
    best = None
    for p in glob.glob(os.path.join(output_dir, "checkpoint-iter*.pth")):
        m = re.fullmatch(r"checkpoint-iter(\d+)\.pth", os.path.basename(p))
        if m and (best is None or int(m.group(1)) > best[1]):
            best = (p, int(m.group(1)))
    return best


def _prune_iter_ckpts(output_dir, keep: int):
    """Rolling retention for iteration checkpoints (the classification
    writer deletes numbered epochs only): keep the newest `keep`."""
    found = []
    for p in glob.glob(os.path.join(output_dir, "checkpoint-iter*.pth")):
        m = re.fullmatch(r"checkpoint-iter(\d+)\.pth", os.path.basename(p))
        if m:
            found.append((int(m.group(1)), p))
    for _, p in sorted(found)[:-keep] if keep > 0 else []:
        os.remove(p)


def _save_best(miou, state, save_args, crop, num_classes, model_spec):
    from .checkpoint.io import save_model

    save_model(save_args, (1, crop, crop, 3), "best", state, num_classes,
               dict(model_spec, miou=miou))


if __name__ == "__main__":
    main(get_args_parser().parse_args())
