"""Segmentation train/eval machinery (port of
imageclassification_tpu/downstream/seg_engine.py).

One train step: normalize, the UPerNet forward, per-pixel cross-entropy
(ignore label 255) plus 0.4 of the FCN aux head's, the gradients, the poly
LR of the step's iteration written into the optimizer (AdamW with
stage-wise decay scales and no decay on vectors), the update, and the heads'
BatchNorm statistics committed. The eval step returns one batch's
[C, C] confusion counts on the device; the caller accumulates them in
float64 on the host, where mIoU falls out at the end.

The steps run eager on the card or the CPU, in one process: at a world of
1 the JAX package's `sharded_whole_eval` is a plain loop over the val set
(its rank-strided shards and collectives are ROADMAP A9).
"""

from __future__ import annotations

import math
import re
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.augment import IMAGENET_MEAN, IMAGENET_STD
from ..engine.state import TrainState
from ..models.layers import commit_batch_stats
from ..optim.factory import Optimizer

IGNORE_INDEX = 255  # mmseg convention: 255 = unlabeled, excluded everywhere


def _normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized fp32 (the classification eval
    path's constants)."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def seg_loss(main_logits: torch.Tensor, aux_logits: Optional[torch.Tensor],
             labels: torch.Tensor, aux_weight: float = 0.4) -> torch.Tensor:
    """Per-pixel cross-entropy averaged over the pixels not labelled 255, plus
    aux_weight times the same on the aux head's logits. Logits NHWC, labels
    NHW with ids below the class count or 255."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    denom = valid.sum().clamp(min=1).to(torch.float32)

    def ce(logits):
        px = F.cross_entropy(logits.float().permute(0, 3, 1, 2), safe, reduction="none")
        return torch.where(valid, px, torch.zeros_like(px)).sum() / denom

    loss = ce(main_logits)
    if aux_logits is not None:
        loss = loss + aux_weight * ce(aux_logits)
    return loss


def confusion_update(conf: torch.Tensor, logits: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """conf[c_true, c_pred] += count of the pixels of each pair (int64
    counts, exact). Ignores 255 and any label outside [0, num_classes)."""
    preds = logits.argmax(dim=-1).reshape(-1)
    lab = labels.reshape(-1).long()
    valid = (lab != IGNORE_INDEX) & (lab >= 0) & (lab < num_classes)
    idx = lab[valid] * num_classes + preds[valid]
    return conf + torch.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes).to(conf.dtype)


def miou_from_confusion(conf):
    """(miou, per-class iou, overall pixel acc) from a [C, C] matrix, in
    float64; classes absent from both prediction and label are left out of
    the mean (mmseg's nanmean)."""
    conf = np.asarray(conf, np.float64)
    inter = np.diag(conf)
    union = conf.sum(0) + conf.sum(1) - inter
    present = union > 0
    iou = np.where(present, inter / np.maximum(union, 1), np.nan)
    miou = float(np.nanmean(np.where(present, iou, np.nan))) if present.any() else 0.0
    acc = float(inter.sum() / max(conf.sum(), 1.0))
    return miou, iou, acc


def build_seg_train_step(model: nn.Module, lr_schedule, weight_decay: float,
                         aux_weight: float = 0.4) -> Callable:
    """train_step(state, images_u8, labels, generator) -> the loss (a 0-d
    fp32 tensor on the device). The step's lr is lr_schedule[min(step,
    len - 1)], the weight decay constant (the reference seg recipes');
    `generator` draws the drop-path and dropout masks."""
    lr_schedule = np.asarray(lr_schedule, np.float32)

    def train_step(state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        opt: Optimizer = state.optimizer
        model.train()
        main, aux = model(_normalize(images_u8), generator)
        loss = seg_loss(main, aux, labels, aux_weight)
        grads = torch.autograd.grad(loss, opt.params)
        it = min(state.step, len(lr_schedule) - 1)
        opt.set_hyperparams(float(lr_schedule[it]), weight_decay)
        opt.step(grads)
        commit_batch_stats(model)
        state.step += 1
        return loss.detach()

    return train_step


def build_seg_eval_step(model: nn.Module, num_classes: int) -> Callable:
    """eval_step(images_u8, labels) -> this batch's [C, C] confusion counts
    (int64, on the device); the caller accumulates in float64 on the host."""

    @torch.inference_mode()
    def eval_step(images_u8: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        model.eval()
        main, _ = model(_normalize(images_u8))
        conf = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=main.device)
        return confusion_update(conf, main, labels, num_classes)

    return eval_step


def sharded_whole_eval(eval_step: Callable, val_pairs, crop: int, batch: int, num_classes: int,
                       device: torch.device) -> np.ndarray:
    """Whole-image eval over `val_pairs` at a world of 1 (the JAX function's
    rank 0 of 1): squash-resized batches of `batch`, the last padded with
    all-ignore rows to one shape, the counts accumulated in float64 on the
    host. Returns the [C, C] confusion matrix."""
    from .seg_data import val_batches

    n_steps = math.ceil(len(val_pairs) / batch)
    batches = val_batches(val_pairs, crop, batch=batch)
    conf = np.zeros((num_classes, num_classes), np.float64)
    for _ in range(n_steps):
        xs, ys = next(batches)
        pad = batch - xs.shape[0]
        if pad:
            xs = np.concatenate([xs, np.zeros((pad, crop, crop, 3), np.uint8)])
            ys = np.concatenate([ys, np.full((pad, crop, crop), IGNORE_INDEX, np.int32)])
        counts = eval_step(torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device))
        conf += counts.cpu().numpy().astype(np.float64)
    return conf


def slide_window_origins(size: int, crop: int, stride: int) -> List[int]:
    """mmseg slide-test window origins: i * stride clamped so the last window
    sits flush with the edge (EncoderDecoder.slide_inference)."""
    if size <= crop:
        return [0]
    n = -(-(size - crop) // stride) + 1  # ceil + 1
    return sorted({min(i * stride, size - crop) for i in range(n)})


def slide_logits(window_fn: Callable, image_u8: np.ndarray, num_classes: int, crop: int,
                 stride: int, window_batch: int = 8) -> torch.Tensor:
    """`slide_inference`'s logits [H, W, C] as an fp32 tensor where the
    window function's logits lie (on the card for the model's)."""
    H, W = image_u8.shape[:2]
    Hp, Wp = max(H, crop), max(W, crop)
    img = np.zeros((Hp, Wp, 3), image_u8.dtype)
    img[:H, :W] = image_u8
    acc = cnt = None
    wins = [(y, x) for y in slide_window_origins(Hp, crop, stride)
            for x in slide_window_origins(Wp, crop, stride)]
    for i in range(0, len(wins), window_batch):
        chunk = wins[i:i + window_batch]
        batch = np.zeros((window_batch, crop, crop, 3), image_u8.dtype)
        for j, (y, x) in enumerate(chunk):
            batch[j] = img[y:y + crop, x:x + crop]
        logits = torch.as_tensor(window_fn(batch)).float()
        if acc is None:
            acc = logits.new_zeros((Hp, Wp, num_classes))
            cnt = logits.new_zeros((Hp, Wp, 1))
        for (y, x), lg in zip(chunk, logits):
            acc[y:y + crop, x:x + crop] += lg
            cnt[y:y + crop, x:x + crop] += 1.0
    return acc[:H, :W] / cnt[:H, :W]


def slide_inference(window_fn: Callable, image_u8: np.ndarray, num_classes: int, crop: int,
                    stride: int, window_batch: int = 8) -> np.ndarray:
    """Full-resolution logits [H, W, C] of ONE image by sliding crop x crop
    windows at `stride` and averaging overlapping logits (mmseg test_cfg
    mode='slide'). Windows go to `window_fn` (uint8 [window_batch, crop,
    crop, 3] numpy -> logits, a tensor or numpy) in batches of
    `window_batch`, the last zero-padded, so it sees one shape. The fp32 sums
    are taken where the logits lie (on the card for the model's window
    function), in the JAX function's order, and copied to the host once."""
    return slide_logits(window_fn, image_u8, num_classes, crop, stride,
                        window_batch).cpu().numpy()


def _jax_names(model: nn.Module) -> List[str]:
    """The JAX parameter path of each of `model`'s parameters, in
    `named_parameters()` order, through its weight carry (one JAX tensor a
    parameter in a UPerNet)."""
    from ..checkpoint.to_jax import carry_for

    params = dict(model.named_parameters())
    names = list(carry_for(model).to_jax(params))
    if len(names) != len(params):
        raise ValueError("the decay scales need one JAX tensor a parameter")
    return names


def seg_decay_scales(model: nn.Module, decay_type: str, decay_rate: float,
                     num_layers: int = 12) -> List[float]:
    """The lr scale of each of the UPerNet's parameters (`named_parameters()`
    order), the reference's LearningRateDecayOptimizerConstructor rules
    (layer_decay_optimizer_constructor.py:45-54,100) on the JAX parameter
    paths (from the weight carry), as the JAX function computes them:

    stage_wise (N = num_layers + 2): backbone stem/downsample id 0, backbone
    stage i id i + 1, everything else (heads, the backbone's out norms) id
    N - 1; scale decay_rate^(N - id - 1), in float64 rounded to float32.
    layer_wise: the classification rule for ConvNeXt on the backbone
    (optim/layer_decay.py), the heads at 1.0."""
    names = [n for n, _ in model.named_parameters()]
    if decay_type == "layer_wise":
        from ..optim.layer_decay import layer_decay_scales

        bb = [n[len("backbone."):] for n in names if n.startswith("backbone.")]
        bb_scales = iter(layer_decay_scales(bb, "convnext", decay_rate))
        return [next(bb_scales) if n.startswith("backbone.") else 1.0 for n in names]

    n = num_layers + 2

    def leaf_id(path: str) -> int:
        parts = path.split("/")
        if parts[0] != "backbone":
            return n - 1
        p = parts[1]
        if p.startswith(("stem", "downsample_")):
            return 0
        if (m := re.match(r"stage(\d+)_block", p)):
            return int(m.group(1)) + 1
        return n - 1  # the backbone's out norms: the reference's 'else' branch

    return [float(np.float32(decay_rate ** (n - leaf_id(k) - 1))) for k in _jax_names(model)]


def create_seg_optimizer(model: nn.Module, lr: float, weight_decay: float,
                         decay_scales: Optional[Sequence[float]] = None) -> Optimizer:
    """AdamW, betas (0.9, 0.999), eps 1e-8, weight decay on the parameters of
    two or more dims only (the reference seg recipes' optimizer and its
    no-decay set, norms and biases); each parameter's update, decay
    included, times its `decay_scales` entry and the lr (torch semantics:
    a group's lr = scale * base lr)."""
    params = list(model.parameters())
    return Optimizer("adamw", params, lr, weight_decay, eps=1e-8, betas=(0.9, 0.999),
                     layer_scales=decay_scales, decay_mask=[p.dim() >= 2 for p in params])


def transfer_backbone(model: nn.Module, classifier_ckpt: str) -> int:
    """Seed the UPerNet's backbone from a classification checkpoint (the
    reference's init_cfg / load_checkpoint path), pruning the keys that do
    not exist in the pyramid view (head, head norm). Returns the number of
    checkpoint keys skipped."""
    from ..checkpoint.io import load_checkpoint, load_params_with_pruning

    ck = load_checkpoint(classifier_ckpt)
    skipped = load_params_with_pruning(model.backbone, ck["model"])
    print(f"backbone transfer: {skipped} mismatched keys skipped")
    return skipped
