"""Train and eval steps (port of the JAX package's `engine/step.py`).

The train step keeps the JAX step's semantics and order: augment -> mixup or
label smoothing -> forward -> loss (soft-target cross-entropy for 2-D
targets) -> backward -> accumulate (update_freq) -> lr/wd from the schedule
arrays at step // update_freq -> grad norm -> optimizer update (clip inside)
-> EMA -> metrics, the train accuracy in 'exact' mode from a second no-grad
forward on the un-mixed batch with the post-update weights.

A non-finite loss skips the update: parameters, optimizer state and EMA stay
as they were and grad_norm reads 0. JAX gates this branchlessly inside one
compiled step; here the step reads the loss's finiteness on the host, one
synchronisation per step. With update_freq > 1 a non-finite micro-gradient
never enters the accumulator, and a window whose boundary step is non-finite
is discarded.

Distillation, prune masks and AdaHessian are not ported yet (ROADMAP A16,
A17) and raise.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.augment import AugmentPipeline, eval_preprocess
from ..data.mixup import MixupConfig, mixup_cutmix, one_hot_smooth, sample_mixup
from ..optim.ema import ema_update, warmup_decay
from .state import TrainState


def _per_class_counts(preds, labels, num_classes, weights):
    """TP/FP/FN count vectors, each sample weighted (0 for padding)."""
    match = (preds == labels).float() * weights
    miss = (preds != labels).float() * weights
    lab_oh = F.one_hot(labels, num_classes).float()
    pred_oh = F.one_hot(preds, num_classes).float()
    tp = lab_oh.T @ match
    fp = pred_oh.T @ miss
    fn = lab_oh.T @ miss
    return tp, fp, fn


def global_norm(tensors, norm_type: float = 2.0) -> torch.Tensor:
    """Global gradient norm: L2 over every element, or the largest absolute
    element for norm_type = inf."""
    norms = torch.stack(torch._foreach_norm(list(tensors), norm_type))
    return norms.max() if math.isinf(norm_type) else torch.linalg.vector_norm(norms)


def build_train_step(model: nn.Module, args, num_classes: int,
                     mixup_cfg: Optional[MixupConfig], lr_schedule, wd_schedule,
                     ema_decay: float = 0.9995, seed: int = 0, teacher=None,
                     prune_masks=None) -> Callable:
    """Returns train_step(state, batch, draws=None) -> metrics.

    `batch` holds "image" (uint8 NHWC) and "label" (int64) on the model's
    device. `draws` holds the step's random draws ({"augment": ...,
    "mixup": ...}, see `train_step.sample_draws`); without them the step
    draws its own from generators seeded by `seed`. The step runs on
    `state.model` and `state.optimizer`; `model` fixes the device."""
    if teacher is not None or prune_masks is not None:
        raise NotImplementedError(
            "distillation and prune masks are not ported to imageclassification_tpu_torch "
            "yet (ROADMAP A17)")
    device = next(model.parameters()).device
    augment = AugmentPipeline(args)
    update_freq = int(args.update_freq)
    smoothing = float(args.smoothing)
    use_ema = bool(args.model_ema)
    ema_warmup = bool(getattr(args, "model_ema_warmup", False))
    norm_type = float(getattr(args, "grad_norm_type", 2.0))
    exact_acc = getattr(args, "train_acc_mode", "exact") != "mixed"
    lr_schedule = [float(x) for x in lr_schedule]
    wd_schedule = [float(x) for x in wd_schedule]
    # pixel draws on the device; the few mixup scalars on the host; dropout
    # (none at ViT's defaults) on the device
    aug_gen = torch.Generator(device=device).manual_seed(seed)
    mix_gen = torch.Generator().manual_seed(seed + 1)
    drop_gen = torch.Generator(device=device).manual_seed(seed + 2)

    def sample_draws(B: int, H: int, W: int) -> Dict:
        return {"augment": augment.sample(B, H, W, aug_gen),
                "mixup": sample_mixup(mixup_cfg, B, H, W, mix_gen) if mixup_cfg else None}

    def loss_and_grads(model: nn.Module, batch, draws):
        """(loss, logits, augmented un-mixed images, gradients of the
        parameters in order) of one forward and backward."""
        images = augment(batch["image"], draws["augment"])
        labels = batch["label"]
        if mixup_cfg is not None:
            mixed, targets = mixup_cutmix(images, labels, draws["mixup"], mixup_cfg)
        elif smoothing > 0:
            mixed, targets = images, one_hot_smooth(labels, num_classes, smoothing)
        else:
            mixed, targets = images, labels
        logits = model(mixed, generator=drop_gen).float()
        if targets.dim() == 2:  # soft targets: SoftTargetCrossEntropy
            loss = -(targets * F.log_softmax(logits, dim=-1)).sum(-1).mean()
        else:
            loss = F.cross_entropy(logits, targets)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.detach(), logits.detach(), images, grads

    def train_step(state: TrainState, batch, draws: Optional[Dict] = None):
        model, opt = state.model, state.optimizer
        model.train()
        step = state.step
        if draws is None:
            draws = sample_draws(*batch["image"].shape[:3])
        loss, logits, images, grads = loss_and_grads(model, batch, draws)
        labels = batch["label"]
        finite = bool(torch.isfinite(loss))  # the step's one host synchronisation

        if update_freq > 1:
            if finite:
                torch._foreach_add_(state.grad_accum, torch._foreach_mul(grads, 1.0 / update_freq))
            accum = state.grad_accum
            boundary = (step + 1) % update_freq == 0
        else:
            accum, boundary = list(grads), True

        it = min(step // update_freq, len(lr_schedule) - 1)
        lr, wd = lr_schedule[it], wd_schedule[it]
        opt.set_hyperparams(lr, wd)
        grad_norm = (global_norm(accum, norm_type) if finite
                     else torch.zeros((), device=device))

        if boundary and finite:
            for p, g in zip(opt.params, accum):
                p.grad = g
            opt.step()
            for p in opt.params:
                p.grad = None
            if use_ema:
                d = warmup_decay(ema_decay, step // update_freq) if ema_warmup else ema_decay
                ema_update(state.ema, model, d)
        if update_freq > 1 and boundary:
            # every window ends at its boundary, applied or discarded
            torch._foreach_zero_(state.grad_accum)

        if mixup_cfg is not None and exact_acc:
            with torch.no_grad():
                acc_logits = model(images, generator=drop_gen).float()
        else:
            acc_logits = logits
        preds = acc_logits.argmax(-1)
        tp, fp, fn = _per_class_counts(preds, labels, num_classes,
                                       torch.ones_like(preds, dtype=torch.float32))
        state.step = step + 1
        return {
            "loss": loss,
            "class_acc": (preds == labels).float().mean(),
            "grad_norm": grad_norm,
            "lr": lr,
            "min_lr": lr,
            "weight_decay": wd,
            "tp": tp,
            "fp": fp,
            "fn": fn,
            "skipped": 0.0 if finite else 1.0,
        }

    train_step.sample_draws = sample_draws
    train_step.loss_and_grads = loss_and_grads
    return train_step


def build_eval_step(model: nn.Module, num_classes: int) -> Callable:
    """Returns eval_step(batch) -> metric sums, where batch holds "image"
    (uint8 NHWC) and "label" (int64, -1 for the padded tail) on the model's
    device. Plain cross-entropy; the padded tail is masked out of every
    statistic. Puts the model in eval mode."""

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        images = eval_preprocess(batch["image"])
        labels = batch["label"]
        logits = model(images).float()

        valid = labels >= 0
        safe_labels = labels.clamp(min=0)
        losses = F.cross_entropy(logits, safe_labels, reduction="none")
        w = valid.float()

        preds = logits.argmax(-1)
        top1 = ((preds == safe_labels) & valid).float()
        k = min(5, logits.shape[-1])
        topk = logits.topk(k, dim=-1).indices
        top5 = ((topk == safe_labels[:, None]).any(-1) & valid).float()
        tp, fp, fn = _per_class_counts(preds, safe_labels, num_classes, w)
        return {
            "loss_sum": (losses * w).sum(),
            "n": w.sum(),
            "top1_sum": top1.sum(),
            "top5_sum": top5.sum(),
            "tp": tp,
            "fp": fp,
            "fn": fn,
        }

    return eval_step
