"""Eval step (port of imageclassification_tpu/engine/step.py `build_eval_step`)."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..data.augment import eval_preprocess


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
