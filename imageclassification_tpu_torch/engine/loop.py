"""Epoch loops around the steps (port of the JAX package's `engine/loop.py`).

`train_one_epoch` reads each step's metrics back one step late, after the
next step has been queued, so the device never waits for the host to print.
`evaluate` sums the eval step's counts over the whole validation set.
"""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np
import torch

from ..utils.metrics import MetricLogger, per_class_precision_recall


def train_one_epoch(train_step, state, data_loader: Iterable, num_classes: int,
                    num_training_steps_per_epoch: int, update_freq: int = 1,
                    log_writer=None):
    """Run one epoch; returns (state, stats dict of epoch averages)."""
    metric_logger = MetricLogger(delimiter="  ")
    start_time = time.time()
    counts = {k: np.zeros(num_classes) for k in ("tp", "fp", "fn")}

    pending = None  # the previous step's metrics, read after this step is queued
    for data_iter_step, batch in enumerate(data_loader):
        if data_iter_step // update_freq >= num_training_steps_per_epoch:
            continue
        metrics = train_step(state, batch)
        if pending is not None:
            _drain(pending, metric_logger, counts, log_writer)
        pending = metrics
    if pending is not None:
        _drain(pending, metric_logger, counts, log_writer)

    print(f"Averaged stats:{metric_logger},Time:{time.time() - start_time}")
    precisions, recalls = per_class_precision_recall(counts["tp"], counts["fp"], counts["fn"])
    for i in range(num_classes):
        print(f"Class {i}: Precision: {precisions[i]:.5f}, Recall: {recalls[i]:.5f}")
    return state, {k: meter.global_avg for k, meter in metric_logger.meters.items()}


def _scalar(v) -> float:
    return float(v.item()) if isinstance(v, torch.Tensor) else float(v)


def _drain(metrics, metric_logger, counts, log_writer):
    loss = _scalar(metrics["loss"])
    if metrics["skipped"] > 0:
        # a skipped step's loss (and the counts of its non-finite logits) stay
        # out of the epoch averages
        print(f"Loss is {loss}, skipping step")
        return
    for k in counts:
        counts[k] += metrics[k].cpu().numpy()
    class_acc = _scalar(metrics["class_acc"])
    metric_logger.update(loss=loss, class_acc=class_acc)
    if log_writer is not None:
        log_writer.update(loss=loss, head="loss")
        log_writer.update(class_acc=class_acc, head="loss")
        log_writer.update(lr=metrics["lr"], head="opt")
        log_writer.update(min_lr=metrics["min_lr"], head="opt")
        log_writer.update(weight_decay=metrics["weight_decay"], head="opt")
        log_writer.update(grad_norm=_scalar(metrics["grad_norm"]), head="opt")
        log_writer.set_step()


def evaluate(eval_step, data_loader: Iterable, num_classes: int, header: str = "Val:"):
    """Whole validation set: loss, acc1, acc5, per-class precision_i /
    recall_i, avg_precision and avg_recall, from the summed counts."""
    metric_logger = MetricLogger(delimiter="  ")
    totals = None
    for batch in metric_logger.log_every(data_loader, 0, header):
        out = {k: v.double().cpu().numpy() for k, v in eval_step(batch).items()}
        if totals is None:
            totals = out
        else:
            for k, v in out.items():
                totals[k] = totals[k] + v
        bs = int(out["n"])
        if bs > 0:
            metric_logger.update(loss=float(out["loss_sum"]) / bs)
            metric_logger.meters["acc1"].update(100.0 * float(out["top1_sum"]) / bs, n=bs)

    n = max(float(totals["n"]), 1.0)
    stats = {
        "loss": float(totals["loss_sum"] / n),
        "acc1": float(100.0 * totals["top1_sum"] / n),
        "acc5": float(100.0 * totals["top5_sum"] / n),
    }
    precisions, recalls = per_class_precision_recall(totals["tp"], totals["fp"], totals["fn"])
    for i in range(num_classes):
        stats[f"precision_{i}"] = precisions[i]
        stats[f"recall_{i}"] = recalls[i]
        print(f"Class {i}: Precision: {precisions[i]:.5f}, Recall: {recalls[i]:.5f}")
    stats["avg_precision"] = float(np.mean(precisions)) if precisions else 0.0
    stats["avg_recall"] = float(np.mean(recalls)) if recalls else 0.0
    print(f"Average Precision: {stats['avg_precision']:.5f}, "
          f"Average Recall: {stats['avg_recall']:.5f}")
    return stats
