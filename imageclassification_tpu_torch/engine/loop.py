"""Epoch loops around the steps (port of the JAX package's `engine/loop.py`).

`train_one_epoch` reads each step's metrics back one step late, after the
next step has been queued, so the device never waits for the host to print:
a step's metrics are copied to the host behind its work (`StepMetrics`), and
reading them waits for that copy alone. `skipped` is read there too, as
JAX's `_drain` reads it. `evaluate` sums the eval step's counts over the
whole validation set, reading each batch's one batch late the same way.
"""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np

from ..utils.metrics import MetricLogger, per_class_precision_recall


def train_one_epoch(train_step, state, data_loader: Iterable, num_classes: int,
                    num_training_steps_per_epoch: int, update_freq: int = 1,
                    log_writer=None, wandb_logger=None, start_steps: int = 0):
    """Run one epoch; returns (state, stats dict of epoch averages).
    `start_steps`: the optimizer steps before this epoch, which number the
    W&B batch-wise records."""
    metric_logger = MetricLogger(delimiter="  ")
    start_time = time.time()
    counts = {k: np.zeros(num_classes) for k in ("tp", "fp", "fn")}

    pending = None  # (the previous step's metrics, its step), read after this step is queued
    for data_iter_step, batch in enumerate(data_loader):
        step = data_iter_step // update_freq
        if step >= num_training_steps_per_epoch:
            continue
        metrics = train_step(state, batch)
        if pending is not None:
            _drain(pending, metric_logger, counts, log_writer, wandb_logger)
        pending = (metrics, start_steps + step)
    if pending is not None:
        _drain(pending, metric_logger, counts, log_writer, wandb_logger)

    print(f"Averaged stats:{metric_logger},Time:{time.time() - start_time}")
    precisions, recalls = per_class_precision_recall(counts["tp"], counts["fp"], counts["fn"])
    for i in range(num_classes):
        print(f"Class {i}: Precision: {precisions[i]:.5f}, Recall: {recalls[i]:.5f}")
    return state, {k: meter.global_avg for k, meter in metric_logger.meters.items()}


def _drain(pending, metric_logger, counts, log_writer, wandb_logger):
    metrics, it = pending
    loss = float(metrics["loss"])
    if metrics["skipped"] > 0:
        # a skipped step's loss (and the counts of its non-finite logits) stay
        # out of the epoch averages
        print(f"Loss is {loss}, skipping step")
        return
    for k in counts:
        counts[k] += metrics[k].numpy()
    class_acc, lr, min_lr, wd, gn = (float(metrics[k]) for k in (
        "class_acc", "lr", "min_lr", "weight_decay", "grad_norm"))
    metric_logger.update(loss=loss, class_acc=class_acc)
    if log_writer is not None:
        log_writer.update(loss=loss, head="loss")
        log_writer.update(class_acc=class_acc, head="loss")
        log_writer.update(lr=lr, head="opt")
        log_writer.update(min_lr=min_lr, head="opt")
        log_writer.update(weight_decay=wd, head="opt")
        log_writer.update(grad_norm=gn, head="opt")
        log_writer.set_step()
    if wandb_logger:
        wandb_logger._wandb.log({
            "Rank-0 Batch Wise/train_loss": loss,
            "Rank-0 Batch Wise/train_max_lr": lr,
            "Rank-0 Batch Wise/train_min_lr": min_lr,
            "Rank-0 Batch Wise/train_class_acc": class_acc,
            "Rank-0 Batch Wise/train_grad_norm": gn,
            "Rank-0 Batch Wise/global_train_step": it,
        })


def evaluate(eval_step, data_loader: Iterable, num_classes: int, header: str = "Val:"):
    """Whole validation set: loss, acc1, acc5, per-class precision_i /
    recall_i, avg_precision and avg_recall, from the summed counts."""
    metric_logger = MetricLogger(delimiter="  ")
    totals = None

    def add(out):
        nonlocal totals
        out = {k: v.double().numpy() for k, v in out.items()}
        totals = out if totals is None else {k: totals[k] + v for k, v in out.items()}
        bs = int(out["n"])
        if bs > 0:
            metric_logger.update(loss=float(out["loss_sum"]) / bs)
            metric_logger.meters["acc1"].update(100.0 * float(out["top1_sum"]) / bs, n=bs)

    pending = None
    for batch in metric_logger.log_every(data_loader, 0, header):
        out = eval_step(batch)
        if pending is not None:
            add(pending)
        pending = out
    if pending is not None:
        add(pending)

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
