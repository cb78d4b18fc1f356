"""Per-iteration LR/WD schedule arrays (own copy of
imageclassification_tpu/optim/schedules.py, pure numpy): closed-form value
arrays that the train step indexes by its update counter each step."""

from __future__ import annotations

import math

import numpy as np


def cosine_scheduler(
    base_value,
    final_value,
    epochs,
    niter_per_ep,
    warmup_epochs=0,
    start_warmup_value=0,
    warmup_steps=-1,
):
    """Linear warmup then half-cosine decay; len == epochs*niter_per_ep
    (reference utils.py:471-488, including warmup_steps>0 overriding epochs)."""
    warmup_schedule = np.array([])
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    print("Set warmup steps = %d" % warmup_iters)
    if warmup_epochs > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value, warmup_iters)

    n = epochs * niter_per_ep - warmup_iters
    iters = np.arange(n)
    schedule = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(math.pi * iters / n)
    )
    schedule = np.concatenate((warmup_schedule, schedule))
    assert len(schedule) == epochs * niter_per_ep
    return schedule


def linear_scheduler(
    base_value,
    final_value,
    epochs,
    niter_per_ep,
    warmup_epochs=0,
    start_warmup_value=0,
    warmup_steps=-1,
):
    """Linear warmup then linear decay (reference utils.py:490-506)."""
    warmup_schedule = np.array([])
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    print("Set warmup steps = %d" % warmup_iters)
    if warmup_epochs > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value, warmup_iters)

    n = epochs * niter_per_ep - warmup_iters
    iters = np.arange(n)
    schedule = base_value - (base_value - final_value) * iters / n
    schedule = np.concatenate((warmup_schedule, schedule))
    assert len(schedule) == epochs * niter_per_ep
    return schedule


def piecewise_scheduler(
    base_value,
    final_value,
    epochs,
    niter_per_ep,
    warmup_epochs=0,
    start_warmup_value=0,
    warmup_steps=-1,
    milestones=None,
    gamma=0.8,
):
    """Step decay at milestones (reference utils.py:509-534, semantics preserved:
    default milestones at 1/10..9/10 of TOTAL iters, decay applied when the
    post-warmup iteration counter hits a milestone)."""
    warmup_schedule = np.array([])
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    print("Set warmup steps = %d" % warmup_iters)
    if warmup_epochs > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value, warmup_iters)

    n = epochs * niter_per_ep - warmup_iters
    if milestones is None:
        total_iters = epochs * niter_per_ep
        milestones = [int(total_iters * i // 10) for i in range(1, 10)]
    milestones = set(milestones)

    values = [base_value]
    for i in range(1, n):
        values.append(values[-1] * gamma if i in milestones else values[-1])
    schedule = np.concatenate((warmup_schedule, np.array(values)))
    assert len(schedule) == epochs * niter_per_ep
    return schedule


def poly_scheduler(
    base_value,
    total_iters,
    power=1.0,
    min_value=0.0,
    warmup_iters=0,
    warmup_ratio=1e-6,
):
    """mmseg PolyLrUpdaterHook semantics (the reference segmentation recipes:
    semantic_segmentation/configs/convnext/upernet_convnext_tiny_512_160k_ade20k_ss.py:43-45
    — poly power 1.0, min_lr 0, linear warmup 1500 iters, warmup_ratio 1e-6):
    regular lr = (base-min)*(1-i/total)^power + min, scaled during warmup by
    1 - (1 - i/warmup)*(1 - warmup_ratio)."""
    i = np.arange(total_iters, dtype=np.float64)
    reg = (base_value - min_value) * (1.0 - i / total_iters) ** power + min_value
    if warmup_iters > 0:
        k = np.minimum(i, warmup_iters) / warmup_iters
        reg = reg * (1.0 - (1.0 - k) * (1.0 - warmup_ratio))
    assert len(reg) == total_iters
    return reg


def build_schedules(args, niter_per_ep):
    """LR + WD arrays as train.py wires them (train.py:233-254): the chosen
    scheduler for LR, cosine (always) for WD from weight_decay→weight_decay_end."""
    sched_fn = {
        "cosine": cosine_scheduler,
        "linear": linear_scheduler,
        "piecewise": piecewise_scheduler,
    }[args.lr_scheduler]
    lr_values = sched_fn(
        args.lr,
        args.min_lr,
        args.epochs,
        niter_per_ep,
        warmup_epochs=args.warmup_epochs,
        warmup_steps=args.warmup_steps,
    )
    wd_end = args.weight_decay_end
    if wd_end is None:
        wd_end = args.weight_decay
    wd_values = cosine_scheduler(args.weight_decay, wd_end, args.epochs, niter_per_ep)
    return lr_values, wd_values
