"""Train and eval steps (port of the JAX package's `engine/step.py`).

The train step keeps the JAX step's semantics and order: augment -> mixup or
label smoothing -> forward -> loss (soft-target cross-entropy for 2-D
targets) -> backward -> accumulate (update_freq) -> lr/wd from the schedule
arrays at step // update_freq -> grad norm -> optimizer update (clip inside)
-> EMA -> metrics, the train accuracy in 'exact' mode from a second no-grad
forward on the un-mixed batch with the post-update weights.

A non-finite loss skips the update, gated on the device as JAX gates it,
with no branch and no host read: the loss's finiteness is a device bool
that the optimizer (`Optimizer.step(keep=...)`: parameters, moments and the
update count stay exactly as they were), the BatchNorm commit and the EMA
(selects on the device) take, and grad_norm reads 0 and `skipped` 1. With
update_freq > 1 a non-finite micro-gradient is zeroed before it enters the
accumulator, and a window whose boundary step is non-finite is discarded.
Whether a step ends a window is known on the host from the step counter, so
it picks the micro-step or the boundary step, as JAX's `lax.cond` picks a
branch.

The step is split where a CUDA graph needs it (`engine/compiled.py`):
`host_inputs` draws the mixup scalars on the host and packs them with the
schedule index t = step // update_freq into one float64 vector, and
`device_step` does the rest on the device from tensors alone: the pixel
draws and the dropout masks come from the step's CUDA generators, the lr,
wd and EMA warmup decay are read from device tables at t, and the metrics
are one packed vector. `train_step` chains the two eagerly and returns the
metrics as a `StepMetrics`, copied to the host without waiting for the
device.

With `--remat` the loss function (forward and loss) runs under one
`torch.utils.checkpoint.checkpoint`, as JAX wraps its `loss_fn` in
`jax.checkpoint`: no activation is kept, and the backward runs the forward
again first. The recompute draws its dropout and stochastic-depth masks
from a second generator that is given the dropout generator's state on the
host before each step (`host_inputs`; `loss_and_grads` too), so it replays
the first run's masks without keeping them, in eager mode and inside a CUDA
graph alike, where both generators are registered with the graph (torch's
checkpoint would restore only the default generators, and reading a CUDA
generator's state is refused while a graph captures). Under `--layer_decay`
the `lr` and `min_lr` metrics are lr times the largest and the smallest
layer scale, as JAX reports them.

BatchNorm (models with `layers.BatchNorm`): the forward's batch statistics
advance the running statistics on every finite micro-step
(`commit_batch_stats`, gated by the same device bool), and the EMA of the
statistics moves toward the new statistics at each real update; the
exact-mode accuracy forward normalises with its own batch statistics and
throws them away.

Distillation (`teacher`, with --distillation_alpha > 0): the teacher's
eval-mode forward on the same mixed images, without gradient, gives fp32
logits t, and the loss is (1 - alpha) * base + alpha * tau^2 *
KL(softmax(t / tau) || softmax(s / tau)) over the student's logits s, as JAX
computes it inside its loss function. The teacher runs once a step, after
the student's forward and outside the `--remat` checkpoint (its forward is
deterministic, so JAX's recompute of it inside `jax.checkpoint` gives the
same numbers); inside a captured step its parameters are static tensors.

Prune masks (`prune_masks`, --prune_mask): the entries a mask holds False for
are set to zero after each optimizer update and before the EMA sees the
parameters (JAX `engine/step.py:254-262`), a masked fill on the device.

AdaHessian (--opt adahessian): at each boundary micro-step, as JAX
computes it only inside its update branch, the gradients are taken with
`create_graph=True` and a second backward of <g, z> gives Hz, the
Hessian-vector product (JAX's `jax.jvp` of its grad function on the same
loss, the same dropout masks: here the second backward reuses the first
forward's graph); z is Rademacher, one tensor a parameter, drawn on the
device from the step's Hessian generator (registered with the CUDA graphs
as the others), and z * Hz goes to the optimizer as the Hessian diagonal.
Every op on the path has a second derivative in plain PyTorch; the flash
attention has none, and `config.check_ported` refuses that pair.

Several processes (a world of W, `parallel/`): the step is the function of
the global batch, the rank-major concatenation of the ranks' local batches,
that the JAX jit step is. Every draw the JAX step makes over the global
batch is made over it on every rank, from the same seeded generators, and
each rank takes its rows (the pixel draws, `draw_rows`); mixup mixes the
global batch, gathered after the augmentation (`all_gather_rows`), since a
sample's partner B - 1 - i lies on rank W - 1 - r, and each rank keeps its
rows. The dropout and stochastic-depth masks are drawn per rank from a
generator seeded by (seed, rank), a departure from JAX's draw over the
global batch. BatchNorm takes the global batch's statistics
(`models/layers.py`). After the backward the gradients (and adahessian's
z * Hz, z the same on every rank) are averaged over the ranks in one flat
all-reduce with the loss, before the non-finite gate, the gradient norm and
the update, so every rank takes the same branch; with update_freq > 1 at
every micro-step, so that the accumulator and the norm it reports are the
global batch's at every step, as JAX's. The metrics are the global
batch's: the loss and accuracy averaged, the per-class counts summed. At a
world of one every `parallel.mesh` helper is the identity (a rank's rows are
all of them, a view), so the same code is the one-process step.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.augment import AugmentPipeline, draw_rows, eval_preprocess
from ..data.mixup import (MixupConfig, mixup_cutmix, one_hot_smooth, pack_draws,
                          sample_mixup, unpack_draws)
from ..models.layers import clear_batch_stats, commit_batch_stats
from ..optim.ema import ema_update, warmup_decay
from ..optim.factory import route
from ..parallel.dist import get_rank, get_world_size
from ..parallel.mesh import all_gather_rows, mean_across, rows_of, sum_across
from .state import TrainState

# the packed metric vectors: scalars first, then the per-class counts
TRAIN_SCALARS = ("loss", "class_acc", "grad_norm", "lr", "min_lr", "weight_decay", "skipped")
EVAL_SCALARS = ("loss_sum", "n", "top1_sum", "top5_sum")
COUNTS = ("tp", "fp", "fn")


class StepMetrics(Mapping):
    """A step's metrics from its packed fp32 vector `flat` (`scalars`, then
    the `COUNTS` of `num_classes` each). On a card the vector is copied into
    pinned host memory behind the step's work, and the first read waits for
    that copy alone, not for work queued after it; a graph's output buffer
    may be overwritten by the next replay as soon as the copy is queued.
    Values read as CPU tensors: 0-d for the scalars, [num_classes] for the
    counts."""

    def __init__(self, flat: torch.Tensor, scalars: Sequence[str], num_classes: int):
        self._keys, self._num_classes = tuple(scalars), num_classes
        if flat.is_cuda:
            self._host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            self._host.copy_(flat, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record()
        else:
            self._host, self._ready = flat.detach().clone(), None
        self._values = None

    def _read(self) -> Dict:
        if self._values is None:
            if self._ready is not None:
                self._ready.synchronize()
            a, n, c = self._host, len(self._keys), self._num_classes
            self._values = {k: a[i] for i, k in enumerate(self._keys)}
            self._values.update({k: a[n + i * c:n + (i + 1) * c] for i, k in enumerate(COUNTS)})
        return self._values

    def __getitem__(self, key):
        return self._read()[key]

    def __iter__(self):
        return iter(self._read())

    def __len__(self) -> int:
        return len(self._keys) + len(COUNTS)


def _pack(scalars: Sequence[torch.Tensor], tp, fp, fn) -> torch.Tensor:
    return torch.cat([torch.stack([s.float() for s in scalars]), tp, fp, fn])


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device` without waiting for the device: through
    pinned memory onto a card (a copy from pageable memory would first drain
    the stream)."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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


def hutchinson_diag(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                    z: Sequence[torch.Tensor]) -> list:
    """z * Hz, the Hutchinson estimate of the Hessian diagonal, from the
    gradients of `params` taken with create_graph=True: Hz is the second
    backward of <g, z> (zero where a gradient does not depend on the
    parameters)."""
    live = [i for i, g in enumerate(grads) if g.requires_grad]
    hz = torch.autograd.grad([grads[i] for i in live], list(params),
                             grad_outputs=[z[i] for i in live], allow_unused=True)
    return [zi * (h if h is not None else torch.zeros_like(zi)) for zi, h in zip(z, hz)]


def build_train_step(model: nn.Module, args, num_classes: int,
                     mixup_cfg: Optional[MixupConfig], lr_schedule, wd_schedule,
                     ema_decay: float = 0.9995, seed: int = 0, teacher=None,
                     prune_masks=None) -> Callable:
    """Returns train_step(state, batch, draws=None) -> StepMetrics.

    `batch` holds "image" (uint8 NHWC) and "label" (int64) on the model's
    device. `draws` holds the step's random draws ({"augment": ...,
    "mixup": ...}, see `train_step.sample_draws`); without them the step
    draws its own from generators seeded by `seed`. The step runs on
    `state.model` and `state.optimizer`; `model` fixes the device.
    `teacher`: a model in eval mode on the same device, whose logits the
    loss distils with --distillation_alpha > 0 (ignored at 0, as in JAX).
    `prune_masks`: {parameter name: bool tensor of its shape}, False where
    the entry stays zero (`checkpoint.io.derive_prune_masks`); another name
    or shape raises ValueError. Its parts are attributes for
    `engine/compiled.py`: `host_inputs`, `device_step`, `is_boundary`,
    `generators` (the CUDA generators the device step draws from) and
    `num_classes`. In a process group of several ranks (built after
    `parallel.init_distributed_mode`), `draws` and `sample_draws` are those
    of the global batch, and the step takes this rank's rows."""
    device = next(model.parameters()).device
    params = dict(model.named_parameters())
    pruned = []  # (parameter, where it is held at zero)
    for name, mask in (prune_masks or {}).items():
        if name not in params or tuple(mask.shape) != tuple(params[name].shape):
            raise ValueError(f"prune mask {name!r} {tuple(mask.shape)} matches no parameter "
                             "of the model by name and shape")
        pruned.append((params[name], ~mask.to(device=device, dtype=torch.bool)))
    alpha = float(getattr(args, "distillation_alpha", 0.0) or 0.0)
    tau = float(getattr(args, "distillation_tau", 1.0) or 1.0)
    distill = teacher is not None and alpha > 0.0
    augment = AugmentPipeline(args)
    update_freq = int(args.update_freq)
    smoothing = float(args.smoothing)
    use_ema = bool(args.model_ema)
    ema_warmup = bool(getattr(args, "model_ema_warmup", False))
    norm_type = float(getattr(args, "grad_norm_type", 2.0))
    exact_acc = getattr(args, "train_acc_mode", "exact") != "mixed"
    remat = bool(getattr(args, "remat", False))
    # fp32 tables on the device, read at the schedule index (as JAX reads
    # its fp32 schedule arrays inside the step)
    lr_table = torch.tensor(np.asarray(lr_schedule, np.float32), device=device)
    wd_table = torch.tensor(np.asarray(wd_schedule, np.float32), device=device)
    # pixel draws on the device; the few mixup scalars on the host; dropout
    # and stochastic depth (ConvNeXt's drop_path) on the device
    world, rank = get_world_size(), get_rank()
    aug_gen = torch.Generator(device=device).manual_seed(seed)
    mix_gen = torch.Generator().manual_seed(seed + 1)
    # the masks are drawn per rank (the same generator as before at rank 0)
    drop_gen = torch.Generator(device=device).manual_seed(seed + 2 + 1_000_003 * rank)
    # --remat: the recompute's generator, given drop_gen's state before each
    # step, so that it draws the first run's masks again
    redraw_gen = torch.Generator(device=device) if remat else None
    # adahessian: the Rademacher draws of the Hutchinson estimate
    use_hessian = route(args.opt)[0] == "adahessian"
    hess_gen = torch.Generator(device=device).manual_seed(seed + 3) if use_hessian else None

    def sync_redraw() -> None:
        if remat:
            redraw_gen.set_state(drop_gen.get_state())

    def sample_draws(B: int, H: int, W: int) -> Dict:
        """The draws of a step on a local batch of B: those of the global
        batch of B * world."""
        return {"augment": augment.sample(B * world, H, W, aug_gen),
                "mixup": (sample_mixup(mixup_cfg, B * world, H, W, mix_gen) if mixup_cfg
                          else None)}

    def is_boundary(step: int) -> bool:
        """Whether micro-step `step` ends an accumulation window."""
        return (step + 1) % update_freq == 0

    def host_inputs(step: int, B: int, H: int, W: int, mixup_draws=None) -> torch.Tensor:
        """The step's host-side inputs as one float64 CPU vector: the schedule
        index t = step // update_freq, then the mixup draws of the global
        batch (`pack_draws`), drawn here unless given. Gives the recompute's
        generator the dropout generator's state (`--remat`)."""
        sync_redraw()
        parts = [np.asarray([step // update_freq], np.float64)]
        if mixup_cfg is not None:
            if mixup_draws is None:
                mixup_draws = sample_mixup(mixup_cfg, B * world, H, W, mix_gen)
            parts.append(pack_draws(mixup_cfg, mixup_draws))
        return torch.from_numpy(np.concatenate(parts))

    def loss_fn(model: nn.Module, mixed, targets, generator):
        """(loss, fp32 logits) of the training forward."""
        logits = model(mixed, generator=generator).float()
        if targets.dim() == 2:  # soft targets: SoftTargetCrossEntropy
            return -(targets * F.log_softmax(logits, dim=-1)).sum(-1).mean(), logits
        return F.cross_entropy(logits, targets), logits

    def distilled(loss, logits, mixed):
        """(1 - alpha) * loss + alpha * the KD term against the teacher's
        logits on `mixed` (Hinton KD, tau^2-scaled)."""
        with torch.no_grad():
            t = teacher(mixed).float() / tau
        s = logits / tau
        kd = (F.softmax(t, dim=-1) * (F.log_softmax(t, dim=-1) - F.log_softmax(s, dim=-1))
              ).sum(-1).mean() * (tau ** 2)
        return (1.0 - alpha) * loss + alpha * kd

    def rademacher(params) -> list:
        return [torch.where(torch.rand(p.shape, generator=hess_gen, device=p.device) < 0.5,
                            1.0, -1.0).to(p.dtype) for p in params]

    def forward_backward(model: nn.Module, image, label, aug, mix, hessian: bool = False,
                         z=None):
        """(loss, logits, augmented un-mixed images, gradients of the
        parameters in order, and with `hessian` the Hutchinson diagonal on
        the Rademacher `z`, drawn when None; else None) of one forward and
        backward."""
        images = augment(image, aug)
        if mixup_cfg is not None:
            # the global batch's mixup (a partner may lie on another rank),
            # then this rank's rows of it
            mine = rows_of(image.shape[0] * world)
            mixed, targets = mixup_cutmix(all_gather_rows(images), all_gather_rows(label), mix,
                                          mixup_cfg)
            mixed, targets = mixed[mine], targets[mine]
        elif smoothing > 0:
            mixed, targets = images, one_hot_smooth(label, num_classes, smoothing)
        else:
            mixed, targets = images, label
        if remat:
            gens = iter((drop_gen, redraw_gen))  # the first run, then the recompute

            def run(mixed, targets):
                return loss_fn(model, mixed, targets, next(gens))

            # no default generator is drawn from, so none is saved (reading
            # a CUDA generator's state is not allowed while a graph captures)
            loss, logits = checkpoint(run, mixed, targets, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            loss, logits = loss_fn(model, mixed, targets, drop_gen)
        if distill:
            loss = distilled(loss, logits, mixed)
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params, create_graph=hessian)
        diag = None
        if hessian:
            diag = hutchinson_diag(grads, params, rademacher(params) if z is None else list(z))
            grads = tuple(g.detach() for g in grads)
        return loss.detach(), logits.detach(), images, grads, diag

    def local_draws(aug: Dict, B: int) -> Dict:
        """This rank's rows of the global batch's pixel draws."""
        return draw_rows(aug, rows_of(B * world))

    def loss_and_grads(model: nn.Module, batch, draws):
        """`forward_backward` on `batch` with the draws of `sample_draws`
        (this rank's loss and gradients, not averaged over the ranks)."""
        sync_redraw()
        image = batch["image"]
        B = image.shape[0]
        mix = None
        if mixup_cfg is not None:
            flat = to_device(torch.from_numpy(pack_draws(mixup_cfg, draws["mixup"])), device)
            mix = unpack_draws(mixup_cfg, flat, B * world)
        return forward_backward(model, image, batch["label"], local_draws(draws["augment"], B),
                                mix)[:4]

    def device_step(state: TrainState, image: torch.Tensor, label: torch.Tensor,
                    inputs: torch.Tensor, boundary: bool, aug: Optional[Dict] = None,
                    hessian_z: Optional[Sequence[torch.Tensor]] = None):
        """One step on the device from `host_inputs`' vector on the device;
        `aug` the pixel draws of the global batch, drawn from the step's
        generator when None;
        `hessian_z` adahessian's Rademacher draws, one tensor a parameter,
        drawn from the step's generator when None.
        Updates the state's tensors in place (not `state.step`) and returns
        the packed metrics (`TRAIN_SCALARS`, then the counts). Reads nothing
        back to the host, so a CUDA graph can capture it."""
        model, opt = state.model, state.optimizer
        model.train()
        B, H, W = image.shape[:3]
        t = inputs[0].to(torch.int64)
        mix = unpack_draws(mixup_cfg, inputs[1:], B * world) if mixup_cfg is not None else None
        if aug is None:
            aug = augment.sample(B * world, H, W, aug_gen)
        loss, logits, images, grads, diag = forward_backward(
            model, image, label, local_draws(aug, B), mix, hessian=use_hessian and boundary,
            z=hessian_z)
        with torch.no_grad():  # the global batch's loss, gradients and z * Hz
            n = len(grads)
            parts = mean_across([*grads, *(diag or ()), loss])
            grads, diag, loss = parts[:n], parts[n:-1] or None, parts[-1]
        finite = torch.isfinite(loss)
        commit_batch_stats(model, finite)

        with torch.no_grad():
            if update_freq > 1:
                # a non-finite micro-gradient never enters the accumulator
                torch._foreach_add_(state.grad_accum, [
                    torch.where(finite, g * (1.0 / update_freq), torch.zeros_like(g))
                    for g in grads])
                accum = state.grad_accum
            else:
                accum = list(grads)
            it = t.clamp(max=lr_table.numel() - 1)
            lr, wd = torch.take(lr_table, it), torch.take(wd_table, it)
            opt.set_hyperparams(lr, wd)
            grad_norm = torch.where(finite, global_norm(accum, norm_type), 0.0)
            if boundary:
                opt.step(accum, keep=finite, hessian=diag)
                for p, held in pruned:
                    p.masked_fill_(held, 0.0)
                if use_ema:
                    d = warmup_decay(ema_decay, t) if ema_warmup else ema_decay
                    ema_update(state.ema, model, d, finite)
                    if state.ema_stats is not None:
                        ema_update(state.ema_stats, model, d, finite)
                if update_freq > 1:
                    # every window ends at its boundary, applied or discarded
                    torch._foreach_zero_(state.grad_accum)

            if mixup_cfg is not None and exact_acc:
                acc_logits = model(images, generator=drop_gen).float()
                clear_batch_stats(model)
            else:
                acc_logits = logits
            preds = acc_logits.argmax(-1)
            tp, fp, fn = _per_class_counts(preds, label, num_classes,
                                           torch.ones_like(preds, dtype=torch.float32))
            # the global batch's
            class_acc, = mean_across([(preds == label).float().mean()])
            tp, fp, fn = sum_across([tp, fp, fn])
            lo, hi = opt.scale_bounds
            return _pack((loss, class_acc, grad_norm, lr * hi, lr * lo, wd, ~finite), tp, fp, fn)

    def train_step(state: TrainState, batch, draws: Optional[Dict] = None) -> StepMetrics:
        image = batch["image"]
        inputs = host_inputs(state.step, *image.shape[:3],
                             mixup_draws=draws["mixup"] if draws else None)
        flat = device_step(state, image, batch["label"], to_device(inputs, device),
                           is_boundary(state.step), draws["augment"] if draws else None,
                           draws.get("hessian_z") if draws else None)
        state.step += 1
        return StepMetrics(flat, TRAIN_SCALARS, num_classes)

    train_step.sample_draws = sample_draws
    train_step.loss_and_grads = loss_and_grads
    train_step.host_inputs = host_inputs
    train_step.device_step = device_step
    train_step.is_boundary = is_boundary
    train_step.generators = ((aug_gen, drop_gen) + ((redraw_gen,) if remat else ())
                             + ((hess_gen,) if use_hessian else ()))
    train_step.num_classes = num_classes
    return train_step


def build_eval_step(model: nn.Module, num_classes: int) -> Callable:
    """Returns eval_step(batch) -> StepMetrics of metric sums, where batch
    holds "image" (uint8 NHWC) and "label" (int64, -1 for the padded tail)
    on the model's device. Plain cross-entropy; the padded tail is masked
    out of every statistic. Puts the model in eval mode. Its device part,
    `eval_step.device_step(image, label)` -> the packed sums
    (`EVAL_SCALARS`, then the counts), is what `engine/compiled.py`
    captures."""

    @torch.inference_mode()
    def device_step(image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        model.eval()
        logits = model(eval_preprocess(image)).float()
        valid = label >= 0
        safe_labels = label.clamp(min=0)
        losses = F.cross_entropy(logits, safe_labels, reduction="none")
        w = valid.float()
        preds = logits.argmax(-1)
        top1 = ((preds == safe_labels) & valid).float()
        k = min(5, logits.shape[-1])
        topk = logits.topk(k, dim=-1).indices
        top5 = ((topk == safe_labels[:, None]).any(-1) & valid).float()
        tp, fp, fn = _per_class_counts(preds, safe_labels, num_classes, w)
        return _pack(((losses * w).sum(), w.sum(), top1.sum(), top5.sum()), tp, fp, fn)

    def eval_step(batch: Dict[str, torch.Tensor]) -> StepMetrics:
        return StepMetrics(device_step(batch["image"], batch["label"]), EVAL_SCALARS,
                           num_classes)

    eval_step.device_step = device_step
    eval_step.num_classes = num_classes
    return eval_step
