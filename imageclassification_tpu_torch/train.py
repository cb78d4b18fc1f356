"""Training / evaluation CLI (port of the root train.py):

    python -m imageclassification_tpu_torch.train --data_path <ImageFolder> \\
        --model vit_base_patch16 [--flash_attn true] [--device cuda|cpu] ...
    python -m imageclassification_tpu_torch.train --data_path <ImageFolder> \\
        --model convnext_tiny [--drop_path 0.1] [--device cuda|cpu] ...
    python -m imageclassification_tpu_torch.train --data_path <ImageFolder> \\
        --model resnet50 [--device cuda|cpu] ...
    python -m imageclassification_tpu_torch.train --data_path <ImageFolder> \\
        --model vit_base_patch16_224 --flash_attn true --input_size 384 \\
        --pretrained_path <timm state_dict or checkpoint> ...
    python -m imageclassification_tpu_torch.train --data_path <ImageFolder> \\
        --model vit_base_patch16_224 --flash_attn true --input_size 1024 \\
        --pretrained_path <state_dict> --layer_decay 0.65 --remat true ...
    python -m imageclassification_tpu_torch.train --data_path <ImageFolder> \\
        --model vit_base_patch16 --flash_attn true --aa rand-m9-mstd0.5-inc1 \\
        --teacher_path <checkpoint> --distillation_alpha 0.5 --distillation_tau 2.0 ...
    python -m imageclassification_tpu_torch.train --data_path <ImageFolder> \\
        --pretrained_path <pruned checkpoint> --prune_mask true ...
    python -m imageclassification_tpu_torch.train --data_path <ImageFolder> \\
        --model swin_tiny --pretrained_path <timm state_dict> --opt adafactor ...
    python -m imageclassification_tpu_torch.train --data_path <ImageFolder> \\
        --model convnext_tiny --opt adahessian ...
    python -m imageclassification_tpu_torch.train --data_path <ImageFolder>  # efficientvit_m0

The JAX train.py's flags, artifacts and epoch flow: `class_indices.json`
and `checkpoint-{N,best,best-ema}.pth` under --output_dir (JAX layout, so
either package resumes them and either val.py reads them), JSON lines in
log.txt beside it, TensorBoard scalars under --log_dir (and W&B with
--enable_wandb), auto-resume, --eval, --pretrained_path with a checkpoint
or a torch/timm state_dict (a ViT's pos_embed resampled to --input_size), a
torch.profiler trace with --profile_dir, and a checkpoint on SIGTERM/SIGUSR1
before a clean exit. On a card the train and eval steps run
as CUDA graphs (`engine/compiled.py`, the counterpart of the JAX step's
`jax.jit`); on the CPU, and with --check_nans (eager, with NaN checks, as
JAX's jax_debug_nans), they run eagerly. One process a device: a torchrun,
SLURM or OMPI (--dist_on_itp) launch trains data-parallel over
torch.distributed (`parallel/`), the step being the function of the global
batch, as JAX's; its steps run eagerly there (`engine/compiled.py`), and
rank 0 writes the checkpoints, log.txt, TensorBoard and W&B:

    torchrun --nproc_per_node 8 -m imageclassification_tpu_torch.train \\
        --data_path <ImageFolder> --model vit_base_patch16 --flash_attn true ...

Every model of the JAX registry (ViT, ConvNeXt and V2, ResNet, ResNeXt and wide
ResNet, EfficientViT, MobileNetV3, EfficientNet, Swin, DenseNet),
--layer_decay, --remat, the whole optimizer table (adahessian with the
Hutchinson diagonal from a second backward; not with --flash_attn on a
ViT, as in JAX), the --aa policies (RandAugment, AutoAugment, AbelAugment), distillation
(--teacher_path with --distillation_alpha > 0) and --prune_mask run, and the
flags of features not ported yet raise (config.check_ported).
"""

from __future__ import annotations

import datetime
import json
import os
import signal
import time
from pathlib import Path

import numpy as np
import torch

from .checkpoint import io as ckpt_io
from .checkpoint.to_jax import carry_for, jax_leaves
from .checkpoint.torch_convert import load_pretrained_flat, resample_pos_embed
from .config import TrainConfig, check_ported, parse_args
from .data.folder import build_dataset
from .data.loader import BatchLoader
from .data.mixup import build_mixup
from .data.sampler import epoch_batch_indices, eval_batches, ra_epoch_batch_indices
from .device import resolve_device
from .engine.compiled import CapturedTrainStep, captured_eval_step, nan_checked
from .engine.loop import evaluate, train_one_epoch
from .engine.state import create_train_state, num_params
from .engine.step import build_eval_step, build_train_step
from .models import create_model, model_kwargs_for
from .models.layers import batch_norm_stats
from .optim.ema import init_ema, init_ema_stats
from .optim.factory import LEAFWISE, create_optimizer, route
from .optim.layer_decay import layer_decay_scales
from .optim.schedules import build_schedules
from .parallel.dist import any_process, init_distributed_mode, is_main_process
from .parallel.mesh import check_mesh
from .utils.loggers import TensorboardLogger, WandbLogger
from .val import initialize_model as initialize_teacher


class _EmaWeights:
    """Context manager: the model runs with the EMA weights (parameters, and
    BatchNorm statistics where it has them) inside; its own are restored on
    exit."""

    def __init__(self, model, ema, ema_stats=None):
        self.model = model
        self.ema = None if ema is None else {**ema, **(ema_stats or {})}

    def __enter__(self):
        if self.ema is not None:
            self.saved = {k: v.detach().clone()
                          for k, v in self.model.state_dict().items() if k in self.ema}
            self._copy(self.ema)
        return self.model

    def __exit__(self, *exc):
        if self.ema is not None:
            self._copy(self.saved)

    def _copy(self, src):
        tensors = self.model.state_dict(keep_vars=True)
        with torch.no_grad():
            for k, v in src.items():
                tensors[k].copy_(v)


def _load_pretrained(args, state) -> None:
    """--pretrained_path: the weights of a checkpoint of this project or of
    a torch/timm state_dict (converted on the fly, `torch_convert`), with a
    ViT's pos_embed grid resampled to this --input_size, pruned by name and
    shape; the BatchNorm statistics where both have them; the EMA restarts
    from the loaded weights (timm's ModelEmaV3 copies the model after the
    pretrained load)."""
    ck = load_pretrained_flat(args.pretrained_path, args.model)
    src = ck["model"]
    own = getattr(state.model, "pos_embed", None)
    if own is not None:
        src = resample_pos_embed(src, {"pos_embed": own.detach().cpu().numpy()})
    ckpt_io.load_params_with_pruning(state.model, src)
    if ck.get("batch_stats") and batch_norm_stats(state.model):
        ckpt_io.load_params_with_pruning(state.model, ck["batch_stats"], verbose=False)
    if state.ema is not None:
        state.ema = init_ema(state.model)
        state.ema_stats = init_ema_stats(state.model)
    print(f"Loaded pretrained weights from {args.pretrained_path}")


def optimizer_layout(args: TrainConfig, model) -> dict:
    """The per-parameter arguments of `create_optimizer` for `model`: the
    layer scales under --layer_decay < 1 (`layer_decay_scales`, as the JAX
    train.py builds them), and for the optimizers that take each JAX tensor
    apart (`factory.LEAFWISE`: the norms of lamb, adamp, sgdp and
    nvnovograd, adafactor's factoring, adahessian's spatial means) each
    parameter's JAX tensors."""
    kw = {}
    if args.layer_decay and args.layer_decay < 1.0:
        kw["layer_scales"] = layer_decay_scales(
            [k for k, _ in model.named_parameters()], args.model, args.layer_decay)
    if route(args.opt)[0] in LEAFWISE:
        kw["leaves"] = jax_leaves(model, carry_for(model))
    return kw


def main(args: TrainConfig):
    check_ported(args)
    device = resolve_device(args.device)
    # the process group before anything touches the device
    init_distributed_mode(args)
    world, rank = args.world_size, args.rank
    check_mesh(args.mesh_shape, world)
    print(args)
    seed = args.seed

    dataset_train, dataset_val, num_classes = build_dataset(args)
    log_writer, wandb_logger = None, None
    if rank == 0:
        os.makedirs(args.log_dir, exist_ok=True)
        log_writer = TensorboardLogger(log_dir=args.log_dir)
        wandb_logger = WandbLogger(args) if args.enable_wandb else None

    total_batch_size = args.batch_size * args.update_freq * world
    num_training_steps_per_epoch = len(dataset_train) // total_batch_size
    if num_training_steps_per_epoch == 0:
        raise ValueError(
            f"dataset ({len(dataset_train)}) smaller than one global batch "
            f"({total_batch_size}); lower --batch_size"
        )
    input_shape = [1, args.input_size, args.input_size, 3]  # NHWC

    mixup_cfg = build_mixup(args, num_classes)
    if mixup_cfg is not None:
        print("Mixup is activated!")

    model_kwargs = model_kwargs_for(args, num_classes)
    model = create_model(
        args.model, half_precision=(args.use_amp or args.half_precision),
        generator=torch.Generator().manual_seed(seed),
        **{"img_size": args.input_size, **model_kwargs},  # EfficientViT's kwargs hold it
    ).to(device)
    model_spec = {"name": args.model,
                  "kwargs": {k: v for k, v in model_kwargs.items() if k != "pretrained"}}

    print("LR = %.8f" % args.lr)
    print("Batch size = %d" % total_batch_size)
    print("Update frequent = %d" % args.update_freq)
    print("Number of training examples = %d" % len(dataset_train))
    print("Number of training steps per epoch = %d" % num_training_steps_per_epoch)

    optimizer = create_optimizer(args.opt, model.parameters(), lr=args.lr,
                                 weight_decay=args.weight_decay, opt_eps=args.opt_eps,
                                 opt_betas=args.opt_betas, clip_grad=args.clip_grad,
                                 **optimizer_layout(args, model))
    state = create_train_state(model, optimizer, use_ema=args.model_ema,
                               update_freq=args.update_freq)
    print("number of params:", num_params(state))

    print("Use Cosine LR scheduler")
    lr_schedule_values, wd_schedule_values = build_schedules(args, num_training_steps_per_epoch)
    print("Max WD = %.7f, Min WD = %.7f" % (max(wd_schedule_values), min(wd_schedule_values)))

    if args.pretrained and args.pretrained_path:
        _load_pretrained(args, state)
    elif (args.pretrained and not args.resume
          and not (args.auto_resume and ckpt_io.find_latest_checkpoint(args.output_dir))):
        print(
            "WARNING: --pretrained true but no local weights available "
            "(no network egress) — TRAINING FROM SCRATCH. "
            "Pass --pretrained_path (a checkpoint or a torch/timm state_dict) "
            "to fine-tune from pretrained weights.",
            flush=True,
        )

    state, _ = ckpt_io.auto_load_model(args, state)

    prune_masks = None
    if args.prune_mask:
        # sparse fine-tuning: the loaded weights' zero pattern (after the
        # pretrained load and the resume) is held through training
        prune_masks, mask_sparsity = ckpt_io.derive_prune_masks(model)
        print(f"Prune-mask fine-tune: enforcing {mask_sparsity:.3f} sparsity "
              "zero pattern through training")

    teacher = None
    if args.teacher_path and args.distillation_alpha > 0:
        # the teacher rebuilt from its checkpoint's own model_spec, as val.py
        # does; int8 kernels restored to float (the step runs it plainly)
        teacher, t_nc = initialize_teacher(
            args.teacher_path, model_ema=False,
            half_precision=(args.use_amp or args.half_precision), dequantize=True,
            device=args.device)
        if t_nc != num_classes:
            raise ValueError(f"teacher has {t_nc} classes, dataset has {num_classes}")
        print(f"Distillation: teacher={args.teacher_path} "
              f"alpha={args.distillation_alpha} tau={args.distillation_tau}")

    train_step = build_train_step(model, args, num_classes, mixup_cfg, lr_schedule_values,
                                  wd_schedule_values, ema_decay=args.model_ema_decay,
                                  seed=seed, teacher=teacher, prune_masks=prune_masks)
    eval_step = build_eval_step(model, num_classes)
    if args.check_nans:
        train_step = nan_checked(train_step, model)
    elif device.type == "cuda" and world == 1:
        # several ranks run eagerly, the collectives inline
        train_step = CapturedTrainStep(train_step, device)
        eval_step = captured_eval_step(eval_step, device)
    eval_bs = int(1.5 * args.batch_size)
    eval_bs = max(world, (eval_bs // world) * world)

    def make_val_loader():
        # the val set sharded over the ranks: each sample counted once
        idx = np.stack(eval_batches(len(dataset_val), eval_bs, rank=rank, world=world))
        return BatchLoader(dataset_val, idx, args.input_size, train=False, device=device,
                           seed=seed, num_workers=args.num_workers)

    if args.eval:
        print("Eval only mode")
        with _EmaWeights(model, state.ema if args.model_ema else None, state.ema_stats):
            test_stats = evaluate(eval_step, make_val_loader(), num_classes)
        print(f"Accuracy of the network on {len(dataset_val)} test images: "
              f"{test_stats['acc1']:.5f}%")
        return

    # SLURM's grace signal: checkpoint and stop after this epoch
    preempted = {"flag": False}

    def _on_preempt(signum, frame):
        print(f"Received signal {signum}: checkpoint + stop after this epoch")
        preempted["flag"] = True

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        try:
            previous[sig] = signal.signal(sig, _on_preempt)
        except ValueError:
            pass  # not the main thread
    try:
        return _train(args, state, train_step, eval_step, make_val_loader, log_writer,
                      wandb_logger, dataset_train, dataset_val, num_classes,
                      num_training_steps_per_epoch, input_shape, model_spec, preempted)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def _start_profiler(profile_dir: str, device: torch.device):
    """A torch.profiler trace of the host and (on a card) the device, written
    as a TensorBoard trace file into `profile_dir` when it stops."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    return prof


def _train(args, state, train_step, eval_step, make_val_loader, log_writer, wandb_logger,
           dataset_train, dataset_val, num_classes, num_training_steps_per_epoch, input_shape,
           model_spec, preempted):
    """The epoch loop of `main`."""
    model, device, seed = state.model, next(state.model.parameters()).device, args.seed
    world, rank = args.world_size, args.rank
    max_accuracy = 0.0
    max_accuracy_ema = 0.0
    profiler = None
    if args.profile_dir and rank == 0:
        try:
            profiler = _start_profiler(args.profile_dir, device)
        except RuntimeError as e:  # a build or host that cannot trace
            print(f"profiler unavailable: {e}")
    print("Start training for %d epochs" % args.epochs)
    start_time = time.time()
    for epoch in range(args.start_epoch, args.epochs):
        sampler = ra_epoch_batch_indices if args.RASampler else epoch_batch_indices
        idx = sampler(len(dataset_train), args.batch_size * world, epoch, seed, rank=rank,
                      world=world)
        idx = idx[: num_training_steps_per_epoch * args.update_freq]  # drop_last
        train_loader = BatchLoader(dataset_train, idx, args.input_size, train=True,
                                   device=device, seed=seed + epoch,
                                   num_workers=args.num_workers)
        if log_writer is not None:
            log_writer.set_step(epoch * num_training_steps_per_epoch * args.update_freq)
        if wandb_logger:
            wandb_logger.set_steps()
        state, train_stats = train_one_epoch(
            train_step, state, train_loader, num_classes, num_training_steps_per_epoch,
            update_freq=args.update_freq, log_writer=log_writer, wandb_logger=wandb_logger,
            start_steps=epoch * num_training_steps_per_epoch,
        )

        saved_this_epoch = False
        if args.save_ckpt and ((epoch + 1) % args.save_ckpt_freq == 0
                               or epoch + 1 == args.epochs):
            ckpt_io.save_model(args, input_shape, epoch, state, num_classes, model_spec)
            saved_this_epoch = True

        test_stats = evaluate(eval_step, make_val_loader(), num_classes)
        print(f"Accuracy of the model on the {len(dataset_val)} test images: "
              f"{test_stats['acc1']:.3f}%")
        if max_accuracy < test_stats["acc1"]:
            max_accuracy = test_stats["acc1"]
            if args.save_ckpt:
                ckpt_io.save_model(args, input_shape, "best", state, num_classes, model_spec)
        print(f"Max accuracy: {max_accuracy:.3f}%")
        if log_writer is not None:
            log_writer.update(test_acc1=test_stats["acc1"], head="perf", step=epoch)
            log_writer.update(test_loss=test_stats["loss"], head="perf", step=epoch)

        log_stats = {
            "current_time": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            **{f"train_{k}": v for k, v in train_stats.items()},
            **{f"test_{k}": v for k, v in test_stats.items()},
            "epoch": epoch,
            "n_parameters": f"{num_params(state) / 1e6:.2f}M",
        }
        if args.model_ema:
            with _EmaWeights(model, state.ema, state.ema_stats):
                test_stats_ema = evaluate(eval_step, make_val_loader(), num_classes)
            print(f"Accuracy of the model EMA on {len(dataset_val)} test images: "
                  f"{test_stats_ema['acc1']:.1f}%")
            if max_accuracy_ema < test_stats_ema["acc1"]:
                max_accuracy_ema = test_stats_ema["acc1"]
                if args.save_ckpt:
                    ckpt_io.save_model(args, input_shape, "best-ema", state, num_classes,
                                       model_spec)
                print(f"Max EMA accuracy: {max_accuracy_ema:.2f}%")
            if log_writer is not None:
                log_writer.update(test_acc1_ema=test_stats_ema["acc1"], head="perf", step=epoch)
            log_stats.update({f"test_{k}_ema": v for k, v in test_stats_ema.items()})

        if is_main_process():
            log_writer.flush()
            with open(Path(args.output_dir).parent / "log.txt", mode="a",
                      encoding="utf-8") as f:
                f.write(json.dumps(log_stats) + "\n")
        if wandb_logger:
            wandb_logger.log_epoch_metrics(log_stats)

        # the signal reaches the ranks with skew, and the save below ends the
        # loop: every rank takes the decision of all of them
        if any_process(preempted["flag"]):
            if args.save_ckpt and not saved_this_epoch:
                ckpt_io.save_model(args, input_shape, epoch, state, num_classes, model_spec)
            print(f"Preemption checkpoint at epoch {epoch}; exiting cleanly for requeue "
                  f"(auto_resume continues at epoch {epoch + 1})")
            break

    if profiler is not None:
        profiler.stop()
        print(f"profiler trace written to {args.profile_dir}")
    if wandb_logger and args.wandb_ckpt and args.save_ckpt:
        wandb_logger.log_checkpoints()
    total_time = time.time() - start_time
    print("Training time {}".format(str(datetime.timedelta(seconds=int(total_time)))))
    return state


if __name__ == "__main__":
    cli_args = parse_args()
    Path(cli_args.output_dir).mkdir(parents=True, exist_ok=True)
    main(cli_args)
