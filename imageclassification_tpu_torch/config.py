"""Config and flags (own copy of imageclassification_tpu/config.py).

The same dataclass fields, defaults and argparse flags as the JAX package, so
a command line for the JAX `train.py` parses here unchanged, except that
`--device` takes `cuda|cpu` and defaults to `cuda`. The one flag of a
feature not ported yet (--fsdp) is parsed as in JAX, and `check_ported`
raises NotImplementedError naming its ROADMAP item when it is set; none is
silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .device import DEVICES


def str2bool(v) -> bool:
    """Boolean flag coercion."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


@dataclass
class TrainConfig:
    # batching
    batch_size: int = 64          # per-process batch size
    epochs: int = 100
    update_freq: int = 1          # gradient accumulation steps

    # model
    pretrained: bool = True
    model: str = "efficientvit_m0"
    drop_path: float = 0.05
    input_size: int = 224

    # EMA; with model_ema_warmup the decay at real update t is
    # min(decay, (1+t)/(10+t))
    model_ema: bool = False
    model_ema_decay: float = 0.9995
    model_ema_warmup: bool = False

    # optimization
    opt: str = "adamw"
    opt_eps: float = 1e-8
    opt_betas: Optional[List[float]] = None
    clip_grad: Optional[float] = None
    weight_decay: float = 5e-4
    weight_decay_end: float = 5e-6
    lr: float = 1e-3
    min_lr: float = 1e-6
    warmup_epochs: int = 5
    warmup_steps: int = -1

    # augmentation
    RASampler: bool = False
    color_jitter: float = 0.3
    aa: str = ""
    smoothing: float = 0.1

    # random erasing
    reprob: float = 0.25
    remode: str = "pixel"
    recount: int = 1
    resplit: bool = False

    # mixup/cutmix
    mixup: float = 0.8
    cutmix: float = 0.0
    cutmix_minmax: Optional[List[float]] = None
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    mixup_mode: str = "batch"     # 'batch', 'pair', or 'elem'

    # dataset / run control
    data_path: str = "../../datas/CatsDogs_mini"
    train_split_rato: float = 0.9  # 0 => manual train/ + val/ dirs (the JAX flag's spelling)
    device: str = "cuda"           # cuda | cpu
    seed: int = 88
    resume: str = ""
    auto_resume: bool = True
    save_ckpt: bool = True
    save_ckpt_freq: int = 1
    save_ckpt_num: int = 999
    start_epoch: int = 0
    eval: bool = False
    num_workers: int = 32
    use_amp: bool = False          # bfloat16 compute, like half_precision

    # distributed
    world_size: int = 1
    local_rank: int = -1
    dist_on_itp: bool = False
    dist_url: str = "env://"

    # W&B
    enable_wandb: bool = False
    project: str = "classification"
    wandb_ckpt: bool = False

    # extras of the JAX package
    output_dir: str = "train_cls/output"
    log_dir: str = "train_cls/log_dir"
    mesh_shape: str = ""
    fsdp: bool = False
    layer_decay: float = 1.0
    lr_scheduler: str = "cosine"  # cosine | linear | piecewise
    check_nans: bool = False
    profile_dir: str = ""
    pretrained_path: str = ""
    half_precision: bool = True   # bf16 activations/compute (params stay fp32)
    remat: bool = False
    flash_attn: bool = False      # ViT attention through the flash-attention kernels
    swin_attn_layout: str = "merged"
    # 'exact': train accuracy from a second no-grad forward on the un-mixed
    # batch with the post-update weights; 'mixed': from the mixed-batch logits
    train_acc_mode: str = "exact"
    grad_norm_type: float = 2.0   # 2.0 or inf: the reported grad_norm only
    teacher_path: str = ""
    distillation_alpha: float = 0.0
    distillation_tau: float = 1.0
    prune_mask: bool = False

    # runtime state set at startup
    rank: int = 0
    distributed: bool = False

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


_RUNTIME_FIELDS = {"rank", "distributed"}

# the names of the JAX optimizer table, every one ported (the `fused*` names
# are aliases; any of them takes the "lookahead_" prefix)
PORTED_OPTIMIZERS = ("adamw", "sgd", "nesterov", "momentum", "adam", "nadam", "radam", "lion",
                     "lamb", "rmsprop", "rmsproptf", "adadelta", "adamp", "sgdp", "nvnovograd",
                     "adafactor", "adahessian", "fusedadamw", "fusedsgd", "fusedmomentum",
                     "fusedadam", "fusedlamb", "fusednovograd")


def get_args_parser() -> argparse.ArgumentParser:
    """An argparse parser built from the dataclass (the JAX flag names)."""
    parser = argparse.ArgumentParser(
        "Training and evaluation script for image classification (PyTorch/CUDA port)",
        add_help=False,
    )
    for f in dataclasses.fields(TrainConfig):
        if f.name in _RUNTIME_FIELDS:
            continue
        name = "--" + f.name
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.name == "device":
            parser.add_argument(name, type=str, default=default, choices=list(DEVICES))
        elif f.type in ("bool", bool):
            parser.add_argument(name, type=str2bool, default=default)
        elif f.name in ("opt_betas", "cutmix_minmax"):
            parser.add_argument(name, type=float, nargs="+", default=default)
        elif f.name == "clip_grad":
            parser.add_argument(name, type=float, default=default)
        elif f.type in ("int", int):
            parser.add_argument(name, type=int, default=default)
        elif f.type in ("float", float):
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)
    return parser


def parse_args(argv=None) -> TrainConfig:
    parser = argparse.ArgumentParser(
        "Classification training and evaluation script", parents=[get_args_parser()]
    )
    return TrainConfig(**vars(parser.parse_args(argv)))


def check_ported(args: TrainConfig) -> None:
    """Raise NotImplementedError for a flag whose feature is not ported yet,
    naming its ROADMAP item (--fsdp, the JAX parameter sharding: A9b).
    Raise ValueError for adahessian on a ViT with --flash_attn, a pair the
    JAX package cannot run either. A launch of several processes (torchrun,
    SLURM, OMPI with --dist_on_itp) and a --mesh_shape over them are ported
    (`parallel/`); a --mesh_shape whose size is not the world raises
    ValueError in `train.main`, as JAX's make_mesh does."""
    if args.fsdp:
        raise NotImplementedError(
            "--fsdp true is not ported to imageclassification_tpu_torch yet "
            "(ROADMAP A9b (--fsdp))")
    if (args.opt.lower().split("_")[-1] == "adahessian" and args.flash_attn
            and args.model.startswith("vit")):
        raise ValueError(
            f"--opt {args.opt} with --flash_attn true: adahessian differentiates the loss "
            "twice (its Hessian-vector product), and the flash attention has no second "
            "derivative; the JAX package cannot differentiate its flash attention twice "
            "either (jax.jvp of the gradient through its custom_vjp). Use --flash_attn false.")
