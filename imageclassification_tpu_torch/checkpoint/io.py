"""Checkpoints in the JAX package's format (port of
imageclassification_tpu/checkpoint/io.py).

A checkpoint is a pickle of a plain dict: flat numpy parameter dicts under
"model" (and "model_ema", "optimizer", ...), plus "model_spec"
({"name", "kwargs"}), "input_shape" (NHWC), "num_classes" and, for
checkpoints written by modelchange.py's quantizer, "quant_scales" and
"quant_dtype". The port reads that format as it is and writes it: the
parameters, the EMA and the optimizer state in the JAX layout
(checkpoint/to_jax.py), so a checkpoint of either package resumes in the
other and either val.py reads it. A BatchNorm model's running statistics go
under "batch_stats" and, with an EMA, their EMA under
"model_ema_batch_stats"; a resume reads them pruned by name and shape
without a print, and re-seeds the EMA statistics from the model's when the
EMA restarts.

Kept from the JAX package: `checkpoint-{N,best,best-ema}.pth` under
output_dir with rolling deletion of epochs older than
save_ckpt_num * save_ckpt_freq; auto-resume from the newest numbered epoch;
name+shape pruning that prints `Skipping mismatched key:`; optimizer, step
and start epoch restored only when every parameter key matched. The JAX
package writes in a background thread; the port writes before it returns.

At a world of several processes rank 0 writes (every rank holds the same
state); the resume decision is rank 0's, broadcast, and a path missing on a
rank raises FileNotFoundError; the copies every rank loads are held to one
another by an all-gathered fingerprint (the finite sum and the count of
non-finite values), a difference raising RuntimeError.
"""

from __future__ import annotations

import glob
import os
import pickle
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..models.layers import batch_norm_stats
from ..parallel.dist import all_reduce_host, broadcast_host, get_rank, get_world_size
from ..optim.ema import init_ema, init_ema_stats
from .to_jax import carry_for, optimizer_from_jax, optimizer_to_jax

FORMAT_VERSION = 1


def load_checkpoint(path: str, dequantize: bool = True) -> Dict[str, Any]:
    """Load a checkpoint dict. `dequantize=True` restores fp32 weights from
    int8 storage; `dequantize=False` keeps the int8 kernels and their
    metadata. Unpickling runs code: load only checkpoints this project wrote."""
    with open(path, "rb") as f:
        ck = pickle.load(f)
    return _dequantize_weights(ck) if dequantize else ck


def _dequantize_weights(ck: Dict[str, Any]) -> Dict[str, Any]:
    """Restore fp32 kernels from a weight-only int8 checkpoint (per-output-
    channel absmax scales under 'quant_scales'), and drop the quantization
    metadata so a re-pickled checkpoint cannot apply the scales twice."""
    scales = ck.get("quant_scales")
    if not scales or not isinstance(ck.get("model"), dict):
        return ck
    model = dict(ck["model"])
    for k, s in scales.items():
        if k not in model:
            continue
        arr = np.asarray(model[k], np.float32)
        model[k] = (arr.reshape(-1, arr.shape[-1]) * np.asarray(s)).reshape(
            arr.shape
        ).astype(np.float32)
    ck["model"] = model
    print(f"Dequantized {len(scales)} {ck.get('quant_dtype', 'int8')} kernels")
    ck.pop("quant_scales", None)
    ck.pop("quant_dtype", None)
    return ck


def matching_state_dict(model: nn.Module, ckpt_flat: Dict[str, np.ndarray]
                        ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(the entries of the carried state_dict that match a model parameter by
    name AND shape, the checkpoint keys that do not)."""
    sd, sources, unused = carry_for(model).to_port(ckpt_flat)
    current = model.state_dict()
    kept = {}
    dropped = list(unused)
    for k, v in sd.items():
        if k in current and tuple(v.shape) == tuple(current[k].shape):
            kept[k] = v
        else:
            dropped.extend(sources[k])
    return kept, dropped


def load_params_with_pruning(model: nn.Module, ckpt_flat: Dict[str, np.ndarray],
                             verbose: bool = True) -> int:
    """Load the checkpoint's flat JAX parameters into `model`, keeping only
    those that match a model parameter by name AND shape. Prints
    `Skipping mismatched key: <k>` (the checkpoint's key) per drop and
    returns the number dropped. Parameters with no match keep their values."""
    kept, dropped = matching_state_dict(model, ckpt_flat)
    if verbose:
        for k in dropped:
            print(f"Skipping mismatched key: {k}")
    model.load_state_dict(kept, strict=False)
    return len(dropped)


def _copy_matching(ema: Dict[str, torch.Tensor], model: nn.Module,
                   ckpt_flat: Dict[str, np.ndarray]) -> None:
    """Copy the checkpoint's entries that match a tensor of `model` by name
    and shape into the EMA dict `ema`."""
    kept, _ = matching_state_dict(model, ckpt_flat)
    with torch.no_grad():
        for k, v in kept.items():
            if k in ema:
                ema[k].copy_(v)


def write_checkpoint(path: str, ck: Dict[str, Any]) -> None:
    """Pickle the checkpoint dict `ck` to `path` through a temporary file,
    so a reader never sees half a file."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(ck, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def derive_prune_masks(model: nn.Module) -> Tuple[Dict[str, torch.Tensor], float]:
    """The zero pattern of the model's pruned weights for --prune_mask
    (the port's copy of the JAX `derive_prune_masks`): a JAX tensor is
    eligible as JAX decides it, by its JAX name (from the weight carry, so
    ViT's fused qkv is judged as JAX's query, key and value): the name ends
    with 'kernel' and not 'head/kernel', ndim >= 2, more than 4096 elements.
    Returns ({parameter name: bool mask on its device, False where the
    entry is 0} for each parameter holding an eligible JAX tensor, the
    sparsity over the eligible tensors)."""
    carry = carry_for(model)
    params = dict(model.named_parameters())
    keep, eligible, total, kept = {}, set(), 0, 0
    for key, arr in carry.to_jax(params).items():
        if (key.endswith("kernel") and arr.ndim >= 2 and arr.size > 4096
                and not key.endswith("head/kernel")):
            m = arr != 0
            eligible.add(key)
            total += m.size
            kept += int(m.sum())
            keep[key] = m.astype(np.float32)
        else:
            keep[key] = np.ones(arr.shape, np.float32)
    sd, sources, _ = carry.to_port(keep)
    masks = {k: torch.as_tensor(v).to(params[k].device) > 0.5 for k, v in sd.items()
             if any(src in eligible for src in sources[k])}
    return masks, 0.0 if total == 0 else 1.0 - kept / total


def save_model(args, input_shape, epoch, state, num_classes: int,
               model_spec: Dict[str, Any]) -> str:
    """Write output_dir/checkpoint-{epoch}.pth in the JAX layout (rank 0
    only); `epoch` is an int or "best"/"best-ema". Returns the path."""
    model = state.model
    carry = carry_for(model)
    output_dir = Path(args.output_dir)
    path = output_dir / f"checkpoint-{epoch}.pth"
    if get_rank() != 0:
        return str(path)
    output_dir.mkdir(parents=True, exist_ok=True)
    ck = {
        "format_version": FORMAT_VERSION,
        "model_spec": model_spec,
        "step": int(state.step),
        "epoch": epoch,
        "input_shape": list(input_shape),
        "num_classes": num_classes,
        "args": args.to_dict() if hasattr(args, "to_dict") else vars(args),
        "model": carry.to_jax(dict(model.named_parameters())),
        "batch_stats": carry.to_jax(batch_norm_stats(model)),
        "optimizer": optimizer_to_jax(state.optimizer, model, carry),
    }
    if state.ema is not None:
        ck["model_ema"] = carry.to_jax(state.ema)
        if state.ema_stats is not None:
            ck["model_ema_batch_stats"] = carry.to_jax(state.ema_stats)
    write_checkpoint(str(path), ck)
    if isinstance(epoch, int):
        old = output_dir / f"checkpoint-{epoch - args.save_ckpt_num * args.save_ckpt_freq}.pth"
        if old.exists():
            os.remove(old)
    return str(path)


def find_latest_checkpoint(output_dir: str):
    """The checkpoint of the largest numbered epoch in output_dir, or None."""
    latest = -1
    for ckpt in glob.glob(os.path.join(output_dir, "checkpoint-*.pth")):
        t = ckpt.split("-")[-1].split(".")[0]
        if t.isdigit():
            latest = max(int(t), latest)
    if latest >= 0:
        return os.path.join(output_dir, f"checkpoint-{latest}.pth")
    return None


def sync_resume_across_processes(args) -> None:
    """Rank 0's resume decision (args.resume) on every rank: a rank that
    decided otherwise adopts it, and one that cannot see the file raises
    FileNotFoundError (a resume needs the checkpoint on a shared filesystem
    or on every host), so replicas never start from different weights."""
    if get_world_size() == 1:
        return
    enc = np.zeros(1024, np.uint8)
    raw = args.resume.encode()
    if len(raw) > enc.size:
        raise ValueError(f"resume path too long to broadcast: {args.resume!r}")
    enc[:len(raw)] = np.frombuffer(raw, np.uint8)
    resume = bytes(broadcast_host(enc)).rstrip(b"\x00").decode()
    if resume != args.resume:
        print(f"process {get_rank()}: adopting process 0 resume decision {resume!r} "
              f"(local was {args.resume!r})", flush=True)
        args.resume = resume
    if resume and not os.path.exists(resume):
        raise FileNotFoundError(
            f"process {get_rank()} cannot read {resume!r}: a multi-process resume needs the "
            "checkpoint on a shared filesystem (or mirrored to every host)")


def assert_checkpoint_consistent(ckpt_flat: Dict[str, np.ndarray]) -> None:
    """Every rank loaded its own copy of the file: hold the copies to one
    another by a fingerprint (the sum of the finite values, the count of the
    non-finite ones; a NaN must not make equal copies differ), all-gathered
    as a sum into zeros; a difference raises RuntimeError."""
    world = get_world_size()
    if world == 1:
        return
    fp, n_nonfinite = 0.0, 0.0
    for v in ckpt_flat.values():
        arr = np.asarray(v, np.float64)
        finite = np.isfinite(arr)
        fp += float(arr[finite].sum())
        n_nonfinite += float(arr.size - finite.sum())
    fps = np.zeros((world, 2), np.float64)
    fps[get_rank()] = (fp, n_nonfinite)
    fps = all_reduce_host(fps)
    if not np.allclose(fps, fps[0], rtol=1e-5, atol=1e-6):
        raise RuntimeError(
            f"checkpoint content differs across processes (fingerprints {fps.tolist()}): "
            "replicas would diverge; make every host see the same checkpoint file")


def auto_load_model(args, state):
    """Resume or transfer-load into `state` with the JAX package's rules.
    Returns (state, the loaded checkpoint or None); sets args.resume and
    args.start_epoch as the JAX package does."""
    if args.auto_resume and len(args.resume) == 0:
        latest = find_latest_checkpoint(args.output_dir)
        if latest is not None:
            args.resume = latest
        print("Auto resume checkpoint: %s" % args.resume)
    sync_resume_across_processes(args)
    if not args.resume:
        return state, None
    if args.resume.startswith("http"):
        raise RuntimeError(f"cannot download {args.resume}: copy the checkpoint to local "
                           "disk and pass its path to --resume")

    print(args.resume)
    checkpoint = load_checkpoint(args.resume)
    assert_checkpoint_consistent(checkpoint["model"])
    model = state.model
    missing_nums = load_params_with_pruning(model, checkpoint["model"])
    if checkpoint.get("batch_stats"):
        load_params_with_pruning(model, checkpoint["batch_stats"], verbose=False)
    print("Resume checkpoint %s" % args.resume)

    if args.model_ema and state.ema is not None:
        if "model_ema" in checkpoint and missing_nums == 0:
            _copy_matching(state.ema, model, checkpoint["model_ema"])
            if state.ema_stats is not None and checkpoint.get("model_ema_batch_stats"):
                _copy_matching(state.ema_stats, model, checkpoint["model_ema_batch_stats"])
        else:
            state.ema = init_ema(model)
            state.ema_stats = init_ema_stats(model)

    if "optimizer" in checkpoint and "epoch" in checkpoint and missing_nums == 0:
        optimizer_from_jax(checkpoint["optimizer"], state.optimizer, model, carry_for(model))
        if "step" in checkpoint:
            state.step = int(checkpoint["step"])
        if not isinstance(checkpoint["epoch"], str):
            args.start_epoch = checkpoint["epoch"] + 1
        elif not args.eval:
            raise ValueError("resuming training from checkpoint-best is not supported")
        print("With optim & sched!")
    return state, checkpoint
