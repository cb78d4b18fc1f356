"""Folder inference CLI (port of the root val.py):

    python -m imageclassification_tpu_torch.val --img_path <dir> \
        --model_weight_path <checkpoint.pth> [--mode precision|move] [--device cuda|cpu]

* `initialize_model` rebuilds the model from the checkpoint's stored
  model_spec (the user never names the architecture); with --model_ema true
  the EMA weights are used when the checkpoint has them.
* `val_precision` evaluates an ImageFolder tree and prints per-class
  precision/recall, with labels from the training `class_indices.json` next
  to the checkpoint when present.
* `val_move` classifies every image of a folder and moves it into a sibling
  `Empty/` (class 0) or `NonEmpty/` (any other class) directory.

The eval transform is the squash resize (bilinear) on the host, then the
ImageNet normalisation on the device. A checkpoint written by the JAX
`train.py` loads and runs unchanged; one trained with --flash_attn runs the
flash-attention kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

from .checkpoint.io import load_checkpoint, load_params_with_pruning
from .data.augment import eval_preprocess
from .data.folder import IMG_EXTENSIONS, scan_folder
from .data.loader import decode_image
from .device import DEVICES, resolve_device
from .models import create_model
from .utils.metrics import per_class_precision_recall


def initialize_model(model_weight_path: str, model_ema: bool, half_precision=True,
                     return_checkpoint=False, dequantize=False, device="cuda"):
    """Rebuild (model, num_classes) from a checkpoint, the model on `device`
    in eval mode. With return_checkpoint=True the second element is the
    loaded checkpoint dict instead of num_classes.

    int8 checkpoints run quantized in the JAX package (ops/int8.py); that
    path is not ported yet, so one raises NotImplementedError unless
    dequantize=True asks for fp32 weights."""
    device = resolve_device(device)
    checkpoint = load_checkpoint(model_weight_path, dequantize=dequantize)
    if checkpoint.get("quant_scales") and checkpoint.get("quant_dtype") == "int8":
        raise NotImplementedError(
            "int8 execution of a quantized checkpoint is not ported yet; "
            "pass dequantize=True to run it with fp32 weights"
        )
    checkpoint.pop("quant_scales", None)
    checkpoint.pop("quant_dtype", None)
    num_classes = checkpoint["num_classes"]
    spec = checkpoint["model_spec"]
    kwargs = dict(spec.get("kwargs", {}))
    kwargs.pop("num_classes", None)
    shape = checkpoint.get("input_shape") or [1, 224, 224, 3]
    kwargs.setdefault("img_size", shape[1])
    model = create_model(spec["name"], num_classes=num_classes,
                         half_precision=half_precision, **kwargs)
    if model_ema and "model_ema" in checkpoint:
        load_params_with_pruning(model, checkpoint["model_ema"], verbose=False)
        print("initialize model_ema success")
    else:
        load_params_with_pruning(model, checkpoint["model"], verbose=False)
    model = model.to(device).eval()
    if return_checkpoint:
        return model, checkpoint
    return model, num_classes


def _predict_fn(model):
    """images_u8 [B, H, W, 3] on the model's device -> fp32 class probabilities."""

    @torch.inference_mode()
    def predict(images_u8):
        logits = model(eval_preprocess(images_u8)).float()
        return torch.softmax(logits, dim=-1)

    return predict


def _batched(paths, img_size, batch, device):
    """Yield (paths of the chunk, uint8 [batch, s, s, 3] on `device`); the
    last chunk is padded with black images to the full batch."""
    for i in range(0, len(paths), batch):
        chunk = paths[i : i + batch]
        imgs = np.stack([decode_image(p, img_size, train=False) for p in chunk])
        pad = batch - len(chunk)
        if pad:
            imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], np.uint8)])
        yield chunk, torch.from_numpy(imgs).to(device)


def val_move(img_path, model_weight_path, img_size, model_ema, batch_size=64,
             device="cuda"):
    """Move each image into Empty/ (pred class 0) or NonEmpty/ (else)."""
    dev = resolve_device(device)
    # normpath: a trailing slash on img_path must not nest Empty/NonEmpty
    # inside the scanned folder
    base = os.path.dirname(os.path.normpath(img_path))
    empty_path = os.path.join(base, "Empty")
    non_empty_path = os.path.join(base, "NonEmpty")
    os.makedirs(empty_path, exist_ok=True)
    os.makedirs(non_empty_path, exist_ok=True)

    model, _ = initialize_model(model_weight_path, model_ema, device=device)
    predict = _predict_fn(model)

    files = sorted(f for f in os.listdir(img_path) if f.lower().endswith(IMG_EXTENSIONS))
    paths = [os.path.join(img_path, f) for f in files]
    for chunk, imgs in _batched(paths, img_size, batch_size, dev):
        preds = predict(imgs).argmax(-1)[: len(chunk)].cpu().numpy()
        for p, cls in zip(chunk, preds):
            target = empty_path if cls == 0 else non_empty_path
            shutil.move(p, os.path.join(target, os.path.basename(p)))


def _training_class_map(model_weight_path):
    """{class_name: training_label} from the class_indices.json that
    training writes next to its checkpoints, if present."""
    path = os.path.join(os.path.dirname(model_weight_path), "class_indices.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        inv = json.load(f)  # {"0": "cat", ...}
    return {name: int(idx) for idx, name in inv.items()}


def val_precision(img_path, model_weight_path, img_size, model_ema, batch_size=64,
                  device="cuda"):
    """Per-class precision/recall over an ImageFolder tree; returns the
    (tp, fp, fn) count vectors.

    Labels come from the training class mapping when it is available, since
    the alphabetical order of the eval folder's subdirectories mislabels
    everything when the eval tree lacks a class."""
    dev = resolve_device(device)
    index = scan_folder(img_path)
    model, num_classes = initialize_model(model_weight_path, model_ema, device=device)
    predict = _predict_fn(model)

    remap = None
    train_map = _training_class_map(model_weight_path)
    if train_map is not None:
        missing = [c for c in index.class_to_idx if c not in train_map]
        if missing:
            print(f"classes not in training mapping, keeping folder order: {missing}")
        else:
            remap = {folder_id: train_map[name]
                     for name, folder_id in index.class_to_idx.items()}

    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)
    paths = [p for p, _ in index.samples]
    labels = np.asarray([l for _, l in index.samples])
    if remap is not None:
        labels = np.asarray([remap[l] for l in labels])
    pos = 0
    for chunk, imgs in _batched(paths, img_size, batch_size, dev):
        preds = predict(imgs).argmax(-1)[: len(chunk)].cpu().numpy()
        targs = labels[pos : pos + len(chunk)]
        pos += len(chunk)
        for i in range(num_classes):
            tp[i] += np.sum((preds == i) & (targs == i))
            fp[i] += np.sum((preds == i) & (targs != i))
            fn[i] += np.sum((preds != i) & (targs == i))

    precisions, recalls = per_class_precision_recall(tp, fp, fn)
    for i in range(num_classes):
        print(f"Precision{i}: {precisions[i]:.5f}, Recall{i}: {recalls[i]:.5f}")
    return tp, fp, fn


def main(argv=None):
    parser = argparse.ArgumentParser("Folder inference / validation")
    parser.add_argument("--img_path", default="", type=str)
    parser.add_argument(
        "--model_weight_path", default="train_cls/output/checkpoint-0.pth", type=str
    )
    parser.add_argument("--img_size", default=224, type=int)
    parser.add_argument("--model_ema", default=True,
                        type=lambda v: v.lower() in ("1", "true", "t", "yes"))
    parser.add_argument("--mode", default="precision", choices=["precision", "move"])
    parser.add_argument("--batch_size", default=64, type=int)
    parser.add_argument("--device", default="cuda", choices=list(DEVICES))
    a = parser.parse_args(argv)
    print("Start calculation!")
    if a.mode == "move":
        val_move(a.img_path, a.model_weight_path, a.img_size, a.model_ema,
                 a.batch_size, a.device)
    else:
        val_precision(a.img_path, a.model_weight_path, a.img_size, a.model_ema,
                      a.batch_size, a.device)


if __name__ == "__main__":
    main()
