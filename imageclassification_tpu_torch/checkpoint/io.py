"""Reading the JAX package's checkpoints (port of the read side of
imageclassification_tpu/checkpoint/io.py).

A checkpoint is a pickle of a plain dict: flat numpy parameter dicts under
"model" (and "model_ema", "optimizer", ...), plus "model_spec"
({"name", "kwargs"}), "input_shape" (NHWC), "num_classes" and, for
checkpoints written by modelchange.py's quantizer, "quant_scales" and
"quant_dtype". The port reads that format as it is: a checkpoint written by
the JAX `train.py` loads unchanged.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np
from torch import nn

from ..models.vit import ViT
from .from_jax import vit_state_dict_with_sources


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


def load_params_with_pruning(model: nn.Module, ckpt_flat: Dict[str, np.ndarray],
                             verbose: bool = True) -> int:
    """Load the checkpoint's flat JAX parameters into `model`, keeping only
    those that match a model parameter by name AND shape. Prints
    `Skipping mismatched key: <k>` (the checkpoint's key) per drop and
    returns the number dropped. Parameters with no match keep their values."""
    if not isinstance(model, ViT):
        raise NotImplementedError(
            f"weight carry for {type(model).__name__} is not ported yet"
        )
    sd, sources, unused = vit_state_dict_with_sources(ckpt_flat, model.num_heads)
    current = model.state_dict()
    kept = {}
    dropped = list(unused)
    for k, v in sd.items():
        if k in current and tuple(v.shape) == tuple(current[k].shape):
            kept[k] = v
        else:
            dropped.extend(sources[k])
    if verbose:
        for k in dropped:
            print(f"Skipping mismatched key: {k}")
    model.load_state_dict(kept, strict=False)
    return len(dropped)
