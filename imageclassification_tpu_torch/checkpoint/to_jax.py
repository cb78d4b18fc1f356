"""The weight carry back: the port's state_dict -> JAX flat parameters, and
the port's optimizer state -> the JAX optax state, so the port writes
checkpoints in the JAX package's layout.

`vit_flat_from_state_dict` is the inverse of
`from_jax.vit_state_dict_with_sources`: it splits the fused qkv Linear back
into the query/key/value projections ([E, H, hd] kernels, [H, hd] biases).
It maps any dict of tensors shaped like the parameters, so it carries the
optimizer's moments too.

The optimizer state is stored as the JAX `create_optimizer(...).init(params)`
state flattens (`checkpoint/io.py::_flatten` there):

    count                                   int32, updates taken
    hyperparams/{learning_rate,weight_decay}
    adamw:        inner_state/{i}/count, inner_state/{i}/mu/<path>, .../nu/<path>
    sgd/momentum: inner_state/{i}/trace/<path>

where <path> is the JAX parameter path and i the index of the core
transformation in the optax chain: adamw 0, sgd/momentum 1 (after the coupled
weight decay), each one more with --clip_grad (after the clip).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..optim.factory import Optimizer
from .from_jax import vit_state_dict_with_sources

_ATTN = "MultiHeadDotProductAttention_0"


def vit_flat_from_state_dict(sd: Dict[str, torch.Tensor], num_heads: int) -> Dict[str, np.ndarray]:
    """Map the port's ViT state_dict (or any dict keyed like it) to the JAX
    flat parameters, fp32 numpy."""
    ln_names = {"norm1": "LayerNorm_0", "norm2": "LayerNorm_1"}
    ln_leaf = {"weight": "scale", "bias": "bias"}
    flat: Dict[str, np.ndarray] = {}
    for k, t in sd.items():
        v = t.detach().float().cpu().numpy()
        if k in ("cls_token", "pos_embed"):
            flat[k] = v
        elif k == "patch_embed.proj.weight":
            flat["patch_embed/kernel"] = np.ascontiguousarray(v.transpose(2, 3, 1, 0))
        elif k == "patch_embed.proj.bias":
            flat["patch_embed/bias"] = v
        elif k in ("norm.weight", "norm.bias"):
            flat["norm/" + ln_leaf[k.split(".")[1]]] = v
        elif k == "head.weight":
            flat["head/kernel"] = np.ascontiguousarray(v.T)
        elif k == "head.bias":
            flat["head/bias"] = v
        elif (m := re.fullmatch(r"blocks\.(\d+)\.(norm[12])\.(weight|bias)", k)):
            flat[f"block{m[1]}/{ln_names[m[2]]}/{ln_leaf[m[3]]}"] = v
        elif (m := re.fullmatch(r"blocks\.(\d+)\.mlp\.fc([12])\.(weight|bias)", k)):
            name = f"block{m[1]}/Mlp_0/Dense_{int(m[2]) - 1}"
            flat[name + ("/kernel" if m[3] == "weight" else "/bias")] = (
                np.ascontiguousarray(v.T) if m[3] == "weight" else v)
        elif (m := re.fullmatch(r"blocks\.(\d+)\.attn\.proj\.(weight|bias)", k)):
            name = f"block{m[1]}/{_ATTN}/out"
            if m[2] == "weight":
                e = v.shape[0]
                flat[name + "/kernel"] = np.ascontiguousarray(v.T.reshape(num_heads, e // num_heads, e))
            else:
                flat[name + "/bias"] = v
        elif (m := re.fullmatch(r"blocks\.(\d+)\.attn\.qkv\.(weight|bias)", k)):
            parts = np.split(v, 3, axis=0)
            for p, part in zip(("query", "key", "value"), parts):
                name = f"block{m[1]}/{_ATTN}/{p}"
                if m[2] == "weight":
                    e = part.shape[1]
                    flat[name + "/kernel"] = np.ascontiguousarray(
                        part.T.reshape(e, num_heads, e // num_heads))
                else:
                    flat[name + "/bias"] = part.reshape(num_heads, -1)
        else:
            raise KeyError(f"no JAX name for port key {k!r}")
    return flat


def _core_index(opt: Optimizer) -> int:
    return (0 if opt.name == "adamw" else 1) + (opt.clip_grad is not None)


def optimizer_to_jax(opt: Optimizer, model: torch.nn.Module,
                     num_heads: int) -> Dict[str, np.ndarray]:
    """The optimizer's state in the JAX optax layout (module docstring)."""
    named = list(model.named_parameters())
    group = opt.inner.param_groups[0]
    i = _core_index(opt)
    flat = {"count": np.asarray(opt.num_updates, np.int32),
            "hyperparams/learning_rate": np.asarray(group["lr"], np.float32),
            "hyperparams/weight_decay": np.asarray(group["weight_decay"], np.float32)}

    def moments(field):
        return {k: opt.inner.state.get(p, {}).get(field, torch.zeros_like(p)) for k, p in named}

    if opt.name == "adamw":
        flat[f"inner_state/{i}/count"] = np.asarray(opt.num_updates, np.int32)
        for field, jax_field in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            for k, v in vit_flat_from_state_dict(moments(field), num_heads).items():
                flat[f"inner_state/{i}/{jax_field}/{k}"] = v
    else:
        for k, v in vit_flat_from_state_dict(moments("momentum_buffer"), num_heads).items():
            flat[f"inner_state/{i}/trace/{k}"] = v
    return flat


def optimizer_from_jax(flat: Dict[str, np.ndarray], opt: Optimizer,
                       model: torch.nn.Module, num_heads: int) -> int:
    """Load a JAX-layout optimizer state into `opt`, keeping only the leaves
    that match a parameter by name and shape, as the JAX resume does. Returns
    the number of parameters whose state was loaded."""
    named = dict(model.named_parameters())
    i = _core_index(opt)
    fields = ({"mu": "exp_avg", "nu": "exp_avg_sq"} if opt.name == "adamw"
              else {"trace": "momentum_buffer"})
    count = int(np.asarray(flat.get(f"inner_state/{i}/count", flat.get("count", 0))))
    loaded = {}
    for jax_field, field in fields.items():
        prefix = f"inner_state/{i}/{jax_field}/"
        sub = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        sd = vit_state_dict_with_sources(sub, num_heads)[0]
        for k, v in sd.items():
            p = named.get(k)
            if p is not None and tuple(v.shape) == tuple(p.shape):
                loaded.setdefault(p, {})[field] = v.to(p.device, p.dtype)
    for p, st in loaded.items():
        if len(st) < len(fields):
            continue
        if opt.name == "adamw":
            st["step"] = torch.tensor(float(count))
        opt.inner.state[p] = st
    opt.num_updates = int(np.asarray(flat.get("count", count)))
    return len(loaded)
