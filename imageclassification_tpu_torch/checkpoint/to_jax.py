"""The weight carry back: the port's state_dict -> JAX flat parameters, and
the port's optimizer state -> the JAX optax state, so the port writes
checkpoints in the JAX package's layout.

`vit_flat_from_state_dict` is the inverse of
`from_jax.vit_state_dict_with_sources`: it splits the fused qkv Linear back
into the query/key/value projections ([E, H, hd] kernels, [H, hd] biases).
`flat_from_state_dict` is the inverse of `from_jax.state_dict_with_sources`
by a module table (ConvNeXt's, a ResNet's, an EfficientViT's). Each maps any
dict of tensors shaped like the parameters, so it carries the optimizer's
moments too, and a BatchNorm model's carry maps its BatchNorm buffers to
the JAX batch statistics the same way: applied to the parameters it gives
the JAX "model" tree, applied to the buffers the "batch_stats" tree.
`carry_for(model)` gives a model's pair of carry functions (`Carry`); the
optimizer functions take it.

The optimizer state is stored as the JAX `create_optimizer(...).init(params)`
state flattens (`checkpoint/io.py::_flatten` there):

    count                                   int32, updates taken
    hyperparams/{learning_rate,weight_decay}
    adamw, adam, nadam, radam, lamb, adamp:
                  inner_state/{i}/count, inner_state/{i}/mu/<path>, .../nu/<path>
    lion:         inner_state/{i}/count, inner_state/{i}/mu/<path>
    rmsprop(tf):  inner_state/{i}/nu/<path>, inner_state/{i+1}/trace/<path>
    adadelta:     inner_state/{i}/e_g/<path>, inner_state/{i}/e_x/<path>
    sgdp:         inner_state/{i}/momentum/<path>
    sgd/momentum: inner_state/{i}/trace/<path>

where <path> is the JAX parameter path and i the index of the core
transformation in the optax chain: 0, or 1 after the coupled weight decay
of the optimizers that have it, each one more with --clip_grad (after the
clip). With Lookahead the whole of it moves under `inner/`, beside the
Lookahead state's own `count` and `slow/<path>`.
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from ..models.convnext import ConvNeXt
from ..models.efficientvit import EfficientViT
from ..models.resnet import ResNet
from ..models.vit import ViT
from ..optim.factory import COUPLED_WD, MOMENTS, Optimizer
from .from_jax import (CONVNEXT_MODULES, convnext_state_dict_with_sources,
                       efficientvit_modules, match_module, resnet_modules, split_modules,
                       state_dict_with_sources, vit_state_dict_with_sources)

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


def flat_from_state_dict(sd: Dict[str, torch.Tensor], modules) -> Dict[str, np.ndarray]:
    """Map a port state_dict (or any dict keyed like it) to the JAX flat
    parameters, fp32 numpy, by a table of (JAX module, port module, leaves)
    (the inverse of `from_jax.state_dict_with_sources`)."""
    exact, pats = split_modules(
        [(p, j, {pl: (jl, kind) for jl, (pl, kind) in leaves.items()})
         for j, p, leaves in modules])
    flat: Dict[str, np.ndarray] = {}
    for k, t in sd.items():
        v = t.detach().float().cpu().numpy()
        module, _, leaf = k.rpartition(".")
        jax_module, leaves = match_module(module, exact, pats)
        if leaf not in leaves:
            raise KeyError(f"no JAX name for port key {k!r}")
        name, kind = leaves[leaf]
        if kind == "conv":  # torch [out, in, kh, kw] -> flax [kh, kw, in, out]
            v = np.ascontiguousarray(v.transpose(2, 3, 1, 0))
        elif kind == "dense":
            v = np.ascontiguousarray(v.T)
        flat[f"{jax_module}/{name}"] = v
    return flat


def convnext_flat_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Map the port's ConvNeXt state_dict (or any dict keyed like it) to the
    JAX flat parameters, fp32 numpy."""
    return flat_from_state_dict(sd, CONVNEXT_MODULES)


class Carry(NamedTuple):
    """A model family's weight carry: `to_port(flat)` -> (state_dict, the
    JAX sources of each key, the unused JAX keys); `to_jax(state_dict)` ->
    JAX flat parameters."""

    to_port: Callable
    to_jax: Callable


def carry_for(model: torch.nn.Module) -> Carry:
    """The weight carry of `model`'s family; NotImplementedError for a
    family whose carry is not ported."""
    if isinstance(model, ViT):
        return Carry(functools.partial(vit_state_dict_with_sources, num_heads=model.num_heads),
                     functools.partial(vit_flat_from_state_dict, num_heads=model.num_heads))
    if isinstance(model, ConvNeXt):
        return Carry(convnext_state_dict_with_sources, convnext_flat_from_state_dict)
    if isinstance(model, (ResNet, EfficientViT)):
        modules = (resnet_modules(model.stage_sizes, model.block_name)
                   if isinstance(model, ResNet)
                   else efficientvit_modules(model.depths, model.num_heads))
        return Carry(functools.partial(state_dict_with_sources, modules=modules),
                     functools.partial(flat_from_state_dict, modules=modules))
    raise NotImplementedError(
        f"weight carry for {type(model).__name__} is not ported yet (ROADMAP A14-A15)")


# each optimizer's moments in the JAX optax state, in the order of
# `factory.MOMENTS`: (the offset of its transformation from the core's
# first, the JAX field); and whether the core keeps a count of its own
_ADAM = (((0, "mu"), (0, "nu")), True)
_RMS = (((0, "nu"), (1, "trace")), False)
_JAX_LAYOUT = {
    "adamw": _ADAM, "adam": _ADAM, "nadam": _ADAM, "radam": _ADAM, "lamb": _ADAM,
    "adamp": _ADAM, "lion": (((0, "mu"),), True), "rmsprop": _RMS, "rmsproptf": _RMS,
    "adadelta": (((0, "e_g"), (0, "e_x")), False), "sgdp": (((0, "momentum"),), False),
    "sgd": (((0, "trace"),), False), "momentum": (((0, "trace"),), False),
}


def _jax_layout(name: str):
    """([(the port's moment, offset, JAX field)], the core keeps a count)."""
    fields, has_count = _JAX_LAYOUT[name]
    return [(m, *f) for m, f in zip(MOMENTS[name], fields, strict=True)], has_count


def _core_index(opt: Optimizer) -> int:
    return (opt.name in COUPLED_WD) + (opt.clip_grad is not None)


def jax_leaves(model: torch.nn.Module, carry: Carry):
    """Each parameter's JAX tensors as (start, length, JAX ndim) over the
    parameter flattened, in `named_parameters()` order: one for a parameter
    that is one JAX tensor, several for one the carry splits (ViT's fused
    qkv: query, key and value, each a contiguous third). Found by carrying
    the element indices; raises where a JAX tensor is not one contiguous
    run of them."""
    out = []
    for k, p in model.named_parameters():
        whole = carry.to_jax({k: p})
        if len(whole) == 1:
            out.append([(0, p.numel(), next(iter(whole.values())).ndim)])
            continue
        # the carry computes in fp32: indices stay exact up to 2^24 elements
        idx = torch.arange(p.numel(), dtype=torch.float64).reshape(p.shape)
        leaves = []
        for v in carry.to_jax({k: idx}).values():
            flat = np.sort(v.reshape(-1)).astype(np.int64)
            start = int(flat[0])
            if not np.array_equal(flat, np.arange(start, start + flat.size)):
                raise ValueError(f"{k}: a JAX tensor is not a contiguous part of it")
            leaves.append((start, int(flat.size), v.ndim))
        out.append(sorted(leaves))
    return out


def optimizer_to_jax(opt: Optimizer, model: torch.nn.Module,
                     carry: Carry) -> Dict[str, np.ndarray]:
    """The optimizer's state in the JAX optax layout (module docstring),
    mapped by the model's `carry`."""
    names = [k for k, _ in model.named_parameters()]
    count = np.asarray(opt.num_updates, np.int32)
    i = _core_index(opt)
    moments, has_count = _jax_layout(opt.name)
    flat = {"count": count,
            "hyperparams/learning_rate": np.asarray(float(opt.lr), np.float32),
            "hyperparams/weight_decay": np.asarray(float(opt.weight_decay), np.float32)}
    if has_count:
        flat[f"inner_state/{i}/count"] = count
    for field, offset, jax_field in moments:
        for k, v in carry.to_jax(dict(zip(names, opt.moments[field]))).items():
            flat[f"inner_state/{i + offset}/{jax_field}/{k}"] = v
    if not opt.lookahead:
        return flat
    out = {"count": np.asarray(int(opt.lookahead_count), np.int32)}
    out.update({f"slow/{k}": v for k, v in carry.to_jax(dict(zip(names, opt.slow))).items()})
    out.update({f"inner/{k}": v for k, v in flat.items()})
    return out


def optimizer_from_jax(flat: Dict[str, np.ndarray], opt: Optimizer,
                       model: torch.nn.Module, carry: Carry) -> int:
    """Load a JAX-layout optimizer state into `opt` in place, keeping only
    the leaves that match a parameter by name and shape, as the JAX resume
    does. Returns the number of parameters whose state was loaded."""
    index = {k: j for j, (k, _) in enumerate(model.named_parameters())}

    def per_param(prefix: str) -> Dict[int, torch.Tensor]:
        sub = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        return {index[k]: v for k, v in carry.to_port(sub)[0].items()
                if k in index and tuple(v.shape) == tuple(opt.params[index[k]].shape)}

    inner = "inner/" if opt.lookahead else ""
    i = _core_index(opt)
    moments, _ = _jax_layout(opt.name)
    count = int(np.asarray(flat.get(f"{inner}inner_state/{i}/count",
                                    flat.get(f"{inner}count", 0))))
    loaded = {}
    for field, offset, jax_field in moments:
        for j, v in per_param(f"{inner}inner_state/{i + offset}/{jax_field}/").items():
            loaded.setdefault(j, {})[field] = v
    with torch.no_grad():
        for j, st in loaded.items():
            if len(st) == len(moments):
                for field, v in st.items():
                    opt.moments[field][j].copy_(v)
        if opt.lookahead:
            for j, v in per_param("slow/").items():
                opt.slow[j].copy_(v)
            opt.lookahead_count.fill_(int(np.asarray(flat.get("count", 0))))
    opt.num_updates = int(np.asarray(flat.get(f"{inner}count", count)))
    return len(loaded)
