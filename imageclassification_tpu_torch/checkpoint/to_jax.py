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
    nvnovograd:   inner_state/{i}/count, inner_state/{i}/mu/<path>, .../nu/<path> (a scalar)
    adafactor:    inner_state/{i}/0/count, inner_state/{i}/0/{v_row,v_col,v}/<path>
    adahessian:   inner_state/{i}/count, inner_state/{i}/mu/<path>, .../nu/<path>

where <path> is the JAX parameter path and i the index of the core
transformation in the optax chain: 0, or 1 after the coupled weight decay
of the optimizers that have it, each one more with --clip_grad (after the
clip). With Lookahead the whole of it moves under `inner/`, beside the
Lookahead state's own `count` and `slow/<path>`. The states kept per JAX
tensor (nvnovograd's nu, adafactor's) are written and read by the JAX names
of `jax_leaves`, which the optimizer holds.
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from ..downstream.fpn import FPN
from ..downstream.upernet import UPerNet
from ..models.convnext import ConvNeXt
from ..models.densenet import DenseNet
from ..models.efficientnet import EfficientNet
from ..models.efficientvit import EfficientViT
from ..models.mobilenetv3 import MobileNetV3
from ..models.resnet import ResNet
from ..models.swin import SwinTransformer
from ..models.vit import ViT
from ..optim.factory import COUPLED_WD, MOMENTS, JaxLeaf, Optimizer
from .from_jax import (CONVNEXT_MODULES, FPN_MODULES, SWIN_MODULES,
                       convnext_state_dict_with_sources, densenet_modules, efficientnet_modules,
                       efficientvit_modules, match_module, mobilenetv3_modules, resnet_modules,
                       split_modules, state_dict_with_sources, upernet_modules,
                       vit_state_dict_with_sources)

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
        elif kind == "pointwise":  # torch 1x1 conv [out, in, 1, 1] -> flax Dense [in, out]
            v = np.ascontiguousarray(v[:, :, 0, 0].T)
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


def _table(model: torch.nn.Module):
    """The module table of a model whose carry is one, or None."""
    if isinstance(model, ConvNeXt):
        return CONVNEXT_MODULES
    if isinstance(model, SwinTransformer):
        return SWIN_MODULES
    if isinstance(model, ResNet):
        return resnet_modules(model.stage_sizes, model.block_name)
    if isinstance(model, EfficientViT):
        return efficientvit_modules(model.depths, model.num_heads)
    if isinstance(model, MobileNetV3):
        return mobilenetv3_modules(model.cfgs)
    if isinstance(model, EfficientNet):
        return efficientnet_modules(*zip(*model.stage_layout))
    if isinstance(model, DenseNet):
        return densenet_modules(model.block_config)
    if isinstance(model, UPerNet):
        backbone = _table(model.backbone)
        return None if backbone is None else upernet_modules(backbone)
    if isinstance(model, FPN):
        return FPN_MODULES
    return None


def carry_for(model: torch.nn.Module) -> Carry:
    """The weight carry of `model`'s family (every family of the registry,
    and UPerNet and FPN of downstream/); TypeError for a module that is none
    of them."""
    if isinstance(model, ViT):
        return Carry(functools.partial(vit_state_dict_with_sources, num_heads=model.num_heads),
                     functools.partial(vit_flat_from_state_dict, num_heads=model.num_heads))
    if isinstance(model, ConvNeXt):
        return Carry(convnext_state_dict_with_sources, convnext_flat_from_state_dict)
    modules = _table(model)
    if modules is None:
        raise TypeError(f"no weight carry for {type(model).__name__}")
    return Carry(functools.partial(state_dict_with_sources, modules=modules),
                 functools.partial(flat_from_state_dict, modules=modules))


# each optimizer's moments in the JAX optax state, in the order of
# `factory.MOMENTS`: (the offset of its transformation from the core's
# first, the JAX field); and the key of the core's own count under its
# inner_state, where it keeps one
_ADAM = (((0, "mu"), (0, "nu")), "count")
_RMS = (((0, "nu"), (1, "trace")), None)
_JAX_LAYOUT = {
    "adamw": _ADAM, "adam": _ADAM, "nadam": _ADAM, "radam": _ADAM, "lamb": _ADAM,
    "adamp": _ADAM, "lion": (((0, "mu"),), "count"), "rmsprop": _RMS, "rmsproptf": _RMS,
    "adadelta": (((0, "e_g"), (0, "e_x")), None), "sgdp": (((0, "momentum"),), None),
    "sgd": (((0, "trace"),), None), "momentum": (((0, "trace"),), None),
    "nvnovograd": _ADAM, "adahessian": _ADAM,
    # optax.adafactor is a chain of its own: its factored-RMS state first
    "adafactor": (((0, "0/v_row"), (0, "0/v_col"), (0, "0/v")), "0/count"),
}


def _jax_layout(name: str):
    """([(the port's moment, offset, JAX field)], the core's count key or
    None)."""
    fields, count_key = _JAX_LAYOUT[name]
    return [(m, *f) for m, f in zip(MOMENTS[name], fields, strict=True)], count_key


def _core_index(opt: Optimizer) -> int:
    return (opt.name in COUPLED_WD) + (opt.clip_grad is not None)


def jax_leaves(model: torch.nn.Module, carry: Carry) -> List[List[JaxLeaf]]:
    """Each parameter's JAX tensors, in `named_parameters()` order, as
    `JaxLeaf`s: the JAX name, and where the JAX tensor lies in the (C
    contiguous) parameter, in JAX axis order, as the offset and strides of
    a view (`optim.factory.leaf_view`): one for a parameter that is one JAX
    tensor (a conv kernel HWIO over the torch OIHW, a Dense kernel [in, out]
    over the Linear's [out, in]), several for one the carry splits (ViT's
    fused qkv: query, key and value, each [E, H, hd] over a third of the
    rows). Found by carrying each torch axis's coordinates (small integers,
    exact in the carry's fp32); raises where a JAX tensor is no strided view
    of the parameter."""
    out = []
    for k, p in model.named_parameters():
        shape = tuple(p.shape)
        strides = [int(np.prod(shape[d + 1:])) for d in range(len(shape))]
        if not shape:
            (key,) = carry.to_jax({k: p})
            out.append([JaxLeaf(key, 0, (), ())])
            continue
        index: Dict[str, np.ndarray] = {}
        for d, n in enumerate(shape):
            coord = torch.arange(n, dtype=torch.float32).reshape(
                [n if i == d else 1 for i in range(len(shape))]).expand(shape)
            for key, v in carry.to_jax({k: coord}).items():
                index[key] = index.get(key, 0) + v.astype(np.int64) * strides[d]
        leaves = []
        for key, idx in index.items():
            idx = np.asarray(idx)
            offset = int(idx.reshape(-1)[0])
            stride = tuple(int(idx[tuple(1 if i == d else 0 for i in range(idx.ndim))]) - offset
                           if idx.shape[d] > 1 else 1 for d in range(idx.ndim))
            want = offset + sum(np.arange(n).reshape([n if i == d else 1 for i in range(idx.ndim)])
                                * s for d, (n, s) in enumerate(zip(idx.shape, stride)))
            if not np.array_equal(np.broadcast_to(want, idx.shape), idx):
                raise ValueError(f"{k}: the JAX tensor {key} is no strided view of it")
            leaves.append(JaxLeaf(key, offset, tuple(idx.shape), stride))
        out.append(sorted(leaves, key=lambda leaf: leaf.offset))
    return out


def optimizer_to_jax(opt: Optimizer, model: torch.nn.Module,
                     carry: Carry) -> Dict[str, np.ndarray]:
    """The optimizer's state in the JAX optax layout (module docstring),
    mapped by the model's `carry`."""
    names = [k for k, _ in model.named_parameters()]
    count = np.asarray(opt.num_updates, np.int32)
    i = _core_index(opt)
    moments, count_key = _jax_layout(opt.name)
    flat = {"count": count,
            "hyperparams/learning_rate": np.asarray(float(opt.lr), np.float32),
            "hyperparams/weight_decay": np.asarray(float(opt.weight_decay), np.float32)}
    if count_key:
        flat[f"inner_state/{i}/{count_key}"] = count
    for field, offset, jax_field in moments:
        prefix = f"inner_state/{i + offset}/{jax_field}/"
        if opt.leaf_layout[field]:  # one state a JAX tensor, by its JAX name
            for pi, leaves in enumerate(opt.leaves):
                for j, leaf in enumerate(leaves):
                    if leaf.key is None:
                        raise ValueError(f"{opt.name}'s state needs the JAX tensors of the "
                                         "parameters (create_optimizer(leaves=jax_leaves(...)))")
                    flat[prefix + leaf.key] = opt.leaf_state(field, pi, j).cpu().numpy().copy()
            continue
        for k, v in carry.to_jax(dict(zip(names, opt.moments[field]))).items():
            flat[prefix + k] = v
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

    def per_leaf(prefix: str, field: str) -> Dict[int, List[np.ndarray]]:
        out = {}
        for j, leaves in enumerate(opt.leaves):
            arrs = [flat.get(prefix + str(leaf.key)) for leaf in leaves]
            shapes = [tuple(opt.leaf_state(field, j, n).shape) for n in range(len(leaves))]
            if all(a is not None and tuple(np.shape(a)) == s for a, s in zip(arrs, shapes)):
                out[j] = arrs
        return out

    inner = "inner/" if opt.lookahead else ""
    i = _core_index(opt)
    moments, count_key = _jax_layout(opt.name)
    count = int(np.asarray(flat.get(f"{inner}inner_state/{i}/{count_key or 'count'}",
                                    flat.get(f"{inner}count", 0))))
    loaded = {}
    for field, offset, jax_field in moments:
        prefix = f"{inner}inner_state/{i + offset}/{jax_field}/"
        found = per_leaf(prefix, field) if opt.leaf_layout[field] else per_param(prefix)
        for j, v in found.items():
            loaded.setdefault(j, {})[field] = v
    with torch.no_grad():
        for j, st in loaded.items():
            if len(st) == len(moments):
                for field, v in st.items():
                    if opt.leaf_layout[field]:
                        for n, a in enumerate(v):
                            opt.leaf_state(field, j, n).copy_(torch.from_numpy(np.asarray(
                                a, np.float32)))
                    else:
                        opt.moments[field][j].copy_(v)
        if opt.lookahead:
            for j, v in per_param("slow/").items():
                opt.slow[j].copy_(v)
            opt.lookahead_count.fill_(int(np.asarray(flat.get("count", 0))))
    opt.num_updates = int(np.asarray(flat.get(f"{inner}count", count)))
    return len(loaded)
