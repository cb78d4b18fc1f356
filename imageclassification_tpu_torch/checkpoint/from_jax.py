"""The weight carry: JAX flat parameters -> the port's state_dict.

The JAX package stores parameters as a flat {"a/b/c": ndarray} dict (flax
tree paths joined by "/"). This is the inverse of that package's
`checkpoint/torch_convert.py::convert_vit`, written here on its own:

    JAX flat key                                        port state_dict key
    patch_embed/kernel [p,p,3,E]                        patch_embed.proj.weight [E,3,p,p]
    block{i}/LayerNorm_{0,1}/{scale,bias}               blocks.{i}.norm{1,2}.{weight,bias}
    block{i}/MultiHeadDotProductAttention_0/
        {query,key,value}/kernel [E,H,hd]  (fused)      blocks.{i}.attn.qkv.weight [3E,E]
        {query,key,value}/bias [H,hd]      (fused)      blocks.{i}.attn.qkv.bias [3E]
        out/kernel [H,hd,E], out/bias [E]               blocks.{i}.attn.proj.{weight,bias}
    block{i}/Mlp_0/Dense_{0,1}/{kernel,bias}            blocks.{i}.mlp.fc{1,2}.{weight,bias}
    norm/{scale,bias}, head/{kernel,bias}               norm.*, head.*
    cls_token, pos_embed                                unchanged
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

_ATTN = "MultiHeadDotProductAttention_0"


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _linear_w(kernel) -> np.ndarray:
    """flax Dense kernel [in, out] -> torch Linear weight [out, in]."""
    return np.ascontiguousarray(_f32(kernel).T)


def vit_state_dict_with_sources(
    flat: Dict[str, np.ndarray], num_heads: int
) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]], List[str]]:
    """`vit_state_dict_from_jax` plus, for every produced key, the JAX keys it
    came from, and the JAX keys that map to nothing (unknown names, or a
    query/key/value set with a member missing)."""
    sd: Dict[str, np.ndarray] = {}
    src: Dict[str, List[str]] = {}
    unused: List[str] = []

    def put(key: str, value, *sources: str) -> None:
        sd[key] = value
        src[key] = list(sources)

    ln_names = {"LayerNorm_0": "norm1", "LayerNorm_1": "norm2"}
    ln_leaf = {"scale": "weight", "bias": "bias"}
    for k, v in flat.items():
        if k in ("cls_token", "pos_embed"):
            put(k, _f32(v), k)
        elif k == "patch_embed/kernel":
            put("patch_embed.proj.weight",
                np.ascontiguousarray(_f32(v).transpose(3, 2, 0, 1)), k)
        elif k == "patch_embed/bias":
            put("patch_embed.proj.bias", _f32(v), k)
        elif k in ("norm/scale", "norm/bias"):
            put("norm." + ln_leaf[k.split("/")[1]], _f32(v), k)
        elif k == "head/kernel":
            put("head.weight", _linear_w(v), k)
        elif k == "head/bias":
            put("head.bias", _f32(v), k)
        elif (m := re.fullmatch(r"block(\d+)/(LayerNorm_[01])/(scale|bias)", k)):
            put(f"blocks.{m[1]}.{ln_names[m[2]]}.{ln_leaf[m[3]]}", _f32(v), k)
        elif (m := re.fullmatch(r"block(\d+)/Mlp_0/Dense_([01])/(kernel|bias)", k)):
            name = f"blocks.{m[1]}.mlp.fc{int(m[2]) + 1}"
            if m[3] == "kernel":
                put(name + ".weight", _linear_w(v), k)
            else:
                put(name + ".bias", _f32(v), k)
        elif (m := re.fullmatch(rf"block(\d+)/{_ATTN}/out/(kernel|bias)", k)):
            name = f"blocks.{m[1]}.attn.proj"
            if m[2] == "kernel":
                h, hd, e = v.shape
                if h != num_heads:
                    raise ValueError(f"{k}: {h} heads, model has {num_heads}")
                put(name + ".weight", _linear_w(_f32(v).reshape(h * hd, e)), k)
            else:
                put(name + ".bias", _f32(v), k)
        elif re.fullmatch(rf"block\d+/{_ATTN}/(query|key|value)/(kernel|bias)", k):
            continue  # fused below
        else:
            unused.append(k)

    blocks = sorted({int(m[1]) for k in flat
                     if (m := re.fullmatch(rf"block(\d+)/{_ATTN}/(query|key|value)/(kernel|bias)", k))})
    for i in blocks:
        base = f"block{i}/{_ATTN}"
        for leaf, torch_leaf in (("kernel", "weight"), ("bias", "bias")):
            keys = [f"{base}/{p}/{leaf}" for p in ("query", "key", "value")]
            if not all(kk in flat for kk in keys):
                unused.extend(kk for kk in keys if kk in flat)
                continue
            parts = [_f32(flat[kk]) for kk in keys]
            if leaf == "kernel":
                e, h, hd = parts[0].shape
                if h != num_heads:
                    raise ValueError(f"{keys[0]}: {h} heads, model has {num_heads}")
                fused = np.concatenate([_linear_w(p.reshape(e, h * hd)) for p in parts])
            else:
                fused = np.concatenate([p.reshape(-1) for p in parts])
            put(f"blocks.{i}.attn.qkv.{torch_leaf}", fused, *keys)

    return {k: torch.tensor(v) for k, v in sd.items()}, src, unused


def vit_state_dict_from_jax(flat: Dict[str, np.ndarray], num_heads: int) -> Dict[str, torch.Tensor]:
    """Map a JAX ViT's flat parameters to the port's ViT state_dict (fp32)."""
    return vit_state_dict_with_sources(flat, num_heads)[0]
