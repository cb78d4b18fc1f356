"""The weight carry: JAX flat parameters -> the port's state_dict.

The JAX package stores parameters as a flat {"a/b/c": ndarray} dict (flax
tree paths joined by "/"). The functions here are the inverses of that
package's `checkpoint/torch_convert.py::convert_vit`, `convert_convnext`,
`convert_resnet` and `convert_efficientvit`, written here on their own.

ViT:

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

ConvNeXt (`CONVNEXT_MODULES`; each JAX module's leaves map one to one):

    JAX flat key                                        port state_dict key
    stem_conv/{kernel [4,4,3,C], bias}                  stem.0.{weight [C,3,4,4], bias}
    stem_norm/{scale,bias}                              stem.1.{weight,bias}
    downsample_norm{i}/*, downsample_conv{i}/*          stages.{i}.downsample.{0,1}.*
    stage{s}_block{b}/Conv_0/kernel [7,7,1,C]           stages.{s}.blocks.{b}.conv_dw.weight [C,1,7,7]
    stage{s}_block{b}/LayerNorm_0/*                     stages.{s}.blocks.{b}.norm.*
    stage{s}_block{b}/Dense_{0,1}/kernel [in,out]       stages.{s}.blocks.{b}.mlp.fc{1,2}.weight [out,in]
    stage{s}_block{b}/GRN_0/{gamma,beta} [4C]           stages.{s}.blocks.{b}.mlp.grn.{weight,bias}
    stage{s}_block{b}/gamma                             stages.{s}.blocks.{b}.gamma
    norm{i}/* (features_only)                           norm{i}.*
    head_norm/*, head/*                                 head.norm.*, head.fc.*

ResNet (`resnet_modules`; the inverse of `torch_convert.convert_resnet`; the
batch statistics map with the parameters):

    JAX flat key                                        port state_dict key
    conv_stem/kernel [7,7,3,C]                          conv1.weight [C,3,7,7]
    bn_stem/{scale,bias}                                bn1.{weight,bias}
    batch_stats bn_stem/{mean,var}                      bn1.running_{mean,var}
    {Block}_{k}/Conv_{c}/kernel                         layer{s}.{b}.conv{c+1}.weight
    {Block}_{k}/BatchNorm_{c}/*                         layer{s}.{b}.bn{c+1}.*
    {Block}_{k}/{Conv,BatchNorm}_{n} (downsample)       layer{s}.{b}.downsample.{0,1}.*
    head/{kernel,bias}                                  fc.{weight,bias}

EfficientViT (`efficientvit_modules`; the inverse of
`torch_convert.convert_efficientvit`; batch statistics with the parameters):

    JAX flat key                                        port state_dict key
    patch_embed{i}/{Conv_0,BatchNorm_0}/*               patch_embed.{2i}.{c,bn}.*
    sub{s}_{dw0,ffn0,merge,dw1,ffn1}/...                blocks{s+1}.{0.0.m,0.1.m,1,2.0.m,2.1.m}...
    stage{s}_block{b}/{dw0,ffn0,dw1,ffn1}/...           blocks{s+1}.{k}.{dw0,ffn0,dw1,ffn1}.m...
    stage{s}_block{b}/mixer/attn/{qkv,dw_q}{i}/...      blocks{s+1}.{k}.mixer.m.attn.{qkvs,dws}.{i}...
    stage{s}_block{b}/mixer/attn/attention_biases       blocks{s+1}.{k}.mixer.m.attn.attention_biases
    head_bn/*, head/{kernel,bias}                       head.bn.*, head.l.{weight,bias}

with k = b (+ 3 from stage 1 on), ConvBN_{0,1} the FFN's pw{1,2}, and
merge's ConvBN_{0,1,2} and SqueezeExcite_0/Conv_{0,1} its conv{1,2,3} and
se.conv_{reduce,expand}.
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


# (JAX module, port module, {JAX leaf: (port leaf, kind)}) where kind says
# how the array is laid out: "conv" HWIO <-> OIHW, "dense" [in, out] <->
# [out, in], "same" unchanged. "{n}" stands for a stage or block number.
_CONV = {"kernel": ("weight", "conv"), "bias": ("bias", "same")}
_LN = {"scale": ("weight", "same"), "bias": ("bias", "same")}
_DENSE = {"kernel": ("weight", "dense"), "bias": ("bias", "same")}
_BLOCK = ("stage{n}_block{n}", "stages.{n}.blocks.{n}")
CONVNEXT_MODULES = [
    ("stem_conv", "stem.0", _CONV),
    ("stem_norm", "stem.1", _LN),
    ("downsample_norm{n}", "stages.{n}.downsample.0", _LN),
    ("downsample_conv{n}", "stages.{n}.downsample.1", _CONV),
    (_BLOCK[0] + "/Conv_0", _BLOCK[1] + ".conv_dw", _CONV),
    (_BLOCK[0] + "/LayerNorm_0", _BLOCK[1] + ".norm", _LN),
    (_BLOCK[0] + "/Dense_0", _BLOCK[1] + ".mlp.fc1", _DENSE),
    (_BLOCK[0] + "/Dense_1", _BLOCK[1] + ".mlp.fc2", _DENSE),
    (_BLOCK[0] + "/GRN_0", _BLOCK[1] + ".mlp.grn",
     {"gamma": ("weight", "same"), "beta": ("bias", "same")}),
    (_BLOCK[0], _BLOCK[1], {"gamma": ("gamma", "same")}),
    ("norm{n}", "norm{n}", _LN),
    ("head_norm", "head.norm", _LN),
    ("head", "head.fc", _DENSE),
]


def module_pattern(template: str) -> re.Pattern:
    """A module-name template of CONVNEXT_MODULES as a regex in which each
    "{n}" captures a number and everything else is literal."""
    parts = [re.escape(p) for p in template.split("{n}")]
    return re.compile(r"(\d+)".join(parts))


def fill(template: str, numbers) -> str:
    for n in numbers:
        template = template.replace("{n}", n, 1)
    return template


def _to_torch_layout(v, kind: str) -> np.ndarray:
    v = _f32(v)
    if kind == "conv":  # flax [kh, kw, in, out] -> torch [out, in, kh, kw]
        return np.ascontiguousarray(v.transpose(3, 2, 0, 1))
    if kind == "dense":
        return _linear_w(v)
    return v


def match_module(module: str, exact: Dict, pats: List) -> Tuple:
    """(the other side's module name, its leaves) of `module` under a module
    table split by `split_modules`, or (None, {})."""
    if module in exact:
        return exact[module]
    for pat, other, leaves in pats:
        m = pat.fullmatch(module)
        if m:
            return fill(other, m.groups()), leaves
    return None, {}


def split_modules(modules) -> Tuple[Dict, List]:
    """A module table [(module, other side's module, leaves)] as ({module:
    (other, leaves)} for names without "{n}", [(regex, other, leaves)] for
    the others)."""
    exact = {a: (b, leaves) for a, b, leaves in modules if "{n}" not in a}
    pats = [(module_pattern(a), b, leaves) for a, b, leaves in modules if "{n}" in a]
    return exact, pats


def state_dict_with_sources(
    flat: Dict[str, np.ndarray], modules
) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]], List[str]]:
    """JAX flat parameters (or batch statistics) -> (the port's state_dict
    (fp32), for every produced key the JAX key it came from, the JAX keys
    that map to nothing), by a table of (JAX module, port module, leaves)."""
    exact, pats = split_modules(modules)
    sd, src, unused = {}, {}, []
    for k, v in flat.items():
        module, _, leaf = k.rpartition("/")
        port, leaves = match_module(module, exact, pats)
        if leaf in leaves:
            name, kind = leaves[leaf]
            key = f"{port}.{name}"
            sd[key] = torch.tensor(_to_torch_layout(v, kind))
            src[key] = [k]
        else:
            unused.append(k)
    return sd, src, unused


def convnext_state_dict_with_sources(flat: Dict[str, np.ndarray]):
    """JAX ConvNeXt flat parameters -> (the port's state_dict, sources,
    unused JAX keys), as `state_dict_with_sources`."""
    return state_dict_with_sources(flat, CONVNEXT_MODULES)


_BN = {"scale": ("weight", "same"), "bias": ("bias", "same"),
       "mean": ("running_mean", "same"), "var": ("running_var", "same")}
_CONV_KERNEL = {"kernel": ("weight", "conv")}


def resnet_modules(stage_sizes, block_name: str):
    """The module table of a ResNet of `stage_sizes` with blocks
    `block_name` ("BasicBlock" or "Bottleneck"): flax numbers the blocks
    across stages ({block}_{k}) and each block's convs and BatchNorms in
    order of creation, the downsample last (`Conv_{n}`, `BatchNorm_{n}` with
    n the block's conv count); torchvision numbers layer{s}.{b}."""
    n_convs = 2 if block_name == "BasicBlock" else 3
    modules = [("conv_stem", "conv1", _CONV_KERNEL), ("bn_stem", "bn1", _BN),
               ("head", "fc", _DENSE)]
    k = 0
    for s, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            jax_block, port_block = f"{block_name}_{k}", f"layer{s + 1}.{b}"
            for c in range(n_convs):
                modules += [(f"{jax_block}/Conv_{c}", f"{port_block}.conv{c + 1}", _CONV_KERNEL),
                            (f"{jax_block}/BatchNorm_{c}", f"{port_block}.bn{c + 1}", _BN)]
            modules += [(f"{jax_block}/Conv_{n_convs}", f"{port_block}.downsample.0", _CONV_KERNEL),
                        (f"{jax_block}/BatchNorm_{n_convs}", f"{port_block}.downsample.1", _BN)]
            k += 1
    return modules


def efficientvit_modules(depths, num_heads):
    """The module table of an EfficientViT of `depths` and `num_heads` a
    stage: the inverse of `torch_convert.convert_efficientvit` (the JAX
    ConvBN's Conv_0/BatchNorm_0 are the port's ConvBN `c`/`bn`, the JAX
    subsample sandwich sub{s}_* sits at indices 0-2 of the port's stage
    blocks{s+1}, and the stage's blocks follow it)."""
    modules = [("head_bn", "head.bn", _BN), ("head", "head.l", _DENSE)]

    def cbn(jax_name: str, port_name: str) -> None:
        modules.extend([(f"{jax_name}/Conv_0", f"{port_name}.c", _CONV_KERNEL),
                        (f"{jax_name}/BatchNorm_0", f"{port_name}.bn", _BN)])

    def ffn(jax_name: str, port_name: str) -> None:
        cbn(f"{jax_name}/ConvBN_0", f"{port_name}.pw1")
        cbn(f"{jax_name}/ConvBN_1", f"{port_name}.pw2")

    for i in range(4):
        cbn(f"patch_embed{i}", f"patch_embed.{2 * i}")
    for s, (depth, heads) in enumerate(zip(depths, num_heads)):
        stage, offset = f"blocks{s + 1}", 0
        if s > 0:
            merge, port_merge = f"sub{s}_merge", f"{stage}.1"
            cbn(f"sub{s}_dw0", f"{stage}.0.0.m")
            ffn(f"sub{s}_ffn0", f"{stage}.0.1.m")
            for j in range(3):
                cbn(f"{merge}/ConvBN_{j}", f"{port_merge}.conv{j + 1}")
            for j, name in enumerate(("conv_reduce", "conv_expand")):
                modules.append((f"{merge}/SqueezeExcite_0/Conv_{j}", f"{port_merge}.se.{name}",
                                _CONV))
            cbn(f"sub{s}_dw1", f"{stage}.2.0.m")
            ffn(f"sub{s}_ffn1", f"{stage}.2.1.m")
            offset = 3
        for b in range(depth):
            jax_block, port_block = f"stage{s}_block{b}", f"{stage}.{offset + b}"
            attn, port_attn = f"{jax_block}/mixer/attn", f"{port_block}.mixer.m.attn"
            cbn(f"{jax_block}/dw0", f"{port_block}.dw0.m")
            ffn(f"{jax_block}/ffn0", f"{port_block}.ffn0.m")
            modules.append((attn, port_attn, {"attention_biases": ("attention_biases", "same")}))
            for i in range(heads):
                cbn(f"{attn}/qkv{i}", f"{port_attn}.qkvs.{i}")
                cbn(f"{attn}/dw_q{i}", f"{port_attn}.dws.{i}")
            cbn(f"{attn}/proj", f"{port_attn}.proj.1")
            cbn(f"{jax_block}/dw1", f"{port_block}.dw1.m")
            ffn(f"{jax_block}/ffn1", f"{port_block}.ffn1.m")
    return modules


def vit_state_dict_from_jax(flat: Dict[str, np.ndarray], num_heads: int) -> Dict[str, torch.Tensor]:
    """Map a JAX ViT's flat parameters to the port's ViT state_dict (fp32)."""
    return vit_state_dict_with_sources(flat, num_heads)[0]
