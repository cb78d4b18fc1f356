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

Swin (`SWIN_MODULES`; the inverse of `torch_convert.convert_swin`):

    JAX flat key                                        port state_dict key
    patch_embed/*, patch_norm/*                         patch_embed.{proj,norm}.*
    stage{s}_block{b}/{norm1,norm2}/*                   layers.{s}.blocks.{b}.{norm1,norm2}.*
    stage{s}_block{b}/attn/{qkv,proj}/*                 layers.{s}.blocks.{b}.attn.{qkv,proj}.*
    stage{s}_block{b}/attn/relative_position_bias_table layers.{s}.blocks.{b}.attn.<same>
    stage{s}_block{b}/mlp/Dense_{0,1}/*                 layers.{s}.blocks.{b}.mlp.fc{1,2}.*
    merge{s}/{norm,reduction}/*                         layers.{s}.downsample.{norm,reduction}.*
    norm/*, head/*, norm{i}/* (features_only)           norm.*, head.*, norm{i}.*

UPerNet (`upernet_modules`) and the FPN neck (`FPN_MODULES`) of downstream/:
the backbone's table under backbone/ and backbone., and the heads' modules
by their JAX names, each ConvModule's conv (a kernel without bias) and bn
(scale, bias and the batch statistics mean, var):

    JAX flat key                                        port state_dict key
    backbone/<ConvNeXt or Swin key>                     backbone.<its port key>
    decode_head/{lateral,fpn}{i}/{conv,bn}/*            decode_head.{lateral,fpn}{i}.{conv,bn}.*
    decode_head/ppm/{pool{i},bottleneck}/{conv,bn}/*    decode_head.ppm.{pool{i},bottleneck}.*
    decode_head/fuse/{conv,bn}/*                        decode_head.fuse.{conv,bn}.*
    {decode,auxiliary}_head/conv_seg/{kernel,bias}      {decode,auxiliary}_head.conv_seg.*
    auxiliary_head/conv0/{conv,bn}/*                    auxiliary_head.conv0.{conv,bn}.*
    lateral{i}/*, fpn{i}/* (FPN)                        lateral{i}.*, fpn{i}.*

MobileNetV3, EfficientNet and DenseNet (`mobilenetv3_modules`,
`efficientnet_modules`, `densenet_modules`; the inverses of
`convert_mobilenetv3`, `convert_efficientnet` and `convert_densenet`, their
batch statistics with the parameters). Their squeeze-excitations are Dense
layers in JAX ([in, out] kernels) and 1x1 convs with bias in
torchvision/timm ([out, in, 1, 1]): the "pointwise" layout.
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
    if kind == "pointwise":  # flax Dense [in, out] -> torch 1x1 conv [out, in, 1, 1]
        return _linear_w(v)[:, :, None, None]
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


_SWIN_BLOCK = ("stage{n}_block{n}", "layers.{n}.blocks.{n}")
SWIN_MODULES = [
    ("patch_embed", "patch_embed.proj", _CONV),
    ("patch_norm", "patch_embed.norm", _LN),
    (_SWIN_BLOCK[0] + "/norm1", _SWIN_BLOCK[1] + ".norm1", _LN),
    (_SWIN_BLOCK[0] + "/norm2", _SWIN_BLOCK[1] + ".norm2", _LN),
    (_SWIN_BLOCK[0] + "/attn/qkv", _SWIN_BLOCK[1] + ".attn.qkv", _DENSE),
    (_SWIN_BLOCK[0] + "/attn/proj", _SWIN_BLOCK[1] + ".attn.proj", _DENSE),
    (_SWIN_BLOCK[0] + "/attn", _SWIN_BLOCK[1] + ".attn",
     {"relative_position_bias_table": ("relative_position_bias_table", "same")}),
    (_SWIN_BLOCK[0] + "/mlp/Dense_0", _SWIN_BLOCK[1] + ".mlp.fc1", _DENSE),
    (_SWIN_BLOCK[0] + "/mlp/Dense_1", _SWIN_BLOCK[1] + ".mlp.fc2", _DENSE),
    ("merge{n}/norm", "layers.{n}.downsample.norm", _LN),
    ("merge{n}/reduction", "layers.{n}.downsample.reduction", {"kernel": ("weight", "dense")}),
    ("norm", "norm", _LN),
    ("norm{n}", "norm{n}", _LN),
    ("head", "head", _DENSE),
]
_POINTWISE = {"kernel": ("weight", "pointwise"), "bias": ("bias", "same")}


def _conv_bn(modules: list, jax_conv: str, jax_bn: str, port_conv: str, port_bn: str) -> None:
    modules.extend([(jax_conv, port_conv, _CONV_KERNEL), (jax_bn, port_bn, _BN)])


def mobilenetv3_modules(cfgs):
    """The module table of a MobileNetV3 of block table `cfgs`: block i is
    torchvision's features.{i+1}, whose sub-index j counts the expand conv
    (where the block has one), the depthwise conv, the SE (where it has
    one) and the project conv in turn."""
    modules = [("pre_head", "classifier.0", _DENSE), ("head", "classifier.3", _DENSE)]
    _conv_bn(modules, "stem_conv", "stem_bn", "features.0.0", "features.0.1")
    for i, c in enumerate(cfgs):
        jax_block, port_block = f"block_{i}", f"features.{i + 1}.block"
        j = 0
        parts = (["expand"] if c.expanded != c.in_ch else []) + ["dw"] + (
            ["se"] if c.use_se else []) + ["project"]
        for part in parts:
            if part == "se":
                modules += [(f"{jax_block}/se_fc{n}", f"{port_block}.{j}.fc{n}", _POINTWISE)
                            for n in (1, 2)]
            else:
                _conv_bn(modules, f"{jax_block}/{part}_conv", f"{jax_block}/{part}_bn",
                         f"{port_block}.{j}.0", f"{port_block}.{j}.1")
            j += 1
    last = len(cfgs) + 1
    _conv_bn(modules, "conv_last", "bn_last", f"features.{last}.0", f"features.{last}.1")
    return modules


def efficientnet_modules(stage_repeats, expands):
    """The module table of an EfficientNet whose stage s has
    `stage_repeats[s]` blocks of expand ratio `expands[s]`: the JAX blocks
    block_{i} numbered across stages, timm's blocks.{s}.{j}; a
    depthwise-separable block (expand 1) names its convs and BatchNorms
    conv_dw/bn1, conv_pw/bn2 in timm, an inverted residual conv_pw/bn1,
    conv_dw/bn2, conv_pwl/bn3."""
    modules = [("head", "classifier", _DENSE)]
    _conv_bn(modules, "conv_stem", "bn_stem", "conv_stem", "bn1")
    _conv_bn(modules, "conv_head", "bn_head", "conv_head", "bn2")
    i = 0
    for s, (repeats, e) in enumerate(zip(stage_repeats, expands)):
        for j in range(repeats):
            jb, pb = f"block_{i}", f"blocks.{s}.{j}"
            pairs = ([("dw", "conv_dw", "bn1"), ("pwl", "conv_pw", "bn2")] if e == 1 else
                     [("pw", "conv_pw", "bn1"), ("dw", "conv_dw", "bn2"),
                      ("pwl", "conv_pwl", "bn3")])
            for part, conv, bn in pairs:
                _conv_bn(modules, f"{jb}/conv_{part}", f"{jb}/bn_{part}", f"{pb}.{conv}",
                         f"{pb}.{bn}")
            modules += [(f"{jb}/se_reduce", f"{pb}.se.conv_reduce", _POINTWISE),
                        (f"{jb}/se_expand", f"{pb}.se.conv_expand", _POINTWISE)]
            i += 1
    return modules


def densenet_modules(block_config):
    """The module table of a DenseNet of `block_config`: the JAX
    block{i}_layer{j} and transition{i}_* from 0, torchvision's
    features.denseblock{i}.denselayer{j} and features.transition{i} from
    1."""
    modules = [("conv0", "features.conv0", _CONV_KERNEL), ("norm0", "features.norm0", _BN),
               ("norm5", "features.norm5", _BN), ("head", "classifier", _DENSE)]
    for i, layers in enumerate(block_config):
        for j in range(layers):
            jl, pl = f"block{i}_layer{j}", f"features.denseblock{i + 1}.denselayer{j + 1}"
            for n in (1, 2):
                modules += [(f"{jl}/norm{n}", f"{pl}.norm{n}", _BN),
                            (f"{jl}/conv{n}", f"{pl}.conv{n}", _CONV_KERNEL)]
        if i != len(block_config) - 1:
            _conv_bn(modules, f"transition{i}_conv", f"transition{i}_norm",
                     f"features.transition{i + 1}.conv", f"features.transition{i + 1}.norm")
    return modules


def _conv_module(jax_name: str, port_name: str):
    """The rows of one UPerNet ConvModule (conv without bias, BatchNorm)."""
    return [(f"{jax_name}/conv", f"{port_name}.conv", _CONV_KERNEL),
            (f"{jax_name}/bn", f"{port_name}.bn", _BN)]


# UPerNet's heads (downstream/upernet.py): the JAX names, "." for "/"
UPERNET_HEAD_MODULES = [
    *_conv_module("decode_head/lateral{n}", "decode_head.lateral{n}"),
    *_conv_module("decode_head/ppm/pool{n}", "decode_head.ppm.pool{n}"),
    *_conv_module("decode_head/ppm/bottleneck", "decode_head.ppm.bottleneck"),
    *_conv_module("decode_head/fpn{n}", "decode_head.fpn{n}"),
    *_conv_module("decode_head/fuse", "decode_head.fuse"),
    ("decode_head/conv_seg", "decode_head.conv_seg", _CONV),
    *_conv_module("auxiliary_head/conv0", "auxiliary_head.conv0"),
    ("auxiliary_head/conv_seg", "auxiliary_head.conv_seg", _CONV),
]
# the detection neck (downstream/fpn.py): convs with bias
FPN_MODULES = [("lateral{n}", "lateral{n}", _CONV), ("fpn{n}", "fpn{n}", _CONV)]


def upernet_modules(backbone_modules):
    """The module table of a UPerNet whose backbone has the table
    `backbone_modules` (ConvNeXt's or Swin's): the backbone's rows under
    backbone/ (JAX) and backbone. (port), then the heads'."""
    return [(f"backbone/{j}", f"backbone.{p}", leaves) for j, p, leaves in backbone_modules] + \
        UPERNET_HEAD_MODULES


def vit_state_dict_from_jax(flat: Dict[str, np.ndarray], num_heads: int) -> Dict[str, torch.Tensor]:
    """Map a JAX ViT's flat parameters to the port's ViT state_dict (fp32)."""
    return vit_state_dict_with_sources(flat, num_heads)[0]
