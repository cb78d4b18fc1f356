"""torch/timm state_dict -> the JAX package's flat layout (port of
imageclassification_tpu/checkpoint/torch_convert.py for the ported
families), so a locally downloaded hub file fine-tunes through
`train.py --pretrained_path`:

    python -m imageclassification_tpu_torch.train --data_path <ImageFolder> \\
        --model vit_base_patch16_224 --input_size 384 --pretrained_path vit_b16.pth
    python -m imageclassification_tpu_torch.checkpoint.torch_convert \\
        --src resnet50.pth --model resnet50 --out resnet50_repo.pth

Layouts (key naming families), each converted by pure numpy on a {key:
ndarray} dict:
  * ResNet, ResNeXt, wide ResNet: torchvision == timm naming
    (conv1/bn1/layer{1-4}.{i}.conv{1-3}/downsample/fc);
  * ConvNeXt and ConvNeXt-V2: facebookresearch naming (downsample_layers/
    stages.i.j.dwconv/pwconv1/pwconv2/gamma/grn/norm/head) and timm naming
    (stem/stages.i.blocks.j.conv_dw/mlp.fc1/mlp.grn/...);
  * ViT: timm naming (cls_token/pos_embed/patch_embed.proj/blocks.{i}.norm1/
    attn.qkv/attn.proj/norm2/mlp.fc1/fc2/norm/head);
  * EfficientViT (MSRA): microsoft/Cream naming (patch_embed.{0,2,4,6},
    blocks{1-3} with Residual/Conv2d_BN/FFN/CascadedGroupAttention
    submodules, BN_Linear head);
  * MobileNetV3: torchvision naming (features.N.block...; a timm-layout
    file raises ValueError, as in the JAX package);
  * EfficientNet B0-B4: timm naming (conv_stem/bn1/blocks.{s}.{j}/conv_head);
  * Swin: timm's classic naming (patch_embed/layers.{s}.blocks.{b}/
    layers.{s}.downsample/norm/head);
  * DenseNet: torchvision naming (features.denseblock{i}.denselayer{j}/
    features.transition{i}/classifier).

The result is the JAX package's flat parameter tree ("a/b/c" keys), which
`checkpoint/io.load_params_with_pruning` carries onto the port's model,
dropping what does not match by name and shape with the JAX package's
`Skipping mismatched key:` print (a head of another class count, say).
"""

from __future__ import annotations

import argparse
import math
import pickle
import re
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import vit
from ..models.densenet import _CONFIGS
from ..models.efficientnet import _B0_STAGES, _VARIANTS
from ..models.mobilenetv3 import _LARGE, _SMALL
from .io import _dequantize_weights

Flat = Dict[str, np.ndarray]


def _t(x: np.ndarray) -> np.ndarray:
    """torch Linear weight [out, in] -> flax Dense kernel [in, out]."""
    return np.ascontiguousarray(x.T)


def _conv(x: np.ndarray) -> np.ndarray:
    """torch Conv2d weight [out, in, kh, kw] -> flax [kh, kw, in, out]."""
    return np.ascontiguousarray(x.transpose(2, 3, 1, 0))


def _np(sd: dict) -> Flat:
    """Coerce tensors (torch or numpy) to numpy arrays."""
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


# --------------------------------------------------------------------- ResNet


_RESNET_STAGES = {
    "resnet18": [2, 2, 2, 2], "resnet34": [3, 4, 6, 3],
    "resnet50": [3, 4, 6, 3], "resnet101": [3, 4, 23, 3],
    "resnet152": [3, 8, 36, 3],
    # torchvision's ResNeXt and wide variants share the key naming; only the
    # tensor shapes differ (grouped 3x3, doubled width)
    "resnext50_32x4d": [3, 4, 6, 3], "resnext101_32x8d": [3, 4, 23, 3],
    "wide_resnet50_2": [3, 4, 6, 3], "wide_resnet101_2": [3, 4, 23, 3],
}
_BASIC = {"resnet18", "resnet34"}


def convert_resnet(sd: Flat, model_name: str) -> Tuple[Flat, Flat]:
    stages = _RESNET_STAGES[model_name]
    block = "BasicBlock" if model_name in _BASIC else "Bottleneck"
    n_convs = 2 if model_name in _BASIC else 3
    params: Flat = {}
    stats: Flat = {}

    def bn(dst: str, src: str) -> None:
        params[f"{dst}/scale"] = sd[f"{src}.weight"]
        params[f"{dst}/bias"] = sd[f"{src}.bias"]
        stats[f"{dst}/mean"] = sd[f"{src}.running_mean"]
        stats[f"{dst}/var"] = sd[f"{src}.running_var"]

    params["conv_stem/kernel"] = _conv(sd["conv1.weight"])
    bn("bn_stem", "bn1")

    k = 0
    for s, n_blocks in enumerate(stages):
        for b in range(n_blocks):
            dst = f"{block}_{k}"
            src = f"layer{s + 1}.{b}"
            for c in range(n_convs):
                params[f"{dst}/Conv_{c}/kernel"] = _conv(sd[f"{src}.conv{c + 1}.weight"])
                bn(f"{dst}/BatchNorm_{c}", f"{src}.bn{c + 1}")
            if f"{src}.downsample.0.weight" in sd:
                params[f"{dst}/Conv_{n_convs}/kernel"] = _conv(sd[f"{src}.downsample.0.weight"])
                bn(f"{dst}/BatchNorm_{n_convs}", f"{src}.downsample.1")
            k += 1

    params["head/kernel"] = _t(sd["fc.weight"])
    params["head/bias"] = sd["fc.bias"]
    return params, stats


# ------------------------------------------------------------------- ConvNeXt


def convert_convnext(sd: Flat, model_name: str) -> Tuple[Flat, Flat]:
    params: Flat = {}
    fb = "downsample_layers.0.0.weight" in sd  # facebookresearch naming

    def ln(dst: str, src: str) -> None:
        params[f"{dst}/scale"] = sd[f"{src}.weight"]
        params[f"{dst}/bias"] = sd[f"{src}.bias"]

    if fb:
        params["stem_conv/kernel"] = _conv(sd["downsample_layers.0.0.weight"])
        params["stem_conv/bias"] = sd["downsample_layers.0.0.bias"]
        ln("stem_norm", "downsample_layers.0.1")
        for i in (1, 2, 3):
            ln(f"downsample_norm{i}", f"downsample_layers.{i}.0")
            params[f"downsample_conv{i}/kernel"] = _conv(sd[f"downsample_layers.{i}.1.weight"])
            params[f"downsample_conv{i}/bias"] = sd[f"downsample_layers.{i}.1.bias"]
    else:  # timm
        params["stem_conv/kernel"] = _conv(sd["stem.0.weight"])
        params["stem_conv/bias"] = sd["stem.0.bias"]
        ln("stem_norm", "stem.1")
        for i in (1, 2, 3):
            ln(f"downsample_norm{i}", f"stages.{i}.downsample.0")
            params[f"downsample_conv{i}/kernel"] = _conv(sd[f"stages.{i}.downsample.1.weight"])
            params[f"downsample_conv{i}/bias"] = sd[f"stages.{i}.downsample.1.bias"]

    # blocks: fb 'stages.{s}.{b}.<dwconv|norm|pwconv1|pwconv2|gamma>'
    #         timm 'stages.{s}.blocks.{b}.<conv_dw|norm|mlp.fc1|mlp.fc2|gamma>'
    pat = (re.compile(r"stages\.(\d+)\.(\d+)\.dwconv\.weight") if fb
           else re.compile(r"stages\.(\d+)\.blocks\.(\d+)\.conv_dw\.weight"))
    names = ({"dw": "dwconv", "fc1": "pwconv1", "fc2": "pwconv2"} if fb
             else {"dw": "conv_dw", "fc1": "mlp.fc1", "fc2": "mlp.fc2"})
    for key in sd:
        m = pat.fullmatch(key)
        if not m:
            continue
        s, b = int(m.group(1)), int(m.group(2))
        src = f"stages.{s}.{b}" if fb else f"stages.{s}.blocks.{b}"
        dst = f"stage{s}_block{b}"
        params[f"{dst}/Conv_0/kernel"] = _conv(sd[f"{src}.{names['dw']}.weight"])
        params[f"{dst}/Conv_0/bias"] = sd[f"{src}.{names['dw']}.bias"]
        ln(f"{dst}/LayerNorm_0", f"{src}.norm")
        params[f"{dst}/Dense_0/kernel"] = _t(sd[f"{src}.{names['fc1']}.weight"])
        params[f"{dst}/Dense_0/bias"] = sd[f"{src}.{names['fc1']}.bias"]
        params[f"{dst}/Dense_1/kernel"] = _t(sd[f"{src}.{names['fc2']}.weight"])
        params[f"{dst}/Dense_1/bias"] = sd[f"{src}.{names['fc2']}.bias"]
        if f"{src}.gamma" in sd:
            params[f"{dst}/gamma"] = sd[f"{src}.gamma"]
        # ConvNeXt-V2: GRN on the MLP hidden (fb 'grn.gamma'/'grn.beta'
        # stored [1,1,1,4C]; timm 'mlp.grn.weight'/'mlp.grn.bias')
        for g_src, b_src in ((f"{src}.grn.gamma", f"{src}.grn.beta"),
                             (f"{src}.mlp.grn.weight", f"{src}.mlp.grn.bias")):
            if g_src in sd:
                params[f"{dst}/GRN_0/gamma"] = sd[g_src].reshape(-1)
                params[f"{dst}/GRN_0/beta"] = sd[b_src].reshape(-1)
                break

    if "norm.weight" in sd:  # fb head norm
        ln("head_norm", "norm")
    elif "head.norm.weight" in sd:  # timm
        ln("head_norm", "head.norm")
    for head in ("head", "head.fc"):
        if f"{head}.weight" in sd:
            params["head/kernel"] = _t(sd[f"{head}.weight"])
            params["head/bias"] = sd[f"{head}.bias"]
            break
    return params, {}


# ------------------------------------------------------------------------ ViT


def convert_vit(sd: Flat, model_name: str) -> Tuple[Flat, Flat]:
    params: Flat = {}
    embed_dim = sd["cls_token"].shape[-1]
    # timm fuses q, k, v into one [3E, E] matrix
    qkv_w = sd["blocks.0.attn.qkv.weight"]
    if qkv_w.shape[0] != 3 * embed_dim:
        raise ValueError(f"blocks.0.attn.qkv.weight {qkv_w.shape}: not a fused qkv of "
                         f"width {embed_dim}")
    # the head count comes from the target model (a fixed head_dim of 64
    # would mis-reshape q/k/v for any other ratio); an unknown name falls
    # back to the standard head_dim
    ctor = getattr(vit, model_name.removesuffix("_224"), None)
    n_heads = getattr(ctor, "num_heads", embed_dim // 64)
    head_dim = embed_dim // n_heads

    params["cls_token"] = sd["cls_token"]
    params["pos_embed"] = sd["pos_embed"]
    params["patch_embed/kernel"] = _conv(sd["patch_embed.proj.weight"])
    params["patch_embed/bias"] = sd["patch_embed.proj.bias"]

    def ln(dst: str, src: str) -> None:
        params[f"{dst}/scale"] = sd[f"{src}.weight"]
        params[f"{dst}/bias"] = sd[f"{src}.bias"]

    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        src = f"blocks.{i}"
        dst = f"block{i}"
        attn = f"{dst}/MultiHeadDotProductAttention_0"
        ln(f"{dst}/LayerNorm_0", f"{src}.norm1")
        ln(f"{dst}/LayerNorm_1", f"{src}.norm2")
        w = sd[f"{src}.attn.qkv.weight"]        # [3E, E]
        b = sd[f"{src}.attn.qkv.bias"]          # [3E]
        for j, name in enumerate(("query", "key", "value")):
            wj = w[j * embed_dim:(j + 1) * embed_dim]     # [E, E] (out, in)
            params[f"{attn}/{name}/kernel"] = _t(wj).reshape(embed_dim, n_heads, head_dim)
            params[f"{attn}/{name}/bias"] = b[j * embed_dim:(j + 1) * embed_dim].reshape(
                n_heads, head_dim)
        wo = sd[f"{src}.attn.proj.weight"]      # [E, E] (out, in)
        params[f"{attn}/out/kernel"] = _t(wo).reshape(n_heads, head_dim, embed_dim)
        params[f"{attn}/out/bias"] = sd[f"{src}.attn.proj.bias"]
        params[f"{dst}/Mlp_0/Dense_0/kernel"] = _t(sd[f"{src}.mlp.fc1.weight"])
        params[f"{dst}/Mlp_0/Dense_0/bias"] = sd[f"{src}.mlp.fc1.bias"]
        params[f"{dst}/Mlp_0/Dense_1/kernel"] = _t(sd[f"{src}.mlp.fc2.weight"])
        params[f"{dst}/Mlp_0/Dense_1/bias"] = sd[f"{src}.mlp.fc2.bias"]
        i += 1

    ln("norm", "norm")
    if "head.weight" in sd:
        params["head/kernel"] = _t(sd["head.weight"])
        params["head/bias"] = sd["head.bias"]
    return params, {}


# ------------------------------------------------------------- EfficientViT


def convert_efficientvit(sd: Flat, model_name: str) -> Tuple[Flat, Flat]:
    """MSRA EfficientViT (Cream repo / hub .pth) layout -> the JAX layout.

    Source naming (microsoft/Cream EfficientViT classification model, which
    the port's models/efficientvit.py keeps):
      patch_embed.{0,2,4,6}.{c,bn}            4x Conv2d_BN stem
      blocks{1,2,3}.{i}...                    stages; in blocks2/blocks3 the
        first three entries are the subsample sandwich (Sequential(Residual
        dw, Residual FFN), PatchMerging, Sequential(Residual dw, Residual
        FFN)), then EfficientViTBlocks
      <block>.{dw0,dw1}.m.{c,bn}              Residual depthwise Conv2d_BN
      <block>.{ffn0,ffn1}.m.{pw1,pw2}.{c,bn}  Residual FFN
      <block>.mixer.m.attn.{qkvs.i,dws.i}.{c,bn} cascaded group attention
      <block>.mixer.m.attn.proj.1.{c,bn}      ReLU->Conv2d_BN projection
      <block>.mixer.m.attn.attention_biases   [heads, n_offsets]
      head.{bn,l}                             BN_Linear classifier
    """
    params: Flat = {}
    stats: Flat = {}

    def cbn(dst: str, src: str) -> None:
        """Conv2d_BN (attrs c + bn) -> ConvBN (Conv_0 + BatchNorm_0)."""
        params[f"{dst}/Conv_0/kernel"] = _conv(sd[f"{src}.c.weight"])
        params[f"{dst}/BatchNorm_0/scale"] = sd[f"{src}.bn.weight"]
        params[f"{dst}/BatchNorm_0/bias"] = sd[f"{src}.bn.bias"]
        stats[f"{dst}/BatchNorm_0/mean"] = sd[f"{src}.bn.running_mean"]
        stats[f"{dst}/BatchNorm_0/var"] = sd[f"{src}.bn.running_var"]

    def block(dst: str, src: str) -> None:
        cbn(f"{dst}/dw0", f"{src}.dw0.m")
        cbn(f"{dst}/ffn0/ConvBN_0", f"{src}.ffn0.m.pw1")
        cbn(f"{dst}/ffn0/ConvBN_1", f"{src}.ffn0.m.pw2")
        attn_src = f"{src}.mixer.m.attn"
        attn_dst = f"{dst}/mixer/attn"
        params[f"{attn_dst}/attention_biases"] = sd[f"{attn_src}.attention_biases"]
        i = 0
        while f"{attn_src}.qkvs.{i}.c.weight" in sd:
            cbn(f"{attn_dst}/qkv{i}", f"{attn_src}.qkvs.{i}")
            cbn(f"{attn_dst}/dw_q{i}", f"{attn_src}.dws.{i}")
            i += 1
        cbn(f"{attn_dst}/proj", f"{attn_src}.proj.1")
        cbn(f"{dst}/dw1", f"{src}.dw1.m")
        cbn(f"{dst}/ffn1/ConvBN_0", f"{src}.ffn1.m.pw1")
        cbn(f"{dst}/ffn1/ConvBN_1", f"{src}.ffn1.m.pw2")

    for i, t in enumerate((0, 2, 4, 6)):
        cbn(f"patch_embed{i}", f"patch_embed.{t}")

    for s in range(3):
        src_stage = f"blocks{s + 1}"
        offset = 0
        if s > 0:
            # the subsample sandwich in front of stage s (indices 0, 1, 2)
            cbn(f"sub{s}_dw0", f"{src_stage}.0.0.m")
            cbn(f"sub{s}_ffn0/ConvBN_0", f"{src_stage}.0.1.m.pw1")
            cbn(f"sub{s}_ffn0/ConvBN_1", f"{src_stage}.0.1.m.pw2")
            merge = f"{src_stage}.1"
            cbn(f"sub{s}_merge/ConvBN_0", f"{merge}.conv1")
            cbn(f"sub{s}_merge/ConvBN_1", f"{merge}.conv2")
            se = f"{merge}.se"
            for j, names in enumerate((("fc1", "conv_reduce"), ("fc2", "conv_expand"))):
                src_se = next(f"{se}.{n}" for n in names if f"{se}.{n}.weight" in sd)
                params[f"sub{s}_merge/SqueezeExcite_0/Conv_{j}/kernel"] = _conv(
                    sd[f"{src_se}.weight"])
                params[f"sub{s}_merge/SqueezeExcite_0/Conv_{j}/bias"] = sd[f"{src_se}.bias"]
            cbn(f"sub{s}_merge/ConvBN_2", f"{merge}.conv3")
            cbn(f"sub{s}_dw1", f"{src_stage}.2.0.m")
            cbn(f"sub{s}_ffn1/ConvBN_0", f"{src_stage}.2.1.m.pw1")
            cbn(f"sub{s}_ffn1/ConvBN_1", f"{src_stage}.2.1.m.pw2")
            offset = 3
        b = 0
        while f"{src_stage}.{offset + b}.dw0.m.c.weight" in sd:
            block(f"stage{s}_block{b}", f"{src_stage}.{offset + b}")
            b += 1

    params["head_bn/scale"] = sd["head.bn.weight"]
    params["head_bn/bias"] = sd["head.bn.bias"]
    stats["head_bn/mean"] = sd["head.bn.running_mean"]
    stats["head_bn/var"] = sd["head.bn.running_var"]
    params["head/kernel"] = _t(sd["head.l.weight"])
    params["head/bias"] = sd["head.l.bias"]
    return params, stats


# --------------------------------------------------------------- MobileNetV3


def convert_mobilenetv3(sd: Flat, model_name: str) -> Tuple[Flat, Flat]:
    """torchvision mobilenet_v3_{large,small} state_dict -> the JAX layout.

    Source naming (torchvision/models/mobilenetv3.py):
      features.0.{0,1}                 stem Conv2dNormActivation
      features.{i}.block.{j}.{0,1}     expand? / depthwise / project convs
      features.{i}.block.{j}.fc{1,2}   SqueezeExcitation 1x1 convs (w/ bias)
      features.{last}.{0,1}            final 1x1 Conv2dNormActivation
      classifier.{0,3}                 Linear / Linear
    The block sub-index j shifts by whether the expand conv and SE exist, so
    the walk mirrors torchvision's layer-append order."""

    if "features.0.0.weight" not in sd:
        hint = ("timm-layout (conv_stem.*/blocks.*)"
                if any(k.startswith(("conv_stem", "blocks.")) for k in sd)
                else "unrecognized-layout")
        raise ValueError(
            f"convert_mobilenetv3 supports torchvision-layout state_dicts "
            f"only (features.N.block... keys); got a {hint} state_dict. "
            f"Export from torchvision.models.mobilenet_v3_* instead."
        )
    cfgs = _SMALL if "small" in model_name else _LARGE
    params: Flat = {}
    stats: Flat = {}

    def bn(dst: str, src: str) -> None:
        params[f"{dst}/scale"] = sd[f"{src}.weight"]
        params[f"{dst}/bias"] = sd[f"{src}.bias"]
        stats[f"{dst}/mean"] = sd[f"{src}.running_mean"]
        stats[f"{dst}/var"] = sd[f"{src}.running_var"]

    params["stem_conv/kernel"] = _conv(sd["features.0.0.weight"])
    bn("stem_bn", "features.0.1")

    for i, c in enumerate(cfgs):
        dst = f"block_{i}"
        src = f"features.{i + 1}.block"
        j = 0
        if c.expanded != c.in_ch:
            params[f"{dst}/expand_conv/kernel"] = _conv(sd[f"{src}.{j}.0.weight"])
            bn(f"{dst}/expand_bn", f"{src}.{j}.1")
            j += 1
        params[f"{dst}/dw_conv/kernel"] = _conv(sd[f"{src}.{j}.0.weight"])
        bn(f"{dst}/dw_bn", f"{src}.{j}.1")
        j += 1
        if c.use_se:
            for fc in ("fc1", "fc2"):
                w = sd[f"{src}.{j}.{fc}.weight"]  # [out, in, 1, 1] 1x1 conv
                params[f"{dst}/se_{fc}/kernel"] = _t(w[:, :, 0, 0])
                params[f"{dst}/se_{fc}/bias"] = sd[f"{src}.{j}.{fc}.bias"]
            j += 1
        params[f"{dst}/project_conv/kernel"] = _conv(sd[f"{src}.{j}.0.weight"])
        bn(f"{dst}/project_bn", f"{src}.{j}.1")

    last = len(cfgs) + 1
    params["conv_last/kernel"] = _conv(sd[f"features.{last}.0.weight"])
    bn("bn_last", f"features.{last}.1")
    params["pre_head/kernel"] = _t(sd["classifier.0.weight"])
    params["pre_head/bias"] = sd["classifier.0.bias"]
    params["head/kernel"] = _t(sd["classifier.3.weight"])
    params["head/bias"] = sd["classifier.3.bias"]
    return params, stats


# -------------------------------------------------------------- EfficientNet


def convert_efficientnet(sd: Flat, model_name: str) -> Tuple[Flat, Flat]:
    """timm efficientnet_b{0..4} state_dict -> the JAX layout.

    Source naming (timm/models/efficientnet.py, non-TF variants):
      conv_stem / bn1                        stem
      blocks.{s}.{j}.conv_dw/bn1, se.conv_reduce/conv_expand, conv_pw/bn2
                                             stage-0 DepthwiseSeparableConv
      blocks.{s}.{j}.conv_pw/bn1, conv_dw/bn2, se.*, conv_pwl/bn3
                                             InvertedResidual (expand>1)
      conv_head / bn2 (top level)            pre-pool 1x1
      classifier                             Linear head
    The JAX model numbers its blocks block_{i} across stages, so the walk
    recomputes the per-variant repeat counts."""
    _, depth_mult = _VARIANTS[model_name]
    params: Flat = {}
    stats: Flat = {}

    def bn(dst: str, src: str) -> None:
        params[f"{dst}/scale"] = sd[f"{src}.weight"]
        params[f"{dst}/bias"] = sd[f"{src}.bias"]
        stats[f"{dst}/mean"] = sd[f"{src}.running_mean"]
        stats[f"{dst}/var"] = sd[f"{src}.running_var"]

    def se(dst: str, src: str) -> None:
        for t_name, f_name in (("conv_reduce", "se_reduce"),
                               ("conv_expand", "se_expand")):
            w = sd[f"{src}.se.{t_name}.weight"]  # [out, in, 1, 1] 1x1 conv
            params[f"{dst}/{f_name}/kernel"] = _t(w[:, :, 0, 0])
            params[f"{dst}/{f_name}/bias"] = sd[f"{src}.se.{t_name}.bias"]

    params["conv_stem/kernel"] = _conv(sd["conv_stem.weight"])
    bn("bn_stem", "bn1")

    i = 0
    for s, (k, _, e, c, r) in enumerate(_B0_STAGES):
        for j in range(int(math.ceil(r * depth_mult))):
            dst = f"block_{i}"
            src = f"blocks.{s}.{j}"
            if e == 1:  # DepthwiseSeparableConv: dw/bn1, se, pw/bn2
                params[f"{dst}/conv_dw/kernel"] = _conv(sd[f"{src}.conv_dw.weight"])
                bn(f"{dst}/bn_dw", f"{src}.bn1")
                se(dst, src)
                params[f"{dst}/conv_pwl/kernel"] = _conv(sd[f"{src}.conv_pw.weight"])
                bn(f"{dst}/bn_pwl", f"{src}.bn2")
            else:       # InvertedResidual: pw/bn1, dw/bn2, se, pwl/bn3
                params[f"{dst}/conv_pw/kernel"] = _conv(sd[f"{src}.conv_pw.weight"])
                bn(f"{dst}/bn_pw", f"{src}.bn1")
                params[f"{dst}/conv_dw/kernel"] = _conv(sd[f"{src}.conv_dw.weight"])
                bn(f"{dst}/bn_dw", f"{src}.bn2")
                se(dst, src)
                params[f"{dst}/conv_pwl/kernel"] = _conv(sd[f"{src}.conv_pwl.weight"])
                bn(f"{dst}/bn_pwl", f"{src}.bn3")
            i += 1

    params["conv_head/kernel"] = _conv(sd["conv_head.weight"])
    bn("bn_head", "bn2")
    params["head/kernel"] = _t(sd["classifier.weight"])
    params["head/bias"] = sd["classifier.bias"]
    return params, stats


# ---------------------------------------------------------------------- Swin


_SWIN_DEPTHS = {
    "swin_tiny": (2, 2, 6, 2),
    "swin_small": (2, 2, 18, 2),
    "swin_base": (2, 2, 18, 2),
}


def convert_swin(sd: Flat, model_name: str) -> Tuple[Flat, Flat]:
    """timm swin_{tiny,small,base}_patch4_window7_224 state_dict -> the JAX
    layout.

    Source naming (timm/models/swin_transformer.py, classic layout):
      patch_embed.proj / patch_embed.norm
      layers.{s}.blocks.{b}.{norm1,attn.qkv,attn.proj,
        attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}
      layers.{s}.downsample.{norm,reduction}   (end of stage s => merge{s})
      norm / head
    attn.relative_position_index buffers are skipped — the model makes
    its own index."""
    variant = "_".join(model_name.split("_")[:2])
    depths = _SWIN_DEPTHS[variant]
    params: Flat = {}
    stats: Flat = {}

    def ln(dst: str, src: str) -> None:
        params[f"{dst}/scale"] = sd[f"{src}.weight"]
        params[f"{dst}/bias"] = sd[f"{src}.bias"]

    def dense(dst: str, src: str, bias: bool = True) -> None:
        params[f"{dst}/kernel"] = _t(sd[f"{src}.weight"])
        if bias:
            params[f"{dst}/bias"] = sd[f"{src}.bias"]

    params["patch_embed/kernel"] = _conv(sd["patch_embed.proj.weight"])
    params["patch_embed/bias"] = sd["patch_embed.proj.bias"]
    ln("patch_norm", "patch_embed.norm")

    for s, depth in enumerate(depths):
        for b in range(depth):
            dst = f"stage{s}_block{b}"
            src = f"layers.{s}.blocks.{b}"
            ln(f"{dst}/norm1", f"{src}.norm1")
            dense(f"{dst}/attn/qkv", f"{src}.attn.qkv")
            params[f"{dst}/attn/relative_position_bias_table"] = sd[
                f"{src}.attn.relative_position_bias_table"
            ]
            dense(f"{dst}/attn/proj", f"{src}.attn.proj")
            ln(f"{dst}/norm2", f"{src}.norm2")
            dense(f"{dst}/mlp/Dense_0", f"{src}.mlp.fc1")
            dense(f"{dst}/mlp/Dense_1", f"{src}.mlp.fc2")
        if f"layers.{s}.downsample.reduction.weight" in sd:
            ln(f"merge{s}/norm", f"layers.{s}.downsample.norm")
            dense(f"merge{s}/reduction", f"layers.{s}.downsample.reduction",
                  bias=False)

    ln("norm", "norm")
    dense("head", "head")
    return params, stats


# ------------------------------------------------------------------ DenseNet


def convert_densenet(sd: Flat, model_name: str) -> Tuple[Flat, Flat]:
    """torchvision densenet{121,169,201} state_dict -> the JAX layout.

    Source naming (torchvision/models/densenet.py):
      features.conv0 / features.norm0
      features.denseblock{i}.denselayer{j}.{norm1,conv1,norm2,conv2}  (1-based)
      features.transition{i}.{norm,conv}
      features.norm5 / classifier"""
    cfg = _CONFIGS[model_name]
    params: Flat = {}
    stats: Flat = {}

    def bn(dst: str, src: str) -> None:
        params[f"{dst}/scale"] = sd[f"{src}.weight"]
        params[f"{dst}/bias"] = sd[f"{src}.bias"]
        stats[f"{dst}/mean"] = sd[f"{src}.running_mean"]
        stats[f"{dst}/var"] = sd[f"{src}.running_var"]

    params["conv0/kernel"] = _conv(sd["features.conv0.weight"])
    bn("norm0", "features.norm0")
    for i, layers in enumerate(cfg):
        for j in range(layers):
            dst = f"block{i}_layer{j}"
            src = f"features.denseblock{i + 1}.denselayer{j + 1}"
            bn(f"{dst}/norm1", f"{src}.norm1")
            params[f"{dst}/conv1/kernel"] = _conv(sd[f"{src}.conv1.weight"])
            bn(f"{dst}/norm2", f"{src}.norm2")
            params[f"{dst}/conv2/kernel"] = _conv(sd[f"{src}.conv2.weight"])
        if i != len(cfg) - 1:
            bn(f"transition{i}_norm", f"features.transition{i + 1}.norm")
            params[f"transition{i}_conv/kernel"] = _conv(
                sd[f"features.transition{i + 1}.conv.weight"]
            )
    bn("norm5", "features.norm5")
    params["head/kernel"] = _t(sd["classifier.weight"])
    params["head/bias"] = sd["classifier.bias"]
    return params, stats


# ------------------------------------------------------------------- dispatch


def convert_state_dict(sd: dict, model_name: str) -> Tuple[Flat, Flat]:
    """(torch-layout state_dict, model name) -> (flat params, flat
    batch_stats) in the JAX package's flat key scheme."""
    # unwrap common checkpoint containers before the numpy coercion (asarray
    # on a nested dict would make a 0-d object array)
    for container in ("state_dict", "model", "model_state"):
        if container in sd and isinstance(sd[container], dict):
            sd = sd[container]
    sd = _np({re.sub(r"^module\.", "", k): v for k, v in sd.items()})

    if model_name.startswith(("resnet", "resnext", "wide_resnet")):
        return convert_resnet(sd, model_name)
    if model_name.startswith("convnext"):
        return convert_convnext(sd, model_name)
    if model_name.startswith("vit"):
        return convert_vit(sd, model_name)
    if model_name.startswith("efficientvit"):
        return convert_efficientvit(sd, model_name)
    if model_name.startswith(("mobilenetv3", "mobilenet_v3")):
        return convert_mobilenetv3(sd, model_name)
    if model_name.startswith("efficientnet"):
        return convert_efficientnet(sd, model_name)
    if model_name.startswith("swin"):
        return convert_swin(sd, model_name)
    if model_name.startswith("densenet"):
        return convert_densenet(sd, model_name)
    raise ValueError(
        f"no torch converter for model family of {model_name!r} "
        "(supported: resnet*, convnext*, vit*, efficientvit*, mobilenetv3*, "
        "efficientnet_b*, swin_*, densenet*)")


def resample_pos_embed(flat: Flat, target_flat: Flat) -> Flat:
    """Bicubic-resample a ViT 'pos_embed' grid to the target's token count
    (timm's resample_abs_pos_embed, as the JAX package does it: without it
    the shape-mismatch pruning would drop the embedding).

    Both embeds are [1, 1 + N, D] with a leading cls token and square grids;
    anything else is left untouched (the pruning handles it). The resample
    is Keys' cubic (a = -0.5) with the weights renormalised at the borders,
    which is torch's antialiased bicubic: JAX's `jax.image.resize(...,
    "bicubic")`. torch's non-antialiased bicubic (a = -0.75, clamped
    indices) is another function."""
    src = flat.get("pos_embed")
    tgt = target_flat.get("pos_embed")
    if src is None or tgt is None or src.shape == tuple(tgt.shape):
        return flat
    if src.ndim != 3 or len(tgt.shape) != 3 or src.shape[-1] != tgt.shape[-1]:
        return flat
    g_src = int(round((src.shape[1] - 1) ** 0.5))
    g_tgt = int(round((tgt.shape[1] - 1) ** 0.5))
    if g_src * g_src + 1 != src.shape[1] or g_tgt * g_tgt + 1 != tgt.shape[1]:
        return flat

    cls_tok, grid = src[:, :1], src[:, 1:]
    d = src.shape[-1]
    nchw = torch.from_numpy(np.ascontiguousarray(grid, np.float32)).reshape(
        1, g_src, g_src, d).permute(0, 3, 1, 2)
    grid = F.interpolate(nchw, size=(g_tgt, g_tgt), mode="bicubic", align_corners=False,
                         antialias=True).permute(0, 2, 3, 1).numpy()
    out = dict(flat)
    out["pos_embed"] = np.concatenate(
        [cls_tok, grid.reshape(1, g_tgt * g_tgt, d)], axis=1).astype(src.dtype)
    print(f"Resized pos_embed grid {g_src}x{g_src} -> {g_tgt}x{g_tgt}")
    return out


def load_pretrained_flat(path: str, model_name: str) -> dict:
    """Pretrained weights from a checkpoint of this project (a pickle with a
    flat "model" dict, as either package writes) or from a torch/timm
    state_dict (torch zip serialization, or a pickled dict, bare or in a
    container), converted on the fly. Returns {"model", "batch_stats"} as
    flat numpy dicts in the JAX layout. Unpickling runs code: load only
    files from a source you trust."""
    ck = None
    try:
        with open(path, "rb") as f:
            ck = pickle.load(f)
    except (pickle.UnpicklingError, EOFError):
        pass  # not a plain pickle: the torch zip format below
    if isinstance(ck, dict) and isinstance(ck.get("model"), dict):
        # checkpoints of this project carry format_version and "/"-joined
        # flax keys; a pickled torch-layout state_dict in a "model"
        # container has "."-nested keys and goes through the conversion
        keys = list(ck["model"])
        looks_repo = "format_version" in ck or (keys and all("." not in k for k in keys))
        has_torch_tensors = any(isinstance(v, torch.Tensor) for v in ck["model"].values())
        if looks_repo and not has_torch_tensors:
            return _dequantize_weights(ck)
    if ck is None:
        ck = torch.load(path, map_location="cpu", weights_only=True)
    params, stats = convert_state_dict(ck, model_name)
    print(f"Converted torch state_dict {path}")
    return {"model": params, "batch_stats": stats}


def convert_torch_checkpoint(in_path: str, model_name: str, out_path: str,
                             num_classes: int | None = None) -> str:
    """Convert a torch .pth/.bin state_dict file into a checkpoint in the
    JAX package's format, which either package reads through
    --pretrained_path or --resume (pruning semantics intact)."""
    try:
        sd = torch.load(in_path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # a plain pickle of numpy arrays
        with open(in_path, "rb") as f:
            sd = pickle.load(f)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    params, stats = convert_state_dict(sd, model_name)
    if num_classes is None:
        head = params.get("head/bias")
        num_classes = int(head.shape[0]) if head is not None else 1000
    ck = {
        "format_version": 1,
        "model_spec": {"name": model_name, "kwargs": {"num_classes": num_classes}},
        "model": params,
        "batch_stats": stats,
        "num_classes": num_classes,
        "converted_from": in_path,
    }
    with open(out_path, "wb") as f:
        pickle.dump(ck, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"wrote {out_path} ({len(params)} tensors, num_classes={num_classes})")
    return out_path


if __name__ == "__main__":
    p = argparse.ArgumentParser("torch state_dict -> repo checkpoint")
    p.add_argument("--src", required=True, help="torch .pth/.bin state_dict")
    p.add_argument("--model", required=True, help="model name (resnet50, ...)")
    p.add_argument("--out", required=True)
    p.add_argument("--num_classes", type=int, default=None)
    a = p.parse_args()
    convert_torch_checkpoint(a.src, a.model, a.out, a.num_classes)
