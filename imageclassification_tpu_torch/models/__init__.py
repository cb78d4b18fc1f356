"""Model registry (port of imageclassification_tpu/models/__init__.py).

Holds the ViT family with its timm-style `_224` aliases, the ConvNeXt
and ConvNeXt-V2 families, the ResNet family (ResNet, ResNeXt, wide
ResNet) and EfficientViT m0-m5. The other names of
the JAX registry are known here so that asking for one says it is not ported
yet, while an unknown name raises ValueError as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from . import convnext, efficientvit, resnet, vit

_REGISTRY: Dict[str, Callable] = {}

# names the JAX registry has and the port does not have yet
_NOT_YET_PORTED = frozenset(
    ["mobilenetv3_large_100", "mobilenetv3_small_100",
     "mobilenet_v3_large", "mobilenet_v3_small"]
    + [f"efficientnet_b{i}" for i in range(5)]
    + [f"swin_{s}{suffix}" for s in ("tiny", "small", "base")
       for suffix in ("", "_patch4_window7_224")]
    + ["densenet121", "densenet169", "densenet201"]
)


def register(name: str, ctor: Callable) -> None:
    _REGISTRY[name] = ctor


def list_models():
    return sorted(_REGISTRY)


for _n in ("vit_tiny_patch16", "vit_small_patch16", "vit_small_patch32",
           "vit_base_patch16", "vit_base_patch32", "vit_large_patch16"):
    register(_n, getattr(vit, _n))
    register(_n + "_224", getattr(vit, _n))
for _n in convnext.NAMES:
    register(_n, getattr(convnext, _n))
for _n in resnet.NAMES:
    register(_n, getattr(resnet, _n))
for _n in efficientvit.NAMES:
    register(_n, getattr(efficientvit, _n))


def create_model(
    name: str,
    pretrained: bool = False,
    num_classes: int = 1000,
    half_precision: bool = False,
    **kwargs: Any,
):
    """Build a model by name: bf16 compute with fp32 parameters when
    `half_precision`, else fp32. Weights come from a checkpoint afterwards
    (checkpoint/io.py), so `pretrained`/`pretrained_path` build nothing here."""
    if name not in _REGISTRY:
        if name in _NOT_YET_PORTED:
            raise NotImplementedError(
                f"model {name!r} is in the JAX registry but not yet ported to "
                f"imageclassification_tpu_torch. Ported: {list_models()}"
            )
        raise ValueError(f"Unknown model {name!r}. Available: {list_models()}")
    kwargs.pop("pretrained_path", None)
    dtype = torch.bfloat16 if half_precision else torch.float32
    return _REGISTRY[name](num_classes=num_classes, dtype=dtype, **kwargs)


def model_kwargs_for(args, num_classes: int) -> dict:
    """Per-family constructor kwargs from the CLI args (same routing as the
    JAX package; the checkpoint's model_spec stores its result)."""
    kw: dict = {"pretrained": args.pretrained, "num_classes": num_classes}
    if args.model.startswith("efficientvit"):
        kw["drop_rate"] = args.drop_path
        kw["img_size"] = args.input_size
    elif args.model.startswith("convnext"):
        kw["drop_path_rate"] = args.drop_path
    elif args.model.startswith("vit") and getattr(args, "flash_attn", False):
        kw["flash_attn"] = True
    elif args.model.startswith("swin"):
        kw["attn_layout"] = getattr(args, "swin_attn_layout", "merged")
    return kw
