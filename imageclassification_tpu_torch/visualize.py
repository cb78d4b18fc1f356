"""Model visualization CLI (port of the root visualize.py):

    python -m imageclassification_tpu_torch.visualize --mode gradcam|features|summary \
        --model_weight_path <checkpoint.pth> --img_path <image or folder> [--device cuda|cpu]

* summary: a table of the model's modules (port name, JAX path, output
  shape, parameters) to --depth, the total parameter count, and the FLOPs of
  the batch-1 eval forward from `torch.utils.flop_counter.FlopCounterMode`
  (the JAX package prints XLA's cost analysis). XLA's "bytes accessed" has
  no counterpart here: on the card the peak device memory of that forward is
  printed instead.
* gradcam: Grad-CAM overlays. A zero probe is added to the target module's
  output by a forward hook, and the gradient of the one-hot logits with
  respect to the probe is the gradient at the activation; GAP of the
  gradients, ReLU of the weighted sum, bilinear resize, min-max
  normalisation. ViT tokens drop the cls token and are laid on the grid.
* features: the channel-wise L2 energy of the output of each top-level
  module with a spatial (4-D) output, as PNG heatmaps.

Layers are named by their JAX module paths (`--layer block11/LayerNorm_0`),
and the automatic pick is the JAX package's rule (`pick_cam_layer`) on the
JAX paths of the port's modules in execution order: `jax_module_names`
finds each port module's JAX path through the weight carry (the port module
whose parameters are exactly those of a JAX module). The models apply some
modules through helpers (`models/layers.py::linear`, `layer_norm`,
`conv2d_nhwc`), which run the modules' forward hooks, so the probe reaches
those too.

Checkpoints load through `val.initialize_model` in fp32, as in the JAX CLI
(Grad-CAM and features dequantized). On the card a checkpoint trained with
--flash_attn computes in bf16, because the flash-attention kernel takes bf16
only; its Grad-CAM then launches the kernel's forward in every block and
its backward in the last.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .checkpoint.to_jax import carry_for
from .data.augment import eval_preprocess
from .data.folder import IMG_EXTENSIONS
from .data.loader import decode_image
from .device import DEVICES, resolve_device
from .ops.int8 import Int8Linear

# ---------------------------------------------------------------------------
# module discovery


def jax_module_names(model: nn.Module) -> Dict[str, str]:
    """{port module name: JAX module path} for every port module whose
    parameters carry to exactly the parameters of one JAX module (the
    longest common path of their JAX keys, with no JAX key under it left
    out). Of several port modules with the same parameters (a residual
    wrapper and what it wraps) the innermost is kept: the JAX module's
    output is the wrapped one's."""
    carry = carry_for(model)
    keys_of = {k: list(carry.to_jax({k: p.detach()}))
               for k, p in model.named_parameters()}
    all_keys = [j for js in keys_of.values() for j in js]
    names: Dict[str, str] = {}
    for name, _ in model.named_modules():
        if not name:
            continue
        ks = {j for k, js in keys_of.items() if k.startswith(name + ".") for j in js}
        if not ks:
            continue
        common = os.path.commonprefix([j.split("/")[:-1] for j in ks])
        if not common:
            continue
        path = "/".join(common)
        if ks == {j for j in all_keys if j.startswith(path + "/")}:
            names[name] = path
    inner: Dict[str, str] = {}
    for name, path in names.items():
        if path not in inner or name.startswith(inner[path] + "."):
            inner[path] = name
    return {name: path for path, name in inner.items()}


def module_call_order(model: nn.Module, x: torch.Tensor,
                      names: Dict[str, str] = None) -> List[Tuple[str, tuple]]:
    """[(JAX path, output shape)] of every module of `names` (default
    `jax_module_names(model)`) in the order its calls return, from one
    forward of x without gradients."""
    names = jax_module_names(model) if names is None else names
    order = []

    def record(path):
        def hook(module, inputs, out):
            if isinstance(out, torch.Tensor):
                order.append((path, tuple(out.shape)))
        return hook

    modules = dict(model.named_modules())
    handles = [modules[n].register_forward_hook(record(p)) for n, p in names.items()]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return order


def _griddable(n):
    """Token count that maps to a square patch grid (with or without a
    leading cls token)."""
    for k in (n, n - 1):
        g = int(round(float(np.sqrt(k))))
        if g >= 2 and g * g == k:
            return True
    return False


_ATTN_RE = re.compile(r"(?i)attention|(^|/)attn(/|$)")


def pick_cam_layer(order):
    """The JAX package's default Grad-CAM target (visualize.py there): the
    last module in execution order whose output is a square spatial map
    (4-D, H = W > 1), or for token sequences (3-D, N a patch grid) the last
    one before the last attention, where the patch tokens still reach the
    cls token the classifier reads."""
    last4 = last4_i = None
    cand3 = []
    attn_prefix = None
    for i, (path, shape) in enumerate(order):
        if len(shape) == 4 and shape[1] == shape[2] and shape[1] > 1:
            last4, last4_i = path, i
        elif len(shape) == 3 and _griddable(shape[1]):
            cand3.append((i, path))
        if _ATTN_RE.search(path):
            segs = path.split("/")
            k = max(j for j, s in enumerate(segs) if _ATTN_RE.search(s))
            attn_prefix = "/".join(segs[: k + 1])
    if attn_prefix is None:
        first_attn_i = len(order)
    else:
        first_attn_i = min(i for i, (p, _) in enumerate(order)
                           if p == attn_prefix or p.startswith(attn_prefix + "/"))
    pre_attn3 = [p for i, p in cand3 if i < first_attn_i]
    if last4 is not None and (not pre_attn3 or last4_i >= first_attn_i):
        return last4
    if pre_attn3:
        return pre_attn3[-1]
    if last4 is not None:
        return last4
    if cand3:
        return cand3[-1][1]
    raise ValueError("no spatial module output found to visualize")


# ---------------------------------------------------------------------------
# grad-cam


def make_gradcam_fn(model: nn.Module, module: nn.Module, img_size: int):
    """gradcam(images_u8 [B, s, s, 3], class_idx) -> (probabilities [B,
    classes] fp32, Grad-CAM maps [B, img_size, img_size] in [0, 1]), the
    probe added to `module`'s output; class_idx < 0 explains each image's
    argmax class."""

    def gradcam(images_u8: torch.Tensor, class_idx: int):
        x = eval_preprocess(images_u8)
        kept = {}

        def probe_hook(mod, inputs, out):
            kept["probe"] = torch.zeros_like(out, requires_grad=True)
            kept["act"] = out + kept["probe"]
            return kept["act"]

        handle = module.register_forward_hook(probe_hook)
        try:
            with torch.enable_grad():
                logits = model(x).float()
        finally:
            handle.remove()
        if "probe" not in kept:
            raise ValueError("the Grad-CAM layer never executed")
        cls = (torch.full(logits.shape[:1], class_idx, device=logits.device)
               if class_idx >= 0 else logits.argmax(-1))
        onehot = F.one_hot(cls, logits.shape[-1]).to(logits.dtype)
        (grad,) = torch.autograd.grad(logits, kept["probe"], grad_outputs=onehot)
        act, grad = kept["act"].detach().float(), grad.float()
        if act.dim() == 3:  # ViT tokens: drop cls, lay on the patch grid
            n = act.shape[1]
            g = int(round(float(np.sqrt(n - 1))))
            if g * g == n - 1:
                act, grad = act[:, 1:], grad[:, 1:]
            else:
                g = int(round(float(np.sqrt(n))))
            act = act.reshape(act.shape[0], g, g, act.shape[-1])
            grad = grad.reshape(grad.shape[0], g, g, grad.shape[-1])
        w = grad.mean(dim=(1, 2), keepdim=True)  # GAP of the gradients
        cam = torch.relu((w * act).sum(-1))
        cam = F.interpolate(cam[:, None], size=(img_size, img_size), mode="bilinear",
                            align_corners=False)[:, 0]
        lo = cam.amin(dim=(1, 2), keepdim=True)
        hi = cam.amax(dim=(1, 2), keepdim=True)
        cam = (cam - lo) / torch.clamp(hi - lo, min=1e-8)
        return torch.softmax(logits.detach(), -1), cam

    return gradcam


def _jet(x):
    """Minimal jet-style colormap, x in [0,1] -> uint8 RGB."""
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def overlay(image_u8, cam, alpha=0.4):
    heat = _jet(np.asarray(cam, np.float32))
    return np.clip((1 - alpha) * np.asarray(image_u8, np.float32) + alpha * heat,
                   0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# modes


def _list_images(img_path):
    if os.path.isfile(img_path):
        return [img_path]
    return sorted(os.path.join(img_path, f) for f in os.listdir(img_path)
                  if f.lower().endswith(IMG_EXTENSIONS))


def _half_precision(a) -> bool:
    """bf16 compute for a --flash_attn checkpoint on the card (module
    docstring), fp32 otherwise, as the JAX CLI."""
    from .checkpoint.io import load_checkpoint

    spec = load_checkpoint(a.model_weight_path, dequantize=False)["model_spec"]
    half = a.device == "cuda" and bool(spec.get("kwargs", {}).get("flash_attn"))
    if half:
        print("--flash_attn checkpoint on the card: bf16 compute (the flash-attention "
              "kernel takes bf16 only)")
    return half


def _load(a, dequantize: bool):
    """The checkpoint's model through `val.initialize_model`, its
    parameters frozen (Grad-CAM differentiates the probe alone)."""
    from .val import initialize_model

    model, num_classes = initialize_model(a.model_weight_path, a.model_ema,
                                          half_precision=_half_precision(a),
                                          dequantize=dequantize, device=a.device)
    return model.requires_grad_(False), num_classes


def resolve_layer(model: nn.Module, img_size: int, layer: str = ""):
    """(JAX path, port module, output shape) of the Grad-CAM target: `layer`
    (a JAX module path) or the automatic pick. SystemExit for a path that
    names no module with a 3- or 4-D output."""
    device = next(model.parameters()).device
    names = jax_module_names(model)
    order = module_call_order(model, torch.zeros(1, img_size, img_size, 3, device=device), names)
    layer = layer or pick_cam_layer(order)
    shapes = dict(order)
    if layer not in shapes:
        known = [p for p, s in order if len(s) in (3, 4)]
        raise SystemExit(f"unknown --layer {layer!r}; spatial candidates: {known}")
    port = {path: name for name, path in names.items()}[layer]
    return layer, model.get_submodule(port), shapes[layer]


def _batches(paths, img_size, batch):
    for i in range(0, len(paths), batch):
        chunk = paths[i : i + batch]
        imgs = np.stack([decode_image(p, img_size, train=False) for p in chunk])
        pad = batch - len(chunk)
        if pad:
            imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], np.uint8)])
        yield chunk, imgs


def run_gradcam(a):
    from PIL import Image

    model, _ = _load(a, dequantize=True)
    paths = _list_images(a.img_path)
    if not paths:
        raise SystemExit(f"no images under {a.img_path}")
    os.makedirs(a.out_dir, exist_ok=True)
    layer, module, shape = resolve_layer(model, a.img_size, a.layer)
    print(f"Grad-CAM layer: {layer} {shape}")
    fn = make_gradcam_fn(model, module, a.img_size)
    device = next(model.parameters()).device
    for chunk, imgs in _batches(paths, a.img_size, a.batch_size):
        probs, cams = fn(torch.from_numpy(imgs).to(device), a.class_idx)
        probs, cams = probs.cpu().numpy(), cams.cpu().numpy()
        for j, p in enumerate(chunk):
            out = overlay(imgs[j], cams[j], a.alpha)
            cls = int(probs[j].argmax()) if a.class_idx < 0 else a.class_idx
            stem = os.path.splitext(os.path.basename(p))[0]
            dst = os.path.join(a.out_dir, f"{stem}_cam_cls{cls}_p{probs[j].max():.2f}.png")
            Image.fromarray(out).save(dst)
            print(f"{p} -> {dst} (class {cls}, prob {probs[j].max():.4f})")


def feature_maps(model: nn.Module, images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{JAX path: channel-wise L2 norm of the first image's output} for each
    top-level JAX module with a 4-D output of height > 1, in the order of
    their first calls (the last call's output kept)."""
    names = {n: p for n, p in jax_module_names(model).items() if "/" not in p}
    acts: Dict[str, torch.Tensor] = {}

    def keep(path):
        def hook(module, inputs, out):
            if isinstance(out, torch.Tensor) and out.dim() == 4 and out.shape[1] > 1:
                acts[path] = torch.linalg.vector_norm(out.float(), dim=-1)[0]
        return hook

    modules = dict(model.named_modules())
    handles = [modules[n].register_forward_hook(keep(p)) for n, p in names.items()]
    try:
        with torch.no_grad():
            model(eval_preprocess(images_u8))
    finally:
        for h in handles:
            h.remove()
    return acts


def run_features(a):
    from PIL import Image

    model, _ = _load(a, dequantize=True)
    paths = _list_images(a.img_path)[:1]
    if not paths:
        raise SystemExit(f"no images under {a.img_path}")
    os.makedirs(a.out_dir, exist_ok=True)
    img = decode_image(paths[0], a.img_size, train=False)
    device = next(model.parameters()).device
    maps = feature_maps(model, torch.from_numpy(np.array(img[None])).to(device))
    stem = os.path.splitext(os.path.basename(paths[0]))[0]
    for name, m in maps.items():
        m = m.cpu().numpy()
        m = (m - m.min()) / max(m.max() - m.min(), 1e-8)
        big = np.asarray(Image.fromarray(_jet(m)).resize((a.img_size, a.img_size),
                                                         Image.NEAREST))
        dst = os.path.join(a.out_dir, f"{stem}_feat_{name.replace('/', '_')}.png")
        Image.fromarray(big).save(dst)
        print(f"{name} {tuple(m.shape)} -> {dst}")


def count_params(model: nn.Module) -> int:
    """Parameters as the JAX package counts them: every parameter, and an
    int8 layer's weight (unpadded) and bias."""
    n = sum(p.numel() for p in model.parameters())
    for m in model.modules():
        if isinstance(m, Int8Linear):
            n += m.in_features * m.out_features + (0 if m.bias is None else m.bias.numel())
    return n


def summary(model: nn.Module, img_size: int, depth: int = 2) -> dict:
    """The summary's table rows [(port name, JAX path, output shape,
    parameters)] to `depth`, the parameter count, the FLOPs of the batch-1
    eval forward and, on the card, the forward's peak device memory in
    bytes (None on the CPU)."""
    from torch.utils.flop_counter import FlopCounterMode

    device = next(model.parameters()).device
    x = torch.zeros(1, img_size, img_size, 3, device=device)
    names = jax_module_names(model)
    shapes: Dict[str, tuple] = {}

    def record(name):
        def hook(module, inputs, out):
            if isinstance(out, torch.Tensor):
                shapes[name] = tuple(out.shape)
        return hook

    shown = [(n, m) for n, m in model.named_modules() if n and n.count(".") < depth]
    handles = [m.register_forward_hook(record(n)) for n, m in shown]
    peak = None
    try:
        with torch.no_grad():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            with FlopCounterMode(display=False) as counter:
                model(x)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                peak = torch.cuda.max_memory_allocated(device)
    finally:
        for h in handles:
            h.remove()
    rows = [(n, names.get(n, ""), shapes.get(n), count_params(m)) for n, m in shown]
    return {"rows": rows, "params": count_params(model), "flops": counter.get_total_flops(),
            "peak_bytes": peak}


def run_summary(a):
    if a.model_weight_path and os.path.exists(a.model_weight_path):
        model, _ = _load(a, dequantize=False)
    else:
        from .models import create_model

        model = create_model(a.model, num_classes=a.num_classes, img_size=a.img_size)
        model = model.to(resolve_device(a.device)).eval()
    res = summary(model, a.img_size, a.depth)
    print(f"{'module':48s} {'JAX path':40s} {'output':24s} {'params':>12s}")
    for name, path, shape, n in res["rows"]:
        print(f"{name:48s} {path:40s} {str(shape or '-'):24s} {n:12d}")
    print(f"number of params: {res['params']}")
    mem = ("not measured on the CPU" if res["peak_bytes"] is None
           else f"{res['peak_bytes'] / 1e6:.1f} MB peak device memory")
    print(f"FlopCounterMode (batch 1, {a.img_size}x{a.img_size} eval forward): "
          f"{res['flops'] / 1e9:.3f} GFLOPs; XLA's bytes accessed has no counterpart: {mem}")
    return res


def main(argv=None):
    p = argparse.ArgumentParser("Model visualization")
    p.add_argument("--mode", default="gradcam", choices=["summary", "gradcam", "features"])
    p.add_argument("--model_weight_path", default="train_cls/output/checkpoint-best.pth")
    p.add_argument("--model", default="efficientvit_m0",
                   help="summary-mode fallback when no checkpoint exists")
    p.add_argument("--num_classes", default=1000, type=int)
    p.add_argument("--img_path", default="", type=str,
                   help="image file or folder (gradcam/features)")
    p.add_argument("--img_size", default=224, type=int)
    p.add_argument("--layer", default="", type=str,
                   help="JAX module path to visualize (default: the JAX package's pick)")
    p.add_argument("--class_idx", default=-1, type=int,
                   help="class to explain (-1: per-image argmax)")
    p.add_argument("--alpha", default=0.4, type=float)
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--depth", default=2, type=int, help="summary table nesting depth")
    p.add_argument("--out_dir", default="train_cls/visualize")
    p.add_argument("--model_ema", default=False,
                   type=lambda v: str(v).lower() in ("1", "true", "t", "yes"))
    p.add_argument("--device", default="cuda", choices=list(DEVICES))
    a = p.parse_args(argv)
    return {"summary": run_summary, "gradcam": run_gradcam, "features": run_features}[a.mode](a)


if __name__ == "__main__":
    main()
