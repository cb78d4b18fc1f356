"""Checkpoint conversions (port of the root modelchange.py):

    python -m imageclassification_tpu_torch.modelchange --ckpt <checkpoint.pth> \
        --mode ema2model|quantize|prune|stablehlo|aot [--dtype int8|fp16|bf16] \
        [--sparsity 0.5 --prune_scope global|per_kernel] [--model_ema] [--out <path>] \
        [--device cuda|cpu]

* ema2model: the EMA weights (and their BatchNorm statistics) become the
  model; the optimizer state and step are dropped.
* quantize --dtype int8: per-output-channel absmax int8 of every kernel with
  ndim >= 2 and more than 4096 entries (scales over the kernel's last axis).
  `val.py` then runs the Dense-style kernels as int8 products
  (`ops/int8.py`) and dequantizes the conv kernels at load. fp16 casts every
  array. bf16 rounds every array to bfloat16 (round to nearest even) and
  stores it as fp32: numpy has no bfloat16 of its own (the JAX package
  writes an ml_dtypes array, which the card's host need not have), and
  either package loads the fp32 array to the same values as the JAX file.
* prune: zero the smallest-magnitude entries of every eligible kernel (the
  int8 rule, head kernels exempt), ranked globally or per kernel.
* stablehlo (the default; `pth2trt` is its alias) and aot: the eval forward
  as a `torch.export` program with the weights in it (`torch.export.save`,
  `.pt2`), on the device it runs on, verified as the JAX package verifies
  its StableHLO: loaded back, run on zeros and held against the live model.
  An int8 checkpoint exports its int8 forward. A ViT trained with
  --flash_attn and exported on the card keeps the flash-attention kernel:
  its launches are torch operators (`ops/flash_attention.py`), so the
  reloaded program launches the kernel. The two modes differ in their file
  name only (`.pt2`, `.aot.pt2`): a torch.export program is tied to its
  device either way.

The numpy modes write the same arrays as the JAX package's, and each
package reads the other's files. No output path is ever the source's.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch
from torch import nn

from .checkpoint.io import load_checkpoint
from .device import DEVICES
from .val import initialize_model

# kernels that quantize and prune: ndim >= 2 and more than this many entries
MIN_KERNEL_SIZE = 4096
# the verification's tolerance (the JAX package's), relative
VERIFY_RTOL = 1e-5


def _derive_out(pth_path: str, suffix: str) -> str:
    """Output path from the input path, never the input path itself (a bare
    replace on a name without `.pth` would return it unchanged)."""
    out = (pth_path[: -len(".pth")] + suffix) if pth_path.endswith(".pth") \
        else pth_path + suffix
    assert out != pth_path
    return out


def _write(ck: dict, out_path: str) -> None:
    with open(out_path, "wb") as f:
        pickle.dump(ck, f, protocol=pickle.HIGHEST_PROTOCOL)


def convert_model_ema_to_model(pth_path: str, out_path: str | None = None) -> str:
    """Promote the EMA weights (and EMA BatchNorm statistics) into `model`
    and drop the optimizer state and step."""
    ck = load_checkpoint(pth_path)
    if "model_ema" not in ck:
        raise KeyError(f"{pth_path} has no model_ema")
    ck["model"] = ck.pop("model_ema")
    if "model_ema_batch_stats" in ck:
        ck["batch_stats"] = ck.pop("model_ema_batch_stats")
    ck.pop("optimizer", None)
    ck.pop("step", None)
    out_path = out_path or _derive_out(pth_path, "-ema.pth")
    _write(ck, out_path)
    print(f"wrote {out_path}")
    return out_path


def _bf16_values(arr: np.ndarray) -> np.ndarray:
    """arr rounded to bfloat16 (to nearest even), as an fp32 array."""
    return torch.from_numpy(np.asarray(arr, np.float32)).to(torch.bfloat16).float().numpy()


def dynamic_quantize_model(pth_path: str, dtype: str = "int8", out_path: str | None = None) -> str:
    """int8: per-output-channel absmax scales on the kernels with ndim >= 2
    and more than MIN_KERNEL_SIZE entries; fp16/bf16: every array cast (bf16
    as fp32 values, module docstring)."""
    ck = load_checkpoint(pth_path)
    qflat, scales = {}, {}
    for k, v in ck["model"].items():
        arr = np.asarray(v)
        if dtype in ("fp16", "float16"):
            qflat[k] = arr.astype(np.float16)
        elif dtype in ("bf16", "bfloat16"):
            qflat[k] = _bf16_values(arr)
        elif dtype == "int8":
            if k.endswith("kernel") and arr.ndim >= 2 and arr.size > MIN_KERNEL_SIZE:
                mat = arr.reshape(-1, arr.shape[-1])
                s = np.abs(mat).max(axis=0) / 127.0
                s = np.where(s == 0, 1.0, s)
                qflat[k] = np.clip(np.round(mat / s), -127, 127).astype(np.int8).reshape(arr.shape)
                scales[k] = s.astype(np.float32)
            else:
                qflat[k] = arr
        else:
            raise ValueError(f"unsupported quantization dtype {dtype}")
    ck["model"] = qflat
    ck["quant_scales"] = scales
    ck["quant_dtype"] = dtype
    out_path = out_path or _derive_out(pth_path, f"-{dtype}.pth")
    _write(ck, out_path)
    print(f"wrote {out_path} ({dtype}; {len(scales)} kernels quantized)")
    return out_path


def prune_model(pth_path: str, sparsity: float = 0.5, scope: str = "global",
                out_path: str | None = None) -> str:
    """Magnitude pruning of every kernel with ndim >= 2 and more than
    MIN_KERNEL_SIZE entries, classifier kernels (`head/kernel`) exempt:
    entries with |w| at or below the `sparsity` quantile (of all eligible
    kernels jointly for scope 'global', of each kernel for 'per_kernel')
    become 0. Records 'prune_sparsity' and drops the optimizer state, whose
    moments would undo the zeros."""
    if not 0.0 < sparsity < 1.0:
        raise ValueError(f"sparsity must be in (0,1), got {sparsity}")
    ck = load_checkpoint(pth_path)
    flat = ck["model"]
    eligible = {
        k: np.asarray(v, np.float32) for k, v in flat.items()
        if k.endswith("kernel") and np.ndim(v) >= 2 and np.size(v) > MIN_KERNEL_SIZE
        and not k.endswith("head/kernel")
    }
    if not eligible:
        raise ValueError("no prunable kernels found")
    if scope == "global":
        thresh = np.quantile(np.concatenate([np.abs(v).ravel() for v in eligible.values()]),
                             sparsity)
        thresholds = {k: thresh for k in eligible}
    elif scope == "per_kernel":
        thresholds = {k: np.quantile(np.abs(v), sparsity) for k, v in eligible.items()}
    else:
        raise ValueError(f"unknown scope {scope!r}")
    pruned = dict(flat)
    total = kept = 0
    for k, v in eligible.items():
        mask = np.abs(v) > thresholds[k]
        pruned[k] = (v * mask).astype(np.asarray(flat[k]).dtype)
        total += mask.size
        kept += int(mask.sum())
        print(f"  {k}: {1.0 - mask.mean():.3f} sparse")
    ck["model"] = pruned
    ck["prune_sparsity"] = 1.0 - kept / total
    ck.pop("optimizer", None)
    ck.pop("step", None)
    out_path = out_path or _derive_out(pth_path, f"-pruned{sparsity:g}.pth")
    _write(ck, out_path)
    print(f"wrote {out_path} (achieved sparsity {ck['prune_sparsity']:.3f} over "
          f"{len(eligible)} kernels)")
    return out_path


class _Forward(nn.Module):
    """The exported function: NHWC float images -> logits."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def export_model(pth_path: str, model_ema: bool = False, device: str = "cuda"):
    """(the torch.export program of the checkpoint's eval forward, bf16
    compute as val.py serves it, at the checkpoint's input shape on
    `device`; the live model; that input shape). An int8 checkpoint (whose
    raw int8 weights also serve when --model_ema finds no EMA) exports its
    int8 forward."""
    model, ck = initialize_model(pth_path, model_ema, return_checkpoint=True, device=device)
    fwd = _Forward(model.requires_grad_(False)).eval()
    shape = tuple(ck.get("input_shape") or (1, 224, 224, 3))
    x = torch.zeros(shape, device=next(model.parameters()).device)
    with torch.no_grad():
        fwd(x)  # first eager call (Swin builds its shift masks there)
        program = torch.export.export(fwd, (x,))
    return program, fwd, shape


def load_exported(path: str):
    """A saved program back (`torch.export.load`), after registering the
    flash-attention operators its graph may call; run it with
    `.module()(x)`."""
    from .ops import flash_attention  # noqa: F401  (registers the operators)

    return torch.export.load(path)


def _export(pth_path: str, out_path: str, model_ema: bool, device: str) -> str:
    program, live, shape = export_model(pth_path, model_ema, device)
    torch.export.save(program, out_path)
    back = load_exported(out_path)
    x = torch.zeros(shape, device=next(live.parameters()).device)
    with torch.no_grad():
        ref = live(x).float().cpu().numpy()
        got = back.module()(x).float().cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=VERIFY_RTOL)
    print(f"wrote {out_path} (torch.export program, {shape} on {x.device}, verified)")
    return out_path


def pth2stablehlo(pth_path: str, out_path: str | None = None, model_ema: bool = False,
                  device: str = "cuda") -> str:
    """The eval forward as a saved torch.export program (`.pt2`), verified
    by reloading it and holding its output on zeros against the live model."""
    return _export(pth_path, out_path or _derive_out(pth_path, ".pt2"), model_ema, device)


def pth2aot(pth_path: str, out_path: str | None = None, model_ema: bool = False,
            device: str = "cuda") -> str:
    """The same program under the `aot` name (`.aot.pt2`)."""
    return _export(pth_path, out_path or _derive_out(pth_path, ".aot.pt2"), model_ema, device)


# the serving alias of the JAX CLI
pth2trt = pth2stablehlo


def main(argv=None):
    p = argparse.ArgumentParser("Checkpoint conversion")
    p.add_argument("--ckpt", default="train_cls/output/checkpoint-best.pth")
    p.add_argument("--mode", default="stablehlo",
                   choices=["ema2model", "quantize", "prune", "stablehlo", "aot"])
    p.add_argument("--dtype", default="int8")
    p.add_argument("--sparsity", default=0.5, type=float)
    p.add_argument("--prune_scope", default="global", choices=["global", "per_kernel"])
    p.add_argument("--model_ema", default=False, action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=list(DEVICES))
    a = p.parse_args(argv)
    if a.mode == "ema2model":
        return convert_model_ema_to_model(a.ckpt, a.out)
    if a.mode == "quantize":
        return dynamic_quantize_model(a.ckpt, a.dtype, a.out)
    if a.mode == "prune":
        return prune_model(a.ckpt, a.sparsity, a.prune_scope, a.out)
    if a.mode == "aot":
        return pth2aot(a.ckpt, a.out, a.model_ema, a.device)
    return pth2stablehlo(a.ckpt, a.out, a.model_ema, a.device)


if __name__ == "__main__":
    main()
