"""int8 execution of quantized checkpoints (port of
imageclassification_tpu/ops/int8.py).

A checkpoint quantized by `modelchange --mode quantize --dtype int8` holds
its large matmul and conv kernels as int8 with per-output-channel fp32
scales. At inference the Dense-style kernels stay int8 and run a real int8
product; conv kernels are dequantized at load (weight-only storage), as in
the JAX package:

* `dynamic_quantize_act`: symmetric per-tensor absmax quantization of the
  activations, scale = max(absmax, 1e-12) / 127, round half to even, clip to
  +-127. The absmax stays a device scalar (no host read), so a captured
  predict captures the int8 forward too.
* `int8_matmul`: the int32 accumulate of int8 activations and int8 weights,
  then acc * (act_scale * w_scale) in fp32, the fp32 bias, the output dtype.
  On a card the product is `torch._int_mm` (cuBLASLt); on the CPU its plain
  version, an int32 matmul. Both give the same int32 accumulators exactly.
  cuBLASLt takes M > 16 and K, N multiples of 8, with the second operand
  column-major: the weight is laid out once at load as [N, K] row-major
  (N and K padded with zeros to multiples of 8) and passed transposed, and
  a call with M <= 16 rows pads the activations with zero rows (a zero row
  changes no absmax). The result is sliced back. A shape that the padded
  call still cannot take raises; nothing falls back to a float product.
* `Int8Linear` stands in for each `nn.Linear` (or 1x1 conv used as one,
  the squeeze-excitations) whose JAX kernel is in the checkpoint's active
  scales and arrived int8 (`quantize_linears_`, the port's analogue of the
  JAX flax interceptor): fp32 EMA weights under a quantized checkpoint stay
  float. The models call their Linears through `models/layers.py::linear`,
  which routes an `Int8Linear` here.

The scales cover the JAX kernel's last axis only (a DenseGeneral query
kernel [E, H, hd] has hd of them, broadcast over the heads). Each scale
vector is broadcast to its kernel's shape and carried through the same
weight carry as the kernel (`carry_for(model).to_port`), so every row of the
port's weight gets its JAX scale; ViT's fused qkv shares one activation
scale between q, k and v, exactly as JAX's three products do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CLIP = 127.0
# cuBLASLt's int8 GEMM (torch._int_mm): rows of the first operand, and the
# multiple that K and N must be
MIN_ROWS = 17
ALIGN = 8


def dynamic_quantize_act(x: torch.Tensor, clip: float = CLIP):
    """Symmetric per-tensor dynamic quantization: (int8 values, fp32 0-d
    scale tensor on x's device)."""
    xf = x.float()
    scale = xf.abs().amax().clamp_min(1e-12) / clip
    q = torch.clamp(torch.round(xf / scale), -clip, clip).to(torch.int8)
    return q, scale


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 [M, N] = a [M, K] int8 @ b [K, N] int8. CUDA: `torch._int_mm`
    (raises for a shape or layout cuBLASLt does not take); CPU: the plain
    int32 matmul. Counts its CUDA calls in `int_mm.calls`."""
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    int_mm.calls += 1
    return torch._int_mm(a, b)


int_mm.calls = 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_weight(w: torch.Tensor) -> torch.Tensor:
    """int8 weight [N, K] -> [N', K'] row-major, N' and K' the multiples of 8
    at or above N and K, the new rows and columns zero: the layout
    `padded_int_mm` takes (its transpose is cuBLASLt's column-major
    second operand)."""
    n, k = w.shape
    return F.pad(w, (0, _round_up(k, ALIGN) - k, 0, _round_up(n, ALIGN) - n)).contiguous()


def padded_int_mm(xq: torch.Tensor, w_padded: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [M, n] = xq [M, K] int8 @ W^T, W the [n, K] int8 weight laid
    out by `pad_weight`: xq padded with zero columns to W's K' and, with M <=
    16 rows, zero rows to MIN_ROWS; the padding's rows and columns sliced off."""
    m, k = xq.shape
    kp = w_padded.shape[1]
    rows = m if m >= MIN_ROWS else MIN_ROWS
    if (rows, kp) != (m, k):
        xq = F.pad(xq, (0, kp - k, 0, rows - m))
    return int_mm(xq, w_padded.t())[:m, :n]


def int8_matmul(x: torch.Tensor, w_padded: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, out_dtype=torch.float32) -> torch.Tensor:
    """Dynamic-activation int8 product over the last axis of x (JAX
    `int8_matmul`): x [..., K] float; w_padded the [N, K] int8 weight laid
    out by `pad_weight`; w_scale [N] fp32 per-output scales; bias [N] fp32
    or None. int32 accumulate, rescale by act_scale * w_scale, fp32 bias,
    result in out_dtype."""
    n = w_scale.shape[0]
    xq, a_scale = dynamic_quantize_act(x)
    acc = padded_int_mm(xq.reshape(-1, xq.shape[-1]), w_padded, n)
    out = acc.float() * (a_scale * w_scale)
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype).reshape(*x.shape[:-1], n)


class Int8Linear(nn.Module):
    """An int8 stand-in for an `nn.Linear` (or a 1x1 conv applied as one):
    buffers `qweight` (int8, laid out by `pad_weight`), `scale` (fp32 [N])
    and `bias` (fp32 [N] or None). `forward(x, out_dtype)` is
    `int8_matmul`; it takes x as it arrives (the quantization reads it in
    fp32), as the JAX interceptor takes the module's input."""

    def __init__(self, weight_int8: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.out_features, self.in_features = weight_int8.shape
        self.register_buffer("qweight", pad_weight(weight_int8.to(torch.int8)))
        self.register_buffer("scale", scale.float().contiguous())
        self.register_buffer("bias", None if bias is None else bias.detach().float().clone())

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return int8_matmul(x, self.qweight, self.scale, self.bias, out_dtype)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, int8"


def quantize_linears_(model: nn.Module, flat: Dict[str, Any],
                      qscales: Dict[str, np.ndarray]) -> Dict[str, str]:
    """Swap in an `Int8Linear` for each Linear (or 1x1 conv) of `model` whose
    JAX kernels are all in `qscales` and all int8 in `flat` (the JAX flat
    parameters the model was loaded from, int8 kernels intact). The model's
    float weight holds the int8 values exactly (the carry reads them as
    fp32) and becomes the int8 buffer. Returns {port module: JAX kernel
    keys joined by ','}."""
    from ..checkpoint.to_jax import carry_for

    active = {k: np.broadcast_to(np.asarray(s, np.float32), np.shape(flat[k]))
              for k, s in qscales.items()
              if k in flat and np.asarray(flat[k]).dtype == np.int8}
    if not active:
        return {}
    sd, sources, _ = carry_for(model).to_port(active)
    swapped = {}
    for key, scales in sd.items():
        name, _, leaf = key.rpartition(".")
        if leaf != "weight":
            continue
        module = model.get_submodule(name)
        if not (isinstance(module, nn.Linear) or (
                isinstance(module, nn.Conv2d) and module.kernel_size == (1, 1)
                and module.groups == 1)):
            raise TypeError(f"{name}: an int8 kernel on a {type(module).__name__}")
        w = module.weight.detach().reshape(module.weight.shape[0], -1)
        rows = scales.reshape(scales.shape[0], -1)
        if not torch.equal(rows, rows[:, :1].expand_as(rows)) or not torch.equal(w, w.round()):
            raise ValueError(f"{name}: the int8 kernel or its scales did not carry exactly")
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        setattr(parent, child, Int8Linear(w.to(torch.int8), rows[:, 0], module.bias))
        swapped[name] = ",".join(sources[key])
    return swapped


# ---------------------------------------------------------------------------
# checkpoint side (numpy; the JAX package's `split_executable_quant`)

def _is_executable_int8_key(key: str, arr) -> bool:
    """Kernels the int8 runtime executes: Dense (2-D) and DenseGeneral (3-D,
    the attention projections). 4-D conv kernels are dequantized at load."""
    return key.endswith("kernel") and arr.ndim in (2, 3)


def split_executable_quant(ck: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Prepare a checkpoint loaded with dequantize=False for int8 execution,
    in place: dequantize every quantized kernel the runtime cannot execute
    (conv kernels), keep the executable ones int8. Returns {flat key:
    scales} of the kept kernels ({} for an unquantized checkpoint). The
    quantization metadata is popped, so a re-pickle cannot dequantize twice."""
    scales = ck.pop("quant_scales", None)
    dtype = ck.pop("quant_dtype", None)
    if not scales or dtype != "int8" or not isinstance(ck.get("model"), dict):
        return {}
    model = dict(ck["model"])
    active: Dict[str, np.ndarray] = {}
    n_deq = 0
    for k, s in scales.items():
        if k not in model:
            continue
        arr = np.asarray(model[k])
        if _is_executable_int8_key(k, arr):
            active[k] = np.asarray(s, np.float32)
        else:
            model[k] = (arr.astype(np.float32).reshape(-1, arr.shape[-1])
                        * np.asarray(s, np.float32)).reshape(arr.shape).astype(np.float32)
            n_deq += 1
    ck["model"] = model
    print(f"int8 execution: {len(active)} Dense kernels stay int8, "
          f"{n_deq} conv kernels dequantized (weight-only)")
    return active
