"""int8 execution of quantized checkpoints (imageclassification_tpu_torch/ops/int8.py
and val.py's int8 path) against the JAX package's ops/int8.py and val.py on
the same seeded inputs and checkpoints. JAX's Pallas flash kernel runs in
interpret mode; the port's CPU path runs the plain int32 matmul, which gives
`torch._int_mm`'s accumulators exactly.

The `cuda` tests need a card: the padded int8 product against the CPU's,
and a captured int8 predict. JAX is imported inside the CPU tests only, so
they run where it is absent:

    python -m pytest --noconftest tests/test_torch_int8.py -m cuda
"""

import os
import sys

import numpy as np
import pytest
import torch

from imageclassification_tpu_torch import val as port_val
from imageclassification_tpu_torch.ops import int8

sys.path.insert(0, os.path.dirname(__file__))

IMG = 32
NUM_CLASSES = 10


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret_mode(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


# (leading shape of x, K, N): M = 6 rows (<= 16, padded to MIN_ROWS) with
# N = 10 (padded to 16), K = 36 (padded to 40), and a 3-D x of 2 x 9 rows
MATMUL_CASES = [((6,), 40, 10), ((33,), 36, 24), ((2, 9), 64, 3)]


@pytest.mark.parametrize("lead,K,N", MATMUL_CASES)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax_bitwise(lead, K, N, out_dtype):
    import jax.numpy as jnp

    from imageclassification_tpu.ops import int8 as jax_int8

    rng = np.random.default_rng(0)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    w = rng.integers(-127, 128, (K, N), dtype=np.int8)  # JAX layout [K, N]
    s = rng.uniform(0.001, 0.02, N).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    # the activation quantization: same int8 values and scale
    jq, js = jax_int8.dynamic_quantize_act(jnp.asarray(x))
    pq, ps = int8.dynamic_quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert ps.item() == float(js)
    # the int32 accumulators, exactly
    acc = int8.padded_int_mm(pq.reshape(-1, K), int8.pad_weight(torch.from_numpy(w.T)), N)
    want = np.asarray(jq).reshape(-1, K).astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(acc.numpy(), want)
    # the outputs, bitwise
    jdt = getattr(jnp, out_dtype)
    ref = np.asarray(jax_int8.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                          jnp.asarray(b), out_dtype=jdt).astype(jnp.float32))
    got = int8.int8_matmul(torch.from_numpy(x), int8.pad_weight(torch.from_numpy(w.T)),
                           torch.from_numpy(s), torch.from_numpy(b),
                           getattr(torch, out_dtype)).float().numpy()
    assert got.shape == lead + (N,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("M,K,N", [(1, 8, 8), (16, 20, 1000), (17, 768, 10), (40, 3, 5)])
def test_padded_product_equals_the_unpadded_plain_product(M, K, N):
    # the padding for cuBLASLt (rows to MIN_ROWS, K and N to multiples of 8)
    # is sliced off exactly: against the unpadded int32 matmul
    g = torch.Generator().manual_seed(M * K + N)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (N, K), dtype=torch.int8, generator=g)
    wp = int8.pad_weight(w)
    assert wp.shape == (-(-N // 8) * 8, -(-K // 8) * 8) and wp.is_contiguous()
    assert torch.equal(wp[:N, :K], w) and not wp[N:].any() and not wp[:, K:].any()
    got = int8.padded_int_mm(a, wp, N)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, a.to(torch.int32) @ w.t().to(torch.int32))


def _quantized(tmp_path, name, ema=False, **kw):
    import modelchange as jax_modelchange
    from jax_ckpt import seeded_checkpoint

    src = seeded_checkpoint(tmp_path / f"{name}.pth", name, IMG, NUM_CLASSES, ema=ema, **kw)
    return jax_modelchange.dynamic_quantize_model(src, "int8")


def _images(n=4, img=IMG, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, img, img, 3), dtype=np.uint8)


# model-level: fp32 compute on both sides, so what is left is fp32 rounding
# upstream of each activation quantization (the float forwards agree to
# 2e-6). A value within that rounding of a .5 boundary rounds to the other
# int8 step in one package, and the network carries the step on: the ViT's
# first such tie (block 3 of 12, 3e-3 there) reaches 3.5e-2 on logits of
# size ~1.3; ConvNeXt-atto meets none (2e-6). Each layer alone is bitwise
# equal on the same input (test_fused_qkv_int8_layer_matches_jax_bitwise).
LOGITS_ATOL = 5e-2


def test_fused_qkv_int8_layer_matches_jax_bitwise(tmp_path):
    # ViT's fused qkv Int8Linear against JAX's three DenseGeneral int8
    # products (query, key, value) on one activation: the scales carried
    # through the weight carry give every row its JAX scale
    import pickle

    import jax.numpy as jnp

    from imageclassification_tpu.ops import int8 as jax_int8

    q = _quantized(tmp_path, "vit_tiny_patch16")
    pm, _ = port_val.initialize_model(q, False, half_precision=False, device="cpu")
    with open(q, "rb") as f:
        ck = pickle.load(f)
    x = np.random.default_rng(2).standard_normal((2, 5, 192)).astype(np.float32)
    parts = []
    for p in ("query", "key", "value"):
        key = f"block0/MultiHeadDotProductAttention_0/{p}/kernel"
        kern, s = ck["model"][key], ck["quant_scales"][key]
        n = kern.shape[1] * kern.shape[2]
        parts.append(np.asarray(jax_int8.int8_matmul(
            jnp.asarray(x), jnp.asarray(kern.reshape(kern.shape[0], n)),
            jnp.asarray(np.broadcast_to(s, kern.shape[1:]).reshape(n)),
            jnp.asarray(ck["model"][key[:-6] + "bias"].reshape(n)))))
    layer = pm.blocks[0].attn.qkv
    assert isinstance(layer, int8.Int8Linear)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.concatenate(parts, -1))


@pytest.mark.parametrize("name,kw", [("vit_tiny_patch16", {"flash_attn": True}),
                                     ("convnext_atto", {})])
def test_int8_forward_matches_jax_quantized_apply(tmp_path, interpret_mode, name, kw):
    import jax.numpy as jnp

    import val as jax_val
    from imageclassification_tpu.data.augment import eval_preprocess
    from imageclassification_tpu.ops.int8 import quantized_apply

    q = _quantized(tmp_path, name, **kw)
    jm, params, bs, jck = jax_val.initialize_model(q, False, half_precision=False,
                                                   return_checkpoint=True)
    pm, pck = port_val.initialize_model(q, False, half_precision=False, return_checkpoint=True,
                                        device="cpu")
    # the same kernels stay int8: JAX's split, the port's copy of it, and the
    # port's int8 layers (ViT's q, k and v kernels are one fused layer)
    assert sorted(pck["quant_exec_scales"]) == sorted(jck["quant_exec_scales"])
    swapped = [m for m in pm.modules() if isinstance(m, int8.Int8Linear)]
    per_layer = 3 if name.startswith("vit") else 1
    fused = 12 if name.startswith("vit") else 0  # one qkv layer a block
    assert len(swapped) + (per_layer - 1) * fused == len(jck["quant_exec_scales"])
    imgs = _images()
    x = eval_preprocess(jnp.asarray(imgs))
    variables = {"params": params, **({"batch_stats": bs} if bs else {})}
    ref = np.asarray(quantized_apply(jm, variables, x, qscales=jck["quant_exec_scales"],
                                     train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(np.asarray(x))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=LOGITS_ATOL, rtol=0)
    assert (got.argmax(-1) == ref.argmax(-1)).all()


# val.py end to end (bf16 compute, as both CLIs serve): probabilities of 10
# classes; bf16 rounding (2^-8 a rounding) over the blocks of each family,
# as the float serving tests allow, plus the activation-quantization flips
PROBS_ATOL = 2e-2
FAMILIES = [("resnet18", IMG, {}), ("efficientvit_m0", IMG, {}),
            ("mobilenet_v3_small", IMG, {}), ("efficientnet_b0", IMG, {}),
            ("densenet121", IMG, {}), ("swin_tiny", 224, {})]


@pytest.mark.parametrize("name,img,kw", FAMILIES)
def test_int8_val_of_every_family_matches_jax_val(tmp_path, name, img, kw):
    import jax.numpy as jnp

    import modelchange as jax_modelchange
    import val as jax_val
    from jax_ckpt import seeded_checkpoint

    # 32 classes: every family's head is large enough to quantize
    src = seeded_checkpoint(tmp_path / f"{name}.pth", name, img, 32, **kw)
    q = jax_modelchange.dynamic_quantize_model(src, "int8")
    jm, params, bs, jck = jax_val.initialize_model(q, False, return_checkpoint=True)
    pm, pck = port_val.initialize_model(q, False, return_checkpoint=True, device="cpu")
    assert sorted(pck["quant_exec_scales"]) == sorted(jck["quant_exec_scales"])
    n_int8 = sum(isinstance(m, int8.Int8Linear) for m in pm.modules())
    assert n_int8 == len(jck["quant_exec_scales"]) > 0
    imgs = _images(2, img)
    ref = np.asarray(jax_val._predict_fn(jm, jck["quant_exec_scales"])(params, bs,
                                                                        jnp.asarray(imgs)))
    with torch.no_grad():
        got = port_val._predict_fn(pm)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, ref, atol=PROBS_ATOL, rtol=0)


def test_fp32_ema_under_an_int8_checkpoint_stays_float(tmp_path):
    # as JAX: --model_ema serves the checkpoint's fp32 EMA with no int8
    # layer; without an EMA (or with --model_ema false) the int8 weights
    q = _quantized(tmp_path, "convnext_atto", ema=True)
    m_ema, ck = port_val.initialize_model(q, True, return_checkpoint=True, device="cpu")
    assert ck["quant_exec_scales"]  # the scales are active: the kernels simply are not int8
    assert not any(isinstance(m, int8.Int8Linear) for m in m_ema.modules())
    m_raw, _ = port_val.initialize_model(q, False, device="cpu")
    assert sum(isinstance(m, int8.Int8Linear) for m in m_raw.modules()) == 24


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch._int_mm has no CPU counterpart to check)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(8, 768, 1000), (16, 192, 10), (17, 36, 24), (64, 40, 3),
                                   (12608, 768, 2304), (12608, 3072, 768)])
def test_int_mm_at_padded_shapes_on_card(cuda_device, M, K, N):
    g = torch.Generator().manual_seed(M + K + N)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (N, K), dtype=torch.int8, generator=g)
    calls = int8.int_mm.calls
    got = int8.padded_int_mm(a.to(cuda_device), int8.pad_weight(w).to(cuda_device), N)
    assert int8.int_mm.calls == calls + 1
    rows = min(M, 256)
    assert torch.equal(got[:rows].cpu(), a[:rows].to(torch.int32) @ w.t().to(torch.int32))


@pytest.mark.cuda
def test_int8_predict_is_captured_on_card(cuda_device, tmp_path):
    # a seeded int8 checkpoint of ViT-Ti --flash_attn: every int8 layer runs
    # torch._int_mm (no float fallback), the captured predict equals the
    # eager one, and the probabilities are finite
    import chip_smoke
    from imageclassification_tpu_torch import modelchange

    rng = np.random.default_rng(0)
    vit = dict(name="vit_tiny_patch16", dim=192, depth=12, heads=3, patch=16)
    ck = chip_smoke.write_checkpoint(str(tmp_path / "vit"), rng, vit, 224, 1000)
    q = modelchange.dynamic_quantize_model(ck, "int8")
    model, _ = port_val.initialize_model(q, False, device="cuda")
    layers = sum(isinstance(m, int8.Int8Linear) for m in model.modules())
    assert layers == 12 * 4 + 1
    predict = port_val._predict_fn(model)
    imgs = torch.from_numpy(_images(8, 224)).to(cuda_device)
    int8.int_mm.calls = 0
    eager = predict.eager(imgs)
    assert int8.int_mm.calls == layers
    got = predict(imgs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, predict(imgs), rtol=0, atol=0)
    torch.testing.assert_close(got, eager, rtol=0, atol=1e-6)
