"""The checkpoint tools of the port (imageclassification_tpu_torch/modelchange.py)
against the JAX package's modelchange.py and val.py on the same seeded
checkpoints: the numpy modes write the same arrays, each package serves the
other's int8 files, and the torch.export program of the eval forward
matches the JAX StableHLO artifact. Also chip_smoke.py's phase 14 rehearsed
on the CPU (`--device cpu`, small inputs, the kernels' plain versions).

The `cuda` test needs a card: a --flash_attn ViT exported on it keeps
launching the flash-attention kernel after a reload. JAX is imported inside
the CPU tests only, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_modelchange.py -m cuda
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from imageclassification_tpu_torch import modelchange as port_mc
from imageclassification_tpu_torch import val as port_val
from imageclassification_tpu_torch.ops import flash_attention as fa
from imageclassification_tpu_torch.ops import int8

sys.path.insert(0, os.path.dirname(__file__))

IMG = 32
NUM_CLASSES = 10


@pytest.fixture(autouse=True)
def few_torch_threads():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _seeded(tmp_path, name, **kw):
    from jax_ckpt import seeded_checkpoint

    return seeded_checkpoint(tmp_path / f"{name}.pth", name, IMG, NUM_CLASSES, **kw)


# (mode, the JAX function's arguments after the path); one resnet18
# checkpoint with an EMA and batch statistics: conv kernels, a head of
# 512 x 10 (quantized, never pruned), BatchNorm leaves
MODES = [("ema2model", ()), ("quantize", ("int8",)), ("quantize", ("fp16",)),
         ("quantize", ("bf16",)), ("prune", (0.5, "global")), ("prune", (0.3, "per_kernel"))]


@pytest.mark.parametrize("mode,args", MODES)
def test_numpy_modes_write_the_same_arrays_as_jax(tmp_path, mode, args):
    import modelchange as jax_mc

    src = _seeded(tmp_path, "resnet18", ema=True)
    fns = {"ema2model": ("convert_model_ema_to_model",), "quantize": ("dynamic_quantize_model",),
           "prune": ("prune_model",)}[mode]
    jax_out = getattr(jax_mc, fns[0])(src, *args, out_path=str(tmp_path / "jax.pth"))
    port_out = getattr(port_mc, fns[0])(src, *args, out_path=str(tmp_path / "port.pth"))
    jck, pck = _load(jax_out), _load(port_out)
    assert sorted(jck) == sorted(pck)
    for key, jv in jck.items():
        pv = pck[key]
        if not isinstance(jv, dict):
            assert pv == jv, key
            continue
        assert sorted(pv) == sorted(jv), key
        for k, a in jv.items():
            b = np.asarray(pv[k])
            if args == ("bf16",) and key == "model":
                # bf16 as fp32 values (modelchange.py docstring): the same numbers
                assert b.dtype == np.float32
                np.testing.assert_array_equal(b, np.asarray(a, np.float32))
            else:
                assert b.dtype == np.asarray(a).dtype, (key, k)
                np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"{key}/{k}")


def test_jax_loads_the_ports_bf16_file_to_the_same_values(tmp_path):
    import val as jax_val

    import modelchange as jax_mc

    src = _seeded(tmp_path, "convnext_atto")
    jax_file = jax_mc.dynamic_quantize_model(src, "bf16", out_path=str(tmp_path / "jax.pth"))
    port_file = port_mc.dynamic_quantize_model(src, "bf16", out_path=str(tmp_path / "port.pth"))
    _, jp, _, _ = jax_val.initialize_model(jax_file, False)
    _, pp, _, _ = jax_val.initialize_model(port_file, False)
    import jax

    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(pp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _images(n, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)


# convnext_atto at bf16 compute (as both val.py serve), 10 probabilities:
# the float serving tests' bf16 allowance; its int8 activations meet no
# rounding tie between the packages (test_torch_int8.py)
PROBS_ATOL = 2e-2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_serves_the_others_int8_checkpoint(tmp_path, writer):
    import jax.numpy as jnp

    import modelchange as jax_mc
    import val as jax_val

    src = _seeded(tmp_path, "convnext_atto")
    mc = port_mc if writer == "port" else jax_mc
    q = mc.dynamic_quantize_model(src, "int8")
    jm, params, bs, jck = jax_val.initialize_model(q, False, return_checkpoint=True)
    pm, pck = port_val.initialize_model(q, False, return_checkpoint=True, device="cpu")
    assert len(jck["quant_exec_scales"]) == len(pck["quant_exec_scales"]) == 24
    assert sum(isinstance(m, int8.Int8Linear) for m in pm.modules()) == 24
    imgs = _images(4)
    ref = np.asarray(jax_val._predict_fn(jm, jck["quant_exec_scales"])(params, bs,
                                                                        jnp.asarray(imgs)))
    with torch.no_grad():
        got = port_val._predict_fn(pm)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, ref, atol=PROBS_ATOL, rtol=0)


# the exported programs (bf16 compute) on zeros against the JAX StableHLO
# artifacts: logits of size ~1-2, bf16 rounded at other points in the two
# packages over 12 ViT blocks / 12 ConvNeXt blocks: 2^-5 of max|ref|
EXPORT_RTOL = 2.0 ** -5


@pytest.mark.parametrize("name,quantize", [("vit_tiny_patch16", False), ("convnext_atto", True)])
def test_exported_program_round_trip_matches_jax_stablehlo(tmp_path, name, quantize):
    import jax.numpy as jnp

    import modelchange as jax_mc

    src = _seeded(tmp_path, name)
    if quantize:  # the int8 forward is exported
        src = jax_mc.dynamic_quantize_model(src, "int8")
    out = port_mc.main(["--ckpt", src, "--device", "cpu"])  # default mode: stablehlo
    assert out == src[: -len(".pth")] + ".pt2" and os.path.exists(out)
    program = port_mc.load_exported(out)
    if quantize:
        assert program.graph_module.code.count("int8") > 0
    got = program.module()(torch.zeros(1, IMG, IMG, 3)).float().numpy()
    live, _ = port_val.initialize_model(src, False, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(got, live(torch.zeros(1, IMG, IMG, 3)).float().numpy())
    ref = np.asarray(jax_mc.load_stablehlo(jax_mc.pth2stablehlo(src)).call(
        jnp.zeros((1, IMG, IMG, 3), jnp.float32)), np.float32)
    np.testing.assert_allclose(got, ref, atol=EXPORT_RTOL * np.abs(ref).max(), rtol=0)


def test_derived_paths_never_overwrite_the_source():
    assert port_mc._derive_out("a/ck.pth", "-int8.pth") == "a/ck-int8.pth"
    assert port_mc._derive_out("a/ck", ".pt2") == "a/ck.pt2"
    with pytest.raises(ValueError, match="sparsity"):
        port_mc.prune_model("unused.pth", sparsity=1.0)


def test_flash_operators_trace_with_fake_tensors():
    # torch.export traces with fake tensors: under a dispatch mode the
    # kernels' launches go through operators whose fake versions give the
    # shapes, and FlopCounterMode counts the forward's two products
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    assert not fa._watched()

    ops = torch.ops.imageclassification_tpu_torch
    with FakeTensorMode():
        q = torch.empty(2, 197, 3, 64, dtype=torch.bfloat16, device="cuda")
        out, lse = ops.flash_attention_fwd(q, q, q, True)
        assert out.shape == q.shape and lse.shape == (2, 3, 197) and lse.dtype == torch.float32
        assert ops.flash_attention_fwd(q, q, q, False)[1].numel() == 0
        grads = ops.flash_attention_bwd(q, q, q, out, lse, out)
        assert [g.shape for g in grads] == [q.shape] * 3
        with FlopCounterMode(display=False) as counter:
            fa.flash_attention(q, q, q)
    assert counter.get_total_flops() == 4 * 2 * 3 * 197 * 197 * 64


VIT_TI = dict(name="vit_tiny_patch16", dim=192, depth=12, heads=3, patch=16)
CONVNEXT_ATTO = dict(name="convnext_atto", depths=(2, 2, 6, 2), dims=(40, 80, 160, 320))
PHASE14 = dict(img=32, batch=4, num_classes=10, cam_batch=2, seed=14,
               gemm={"tiny": (6, 40, 10), "aligned": (32, 64, 24)})


def test_phase14_rehearsal_on_cpu(tmp_path, capsys):
    # 14a-14c at a tiny size: quantize and serve a ViT-Ti --flash_attn
    # checkpoint with an EMA, ema2model, prune, the aot export of the
    # source, Grad-CAM and summary on it and on ConvNeXt-atto
    import chip_smoke

    res = chip_smoke.lifecycle_phase(str(tmp_path), "cpu", PHASE14, VIT_TI, CONVNEXT_ATTO,
                                     str(tmp_path / "images"))
    assert res["int8"]["kept"] == 72 and res["int8"]["int8_layers"] == 48
    assert not any(res["int8"]["totals"].values())  # no kernel on the CPU
    assert all(row["exact"] for row in res["int8"]["gemm"].values())
    assert abs(res["export"]["prune_sparsity"] - 0.5) < 0.01
    assert res["export"]["bf16"]["max_abs_vs_live"] == 0.0
    cams = res["gradcam"]
    assert cams["vit_tiny_patch16"]["layer"] == "block11/LayerNorm_0"
    assert cams["convnext_atto"]["params"] > 0
    printed = capsys.readouterr().out
    assert "int8 execution: 72 Dense kernels stay int8" in printed
    assert "number of params:" in printed and "GFLOPs" in printed


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash-attention kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_exported_flash_program_launches_the_kernel_on_card(cuda_device, tmp_path):
    # ViT-Ti --flash_attn exported on the card (aot), reloaded: one call
    # launches the forward kernel once a block and matches the live model;
    # its int8 checkpoint's program holds the int8 products (aten._int_mm,
    # one a layer: the program calls it without the port's wrapper)
    import chip_smoke

    ck = chip_smoke.write_checkpoint(str(tmp_path / "vit"), np.random.default_rng(0), VIT_TI,
                                     224, 1000)
    for path in (ck, port_mc.dynamic_quantize_model(ck, "int8")):
        out = port_mc.pth2aot(path, device="cuda")
        exported = port_mc.load_exported(out)
        products = sum(n.target == torch.ops.aten._int_mm.default
                       for n in exported.graph_module.graph.nodes)
        assert products == (0 if path == ck else 4 * VIT_TI["depth"] + 1)
        program = exported.module()
        live, _ = port_val.initialize_model(path, False, device="cuda")
        x = torch.zeros(1, 224, 224, 3, device=cuda_device)
        fa.reset_launches()
        with torch.no_grad():
            y = program(x)
        assert fa.flash_attention.launches == VIT_TI["depth"]
        with torch.no_grad():
            torch.testing.assert_close(y, live(x), rtol=0, atol=0)
