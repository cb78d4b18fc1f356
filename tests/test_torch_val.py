"""Port folder inference (imageclassification_tpu_torch/val.py and
engine/step.py) against the JAX package's val.py and eval step, end to end on
one JAX-format checkpoint: a vit_tiny_patch16 at 32x32 trained-checkpoint
layout with flash_attn=True. The JAX side runs its Pallas flash kernel in
interpret mode and decodes through PIL; the port runs on the CPU with its
plain versions. Also the guards: no JAX in the port, and no silent CPU."""

import ast
import functools
import os
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import imageclassification_tpu.data.native_decode as jax_native
import imageclassification_tpu_torch.val as port_val
import val as jax_val
from imageclassification_tpu.engine.step import build_eval_step as jax_build_eval_step
from imageclassification_tpu.models import create_model as jax_create_model
from imageclassification_tpu_torch.data import native_decode
from imageclassification_tpu_torch.device import resolve_device
from imageclassification_tpu_torch.engine.step import build_eval_step

ROOT = Path(__file__).resolve().parent.parent
NUM_CLASSES = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_reference(monkeypatch):
    """JAX val.py as the reference: Pallas kernels in interpret mode, JPEGs
    through each package's native decoder (the same pixels)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    assert (jax_native.get_lib() is None) == (native_decode.get_lib() is None)


@pytest.fixture
def fp32_both(monkeypatch):
    """Run both val.py's in fp32: exact per-class counts need every argmax to
    agree, and bf16 rounding differs between the frameworks by more than the
    smallest top-2 margin here; fp32 agrees to ~1e-6."""
    monkeypatch.setattr(jax_val, "initialize_model",
                        functools.partial(jax_val.initialize_model, half_precision=False))
    monkeypatch.setattr(port_val, "initialize_model",
                        functools.partial(port_val.initialize_model, half_precision=False))


def _vit_tiny_flat(seed, head_std=0.1):
    """Flat parameters of vit_tiny_patch16 at 32x32 in the JAX checkpoint
    layout, drawn with numpy (chip_smoke.jax_vit_params); a head of std
    `head_std` spreads the predictions over the classes."""
    return chip_smoke.jax_vit_params(np.random.default_rng(seed), dim=192, depth=12,
                                     heads=3, patch=16, img=32, num_classes=NUM_CLASSES,
                                     head_std=head_std)


def _flatten_shapes(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(p.key for p in path): leaf.shape for path, leaf in leaves}


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


@pytest.fixture(scope="module")
def vit_ckpt(tmp_path_factory):
    """A checkpoint in the layout the JAX train.py writes, with EMA weights
    that differ from the raw ones, and class_indices.json beside it."""
    out = tmp_path_factory.mktemp("vit_ckpt")
    ck = {
        "format_version": 1,
        "model_spec": {"name": "vit_tiny_patch16",
                       "kwargs": {"num_classes": NUM_CLASSES, "flash_attn": True}},
        "step": 4, "epoch": 0, "input_shape": [1, 32, 32, 3],
        "num_classes": NUM_CLASSES, "args": {},
        "model": _vit_tiny_flat(0), "model_ema": _vit_tiny_flat(1),
    }
    path = out / "checkpoint-0.pth"
    with open(path, "wb") as f:
        pickle.dump(ck, f, protocol=pickle.HIGHEST_PROTOCOL)
    (out / "class_indices.json").write_text('{"0": "cat", "1": "dog", "2": "fox"}')
    return str(path)


def _probs(toy_dataset, ckpt, model_ema, half_precision):
    from imageclassification_tpu.data.folder import scan_folder

    paths = [p for p, _ in scan_folder(toy_dataset).samples]
    jm, jp, jbs, _ = jax_val.initialize_model(ckpt, model_ema, half_precision=half_precision)
    jpredict = jax_val._predict_fn(jm)
    pm, _ = port_val.initialize_model(ckpt, model_ema, half_precision=half_precision,
                                      device="cpu")
    ppredict = port_val._predict_fn(pm)
    want, got = [], []
    for (_, jimgs), (_, pimgs) in zip(jax_val._batched(paths, 32, 16),
                                      port_val._batched(paths, 32, 16, "cpu")):
        want.append(np.asarray(jpredict(jp, jbs, jimgs)))
        got.append(ppredict(pimgs).numpy())
    return np.concatenate(got)[: len(paths)], np.concatenate(want)[: len(paths)]


# fp32 atol 1e-5 (measured ~1e-6: summation order and the LayerNorm variance
# formula). bf16 atol 2e-2: both run bf16 compute with fp32 LayerNorm
# statistics and head, rounding at different points over 12 blocks (flax
# rounds each matmul before its bias and takes softmax in bf16).
@pytest.mark.parametrize("half_precision,atol,model_ema", [
    (False, 1e-5, False), (True, 2e-2, True),
])
def test_predict_probabilities_match_jax(jax_reference, toy_dataset, vit_ckpt,
                                         half_precision, atol, model_ema):
    got, want = _probs(toy_dataset, vit_ckpt, model_ema, half_precision)
    assert got.shape == want.shape == (30, NUM_CLASSES)
    assert np.isfinite(got).all()
    assert len(set(want.argmax(1).tolist())) > 1  # predictions are not all one class
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_val_precision_matches_jax(jax_reference, fp32_both, toy_dataset, vit_ckpt, capsys):
    want = jax_val.val_precision(toy_dataset, vit_ckpt, 32, model_ema=False, batch_size=16)
    want_out = capsys.readouterr().out
    got = port_val.val_precision(toy_dataset, vit_ckpt, 32, model_ema=False, batch_size=16,
                                 device="cpu")
    got_out = capsys.readouterr().out
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert int(got[0].sum() + got[1].sum()) == 30
    assert [l for l in got_out.splitlines() if l.startswith("Precision")] == \
        [l for l in want_out.splitlines() if l.startswith("Precision")]


def test_val_move_matches_jax(jax_reference, fp32_both, toy_dataset, vit_ckpt, tmp_path):
    moved = {}
    for side, fn, kw in (("jax", jax_val.val_move, {}),
                         ("port", port_val.val_move, {"device": "cpu"})):
        src = tmp_path / side / "incoming"
        src.mkdir(parents=True)
        for cls in sorted(os.listdir(toy_dataset)):
            for f in sorted(os.listdir(os.path.join(toy_dataset, cls)))[:4]:
                shutil.copy(os.path.join(toy_dataset, cls, f), src / f"{cls}_{f}")
        fn(str(src) + "/", vit_ckpt, 32, False, batch_size=5, **kw)
        assert not os.listdir(src)
        moved[side] = {d: sorted(os.listdir(tmp_path / side / d)) for d in ("Empty", "NonEmpty")}
    assert moved["port"] == moved["jax"]
    assert sum(len(v) for v in moved["port"].values()) == 12


def test_training_class_map_matches(vit_ckpt):
    assert port_val._training_class_map(vit_ckpt) == jax_val._training_class_map(vit_ckpt)
    assert port_val._training_class_map(str(ROOT / "nowhere" / "x.pth")) is None


def test_eval_step_sums_match_jax_with_padded_tail():
    # fp32 on the einsum attention path (the flash path is covered above);
    # 6 real samples and 2 pad rows (label -1)
    flat = _vit_tiny_flat(2, head_std=1.0)
    jmodel = jax_create_model("vit_tiny_patch16", num_classes=NUM_CLASSES)
    params = _nest(flat)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    labels = np.asarray([0, 1, 2, 2, 1, 0, -1, -1])
    want = jax_build_eval_step(jmodel, NUM_CLASSES)(
        params, {}, {"image": jnp.asarray(images), "label": jnp.asarray(labels, jnp.int32)})

    from imageclassification_tpu_torch.checkpoint.io import load_params_with_pruning
    from imageclassification_tpu_torch.models import create_model

    pmodel = create_model("vit_tiny_patch16", num_classes=NUM_CLASSES, img_size=32)
    assert load_params_with_pruning(pmodel, flat, verbose=False) == 0
    got = build_eval_step(pmodel, NUM_CLASSES)(
        {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    assert float(got["n"]) == 6.0
    for k in ("n", "top1_sum", "top5_sum", "tp", "fp", "fn"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # fp32 loss sum over 6 samples: summation order only
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)


def test_int8_checkpoint_not_ported_yet(vit_ckpt, tmp_path):
    with open(vit_ckpt, "rb") as f:
        ck = pickle.load(f)
    ck["quant_dtype"] = "int8"
    ck["quant_scales"] = {"head/kernel": np.ones(NUM_CLASSES, np.float32)}
    path = tmp_path / "checkpoint-int8.pth"
    with open(path, "wb") as f:
        pickle.dump(ck, f)
    # int8 execution is ported: the scale is active, but the head kernel
    # arrived fp32, so it stays a float Linear (the JAX interceptor's rule)
    model, ck = port_val.initialize_model(str(path), False, return_checkpoint=True,
                                          device="cpu")
    assert list(ck["quant_exec_scales"]) == ["head/kernel"]
    assert not any(type(m).__name__ == "Int8Linear" for m in model.modules())
    model, _ = port_val.initialize_model(str(path), False, dequantize=True, device="cpu")
    assert not model.training


def _imports(path):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "imageclassification_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "imageclassification_tpu"), \
                f"{path} imports {mod}"


def test_entry_points_refuse_silent_cpu(toy_dataset, vit_ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_val.val_precision(toy_dataset, vit_ckpt, 32, False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_val.initialize_model(vit_ckpt, False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_val.main(["--img_path", toy_dataset, "--model_weight_path", vit_ckpt])
    with pytest.raises(ValueError):
        resolve_device("tpu")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_runs_on_cpu(toy_dataset, vit_ckpt, capsys):
    port_val.main(["--img_path", toy_dataset, "--model_weight_path", vit_ckpt,
                   "--img_size", "32", "--batch_size", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Start calculation!" in out and "initialize model_ema success" in out
    assert "Precision2:" in out


def test_chip_smoke_checkpoint_layout_is_the_jax_layout():
    flat = chip_smoke.jax_vit_params(np.random.default_rng(0), dim=192, depth=12, heads=3,
                                     patch=16, img=32, num_classes=NUM_CLASSES)
    model = jax_create_model("vit_tiny_patch16", num_classes=NUM_CLASSES)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    assert {k: v.shape for k, v in flat.items()} == _flatten_shapes(shapes["params"])


def test_chip_smoke_main_path_rehearsal_on_cpu(tmp_path):
    # the main path of chip_smoke.py at a tiny size on the CPU: plain
    # versions, so no kernel launches
    model = dict(name="vit_tiny_patch16", dim=192, depth=12, heads=3, patch=16)
    res = chip_smoke.run_main_path(str(tmp_path), "cpu", model, img=32, num_classes=3,
                                   per_class=5, batch=4)
    assert res["n_images"] == 15 and res["n_batches"] == 4
    assert res["launches_val_precision"] == res["launches_val_move"] == 0
    assert res["probs_flash_vs_fp32"] <= chip_smoke.PROBS_ATOL


def test_attention_bound_numbers():
    ms, by = chip_smoke.attention_bound(64, 197, 12, 64)
    assert by == "bytes" and abs(ms - 4 * 64 * 197 * 12 * 64 * 2 / 3.35e12 * 1e3) < 1e-12
    ms, by = chip_smoke.attention_bound(2, 4097, 12, 64)
    assert by == "operations" and abs(ms - 4 * 2 * 12 * 4097 ** 2 * 64 / 989e12 * 1e3) < 1e-12


@pytest.mark.parametrize("n", [37, 65])
def test_chip_smoke_attention_check_sees_a_dropped_last_key(n):
    # the kernel check of chip_smoke.py on the CPU: the bf16-rounded plain
    # version passes, an output that leaves out the last key of a ragged tail
    # fails
    from imageclassification_tpu_torch.ops.flash_attention import flash_attention_ref

    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.standard_normal((2, n, 3, 2, 64)).astype(np.float32))
    q, k, v = qkv.to(torch.bfloat16).unbind(2)
    err, tol, tail = chip_smoke.compare_attention(flash_attention_ref(q, k, v), q, k, v)
    assert err <= tol < tail
    with pytest.raises(AssertionError, match="max"):
        chip_smoke.compare_attention(flash_attention_ref(q, k[:, :-1], v[:, :-1]), q, k, v)


def test_chip_smoke_plain_attention_in_batch_slices_is_the_whole(monkeypatch):
    # the fp32 plain versions that chip_smoke.py holds the kernels to at
    # 16 x 4097 run a few batch elements at a time (their scores would not
    # fit at once): the same function, and the backward check still sees a
    # dropped last key
    from imageclassification_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((5, 33, 3, 2, 64)).astype(np.float32))
    q, k, v = qkv.to(torch.bfloat16).unbind(2)
    do = torch.from_numpy(rng.standard_normal((5, 33, 2, 64)).astype(np.float32))
    do = do.to(torch.bfloat16)
    o, lse = fa.flash_attention_ref(q, k, v), fa.flash_attention_lse_ref(q, k)
    whole = (o, lse, fa.flash_attention_bwd_ref(q, k, v, o, lse, do))
    monkeypatch.setattr(chip_smoke, "PLAIN_SCORE_BYTES", 2 * 2 * 33 * 33 * 4)  # 2 at a time
    sliced = (chip_smoke.by_batch(fa.flash_attention_ref, q, k, v),
              chip_smoke.by_batch(fa.flash_attention_lse_ref, q, k),
              chip_smoke.by_batch(fa.flash_attention_bwd_ref, q, k, v, o, lse, do))
    for a, b in zip((whole[0], whole[1], *whole[2]), (sliced[0], sliced[1], *sliced[2])):
        assert a.shape == b.shape
        torch.testing.assert_close(b.float(), a.float(), rtol=0, atol=1e-6)
    errs = chip_smoke.compare_backward(whole[2], q, k, v, do)
    assert all(e <= t < c for e, t, c in errs.values())
    dropped = fa.flash_attention_bwd_ref(q, k[:, :-1], v[:, :-1], fa.flash_attention_ref(
        q, k[:, :-1], v[:, :-1]), fa.flash_attention_lse_ref(q, k[:, :-1]), do)
    with pytest.raises(AssertionError, match="max"):
        chip_smoke.compare_backward((dropped[0], whole[2][1], whole[2][2]), q, k, v, do)
