"""The port's Swin Transformer (imageclassification_tpu_torch/models/swin.py)
against the JAX package's (imageclassification_tpu/models/swin.py) on the
same weights and inputs: the static relative-position index and shift mask,
the window partition, the input sizes refused; a narrow Swin (embed 16,
depths 2/2/2, window 4, 32x32: a shifted stage, a stage of one window, a
clamped 2x2 window) for the logits in fp32 and bf16 against both JAX
`attn_layout`s, the per-stage features, and one train step; every registry
name at full width for the parameter tree and count and the timm
converter; and a port checkpoint that the JAX val.py serves."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imageclassification_tpu.checkpoint import torch_convert as jax_convert
from imageclassification_tpu.models import create_model as jax_create_model
from imageclassification_tpu.models import model_kwargs_for as jax_model_kwargs_for
from imageclassification_tpu.models import swin as jax_swin
from imageclassification_tpu_torch import config
from imageclassification_tpu_torch import val as port_val
from imageclassification_tpu_torch.checkpoint import io as port_io
from imageclassification_tpu_torch.checkpoint import torch_convert as port_convert
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for
from imageclassification_tpu_torch.engine.state import create_train_state
from imageclassification_tpu_torch.models import create_model, list_models, model_kwargs_for
from imageclassification_tpu_torch.models import swin as port_swin
from imageclassification_tpu_torch.optim.factory import create_optimizer
from test_torch_bn_families import carried, flatten, nest, seeded_flat, step_vs_jax

NUM_CLASSES = 5
IMG = 32
NARROW = dict(embed_dim=16, depths=(2, 2, 2), num_heads=(1, 2, 4), window=4,
              num_classes=NUM_CLASSES)
NAMES = [n for n in list_models() if n.startswith("swin")]
LAYOUTS = ["merged", "legacy"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("w", [2, 4, 7])
def test_relative_position_index_matches_jax(w):
    np.testing.assert_array_equal(port_swin.relative_position_index(w),
                                  jax_swin._relative_position_index(w))


@pytest.mark.parametrize("H,W,w,shift", [(8, 8, 4, 2), (56, 56, 7, 3), (14, 28, 7, 3)])
def test_shift_attn_mask_matches_jax(H, W, w, shift):
    np.testing.assert_array_equal(port_swin.shift_attn_mask(H, W, w, shift),
                                  jax_swin._shift_attn_mask(H, W, w, shift))


def test_window_partition_and_reverse_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)).astype(np.float32)
    got = port_swin.window_partition(torch.from_numpy(x), 4)
    want = np.asarray(jax_swin._window_partition(jnp.asarray(x), 4))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_swin.window_reverse(got, 4, 8, 12).numpy(), x)


@pytest.mark.parametrize("size", [224, 448, 225, 256, 28, 112])
def test_input_sizes_are_refused_as_in_jax(size):
    # check_input_size's error for every size JAX refuses, none for those it
    # takes (224 * 2^k for window 7)
    def outcome(fn):
        try:
            fn(size, 7)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(port_swin.check_input_size) == outcome(jax_swin.check_input_size)
    assert (outcome(port_swin.check_input_size) is None) == (size in (224, 448))
    if size == 256:
        with pytest.raises(ValueError, match="input size 256 unsupported"):
            create_model("swin_tiny", num_classes=3).eval()(torch.zeros(1, 256, 256, 3))


def _models(layout="merged", dtype=torch.float32, seed=1, **kw):
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmodel = jax_swin.SwinTransformer(**NARROW, attn_layout=layout, dtype=jdtype, **kw)
    pmodel = port_swin.SwinTransformer(**NARROW, attn_layout=layout, img_size=IMG, dtype=dtype,
                                       **kw)
    params, _ = seeded_flat(jmodel, IMG, seed)
    carried(pmodel, params, {})
    return jmodel, pmodel, params


def _images(seed=0, batch=4):
    return np.random.default_rng(seed).standard_normal((batch, IMG, IMG, 3)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_logits_match_jax(layout, train):
    # fp32 against either JAX layout (the merged one computes the same
    # function in another dataflow): logits of magnitude ~1 to 1e-5; no
    # dropout or drop path, so train mode is the same function
    jmodel, pmodel, params = _models(layout)
    assert [b.attn.window for s in pmodel.layers for b in s.blocks] == [4, 4, 4, 4, 2, 2]
    x = _images()
    want = np.asarray(jmodel.apply({"params": nest(params)}, jnp.asarray(x), train=train))
    pmodel.train(train)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), generator=torch.Generator()).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bf16_logits_match_jax(layout):
    # bf16 compute, fp32 parameters, LayerNorm statistics and head in both:
    # 2e-2 on logits of magnitude ~1
    jmodel, pmodel, params = _models(layout, torch.bfloat16, seed=2)
    x = _images(1)
    want = np.asarray(jmodel.apply({"params": nest(params)}, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = pmodel.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)


def test_features_only_matches_jax():
    # the downstream backbone's multi-scale maps: the per-stage out norms
    # (norm{i}) on strides 4, 8, 16
    jmodel, pmodel, params = _models(features_only=True, out_indices=(0, 2))
    assert "norm0.weight" in pmodel.state_dict() and "head.weight" not in pmodel.state_dict()
    x = _images(2)
    want = jmodel.apply({"params": nest(params)}, jnp.asarray(x))
    with torch.no_grad():
        got = pmodel.eval()(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(4, 8, 8, 16), (4, 2, 2, 64)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_train_step_matches_jax():
    # one step (AdamW eps 1, mixup, EMA, exact-mode accuracy) against the JAX
    # step on its default merged layout: the loss to 1e-5, the updates to
    # 1e-4 of the largest
    jmodel, pmodel, params = _models("merged", seed=3)
    step_vs_jax(jmodel, pmodel, params, {}, IMG, "swin_tiny")


@pytest.mark.parametrize("name", NAMES)
def test_every_name_has_the_jax_tree_and_count(name):
    jmodel = jax_create_model(name, num_classes=1000)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 224, 224, 3)))
    pmodel = create_model(name, num_classes=1000)
    want = {k: tuple(v.shape) for k, v in flatten(shapes["params"]).items()}
    got = carry_for(pmodel).to_jax(dict(pmodel.named_parameters()))
    assert {k: v.shape for k, v in got.items()} == want
    assert sum(p.numel() for p in pmodel.parameters()) == sum(
        int(np.prod(s)) for s in want.values())


@pytest.mark.parametrize("name", NAMES)
def test_converter_matches_jax_on_a_timm_state_dict(name):
    # a seeded timm-layout state_dict (the port's keys, with timm's
    # relative_position_index and attn_mask buffers beside): the port's
    # converter gives the JAX converter's flat exactly, and the carry takes
    # it back to the same tensors
    pmodel = create_model(name, num_classes=10)
    rng = np.random.default_rng(7)
    sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in pmodel.state_dict().items()}
    hub = dict(sd)
    hub["layers.0.blocks.1.attn_mask"] = torch.zeros(64, 49, 49)
    hub.update({f"layers.{s}.blocks.{b}.attn.relative_position_index":
                torch.zeros(49, 49, dtype=torch.int64)
                for s, stage in enumerate(pmodel.layers) for b in range(len(stage.blocks))})
    got, got_stats = port_convert.convert_state_dict(dict(hub), name)
    want, want_stats = jax_convert.convert_state_dict(dict(hub), name)
    assert set(got) == set(want) and got_stats == want_stats == {}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back, _, unused = carry_for(pmodel).to_port(got)
    assert not unused and set(back) == set(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_attn_layout_routes_as_in_jax(layout):
    import argparse

    args = argparse.Namespace(model="swin_tiny", pretrained=False, drop_path=0.1,
                              input_size=224, flash_attn=False, swin_attn_layout=layout)
    kw = model_kwargs_for(args, 3)
    assert kw == jax_model_kwargs_for(args, 3) and kw["attn_layout"] == layout
    assert create_model("swin_tiny", num_classes=3, attn_layout=layout).attn_layout == layout
    with pytest.raises(ValueError, match="attn_layout"):
        create_model("swin_tiny", attn_layout="blocked")


def test_jax_val_serves_a_port_checkpoint(tmp_path, monkeypatch):
    # a port checkpoint of a seeded swin_tiny (the JAX layout, model_spec
    # with attn_layout), which the JAX val.py rebuilds and serves at 224x224
    # to the port's probabilities (fp32, 1e-5)
    spec = {"name": "swin_tiny", "kwargs": {"num_classes": NUM_CLASSES, "attn_layout": "merged"}}
    pmodel = create_model("swin_tiny", num_classes=NUM_CLASSES)
    params, _ = seeded_flat(jax_create_model("swin_tiny", num_classes=NUM_CLASSES), 224, 5)
    carried(pmodel, params, {})
    state = create_train_state(pmodel, create_optimizer("adamw", pmodel.parameters(), 0.01, 0.05))
    path = port_io.save_model(config.TrainConfig(output_dir=str(tmp_path), device="cpu"),
                              [1, 224, 224, 3], 0, state, NUM_CLASSES, spec)

    import imageclassification_tpu.data.native_decode as jax_native
    import val as jax_val

    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    imgs = np.random.default_rng(0).integers(0, 256, (1, 224, 224, 3), dtype=np.uint8)
    jm, jp, jbs, _ = jax_val.initialize_model(path, False, half_precision=False)
    want = np.asarray(jax_val._predict_fn(jm)(jp, jbs, jnp.asarray(imgs)))
    pm, _ = port_val.initialize_model(path, False, half_precision=False, device="cpu")
    got = port_val._predict_fn(pm)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
