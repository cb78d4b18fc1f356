"""Port ViT (imageclassification_tpu_torch/models/vit.py) against the JAX ViT
on the same inputs and the same weights, carried by
`checkpoint/from_jax.py::vit_state_dict_from_jax`. The JAX flash path runs
its Pallas kernel in interpret mode on the CPU; the port's wrapper takes its
plain version for CPU tensors."""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from imageclassification_tpu.checkpoint.torch_convert import convert_vit
from imageclassification_tpu.models import model_kwargs_for as jax_model_kwargs_for
from imageclassification_tpu.models.vit import ViT as JaxViT
from imageclassification_tpu_torch import models as port_models
from imageclassification_tpu_torch.checkpoint.from_jax import vit_state_dict_from_jax
from imageclassification_tpu_torch.checkpoint.io import load_params_with_pruning
from imageclassification_tpu_torch.models import vit as port_vit
from imageclassification_tpu_torch.models.layers import DropPath, drop_path_rates

SMALL = dict(patch_size=16, dim=128, depth=2, num_heads=2, num_classes=5)


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


def _jax_small(seed=0, **kw):
    """A small JAX ViT and flat params drawn with numpy in its checkpoint
    layout (chip_smoke.jax_vit_params), the head at std 0.02 like the other
    kernels."""
    flat = chip_smoke.jax_vit_params(np.random.default_rng(seed), dim=128, depth=2, heads=2,
                                     patch=16, img=32, num_classes=5, head_std=0.02)
    params = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return JaxViT(**SMALL, **kw), params, flat


def _port_small(flat, **kw):
    model = port_vit.ViT(**SMALL, img_size=32, **kw)
    model.load_state_dict(vit_state_dict_from_jax(flat, SMALL["num_heads"]))
    return model.eval()


# fp32 atol 1e-4: same function, but flax LayerNorm takes var = E[x^2]-E[x]^2
# and torch the two-pass variance, and sums run in another order.
# bf16 atol 2e-2: both sides compute in bf16 with fp32 LayerNorm statistics
# and an fp32 head, but round at different points (flax rounds the matmul
# before adding the bias and runs softmax in bf16; the port's CPU flash path
# is fp32 inside), about one bf16 ulp per layer on logits of magnitude ~0.3.
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("precision,jdt,tdt,atol", [
    ("fp32", jnp.float32, torch.float32, 1e-4),
    ("bf16", jnp.bfloat16, torch.bfloat16, 2e-2),
])
def test_logits_match_jax(interpret_mode, flash, precision, jdt, tdt, atol):
    jmodel, params, flat = _jax_small(flash_attn=flash, dtype=jdt)
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = _port_small(flat, flash_attn=flash, dtype=tdt)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 5)
    assert np.abs(want).max() > 0.05  # the head is not degenerate
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_weight_carry_round_trip_is_exact():
    _, _, flat = _jax_small()
    model = _port_small(flat)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back, _ = convert_vit(sd, "vit_small_test")  # not registered: heads = dim // 64
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_param_count_matches_jax():
    _, _, flat = _jax_small()
    n_jax = sum(v.size for v in flat.values())
    n_port = sum(p.numel() for p in port_vit.ViT(**SMALL, img_size=32).parameters())
    assert n_port == n_jax


def test_init_follows_jax_initializers():
    g = torch.Generator().manual_seed(0)
    m = port_vit.ViT(**SMALL, img_size=32, generator=g)
    w = m.blocks[0].attn.qkv.weight
    assert abs(w.std().item() - 0.02) < 2e-3 and w.abs().max().item() <= 0.04 / 0.8796 + 1e-6
    assert torch.all(m.head.weight == 0) and torch.all(m.cls_token == 0)
    assert torch.all(m.norm.weight == 1)
    g2 = torch.Generator().manual_seed(0)
    torch.testing.assert_close(
        port_vit.ViT(**SMALL, img_size=32, generator=g2).pos_embed, m.pos_embed)


def test_pruning_skips_mismatched_head(capsys):
    _, _, flat = _jax_small()
    model = port_vit.ViT(**{**SMALL, "num_classes": 7}, img_size=32)
    dropped = load_params_with_pruning(model, flat, verbose=True)
    assert dropped == 2
    out = capsys.readouterr().out
    assert "Skipping mismatched key: head/kernel" in out
    assert "Skipping mismatched key: head/bias" in out
    np.testing.assert_array_equal(
        model.blocks[1].mlp.fc2.bias.detach().numpy(), flat["block1/Mlp_0/Dense_1/bias"])


def test_carry_rejects_wrong_head_count():
    _, _, flat = _jax_small()
    with pytest.raises(ValueError):
        vit_state_dict_from_jax(flat, num_heads=4)


@pytest.mark.parametrize("train,drop_rate,expect_flash_calls", [
    (False, 0.0, 2), (False, 0.1, 2), (True, 0.0, 2), (True, 0.1, 0),
])
def test_flash_selection_rule(monkeypatch, train, drop_rate, expect_flash_calls):
    # use_flash = flash_attn and (drop_rate == 0 or not train), per block
    calls = []
    real = port_vit.flash_attention
    monkeypatch.setattr(port_vit, "flash_attention",
                        lambda q, k, v: calls.append(1) or real(q, k, v))
    model = port_vit.ViT(**SMALL, img_size=32, flash_attn=True, drop_rate=drop_rate)
    model.train(train)
    model(torch.zeros(2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    assert len(calls) == expect_flash_calls


def test_training_randomness_needs_a_generator():
    model = port_vit.ViT(**SMALL, img_size=32, drop_rate=0.1).train()
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        model(x)
    a = model(x, generator=torch.Generator().manual_seed(5))
    b = model(x, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_drop_path_per_sample_and_rates():
    dp = DropPath(0.5).train()
    x = torch.ones(64, 3, 4)
    y = dp(x, torch.Generator().manual_seed(0))
    per_sample = y.flatten(1)
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert torch.all(per_sample.min(1).values == per_sample.max(1).values)
    assert dp.eval()(x) is x
    from imageclassification_tpu.models.layers import drop_path_rates as jax_rates

    assert drop_path_rates(0.3, [2, 3]) == jax_rates(0.3, [2, 3])


@pytest.mark.parametrize("name", ["vit_tiny_patch16", "vit_tiny_patch16_224",
                                  "vit_small_patch32_224"])
def test_registry_builds_vit_names(name):
    m = port_models.create_model(name, num_classes=3, half_precision=True,
                                 flash_attn=True, pretrained_path="x", attn_impl="bhnd")
    assert isinstance(m, port_vit.ViT) and m.dtype == torch.bfloat16 and m.flash_attn
    assert m.head.out_features == 3


def test_registry_builds_swin_and_refuses_unknown_names():
    from imageclassification_tpu_torch.models.swin import SwinTransformer

    m = port_models.create_model("swin_tiny", num_classes=3, attn_layout="legacy")
    assert isinstance(m, SwinTransformer) and m.attn_layout == "legacy"
    with pytest.raises(ValueError):
        port_models.create_model("no_such_model")


def test_registry_knows_every_jax_name():
    from imageclassification_tpu.models import list_models as jax_list

    assert port_models.list_models() == jax_list()


@pytest.mark.parametrize("model", ["vit_base_patch16", "resnet50", "convnext_tiny",
                                   "efficientvit_m0", "swin_tiny"])
@pytest.mark.parametrize("flash", [False, True])
def test_model_kwargs_for_matches_jax(model, flash):
    args = argparse.Namespace(model=model, pretrained=False, drop_path=0.1,
                              input_size=224, flash_attn=flash,
                              swin_attn_layout="merged")
    assert port_models.model_kwargs_for(args, 4) == jax_model_kwargs_for(args, 4)
