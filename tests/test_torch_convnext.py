"""Port ConvNeXt (imageclassification_tpu_torch/models/convnext.py) and its
weight carry (checkpoint/from_jax.py, to_jax.py) against the JAX package's
ConvNeXt and `torch_convert.convert_convnext`, on the same numpy-drawn
weights and inputs, at small dims (depths (1, 1, 2, 1), dims
(16, 32, 64, 128), 32x32 input), V1 and V2 (GRN), fp32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imageclassification_tpu.checkpoint.torch_convert import convert_convnext
from imageclassification_tpu.models import create_model as jax_create_model
from imageclassification_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from imageclassification_tpu_torch.checkpoint.from_jax import convnext_state_dict_with_sources
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for, convnext_flat_from_state_dict
from imageclassification_tpu_torch.models import convnext as port_convnext
from imageclassification_tpu_torch.models import create_model

SMALL = dict(depths=(1, 1, 2, 1), dims=(16, 32, 64, 128))
NUM_CLASSES = 5


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flatten(tree):
    return {"/".join(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def jax_convnext_flat(model, img: int, seed: int):
    """Flat parameters of a JAX ConvNeXt `model` at `img` x `img`, drawn
    with numpy: kernels N(0, 0.1), biases N(0, 0.05), LayerNorm scales
    1 + N(0, 0.1), layer scales and GRN parameters N(0, 0.3), so that every
    block moves the residual stream and every path shows in the output."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, img, img, 3)))
    flat = {}
    for k, s in _flatten(shapes["params"]).items():
        leaf = k.rsplit("/", 1)[-1]
        std = {"kernel": 0.1, "bias": 0.05}.get(leaf, 0.3 if leaf in ("gamma", "beta") else 0.1)
        v = std * rng.standard_normal(s.shape)
        if leaf == "scale":
            v += 1.0
        flat[k] = v.astype(np.float32)
    return flat


def _models(v2: bool, features_only: bool = False):
    kw = dict(**SMALL, num_classes=NUM_CLASSES, features_only=features_only)
    jmodel = JaxConvNeXt(**kw, layer_scale_init=0.0 if v2 else 1e-6, use_grn=v2)
    pmodel = port_convnext.ConvNeXt(**kw, layer_scale_init=0.0 if v2 else 1e-6, use_grn=v2)
    flat = jax_convnext_flat(jmodel, 32, seed=int(v2) + 2 * int(features_only))
    sd, _, unused = convnext_state_dict_with_sources(flat)
    assert not unused
    assert set(sd) == set(pmodel.state_dict())
    pmodel.load_state_dict(sd)
    return jmodel, pmodel, flat


def _images(seed=0, batch=3):
    return np.random.default_rng(seed).standard_normal((batch, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2_grn"])
def test_logits_match_jax(v2, train):
    # fp32, the same function: summation order, the conv algorithm and the
    # LayerNorm variance formula differ; 1e-5 on logits of magnitude ~1
    jmodel, pmodel, flat = _models(v2)
    x = _images()
    want = np.asarray(jmodel.apply({"params": _nest(flat)}, jnp.asarray(x), train=train,
                                   rngs={"dropout": jax.random.key(0)}))
    got = pmodel.train(train)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (3, NUM_CLASSES) and got.dtype == np.float32
    assert np.abs(want).max() > 0.1  # the logits are not degenerate
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_features_only_match_jax():
    jmodel, pmodel, flat = _models(v2=False, features_only=True)
    assert {k for k in flat if k.startswith("norm")} == {
        f"norm{i}/{p}" for i in range(4) for p in ("scale", "bias")}
    x = _images(seed=1)
    want = jmodel.apply({"params": _nest(flat)}, jnp.asarray(x))
    got = pmodel.eval()(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (3, 32 // 4 // 2 ** i, 32 // 4 // 2 ** i, SMALL["dims"][i])
        # LayerNorm outputs of magnitude ~1, fp32: 1e-5
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=f"norm{i}")


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2_grn"])
def test_weight_carry_round_trips_exactly(v2):
    _, pmodel, flat = _models(v2)
    # JAX -> port -> JAX is exact, through the port's carry both ways
    back = convnext_flat_from_state_dict(pmodel.state_dict())
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    # and the JAX package's own converter reads the port's state_dict
    # (timm names) to the same flat parameters
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    params, stats = convert_convnext(sd, "convnextv2_atto" if v2 else "convnext_atto")
    assert stats == {} and set(params) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(params[k], flat[k], err_msg=k)


def test_features_only_norms_carry():
    _, pmodel, flat = _models(v2=False, features_only=True)
    back = carry_for(pmodel).to_jax(pmodel.state_dict())
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_carry_reports_unknown_keys():
    _, _, flat = _models(v2=False)
    flat = dict(flat, **{"stage0_block0/Conv_0/extra": np.zeros(3, np.float32),
                         "nowhere/kernel": np.zeros(3, np.float32)})
    sd, src, unused = convnext_state_dict_with_sources(flat)
    assert sorted(unused) == ["nowhere/kernel", "stage0_block0/Conv_0/extra"]
    assert src["stages.0.blocks.0.conv_dw.weight"] == ["stage0_block0/Conv_0/kernel"]
    assert tuple(sd["stages.0.blocks.0.conv_dw.weight"].shape) == (16, 1, 7, 7)
    with pytest.raises(KeyError, match="no JAX name"):
        convnext_flat_from_state_dict({"stem.2.weight": torch.zeros(3)})


@pytest.mark.parametrize("name", port_convnext.NAMES)
def test_every_registry_name_has_the_jax_parameter_tree(name):
    # all 17 constructors: the same parameter names and shapes as the JAX
    # model of that name (at 32x32; shapes do not depend on the input size)
    jmodel = jax_create_model(name, num_classes=NUM_CLASSES)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    want = {k: tuple(v.shape) for k, v in _flatten(shapes["params"]).items()}
    with torch.device("meta"):
        pmodel = create_model(name, num_classes=NUM_CLASSES, img_size=32)
    got = {k: tuple(v.shape) for k, v in convnext_flat_from_state_dict(
        {k: torch.empty(v.shape) for k, v in pmodel.state_dict().items()}).items()}
    assert got == want


def test_bf16_model_keeps_an_fp32_head():
    # the JAX head is nn.Dense(dtype=float32) even in a bf16 model
    model = create_model("convnext_atto", num_classes=NUM_CLASSES, half_precision=True)
    out = model(torch.from_numpy(_images(batch=2)))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    feats = create_model("convnext_atto", half_precision=True, features_only=True,
                         out_indices=(1, 3))(torch.from_numpy(_images(batch=1)))
    assert [f.dtype for f in feats] == [torch.bfloat16] * 2
    assert [f.shape[-1] for f in feats] == [80, 320]


def test_carry_of_an_unported_family_names_its_roadmap_item():
    # checkpoint/io.py dispatches the carry by family: ViT, ConvNeXt,
    # ResNet, EfficientViT; any other model raises, naming the ROADMAP items
    # of the families left
    assert carry_for(create_model("convnext_atto")).to_jax is convnext_flat_from_state_dict
    with pytest.raises(NotImplementedError, match="A14"):
        carry_for(torch.nn.Linear(2, 2))
