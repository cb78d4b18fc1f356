"""The port's MobileNetV3, EfficientNet and DenseNet
(imageclassification_tpu_torch/models/{mobilenetv3,efficientnet,densenet}.py)
against the JAX package's models on the same weights and inputs: narrow
instances that both packages build (a few blocks, few channels, 64x64
inputs) for the logits in fp32 and bf16, eval and train mode, and one train
step; every registry name at full width for the parameter tree and count,
the weight carry, the torch/timm converter, and a port checkpoint that the
JAX val.py serves."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jax_draws
from imageclassification_tpu import config as jax_config
from imageclassification_tpu.checkpoint import torch_convert as jax_convert
from imageclassification_tpu.data.mixup import build_mixup as jax_build_mixup
from imageclassification_tpu.engine.state import create_train_state as jax_create_state
from imageclassification_tpu.engine.step import build_train_step as jax_build_train_step
from imageclassification_tpu.models import create_model as jax_create_model
from imageclassification_tpu.models import densenet as jax_densenet
from imageclassification_tpu.models import efficientnet as jax_efficientnet
from imageclassification_tpu.models import mobilenetv3 as jax_mobilenetv3
from imageclassification_tpu.optim.factory import create_optimizer as jax_create_optimizer
from imageclassification_tpu_torch import config
from imageclassification_tpu_torch import val as port_val
from imageclassification_tpu_torch.checkpoint import io as port_io
from imageclassification_tpu_torch.checkpoint import torch_convert as port_convert
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for
from imageclassification_tpu_torch.data.mixup import build_mixup
from imageclassification_tpu_torch.engine.state import create_train_state
from imageclassification_tpu_torch.engine.step import build_train_step
from imageclassification_tpu_torch.models import create_model, list_models
from imageclassification_tpu_torch.models import densenet as port_densenet
from imageclassification_tpu_torch.models import efficientnet as port_efficientnet
from imageclassification_tpu_torch.models import mobilenetv3 as port_mobilenetv3
from imageclassification_tpu_torch.models.layers import batch_norm_stats
from imageclassification_tpu_torch.optim.factory import create_optimizer

NUM_CLASSES = 5
# 64x64: the last stage's maps are 2x2 (stride 32), so train mode's batch
# statistics there are over 4 values a sample; at 32x32 (1x1 maps, batch 4)
# the fp32 evaluations of both packages lie ~2e-5 from a float64 one
IMG = 64
NAMES = [n for n in list_models() if n.startswith(("mobilenet", "efficientnet_", "densenet"))]


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flatten(tree):
    return {"/".join(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def nest(flat):
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(np.array(v))
    return out


def seeded_flat(jmodel, img: int, seed: int):
    """(flat parameters, flat batch statistics) of a JAX model at `img` x
    `img`, drawn with numpy so that activations stay of magnitude ~1: conv
    and Dense kernels of std sqrt(1 / fan_in) (conv kernels centred per
    output channel), biases N(0, 0.1), BatchNorm scales 1 + N(0, 0.2) and
    biases N(0, 0.2), a head of std 0.05, Swin's bias tables N(0, 0.5);
    running means N(0, 0.2) and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, img, img, 3)))
    params = {}
    for k, s in flatten(shapes["params"]).items():
        if k.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.standard_normal(s.shape) / np.sqrt(fan_in)
            if len(s.shape) == 4:
                v -= v.mean(axis=(0, 1, 2), keepdims=True)
            if k.startswith("head/"):
                v = 0.05 * rng.standard_normal(s.shape)
        elif k.endswith("relative_position_bias_table"):
            v = 0.5 * rng.standard_normal(s.shape)
        elif k.endswith("scale"):
            v = 1.0 + 0.2 * rng.standard_normal(s.shape)
        else:
            v = (0.2 if "bn" in k or "norm" in k else 0.1) * rng.standard_normal(s.shape)
        params[k] = v.astype(np.float32)
    stats = {k: (rng.uniform(0.5, 1.5, s.shape) if k.endswith("var")
                 else 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
             for k, s in flatten(shapes.get("batch_stats", {})).items()}
    return params, stats


def carried(pmodel, params, stats):
    """`pmodel` with the JAX flat parameters and statistics carried onto it
    (every key of its state_dict, nothing left over)."""
    sd, _, unused = carry_for(pmodel).to_port({**params, **stats})
    assert not unused, unused[:5]
    assert set(sd) == set(pmodel.state_dict())
    pmodel.load_state_dict(sd)
    return pmodel


# narrow instances both packages build: MobileNetV3 with the small table's
# first five blocks (no expand / expand, SE on and off, relu and hardswish,
# a residual, strides 1 and 2), EfficientNet at width 0.25 and depth 0.5
# (depthwise-separable and inverted-residual blocks, residuals), DenseNet
# with two blocks of two layers at growth 8 (a transition)
_MBV3_CFGS = jax_mobilenetv3._SMALL[:5]


def narrow(family: str, dtype=torch.float32, drop_rate: float = 0.0):
    """(JAX model, port model) of `family`, narrow, without dropout."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    if family == "mobilenetv3":
        cfgs = [port_mobilenetv3.BlockCfg(*c) for c in _MBV3_CFGS]
        return (jax_mobilenetv3.MobileNetV3(_MBV3_CFGS, 64, NUM_CLASSES, drop_rate, jdtype),
                port_mobilenetv3.MobileNetV3(cfgs, 64, NUM_CLASSES, drop_rate, dtype))
    if family == "efficientnet":
        return (jax_efficientnet.EfficientNet(0.25, 0.5, NUM_CLASSES, drop_rate, 0.0, jdtype),
                port_efficientnet.EfficientNet(0.25, 0.5, NUM_CLASSES, drop_rate, 0.0, dtype))
    return (jax_densenet.DenseNet((2, 2), 8, NUM_CLASSES, jdtype),
            port_densenet.DenseNet((2, 2), 8, NUM_CLASSES, dtype))


FAMILIES = ["mobilenetv3", "efficientnet", "densenet"]


def images(seed=0, batch=4, img=IMG):
    return np.random.default_rng(seed).standard_normal((batch, img, img, 3)).astype(np.float32)


def jax_logits(jmodel, params, stats, x, train):
    variables = {"params": nest(params)}
    if stats:
        variables["batch_stats"] = nest(stats)
    if train:
        out, _ = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.key(0)})
        return np.asarray(out, np.float32)
    return np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False), np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_jax(family, train):
    # fp32: the same function in another order, logits of magnitude ~1 to
    # 1e-5; train mode normalises with the batch statistics in both
    jmodel, pmodel = narrow(family)
    params, stats = seeded_flat(jmodel, IMG, 1)
    carried(pmodel, params, stats)
    x = images()
    want = jax_logits(jmodel, params, stats, x, train)
    pmodel.train(train)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), generator=torch.Generator()).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_logits_match_jax(family):
    # bf16 compute with fp32 parameters and statistics in both: bf16 keeps 8
    # bits, and two orders of the same products round apart; 2e-2 on logits
    # of magnitude ~1
    jmodel, pmodel = narrow(family, torch.bfloat16)
    params, stats = seeded_flat(jmodel, IMG, 2)
    carried(pmodel, params, stats)
    x = images(1)
    want = jax_logits(jmodel, params, stats, x, False)
    with torch.no_grad():
        got = pmodel.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32  # the head in fp32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)


def step_vs_jax(jmodel, pmodel, params, stats, img, model_name, batch=4):
    """One train step (AdamW with eps 1: its update follows the gradient;
    mixup, EMA and the exact-mode accuracy on) of the JAX and the port
    model from the same weights, batch and draws: the loss to 1e-5, the
    updates of the parameters and the EMA to 1e-4 of the largest update,
    the running statistics and their EMA to 1e-5."""
    common = dict(model=model_name, half_precision=False, model_ema=True, model_ema_decay=0.9,
                  lr=0.01, weight_decay=0.05, opt="adamw", opt_eps=1.0, drop_path=0.0,
                  reprob=0.5, color_jitter=0.3, input_size=img)
    jargs = jax_config.TrainConfig(**common)
    pargs = config.TrainConfig(**common, device="cpu")
    lr_sched, wd_sched = np.full(2, jargs.lr), np.full(2, jargs.weight_decay)
    tx = jax_create_optimizer(jargs.opt, jargs.lr, jargs.weight_decay, opt_eps=jargs.opt_eps)
    jstate = jax_create_state(jmodel, tx, jax.random.key(0), (1, img, img, 3), use_ema=True)
    jstate = jstate.replace(params=nest(params), ema_params=nest(params),
                            opt_state=tx.init(nest(params)))
    if stats:
        jstate = jstate.replace(batch_stats=nest(stats), ema_batch_stats=nest(stats))
    jmix = jax_build_mixup(jargs, NUM_CLASSES)
    jstep = jax.jit(jax_build_train_step(jmodel, tx, jargs, NUM_CLASSES, jmix, lr_sched,
                                         wd_sched, ema_decay=jargs.model_ema_decay))
    popt = create_optimizer(pargs.opt, pmodel.parameters(), lr=pargs.lr,
                            weight_decay=pargs.weight_decay, opt_eps=pargs.opt_eps)
    pstate = create_train_state(pmodel, popt, use_ema=True)
    pstep = build_train_step(pmodel, pargs, NUM_CLASSES, build_mixup(pargs, NUM_CLASSES),
                             lr_sched, wd_sched, ema_decay=pargs.model_ema_decay)
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (batch, img, img, 3), dtype=np.uint8)
    labels = rng.integers(0, NUM_CLASSES, batch)
    key = jax.random.key(42)
    jstate, jm = jstep(jstate, {"image": jnp.asarray(imgs),
                                "label": jnp.asarray(labels, jnp.int32)}, key)
    pm = pstep(pstate, {"image": torch.from_numpy(imgs), "label": torch.from_numpy(labels)},
               jax_draws.step_draws(key, 0, batch, img, img, jargs, jmix))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(pm["skipped"]) == float(jm["skipped"]) == 0.0
    carry = carry_for(pmodel)
    jflat, jema = flatten(jstate.params), flatten(jstate.ema_params)
    pflat, pema = carry.to_jax(dict(pmodel.named_parameters())), carry.to_jax(pstate.ema)
    scale = max(np.abs(np.asarray(jflat[k]) - params[k]).max() for k in params)
    assert scale > 1e-4
    for k in params:
        np.testing.assert_allclose(pflat[k] - params[k], np.asarray(jflat[k]) - params[k],
                                   atol=1e-4 * scale, rtol=0, err_msg=k)
        np.testing.assert_allclose(pema[k] - params[k], np.asarray(jema[k]) - params[k],
                                   atol=1e-4 * scale, rtol=0, err_msg=f"ema {k}")
    if stats:
        jst, jema_st = flatten(jstate.batch_stats), flatten(jstate.ema_batch_stats)
        pst, pema_st = carry.to_jax(batch_norm_stats(pmodel)), carry.to_jax(pstate.ema_stats)
        assert set(pst) == set(jst) == set(stats)
        for k in stats:
            np.testing.assert_allclose(pst[k], np.asarray(jst[k]), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
            np.testing.assert_allclose(pema_st[k], np.asarray(jema_st[k]), atol=1e-5, rtol=1e-5,
                                       err_msg=f"ema {k}")


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_matches_jax(family):
    jmodel, pmodel = narrow(family)
    params, stats = seeded_flat(jmodel, IMG, 3)
    carried(pmodel, params, stats)
    step_vs_jax(jmodel, pmodel, params, stats, IMG,
                {"mobilenetv3": "mobilenetv3_small_100", "efficientnet": "efficientnet_b0",
                 "densenet": "densenet121"}[family])


@pytest.mark.parametrize("name", NAMES)
def test_every_name_has_the_jax_tree_and_count(name):
    # at full width: the carry of the port's parameters and statistics has
    # the JAX model's names and shapes, so the parameter counts agree
    jmodel = jax_create_model(name, num_classes=1000)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    pmodel = create_model(name, num_classes=1000)
    carry = carry_for(pmodel)
    for tree, got in (("params", dict(pmodel.named_parameters())),
                      ("batch_stats", batch_norm_stats(pmodel))):
        want = {k: tuple(v.shape) for k, v in flatten(shapes[tree]).items()}
        assert {k: v.shape for k, v in carry.to_jax(got).items()} == want, tree
    assert sum(p.numel() for p in pmodel.parameters()) == sum(
        int(np.prod(v.shape)) for v in flatten(shapes["params"]).values())


@pytest.mark.parametrize("name", NAMES)
def test_converter_matches_jax_on_a_hub_layout_state_dict(name):
    # the port's state_dict is the hub file's layout (torchvision / timm
    # names, with BatchNorm's num_batches_tracked beside): the port's
    # converter gives the JAX converter's flat exactly, and the carry takes
    # it back to the same tensors
    pmodel = create_model(name, num_classes=10)
    rng = np.random.default_rng(7)
    sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in pmodel.state_dict().items()}
    hub = dict(sd)
    hub.update({k[:-len("running_var")] + "num_batches_tracked": torch.tensor(3)
                for k in sd if k.endswith("running_var")})
    got = port_convert.convert_state_dict(dict(hub), name)
    want = jax_convert.convert_state_dict(dict(hub), name)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    back, _, unused = carry_for(pmodel).to_port({**got[0], **got[1]})
    assert not unused and set(back) == set(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)


def test_mobilenetv3_converter_refuses_a_timm_layout():
    # as the JAX converter: torchvision's layout only
    with pytest.raises(ValueError, match="timm-layout"):
        port_convert.convert_state_dict({"conv_stem.weight": np.zeros((16, 3, 3, 3))},
                                        "mobilenetv3_large_100")


SERVED = {"mobilenetv3": "mobilenet_v3_small", "efficientnet": "efficientnet_b0",
          "densenet": "densenet121"}


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_val_serves_a_port_checkpoint(family, tmp_path, monkeypatch):
    # a port checkpoint (save_model: the JAX layout with batch_stats) of the
    # full-width model, seeded, which the JAX val.py rebuilds from its
    # model_spec and serves to the port's probabilities (fp32, 1e-5)
    name = SERVED[family]
    img = 64
    pmodel = create_model(name, num_classes=NUM_CLASSES)
    params, stats = seeded_flat(jax_create_model(name, num_classes=NUM_CLASSES), img, 5)
    carried(pmodel, params, stats)
    state = create_train_state(pmodel, create_optimizer("adamw", pmodel.parameters(), 0.01, 0.05))
    args = config.TrainConfig(output_dir=str(tmp_path), device="cpu")
    path = port_io.save_model(args, [1, img, img, 3], 0, state, NUM_CLASSES,
                              {"name": name, "kwargs": {"num_classes": NUM_CLASSES}})

    import imageclassification_tpu.data.native_decode as jax_native
    import val as jax_val

    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    imgs = np.random.default_rng(0).integers(0, 256, (2, img, img, 3), dtype=np.uint8)
    jm, jp, jbs, _ = jax_val.initialize_model(path, False, half_precision=False)
    want = np.asarray(jax_val._predict_fn(jm)(jp, jbs, jnp.asarray(imgs)))
    pm, nc = port_val.initialize_model(path, False, half_precision=False, device="cpu")
    assert nc == NUM_CLASSES
    got = port_val._predict_fn(pm)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
