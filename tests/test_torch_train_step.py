"""Port train step (imageclassification_tpu_torch/engine/step.py) against the
JAX package's `build_train_step` on the same weights, batch and random draws:
a small ViT (dim 128, 2 heads of 64, depth 2, 32x32 input) with
flash_attn=True, the JAX side running its Pallas flash kernels (forward and
backward) in interpret mode, the port its plain versions; a small ConvNeXt
(depths (1, 1, 1, 1), dims (16, 32, 64, 128), drop_path 0); and a narrow
ResNet (Bottleneck, stages (1, 1, 1, 1), width 8) whose BatchNorm running
statistics and their EMA are held against the JAX state's too. fp32 on both
sides.

Gradients are compared through post-update parameters under SGD, and under
AdamW with a large eps (with a small eps, m/sqrt(v) turns a near-zero
gradient's rounding into a full-size update of either sign)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import jax_draws
from imageclassification_tpu.checkpoint.io import _flatten
from imageclassification_tpu.config import TrainConfig as JaxConfig
from imageclassification_tpu.data.mixup import build_mixup as jax_build_mixup
from imageclassification_tpu.engine.state import create_train_state as jax_create_state
from imageclassification_tpu.engine.step import _global_norm as jax_global_norm
from imageclassification_tpu.engine.step import build_train_step as jax_build_train_step
from imageclassification_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from imageclassification_tpu.models.resnet import Bottleneck as JaxBottleneck
from imageclassification_tpu.models.resnet import ResNet as JaxResNet
from imageclassification_tpu.models.vit import ViT as JaxViT
from imageclassification_tpu.optim.factory import create_optimizer as jax_create_optimizer
from imageclassification_tpu.optim.layer_decay import layer_decay_scales as jax_layer_decay_scales
from imageclassification_tpu_torch import train as port_train
from imageclassification_tpu_torch.checkpoint.from_jax import vit_state_dict_from_jax
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for, optimizer_to_jax
from imageclassification_tpu_torch.config import TrainConfig
from imageclassification_tpu_torch.data.mixup import build_mixup
from imageclassification_tpu_torch.engine.state import create_train_state
from imageclassification_tpu_torch.engine.step import build_train_step, global_norm
from imageclassification_tpu_torch.models import convnext as port_convnext
from imageclassification_tpu_torch.models import resnet as port_resnet
from imageclassification_tpu_torch.models import vit as port_vit
from imageclassification_tpu_torch.optim.factory import create_optimizer
from test_torch_convnext import jax_convnext_flat
from test_torch_resnet import jax_resnet_flat

SMALL = dict(patch_size=16, dim=128, depth=2, num_heads=2, num_classes=5)
SMALL_CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), num_classes=5)
B = 8


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
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _flat(seed=0):
    return chip_smoke.jax_vit_params(np.random.default_rng(seed), dim=128, depth=2, heads=2,
                                     patch=16, img=32, num_classes=5, head_std=0.1)


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8), rng.integers(0, 5, B)


def _configs(**kw):
    common = dict(model="vit_tiny_patch16", flash_attn=True, half_precision=False,
                  model_ema=True, model_ema_decay=0.9, lr=0.05, weight_decay=0.05,
                  reprob=0.5, color_jitter=0.3)
    common.update(kw)
    return JaxConfig(**common), TrainConfig(**{**common, "device": "cpu"})


def _family(name):
    """(JAX model, its flat parameters, its flat batch statistics, the port
    model carrying both) of a small ViT (flash attention), ConvNeXt
    (drop_path 0) or ResNet."""
    stats = {}
    if name == "vit":
        jmodel = JaxViT(**SMALL, flash_attn=True, dtype=jnp.float32)
        pmodel = port_vit.ViT(**SMALL, img_size=32, flash_attn=True)
        flat = _flat()
    elif name == "convnext":
        jmodel = JaxConvNeXt(**SMALL_CONVNEXT)
        pmodel = port_convnext.ConvNeXt(**SMALL_CONVNEXT)
        flat = jax_convnext_flat(jmodel, 32, seed=0)
    else:
        jmodel = JaxResNet([1, 1, 1, 1], JaxBottleneck, num_classes=5, width=8)
        pmodel = port_resnet.ResNet([1, 1, 1, 1], port_resnet.Bottleneck, num_classes=5, width=8)
        flat, stats = jax_resnet_flat(jmodel, 32, seed=0)
    pmodel.load_state_dict(carry_for(pmodel).to_port({**flat, **stats})[0])
    return jmodel, flat, stats, pmodel


CONVNEXT = dict(model="convnext_atto", flash_attn=False, drop_path=0.0)
RESNET = dict(model="resnet50", flash_attn=False)
CASES = {
    # name: (config overrides, steps); ViT unless the name starts with
    # another family's
    "mixup_off_sgd": (dict(mixup=0.0, opt="sgd"), 2),
    "mixup_on_sgd": (dict(opt="sgd", model_ema_warmup=True), 2),
    "update_freq_2_sgd": (dict(opt="sgd", update_freq=2, clip_grad=0.5), 4),
    "mixup_on_adamw_large_eps": (dict(opt="adamw", opt_eps=1.0, lr=0.01), 2),
    "convnext_mixup_off_sgd": (dict(CONVNEXT, mixup=0.0, opt="sgd"), 2),
    "convnext_mixup_on_adamw_large_eps": (dict(CONVNEXT, opt="adamw", opt_eps=1.0, lr=0.01), 2),
    # BatchNorm: the exact-mode accuracy forward on batch statistics, the
    # running statistics advancing at each finite micro-step, their EMA
    "resnet_mixup_on_adamw_large_eps": (dict(RESNET, opt="adamw", opt_eps=1.0, lr=0.01), 2),
    "resnet_update_freq_2_sgd": (dict(RESNET, opt="sgd", update_freq=2), 4),
    # --remat (the JAX loss under jax.checkpoint, the port's under torch's
    # checkpoint: the flash forward runs again in the backward), with
    # --layer_decay and the optimizers of the table
    "remat_lamb_layer_decay_large_eps": (dict(opt="lamb", opt_eps=1.0, lr=0.01, remat=True,
                                              layer_decay=0.65, clip_grad=1.0), 2),
    "remat_radam_layer_decay_update_freq_2": (dict(opt="radam", remat=True, layer_decay=0.75,
                                                   update_freq=2, opt_eps=1.0, lr=0.01), 4),
    "convnext_remat_adamp_layer_decay": (dict(CONVNEXT, opt="adamp", opt_eps=1.0, lr=0.01,
                                              remat=True, layer_decay=0.65), 2),
    "resnet_remat_lookahead_sgdp_layer_decay": (dict(RESNET, opt="lookahead_sgdp", remat=True,
                                                     layer_decay=0.65), 2),
}


def _flat_of(tree):
    return {"/".join(p.key for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _both(kw, family, n_steps):
    """(JAX state and jitted step, port state and step, the flat parameters
    and statistics they start from) of `family` under the config overrides
    `kw`, with schedules of `n_steps` entries."""
    jargs, pargs = _configs(**kw)
    jmodel, flat, stats, pmodel = _family(family)
    lr_sched = np.linspace(jargs.lr, jargs.lr / 2, n_steps)
    wd_sched = np.linspace(jargs.weight_decay, jargs.weight_decay / 2, n_steps)

    scales, bounds = None, (1.0, 1.0)
    if jargs.layer_decay < 1.0:  # as the JAX train.py builds them
        scales = jax_layer_decay_scales(_nest(flat), jargs.model, jargs.layer_decay)
        leaves = [float(x) for x in jax.tree_util.tree_leaves(scales)]
        bounds = (min(leaves), max(leaves))
    tx = jax_create_optimizer(jargs.opt, jargs.lr, jargs.weight_decay, opt_eps=jargs.opt_eps,
                              clip_grad=jargs.clip_grad, layer_scales=scales)
    jstate = jax_create_state(jmodel, tx, jax.random.key(0), (1, 32, 32, 3), use_ema=True,
                              update_freq=jargs.update_freq)
    jstate = jstate.replace(params=_nest(flat), ema_params=_nest(flat),
                            opt_state=tx.init(_nest(flat)))
    if stats:
        jstate = jstate.replace(batch_stats=_nest(stats), ema_batch_stats=_nest(stats))
    jmix = jax_build_mixup(jargs, 5)
    jstep = jax.jit(jax_build_train_step(jmodel, tx, jargs, 5, jmix, lr_sched, wd_sched,
                                         ema_decay=jargs.model_ema_decay,
                                         lr_scale_bounds=bounds))

    popt = create_optimizer(pargs.opt, pmodel.parameters(), lr=pargs.lr,
                            weight_decay=pargs.weight_decay, opt_eps=pargs.opt_eps,
                            clip_grad=pargs.clip_grad,
                            **port_train.optimizer_layout(pargs, pmodel))
    pstate = create_train_state(pmodel, popt, use_ema=True, update_freq=pargs.update_freq)
    pstep = build_train_step(pmodel, pargs, 5, build_mixup(pargs, 5), lr_sched, wd_sched,
                             ema_decay=pargs.model_ema_decay)
    return jargs, jmix, jstate, jstep, pstate, pstep, flat, stats


def _family_of(case):
    return case.split("_")[0] if case.startswith(("convnext", "resnet")) else "vit"


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(interpret_mode, case):
    kw, steps = CASES[case]
    jargs, jmix, jstate, jstep, pstate, pstep, flat, stats = _both(kw, _family_of(case), steps)
    pmodel = pstate.model
    images, labels = _batch()

    rng = jax.random.key(42)
    jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels, jnp.int32)}
    pbatch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    for s in range(steps):
        jstate, jm = jstep(jstate, jbatch, rng)
        draws = jax_draws.step_draws(rng, s, B, 32, 32, jargs, jmix)
        pm = pstep(pstate, pbatch, draws)
        # fp32, the same function: loss to 1e-5 relative, the gradient norm
        # to 1e-4 (summation order, LayerNorm's variance formula, the Pallas
        # kernel's block order); the counts of the exact-mode accuracy
        # forward on post-update weights exactly
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert pm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert pm["min_lr"] == pytest.approx(float(jm["min_lr"]), rel=1e-6)
        assert pm["weight_decay"] == pytest.approx(float(jm["weight_decay"]), rel=1e-6)
        assert float(pm["skipped"]) == float(jm["skipped"]) == 0.0
        for k in ("class_acc", "tp", "fp", "fn"):
            np.testing.assert_array_equal(np.asarray(pm[k]), np.asarray(jm[k]), err_msg=k)
    assert pstate.step == int(jstate.step) == steps

    # the updates of every parameter (and of the EMA) agree to 1e-4 of the
    # largest update: the gradients agree to fp32 rounding
    jflat, jema = _flat_of(jstate.params), _flat_of(jstate.ema_params)
    pflat = carry_for(pmodel).to_jax(dict(pmodel.named_parameters()))
    pema = carry_for(pmodel).to_jax(pstate.ema)
    scale = max(np.abs(jflat[k] - flat[k]).max() for k in flat)
    assert scale > 1e-4  # the steps moved the weights
    for k in flat:
        np.testing.assert_allclose(pflat[k] - flat[k], jflat[k] - flat[k], atol=1e-4 * scale,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(pema[k] - flat[k], jema[k] - flat[k], atol=1e-4 * scale,
                                   rtol=0, err_msg=f"ema {k}")
    if stats:
        # the running statistics and their EMA: fp32 batch means and biased
        # variances of the same activations, 1e-5 on values of magnitude ~1
        jst, jema_st = _flat_of(jstate.batch_stats), _flat_of(jstate.ema_batch_stats)
        pst = carry_for(pmodel).to_jax(dict(pmodel.named_buffers()))
        pema_st = carry_for(pmodel).to_jax(pstate.ema_stats)
        assert set(pst) == set(jst) == set(pema_st) == set(jema_st) == set(stats)
        assert max(np.abs(jst[k] - stats[k]).max() for k in stats) > 1e-2  # they moved
        for k in stats:
            np.testing.assert_allclose(pst[k], jst[k], atol=1e-5, rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(pema_st[k], jema_st[k], atol=1e-5, rtol=1e-5,
                                       err_msg=f"ema {k}")


NON_FINITE = {
    # name: (family, update_freq); each runs finite steps (an update, and
    # with update_freq 2 a finite micro-step after it), then a step whose
    # loss is non-finite (with update_freq 2 the window's boundary)
    "vit_update_freq_1": ("vit", 1),
    "vit_update_freq_2": ("vit", 2),
    "resnet_update_freq_1": ("resnet", 1),
    "resnet_update_freq_2": ("resnet", 2),
}


def _port_flat(pstate):
    """The port state in the JAX layout: parameters, optimizer (as a
    checkpoint carries it), EMA and, for BatchNorm, the statistics and their
    EMA; keys prefixed by the part."""
    model = pstate.model
    carry = carry_for(model)
    parts = {"params": carry.to_jax(dict(model.named_parameters())),
             "opt": optimizer_to_jax(pstate.optimizer, model, carry),
             "ema": carry.to_jax(pstate.ema)}
    if pstate.ema_stats is not None:
        parts["stats"] = carry.to_jax(dict(model.named_buffers()))
        parts["ema_stats"] = carry.to_jax(pstate.ema_stats)
    return {f"{p}/{k}": np.asarray(v) for p, d in parts.items() for k, v in d.items()}


def _jax_flat_state(jstate):
    parts = {"params": jstate.params, "opt": jstate.opt_state, "ema": jstate.ema_params}
    if jstate.batch_stats:
        parts.update(stats=jstate.batch_stats, ema_stats=jstate.ema_batch_stats)
    return {f"{p}/{k}": np.asarray(v) for p, t in parts.items() for k, v in _flatten(t).items()}


@pytest.mark.parametrize("case", list(NON_FINITE))
def test_non_finite_step_matches_jax(interpret_mode, case):
    # the device gate against JAX's selects: a non-finite loss leaves the
    # parameters, both moments, the update count, the EMA, the BatchNorm
    # statistics and their EMA exactly as they were, as the JAX step leaves
    # its state; the state carried in the JAX layout (what a checkpoint
    # holds, the optimizer's count included) is the JAX state's
    family, update_freq = NON_FINITE[case]
    kw = dict(RESNET if family == "resnet" else {}, opt="adamw", opt_eps=1.0, lr=0.01,
              update_freq=update_freq)
    n_finite = 2 * update_freq - 1
    jargs, jmix, jstate, jstep, pstate, pstep, flat, stats = _both(kw, family, n_finite + 1)
    images, labels = _batch()
    rng = jax.random.key(42)
    jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels, jnp.int32)}
    pbatch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    for s in range(n_finite + 1):
        if s == n_finite:  # logits inf - inf: a NaN loss
            head = pstate.model.fc if family == "resnet" else pstate.model.head
            with torch.no_grad():
                head.bias[0] = float("inf")
            p = jstate.params
            jstate = jstate.replace(params={**p, "head": {
                **p["head"], "bias": p["head"]["bias"].at[0].set(jnp.inf)}})
            before = _port_flat(pstate)
        jstate, jm = jstep(jstate, jbatch, rng)
        pm = pstep(pstate, pbatch, jax_draws.step_draws(rng, s, B, 32, 32, jargs, jmix))
        assert float(pm["skipped"]) == float(jm["skipped"]) == float(s == n_finite)
    assert float(pm["grad_norm"]) == float(jm["grad_norm"]) == 0.0
    after, want = _port_flat(pstate), _jax_flat_state(jstate)
    assert set(after) == set(before)
    for k in before:
        if "hyperparams" not in k:  # lr and wd follow the schedule, as in JAX
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    if update_freq > 1:  # the window is discarded
        assert all(not a.any() for a in pstate.grad_accum)
        assert all(not np.asarray(a).any() for a in jax.tree.leaves(jstate.grad_accum))
    want = {k: v for k, v in want.items() if "hyperparams" not in k}
    assert set(want) == {k for k in after if "hyperparams" not in k}
    assert after["opt/count"] == want["opt/count"] == 1
    # the finite steps' tolerances: 1e-4 of the largest update (parameters,
    # EMA) and of the largest first or second moment, 1e-5 for the statistics
    scale = max(np.abs(np.nan_to_num(want[f"params/{k}"]) - flat[k]).max() for k in flat)
    moment = {m: max(np.abs(v).max() for k, v in want.items() if f"/{m}/" in k)
              for m in ("mu", "nu")}
    for k, v in want.items():
        part = k.split("/")[0]
        if part in ("stats", "ema_stats"):
            tol = 1e-5
        elif part == "opt":
            tol = 1e-4 * moment[k.split("/")[3]] if "/mu/" in k or "/nu/" in k else 0.0
        else:
            tol = 1e-4 * scale
        np.testing.assert_allclose(after[k], v, atol=tol, rtol=1e-5 if tol == 1e-5 else 0,
                                   err_msg=k)


def _port_state(update_freq=1, **kw):
    _, pargs = _configs(opt="adamw", update_freq=update_freq, **kw)
    model = port_vit.ViT(**SMALL, img_size=32, flash_attn=True)
    model.load_state_dict(vit_state_dict_from_jax(_flat(), 2))
    opt = create_optimizer("adamw", model.parameters(), lr=0.01, weight_decay=0.05)
    state = create_train_state(model, opt, use_ema=True, update_freq=update_freq)
    step = build_train_step(model, pargs, 5, build_mixup(pargs, 5), [0.01] * 8, [0.05] * 8,
                            ema_decay=0.9)
    images, labels = _batch()
    return state, step, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}


def _snapshot(state):
    return ({k: v.detach().clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.ema.items()})


def _moments(opt):
    return {f"{k}.{i}": t.clone() for k, ts in opt.moments.items() for i, t in enumerate(ts)}


def _assert_same(a, b):
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, equal_nan=True)


def test_non_finite_loss_skips_the_update():
    state, step, batch = _port_state()
    with torch.no_grad():
        state.model.head.bias[0] = float("inf")  # logits inf - inf: a NaN loss
    params, ema_before = _snapshot(state)
    moments = _moments(state.optimizer)
    m = step(state, batch)
    assert not np.isfinite(float(m["loss"]))
    assert m["skipped"] == 1.0 and float(m["grad_norm"]) == 0.0
    _assert_same(params, _snapshot(state)[0])
    _assert_same(ema_before, state.ema)
    # the optimizer's state exists from the start (the captured step needs
    # it at fixed addresses): its moments and count are as before the step
    _assert_same(moments, _moments(state.optimizer))
    assert state.optimizer.num_updates == 0
    assert state.step == 1


def test_non_finite_loss_leaves_batch_stats_and_their_ema():
    # a BatchNorm model: a non-finite loss commits none of the forward's batch
    # statistics, and moves neither the parameters nor either EMA; the next
    # finite step moves the statistics and their EMA
    _, pargs = _configs(**RESNET, opt="adamw")
    _, _, _, model = _family("resnet")
    opt = create_optimizer("adamw", model.parameters(), lr=0.01, weight_decay=0.05)
    state = create_train_state(model, opt, use_ema=True)
    step = build_train_step(model, pargs, 5, build_mixup(pargs, 5), [0.01] * 8, [0.05] * 8,
                            ema_decay=0.9)
    images, labels = _batch()
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    with torch.no_grad():
        model.fc.bias[0] = float("inf")  # logits inf - inf: a NaN loss
    before, ema_before = _snapshot(state)
    stats_before = {k: v.clone() for k, v in state.ema_stats.items()}
    m = step(state, batch)
    assert m["skipped"] == 1.0 and state.optimizer.num_updates == 0
    _assert_same(before, _snapshot(state)[0])  # parameters and running statistics
    _assert_same(ema_before, state.ema)
    _assert_same(stats_before, state.ema_stats)
    with torch.no_grad():
        model.fc.bias[0] = 0.0
    step(state, batch)
    assert state.optimizer.num_updates == 1
    for k, v in model.named_buffers():
        assert not torch.equal(v, before[k]), k
        assert not torch.equal(state.ema_stats[k], stats_before[k]), k


def test_non_finite_window_boundary_discards_the_window():
    state, step, batch = _port_state(update_freq=2)
    params, ema_before = _snapshot(state)
    m0 = step(state, batch)  # finite micro-step: accumulated, no update
    assert m0["skipped"] == 0.0 and any(a.abs().sum() > 0 for a in state.grad_accum)
    bias0 = state.model.head.bias[0].item()
    with torch.no_grad():
        state.model.head.bias[0] = float("inf")
    m1 = step(state, batch)  # non-finite boundary: the window is dropped
    assert m1["skipped"] == 1.0 and float(m1["grad_norm"]) == 0.0
    assert all(a.abs().sum() == 0 for a in state.grad_accum)
    assert state.optimizer.num_updates == 0
    with torch.no_grad():
        state.model.head.bias[0] = bias0
    _assert_same(params, _snapshot(state)[0])
    _assert_same(ema_before, state.ema)
    step(state, batch)
    step(state, batch)  # the next full window updates
    assert state.optimizer.num_updates == 1 and state.step == 4


@pytest.mark.parametrize("norm_type", [2.0, float("inf")])
def test_global_norm_matches_jax(norm_type):
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want = float(jax_global_norm([jnp.asarray(x) for x in leaves], norm_type))
    got = float(global_norm([torch.from_numpy(x) for x in leaves], norm_type))
    assert got == pytest.approx(want, rel=1e-6)


def test_step_refuses_unported_features():
    # distillation and prune masks are ported (tests/test_torch_distill_prune.py);
    # a prune mask that names no parameter, or another shape, is refused
    _, pargs = _configs(opt="adamw")
    model = port_vit.ViT(**SMALL, img_size=32)
    shape = model.head.weight.shape
    build_train_step(model, pargs, 5, None, [0.1], [0.0],
                     prune_masks={"head.weight": torch.ones(shape, dtype=torch.bool)})
    for masks in ({"head.kernel": torch.ones(shape, dtype=torch.bool)},
                  {"head.weight": torch.ones(shape[::-1], dtype=torch.bool)}):
        with pytest.raises(ValueError, match="matches no parameter"):
            build_train_step(model, pargs, 5, None, [0.1], [0.0], prune_masks=masks)


def _remat_pair(family):
    """Two copies of one small model with stochastic depth (ViT, ConvNeXt;
    ResNet has none: its BatchNorm statistics run through the recompute;
    "vit_dropout" adds dropout of rate 0.1, whose masks have the
    activations' shapes and take ViT's attention off the flash kernel),
    with steps built alike but for --remat."""
    out = []
    for remat in (False, True):
        kw = dict(opt="adamw", remat=remat, layer_decay=0.65, drop_path=0.2)
        if family == "vit_dropout":
            model = port_vit.ViT(**SMALL, img_size=32, flash_attn=True, drop_rate=0.1,
                                 drop_path_rate=0.2)
        elif family == "convnext":
            kw.update(CONVNEXT, drop_path=0.2)
            model = port_convnext.ConvNeXt(**SMALL_CONVNEXT, drop_path_rate=0.2)
        elif family == "resnet":
            kw.update(RESNET)
            model = _family("resnet")[3]
        else:
            model = port_vit.ViT(**SMALL, img_size=32, flash_attn=True, drop_path_rate=0.2)
        if family != "resnet":
            model.load_state_dict(out[0][0].state_dict() if out else model.state_dict())
        _, pargs = _configs(**kw)
        opt = create_optimizer("adamw", model.parameters(), lr=0.01, weight_decay=0.05,
                               **port_train.optimizer_layout(pargs, model))
        state = create_train_state(model, opt, use_ema=True)
        step = build_train_step(model, pargs, 5, build_mixup(pargs, 5), [0.01] * 4,
                                [0.05] * 4, ema_decay=0.9, seed=3)
        out.append((model, state, step))
    return out


@pytest.mark.parametrize("family", ["vit", "convnext", "resnet", "vit_dropout"])
def test_remat_step_equals_the_plain_step_with_drop_path(family):
    # --remat runs the forward again inside the backward; its stochastic-depth
    # and dropout masks come from the step's own generator, so the recompute
    # must draw the first run's masks again: two steps with and without
    # remat give the same losses, gradients, parameters, moments and EMA,
    # bitwise on the CPU (the same ops on the same inputs)
    (m0, s0, step0), (m1, s1, step1) = _remat_pair(family)
    images, labels = _batch()
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    draws = step0.sample_draws(B, 32, 32)
    g0 = step0.loss_and_grads(m0, batch, draws)
    forwards = []
    blocks = m1.blocks if family == "vit" else [m1]
    hook = blocks[0].register_forward_hook(lambda *a: forwards.append(1))
    g1 = step1.loss_and_grads(m1, batch, draws)
    hook.remove()
    assert len(forwards) == 2  # the forward, and its recompute in the backward
    assert torch.equal(g0[0], g1[0])
    for a, b in zip(g0[3], g1[3]):
        assert torch.equal(a, b)
    for _ in range(2):
        draws = step0.sample_draws(B, 32, 32)
        metrics = [step(s, batch, draws) for step, s in ((step0, s0), (step1, s1))]
        for k in ("loss", "grad_norm", "lr", "min_lr", "class_acc"):
            assert torch.equal(metrics[0][k], metrics[1][k]), k
    assert float(metrics[0]["min_lr"]) < float(metrics[0]["lr"])  # layer decay reported
    for (k, a), b in zip(m0.state_dict().items(), m1.state_dict().values()):
        assert torch.equal(a, b), k
    for k, ts in s0.optimizer.moments.items():
        for a, b in zip(ts, s1.optimizer.moments[k]):
            assert torch.equal(a, b), k
    for k in s0.ema:
        assert torch.equal(s0.ema[k], s1.ema[k]), k


def test_remat_recompute_redraws_from_the_dropout_generators_state():
    # the recompute draws from a second generator that is given the dropout
    # generator's state before the step, so nothing of the first run's draws
    # is kept: afterwards the dropout generator is where the plain step leaves
    # it, and the second one has drawn as much from the same start; a CUDA
    # graph replays it as one of the step's generators
    (m0, s0, step0), (m1, s1, step1) = _remat_pair("vit_dropout")
    assert len(step1.generators) == len(step0.generators) + 1
    drop0, drop1, redraw = step0.generators[1], step1.generators[1], step1.generators[2]
    images, labels = _batch()
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    for _ in range(2):
        draws = step0.sample_draws(B, 32, 32)
        g0 = step0.loss_and_grads(m0, batch, draws)
        g1 = step1.loss_and_grads(m1, batch, draws)
        assert torch.equal(g0[0], g1[0])
        assert torch.equal(drop0.get_state(), drop1.get_state())
        assert torch.equal(redraw.get_state(), drop1.get_state())
    # a whole step draws more from the dropout generator (the exact-mode
    # accuracy forward); the host side of the next step gives the state over
    step1(s1, batch, step1.sample_draws(B, 32, 32))
    assert not torch.equal(redraw.get_state(), drop1.get_state())
    step1.host_inputs(s1.step, B, 32, 32)
    assert torch.equal(redraw.get_state(), drop1.get_state())
