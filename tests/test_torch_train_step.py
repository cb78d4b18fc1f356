"""Port train step (imageclassification_tpu_torch/engine/step.py) against the
JAX package's `build_train_step` on the same weights, batch and random draws:
a small ViT (dim 128, 2 heads of 64, depth 2, 32x32 input) with
flash_attn=True, the JAX side running its Pallas flash kernels (forward and
backward) in interpret mode, the port its plain versions. fp32 on both sides.

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
from imageclassification_tpu.config import TrainConfig as JaxConfig
from imageclassification_tpu.data.mixup import build_mixup as jax_build_mixup
from imageclassification_tpu.engine.state import create_train_state as jax_create_state
from imageclassification_tpu.engine.step import _global_norm as jax_global_norm
from imageclassification_tpu.engine.step import build_train_step as jax_build_train_step
from imageclassification_tpu.models.vit import ViT as JaxViT
from imageclassification_tpu.optim.factory import create_optimizer as jax_create_optimizer
from imageclassification_tpu_torch.checkpoint.from_jax import vit_state_dict_from_jax
from imageclassification_tpu_torch.checkpoint.to_jax import vit_flat_from_state_dict
from imageclassification_tpu_torch.config import TrainConfig
from imageclassification_tpu_torch.data.mixup import build_mixup
from imageclassification_tpu_torch.engine.state import create_train_state
from imageclassification_tpu_torch.engine.step import build_train_step, global_norm
from imageclassification_tpu_torch.models import vit as port_vit
from imageclassification_tpu_torch.optim.factory import create_optimizer

SMALL = dict(patch_size=16, dim=128, depth=2, num_heads=2, num_classes=5)
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


CASES = {
    # name: (config overrides, steps)
    "mixup_off_sgd": (dict(mixup=0.0, opt="sgd"), 2),
    "mixup_on_sgd": (dict(opt="sgd", model_ema_warmup=True), 2),
    "update_freq_2_sgd": (dict(opt="sgd", update_freq=2, clip_grad=0.5), 4),
    "mixup_on_adamw_large_eps": (dict(opt="adamw", opt_eps=1.0, lr=0.01), 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(interpret_mode, case):
    kw, steps = CASES[case]
    jargs, pargs = _configs(**kw)
    flat = _flat()
    images, labels = _batch()
    lr_sched = np.linspace(jargs.lr, jargs.lr / 2, steps)
    wd_sched = np.linspace(jargs.weight_decay, jargs.weight_decay / 2, steps)

    jmodel = JaxViT(**SMALL, flash_attn=True, dtype=jnp.float32)
    tx = jax_create_optimizer(jargs.opt, jargs.lr, jargs.weight_decay, opt_eps=jargs.opt_eps,
                              clip_grad=jargs.clip_grad)
    jstate = jax_create_state(jmodel, tx, jax.random.key(0), (1, 32, 32, 3), use_ema=True,
                              update_freq=jargs.update_freq)
    jstate = jstate.replace(params=_nest(flat), ema_params=_nest(flat),
                            opt_state=tx.init(_nest(flat)))
    jmix = jax_build_mixup(jargs, 5)
    jstep = jax.jit(jax_build_train_step(jmodel, tx, jargs, 5, jmix, lr_sched, wd_sched,
                                         ema_decay=jargs.model_ema_decay))

    pmodel = port_vit.ViT(**SMALL, img_size=32, flash_attn=True)
    pmodel.load_state_dict(vit_state_dict_from_jax(flat, 2))
    popt = create_optimizer(pargs.opt, pmodel.parameters(), lr=pargs.lr,
                            weight_decay=pargs.weight_decay, opt_eps=pargs.opt_eps,
                            clip_grad=pargs.clip_grad)
    pstate = create_train_state(pmodel, popt, use_ema=True, update_freq=pargs.update_freq)
    pstep = build_train_step(pmodel, pargs, 5, build_mixup(pargs, 5), lr_sched, wd_sched,
                             ema_decay=pargs.model_ema_decay)

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
        assert pm["weight_decay"] == pytest.approx(float(jm["weight_decay"]), rel=1e-6)
        assert float(pm["skipped"]) == float(jm["skipped"]) == 0.0
        for k in ("class_acc", "tp", "fp", "fn"):
            np.testing.assert_array_equal(np.asarray(pm[k]), np.asarray(jm[k]), err_msg=k)
    assert pstate.step == int(jstate.step) == steps

    # the updates of every parameter (and of the EMA) agree to 1e-4 of the
    # largest update: the gradients agree to fp32 rounding
    jflat = {"/".join(p.key for p in path): np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    jema = {"/".join(p.key for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jstate.ema_params)[0]}
    pflat = vit_flat_from_state_dict(pmodel.state_dict(), 2)
    pema = vit_flat_from_state_dict(pstate.ema, 2)
    scale = max(np.abs(jflat[k] - flat[k]).max() for k in flat)
    assert scale > 1e-4  # the steps moved the weights
    for k in flat:
        np.testing.assert_allclose(pflat[k] - flat[k], jflat[k] - flat[k], atol=1e-4 * scale,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(pema[k] - flat[k], jema[k] - flat[k], atol=1e-4 * scale,
                                   rtol=0, err_msg=f"ema {k}")


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


def _assert_same(a, b):
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, equal_nan=True)


def test_non_finite_loss_skips_the_update():
    state, step, batch = _port_state()
    with torch.no_grad():
        state.model.head.bias[0] = float("inf")  # logits inf - inf: a NaN loss
    params, ema_before = _snapshot(state)
    m = step(state, batch)
    assert not np.isfinite(float(m["loss"]))
    assert m["skipped"] == 1.0 and float(m["grad_norm"]) == 0.0
    _assert_same(params, _snapshot(state)[0])
    _assert_same(ema_before, state.ema)
    assert state.optimizer.num_updates == 0 and not state.optimizer.inner.state
    assert state.step == 1


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
    _, pargs = _configs(opt="adamw")
    model = port_vit.ViT(**SMALL, img_size=32)
    for kw in ({"teacher": object()}, {"prune_masks": {}}):
        with pytest.raises(NotImplementedError, match="A17"):
            build_train_step(model, pargs, 5, None, [0.1], [0.0], **kw)
