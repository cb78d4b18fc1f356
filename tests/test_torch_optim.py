"""Port optimisation pieces (imageclassification_tpu_torch/optim: schedules,
factory, ema; checkpoint/to_jax.py for the optimizer state) against the JAX
package's optax chains on the same parameters and gradients."""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from imageclassification_tpu.checkpoint.io import _flatten
from imageclassification_tpu.optim import ema as jax_ema
from imageclassification_tpu.optim import factory as jax_factory
from imageclassification_tpu.optim import schedules as jax_schedules
from imageclassification_tpu_torch.checkpoint.to_jax import (carry_for, optimizer_from_jax,
                                                             optimizer_to_jax)
from imageclassification_tpu_torch.models import vit as port_vit
from imageclassification_tpu_torch.optim import ema, factory, schedules


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sched", ["cosine", "linear", "piecewise"])
@pytest.mark.parametrize("warmup_epochs,warmup_steps", [(0, -1), (2, -1), (1, 7)])
def test_schedules_match_jax(sched, warmup_epochs, warmup_steps):
    args = argparse.Namespace(lr_scheduler=sched, lr=1e-3, min_lr=1e-6, epochs=5,
                              warmup_epochs=warmup_epochs, warmup_steps=warmup_steps,
                              weight_decay=0.05, weight_decay_end=5e-6)
    got = schedules.build_schedules(args, 10)
    want = jax_schedules.build_schedules(args, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _tree(seed):
    """A small parameter tree: a matrix and a vector."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}


@pytest.mark.parametrize("opt", ["adamw", "sgd", "nesterov", "momentum", "fusedadamw"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_updates_match_optax(opt, clip):
    # five updates on the same gradients, with lr and wd changed every step as
    # the train step writes them from the schedules; fp32 on both sides, the
    # same arithmetic in another order (torch folds Adam's bias corrections
    # into the step size): updates of size lr = 0.1 agree to ~2e-6, atol 1e-5
    params = _tree(0)
    tx = jax_factory.create_optimizer(opt, 0.1, 0.05, clip_grad=clip)
    jstate = tx.init(params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("w", "b")]
    popt = factory.create_optimizer(opt, tparams, lr=0.1, weight_decay=0.05, clip_grad=clip)
    rng = np.random.default_rng(1)
    for step in range(5):
        lr, wd = 0.1 / (step + 1), 0.05 * (step + 1)
        grads = {k: (3 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in params.items()}
        jstate = jax_factory.set_hyperparams(jstate, lr, wd)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        popt.set_hyperparams(lr, wd)
        for p, k in zip(tparams, ("w", "b")):
            p.grad = torch.from_numpy(grads[k])
        popt.step()
    for p, k in zip(tparams, ("w", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    assert popt.num_updates == 5


@pytest.mark.parametrize("opt,err", [("adahessian", NotImplementedError),
                                     ("lookahead_adafactor", NotImplementedError),
                                     ("nvnovograd", NotImplementedError),
                                     ("fusednovograd", NotImplementedError),
                                     ("bogus", ValueError)])
def test_unported_and_unknown_optimizers(opt, err):
    with pytest.raises(err, match="A16 \\(rest\\)" if err is NotImplementedError else opt):
        factory.create_optimizer(opt, [torch.nn.Parameter(torch.zeros(2))], 0.1, 0.0)


@pytest.mark.parametrize("t", [0, 1, 10, 5000])
def test_warmup_decay_matches_jax(t):
    assert ema.warmup_decay(0.9995, t) == pytest.approx(
        float(jax_ema.warmup_decay(0.9995, t)), rel=1e-6)


def test_ema_update_matches_jax():
    model = torch.nn.Linear(4, 3)
    e = ema.init_ema(model)
    assert all(e[k] is not p for k, p in model.named_parameters())  # a real copy
    je = {k: jnp.asarray(v.numpy().copy()) for k, v in e.items()}  # no shared buffer
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    for d in (0.9, 0.5):
        ema.ema_update(e, model, d)
        je = jax_ema.ema_update(je, {k: jnp.asarray(p.detach().numpy().copy())
                                     for k, p in model.named_parameters()}, d)
    for k in e:
        np.testing.assert_allclose(e[k].numpy(), np.asarray(je[k]), atol=1e-6, rtol=0)


SMALL = dict(patch_size=16, dim=128, depth=1, num_heads=2, num_classes=3, img_size=32)


def _jax_tx_state(opt, clip, flat_grads_steps):
    """The JAX optimizer state after the given gradient steps, on the flat
    parameters of a port model carried to the JAX layout."""
    from imageclassification_tpu_torch.checkpoint.to_jax import vit_flat_from_state_dict

    model = port_vit.ViT(**SMALL)
    flat = vit_flat_from_state_dict(model.state_dict(), SMALL["num_heads"])
    tx = jax_factory.create_optimizer(opt, 0.01, 0.05, clip_grad=clip)
    params = {k: jnp.asarray(v) for k, v in flat.items()}
    state = tx.init(params)
    for g in flat_grads_steps:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
    return model, flat, _flatten(state), params


@pytest.mark.parametrize("opt,clip", [("adamw", None), ("adamw", 1.0), ("sgd", None),
                                      ("momentum", 2.0)])
def test_optimizer_state_layout_and_values_match_jax(opt, clip):
    # two updates with the same gradients on both sides: the port's state,
    # written in the JAX layout, has the JAX state's keys, shapes and values
    from imageclassification_tpu_torch.checkpoint.to_jax import vit_flat_from_state_dict

    model = port_vit.ViT(**SMALL)
    popt = factory.create_optimizer(opt, model.parameters(), lr=0.01, weight_decay=0.05,
                                    clip_grad=clip)
    rng = np.random.default_rng(3)
    steps = []
    for _ in range(2):
        grads = {k: 0.1 * rng.standard_normal(p.shape).astype(np.float32)
                 for k, p in model.named_parameters()}
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        popt.step()
        steps.append(vit_flat_from_state_dict(
            {k: torch.from_numpy(v) for k, v in grads.items()}, SMALL["num_heads"]))
    _, _, want, _ = _jax_tx_state(opt, clip, steps)
    got = optimizer_to_jax(popt, model, carry_for(model))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k, v in want.items():
        if k.startswith("hyperparams"):
            continue
        np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=1e-5, err_msg=k)

    # and back: a fresh optimizer loaded from the JAX state continues as the
    # first one does
    model2 = port_vit.ViT(**SMALL)
    model2.load_state_dict(model.state_dict())
    popt2 = factory.create_optimizer(opt, model2.parameters(), lr=0.01, weight_decay=0.05,
                                     clip_grad=clip)
    n = len(list(model2.parameters()))
    assert optimizer_from_jax(want, popt2, model2, carry_for(model2)) == n
    assert popt2.num_updates == 2
    for m, o in ((model, popt), (model2, popt2)):
        for p in m.parameters():
            p.grad = torch.full_like(p, 0.01)
        o.step()
    for (k, a), b in zip(model.named_parameters(), model2.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), atol=1e-6, err_msg=k)


# the optimizer table: every ported name, and Lookahead around three of them
TABLE = ["adamw", "adam", "nadam", "radam", "lion", "lamb", "rmsprop", "rmsproptf", "adadelta",
         "adamp", "sgdp", "sgd", "momentum", "fusedadam", "fusedlamb", "lookahead_adamw",
         "lookahead_lamb", "lookahead_sgd"]
# a ViT of depth 2 (four layer scales); its fused qkv is three JAX tensors,
# which lamb's trust ratio and adamp's / sgdp's projection each take apart
TABLE_VIT = dict(patch_size=16, dim=64, depth=2, num_heads=4, num_classes=3, img_size=32)


def _table(opt, clip=0.5, decay=0.65, seed=0, eps=1e-3):
    """A port ViT with `opt` (layer scales of `decay`, clip, the JAX
    tensors), and the JAX optimizer with the JAX scales on its carried
    parameters. eps 1e-3: where the clipped gradient and the coupled decay
    cancel in an element, g / sqrt(v) with eps 1e-8 turns fp32 rounding
    into an update of full size and either sign (seen on a few of 10^5
    elements, in adam and rmsprop alike; 1e-7 apart without the clip or
    without the decay), which no arithmetic order fixes."""
    from imageclassification_tpu.optim.layer_decay import layer_decay_scales as jax_scales
    from imageclassification_tpu_torch.checkpoint.to_jax import jax_leaves
    from imageclassification_tpu_torch.optim.layer_decay import layer_decay_scales

    model = port_vit.ViT(**TABLE_VIT, generator=torch.Generator().manual_seed(seed))
    carry = carry_for(model)
    names = [k for k, _ in model.named_parameters()]
    popt = factory.create_optimizer(
        opt, model.parameters(), lr=0.1, weight_decay=0.05, clip_grad=clip, opt_eps=eps,
        layer_scales=layer_decay_scales(names, "vit_tiny_patch16", decay),
        leaves=jax_leaves(model, carry))
    jparams = _nest_jnp(carry.to_jax(dict(model.named_parameters())))
    tx = jax_factory.create_optimizer(opt, 0.1, 0.05, clip_grad=clip, opt_eps=eps,
                                      layer_scales=jax_scales(jparams, "vit_tiny_patch16", decay))
    return model, popt, carry, tx, jparams


def _nest_jnp(flat):
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        # a copy: on the CPU jnp.asarray may alias an aligned numpy buffer,
        # here a view of a torch parameter that the port's step then updates
        node[leaf] = jnp.asarray(np.array(v))
    return out


def _table_steps(model, popt, carry, tx, jparams, n, seed=1):
    """n updates on both sides with the same seeded gradients, lr and wd
    changed every step; returns the JAX (params, state)."""
    jstate = tx.init(jparams)
    g = torch.Generator().manual_seed(seed)
    for step in range(n):
        lr, wd = 0.1 / (step + 1), 0.05 * (step + 1)
        grads = {k: 0.3 * torch.randn(p.shape, generator=g) for k, p in model.named_parameters()}
        jstate = jax_factory.set_hyperparams(jstate, lr, wd)
        updates, jstate = tx.update(_nest_jnp(carry.to_jax(grads)), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        popt.set_hyperparams(lr, wd)
        popt.step([grads[k].clone() for k in grads])
    return jparams, jstate


@pytest.mark.parametrize("opt", TABLE)
def test_table_updates_match_optax(opt):
    # five updates (seven with Lookahead, which syncs at the sixth) with clip
    # and layer scales on: the parameters match the JAX chain's; fp32 on both
    # sides, the same arithmetic in another order, on updates of up to lr =
    # 0.1
    model, popt, carry, tx, jparams = _table(opt)
    start = {k: np.asarray(v) for k, v in carry.to_jax(dict(model.named_parameters())).items()}
    n = 7 if opt.startswith("lookahead") else 5
    jparams, _ = _table_steps(model, popt, carry, tx, jparams, n)
    got = carry.to_jax(dict(model.named_parameters()))
    want = {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert set(got) == set(want)
    moved = max(np.abs(want[k] - start[k]).max() for k in want)
    assert moved > 1e-3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-6 + 1e-5 * moved, rtol=0, err_msg=k)
    assert popt.num_updates == n


def test_radam_rectifies_from_the_sixth_update():
    # radam's switch (rho_t >= 5 from t = 6 with b2 = 0.999) is a device
    # select; its rho cancels (1999 - 1994), which the port takes in float64,
    # so it is held against the JAX chain run in float64: seven updates, the
    # port in fp32
    model, popt, carry, tx, jparams = _table("radam")
    with jax.enable_x64(True):
        jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), jparams)
        jparams, _ = _table_steps(model, popt, carry, tx, jparams, 7)
        want = {"/".join(p.key for p in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = carry.to_jax(dict(model.named_parameters()))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-6, rtol=0, err_msg=k)
    for t, rect in ((5, False), (6, True)):
        ro = 1999.0 - 2 * t * 0.999 ** t / (1 - 0.999 ** t)
        assert (ro >= 5.0) == rect


@pytest.mark.parametrize("opt", TABLE)
def test_table_state_round_trips_through_the_jax_layout(opt):
    # the port's state in the JAX layout has the JAX state's keys, shapes and
    # values after the same updates; loaded into a fresh optimizer it gives
    # the same layout back, and both go on alike
    model, popt, carry, tx, jparams = _table(opt)
    _, jstate = _table_steps(model, popt, carry, tx, jparams, 7)
    want = _flatten(jstate)
    got = optimizer_to_jax(popt, model, carry)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k, v in want.items():
        if "hyperparams" not in k:
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=1e-4, err_msg=k)
    model2, popt2, carry2, _, _ = _table(opt, seed=5)
    model2.load_state_dict(model.state_dict())
    assert optimizer_from_jax(got, popt2, model2, carry2) == len(popt.params)
    again = optimizer_to_jax(popt2, model2, carry2)
    for k, v in got.items():
        if "hyperparams" not in k:
            np.testing.assert_array_equal(again[k], v, err_msg=k)
    for o in (popt, popt2):
        o.set_hyperparams(0.01, 0.05)
        o.step([torch.full_like(p, 0.01) for p in o.params])
    for (k, a), b in zip(model.named_parameters(), model2.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("opt", TABLE)
def test_table_skipped_step_is_inert(opt):
    # keep false (a non-finite loss): non-finite gradients leave the
    # parameters, every moment, the count and Lookahead's slow weights and
    # counter exactly as they were; the next step applies
    model, popt, carry, tx, jparams = _table(opt)
    _table_steps(model, popt, carry, tx, jparams, 5)

    def snapshot():
        out = {f"p{i}": p.detach().clone() for i, p in enumerate(popt.params)}
        out.update({f"{k}{i}": t.clone() for k, ts in popt.moments.items()
                    for i, t in enumerate(ts)})
        out["count"] = popt.count.clone()
        if popt.lookahead:
            out.update({f"slow{i}": s.clone() for i, s in enumerate(popt.slow)})
            out["lookahead_count"] = popt.lookahead_count.clone()
        return out

    before = snapshot()
    nan = [torch.full_like(p, float("nan")) for p in popt.params]
    popt.step(nan, keep=torch.tensor(False))
    after = snapshot()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    popt.step([torch.full_like(p, 0.01) for p in popt.params], keep=torch.tensor(True))
    assert popt.num_updates == 6
    if popt.lookahead:  # the sixth applied update syncs
        assert int(popt.lookahead_count) == 6
        for p, s in zip(popt.params, popt.slow):
            assert torch.equal(p, s)
