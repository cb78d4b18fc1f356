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


@pytest.mark.parametrize("opt,err", [("adam", NotImplementedError),
                                     ("lookahead_adamw", NotImplementedError),
                                     ("lamb", NotImplementedError), ("bogus", ValueError)])
def test_unported_and_unknown_optimizers(opt, err):
    with pytest.raises(err):
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
