"""The rest of the optimizer table in the port (imageclassification_tpu_torch/
optim/factory.py: nvnovograd and its alias fusednovograd, adafactor,
adahessian, each with and without Lookahead) against the JAX package's optax
chains on the same parameters and gradients: the updates over 10 steps, the
state in the optax layout and back, a skipped step; adafactor factored on
the JAX tensors' shapes (a Dense kernel [in, out], a conv kernel HWIO); the
Hutchinson diagonal of the train step against JAX's jvp, and one adahessian
train step against the JAX step on the same Rademacher draws."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import jax_draws
from imageclassification_tpu.checkpoint.io import _flatten
from imageclassification_tpu.optim import factory as jax_factory
from imageclassification_tpu.optim.layer_decay import layer_decay_scales as jax_scales
from imageclassification_tpu_torch.checkpoint.to_jax import (carry_for, jax_leaves,
                                                             optimizer_from_jax, optimizer_to_jax)
from imageclassification_tpu_torch.config import TrainConfig, check_ported
from imageclassification_tpu_torch.engine.step import hutchinson_diag
from imageclassification_tpu_torch.models import densenet as port_densenet
from imageclassification_tpu_torch.models import vit as port_vit
from imageclassification_tpu_torch.optim import factory
from imageclassification_tpu_torch.optim.factory import factored_dims, leaf_view
from imageclassification_tpu_torch.optim.layer_decay import layer_decay_scales
from test_torch_optim import _nest_jnp

REST = ["nvnovograd", "fusednovograd", "adafactor", "adahessian", "lookahead_nvnovograd",
        "lookahead_adafactor", "lookahead_adahessian"]
# a ViT of depth 2 and width 128: its MLP kernels ([128, 512] in JAX) are
# factored by adafactor, its fused qkv is three JAX tensors [128, 2, 64]
VIT = dict(patch_size=16, dim=128, depth=2, num_heads=2, num_classes=3, img_size=32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(opt, model, name="vit_tiny_patch16", clip=0.5, decay=0.65, eps=1e-3):
    """The port optimizer on `model` (layer scales of `decay`, clip, the JAX
    tensors) and the JAX optimizer with the JAX scales on its carried
    parameters. eps 1e-3 as in test_torch_optim.py's table."""
    carry = carry_for(model)
    names = [k for k, _ in model.named_parameters()]
    scales = layer_decay_scales(names, name, decay) if decay < 1 else None
    popt = factory.create_optimizer(opt, model.parameters(), lr=0.1, weight_decay=0.05,
                                    clip_grad=clip, opt_eps=eps, layer_scales=scales,
                                    leaves=jax_leaves(model, carry))
    jparams = _nest_jnp(carry.to_jax(dict(model.named_parameters())))
    tx = jax_factory.create_optimizer(
        opt, 0.1, 0.05, clip_grad=clip, opt_eps=eps,
        layer_scales=jax_scales(jparams, name, decay) if decay < 1 else None)
    return popt, carry, tx, jparams


def _vit(seed=0):
    return port_vit.ViT(**VIT, generator=torch.Generator().manual_seed(seed))


def _steps(model, popt, carry, tx, jparams, n, seed=1):
    """n updates on both sides with the same seeded gradients (and, for
    adahessian, the same seeded Hessian diagonals), lr and wd changed every
    step; returns the JAX (params, state)."""
    jstate = tx.init(jparams)
    g = torch.Generator().manual_seed(seed)
    hessian = factory.route(popt.name)[0] == "adahessian"
    for step in range(n):
        lr, wd = 0.1 / (step + 1), 0.05 * (step + 1)
        grads = {k: 0.3 * torch.randn(p.shape, generator=g) for k, p in model.named_parameters()}
        extra, diag = {}, None
        if hessian:
            diag = {k: torch.randn(p.shape, generator=g) for k, p in model.named_parameters()}
            extra["hessian_diag"] = _nest_jnp(carry.to_jax(diag))
            diag = [diag[k].clone() for k in diag]
        jstate = jax_factory.set_hyperparams(jstate, lr, wd)
        updates, jstate = tx.update(_nest_jnp(carry.to_jax(grads)), jstate, jparams, **extra)
        jparams = optax.apply_updates(jparams, updates)
        popt.set_hyperparams(lr, wd)
        popt.step([grads[k].clone() for k in grads], hessian=diag)
    return jparams, jstate


def _flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_params_match(model, carry, jparams, start, n_moved=1e-3):
    got = carry.to_jax(dict(model.named_parameters()))
    want = _flat(jparams)
    assert set(got) == set(want)
    moved = max(np.abs(want[k] - start[k]).max() for k in want)
    assert moved > n_moved
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-6 + 1e-5 * moved, rtol=0, err_msg=k)


@pytest.mark.parametrize("opt", REST)
def test_rest_updates_match_optax(opt):
    # ten updates (Lookahead syncs at the sixth) with clip and layer scales
    # on: the parameters match the JAX chain's; fp32 on both sides, the same
    # arithmetic in another order, on updates of up to lr = 0.1
    model = _vit()
    popt, carry, tx, jparams = _setup(opt, model)
    start = {k: np.asarray(v) for k, v in carry.to_jax(dict(model.named_parameters())).items()}
    jparams, _ = _steps(model, popt, carry, tx, jparams, 10)
    _assert_params_match(model, carry, jparams, start)
    assert popt.num_updates == 10
    if popt.name == "adafactor":  # the MLP kernels are factored, on their JAX shapes
        shapes = {leaf.key: leaf.shape for pl in popt.leaves for leaf in pl}
        assert factored_dims(shapes["block0/Mlp_0/Dense_0/kernel"]) == (0, 1)  # [128, 512]
        assert factored_dims(shapes["block0/Mlp_0/Dense_1/kernel"]) == (1, 0)  # [512, 128]


@pytest.mark.parametrize("opt", REST)
def test_rest_state_round_trips_through_the_jax_layout(opt):
    # the port's state in the JAX layout has the JAX state's keys, shapes and
    # values after the same updates (nvnovograd's nu a scalar a JAX tensor,
    # adafactor's v_row / v_col / v as optax shapes them); loaded into a
    # fresh optimizer it gives the same layout back, and both go on alike
    model = _vit()
    popt, carry, tx, jparams = _setup(opt, model)
    _, jstate = _steps(model, popt, carry, tx, jparams, 7)
    want = _flatten(jstate)
    got = optimizer_to_jax(popt, model, carry)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k, v in want.items():
        if "hyperparams" not in k:
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=1e-4, err_msg=k)
    model2 = _vit(seed=5)
    model2.load_state_dict(model.state_dict())
    popt2, carry2, _, _ = _setup(opt, model2)
    assert optimizer_from_jax(got, popt2, model2, carry2) == len(popt.params)
    again = optimizer_to_jax(popt2, model2, carry2)
    for k, v in got.items():
        if "hyperparams" not in k:
            np.testing.assert_array_equal(again[k], v, err_msg=k)
    for o in (popt, popt2):
        o.set_hyperparams(0.01, 0.05)
        o.step([torch.full_like(p, 0.01) for p in o.params],
               hessian=[torch.full_like(p, 0.02) for p in o.params])
    for (k, a), b in zip(model.named_parameters(), model2.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("opt", REST)
def test_rest_skipped_step_is_inert(opt):
    # keep false (a non-finite loss): non-finite gradients (and diagonal)
    # leave the parameters, every state, the count and Lookahead's slow
    # weights and counter exactly as they were; the next step applies
    model = _vit()
    popt, carry, tx, jparams = _setup(opt, model)
    _steps(model, popt, carry, tx, jparams, 5)

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
    popt.step(nan, keep=torch.tensor(False), hessian=nan)
    after = snapshot()
    for k in before:
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0, msg=k)
    popt.step([torch.full_like(p, 0.01) for p in popt.params],
              hessian=[torch.full_like(p, 0.01) for p in popt.params])
    assert popt.num_updates == 6
    assert any(not torch.equal(p, before[f"p{i}"]) for i, p in enumerate(popt.params))


def test_adafactor_factors_conv_kernels_on_the_jax_shapes():
    # a narrow DenseNet whose third dense layer's 1x1 conv is 128 -> 128: in
    # JAX a [1, 1, 128, 128] HWIO kernel, factored over its last two axes;
    # ten updates and the state against optax, without layer scales
    model = port_densenet.DenseNet((3,), growth=32, num_classes=5,
                                   generator=torch.Generator().manual_seed(0))
    popt, carry, tx, jparams = _setup("adafactor", model, decay=1.0)
    key = "block0_layer2/conv1/kernel"
    leaf = next(leaf for pl in popt.leaves for leaf in pl if leaf.key == key)
    assert leaf.shape == (1, 1, 128, 128) and factored_dims(leaf.shape) == (2, 3)
    start = {k: np.asarray(v) for k, v in carry.to_jax(dict(model.named_parameters())).items()}
    jparams, jstate = _steps(model, popt, carry, tx, jparams, 10)
    _assert_params_match(model, carry, jparams, start)
    want, got = _flatten(jstate), optimizer_to_jax(popt, model, carry)
    assert got[f"inner_state/1/0/v_row/{key}"].shape == (1, 1, 128)
    for k, v in want.items():
        if "hyperparams" not in k:
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("family", ["vit", "densenet"])
def test_jax_leaves_view_the_parameters_in_jax_order(family):
    # every JAX tensor of every parameter, taken as a view of the port
    # parameter, equals the carried JAX array: ViT's fused qkv as three
    # [E, H, hd] kernels and [H, hd] biases, Dense kernels transposed, conv
    # kernels HWIO
    model = _vit() if family == "vit" else port_densenet.DenseNet(
        (2, 2), growth=8, num_classes=5, generator=torch.Generator().manual_seed(0))
    carry = carry_for(model)
    want = carry.to_jax(dict(model.named_parameters()))
    seen = set()
    for p, leaves in zip(model.parameters(), jax_leaves(model, carry)):
        for leaf in leaves:
            np.testing.assert_array_equal(leaf_view(p.detach(), leaf).numpy(), want[leaf.key],
                                          err_msg=leaf.key)
            seen.add(leaf.key)
    assert seen == set(want)


def test_hutchinson_diag_matches_jax_jvp():
    # z * Hz of a small ViT's cross-entropy (plain attention, fp32): the
    # port's second backward of <g, z> against JAX's jvp of its grad
    # function, on the same weights, batch and Rademacher z
    from imageclassification_tpu.models.vit import ViT as JaxViT
    from imageclassification_tpu_torch.checkpoint.to_jax import vit_flat_from_state_dict

    small = dict(patch_size=16, dim=64, depth=2, num_heads=2, num_classes=3)
    model = port_vit.ViT(**small, img_size=32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.weight.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
    jmodel = JaxViT(**small, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 3, 4)
    flat = vit_flat_from_state_dict(model.state_dict(), small["num_heads"])
    jparams = _nest_jnp(flat)
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    zkeys = jax.random.split(jax.random.key(3), len(leaves))
    z = treedef.unflatten([jax.random.rademacher(k, v.shape, jnp.float32)
                           for k, v in zip(zkeys, leaves)])

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x), train=False)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    hvp = jax.jvp(jax.grad(loss), (jparams,), (z,))[1]
    want = _flat(jax.tree.map(lambda a, b: a * b, z, hvp))

    carry = carry_for(model)
    pz = carry.to_port(_flat(z))[0]
    params = list(model.parameters())
    logits = model.eval()(torch.from_numpy(x))
    grads = torch.autograd.grad(torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)),
                                params, create_graph=True)
    diag = hutchinson_diag(grads, params, [pz[k] for k, _ in model.named_parameters()])
    got = carry.to_jax({k: d for (k, _), d in zip(model.named_parameters(), diag)})
    scale = max(np.abs(v).max() for v in want.values())
    assert scale > 1e-3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("model", ["vit_base_patch16", "vit_tiny_patch16_224"])
def test_adahessian_refused_with_flash_attention(model):
    # the pair the JAX package cannot run either: adahessian's second
    # derivative through the flash attention; refused before any step
    for opt in ("adahessian", "lookahead_adahessian"):
        args = TrainConfig(model=model, opt=opt, flash_attn=True, device="cpu")
        with pytest.raises(ValueError, match="cannot differentiate its flash attention twice"):
            check_ported(args)
        check_ported(args.replace(flash_attn=False))
    # a model that has no flash attention ignores the flag, as in JAX
    check_ported(TrainConfig(model="convnext_atto", opt="adahessian", flash_attn=True))


def test_adahessian_train_step_matches_jax():
    # one adahessian step (and one with update_freq 2's boundary) of a small
    # ConvNeXt (4-D conv kernels: the spatial mean of |z Hz|) against the
    # JAX step, on the same weights, batch and draws, JAX's z from
    # fold_in(rng, 0x5E55) (tests/jax_draws.py): the loss, the updates, and
    # the optimizer's second moment (b2 d^2: the Hutchinson diagonal)
    from test_torch_train_step import _batch, _both

    kw = dict(model="convnext_atto", flash_attn=False, drop_path=0.0, opt="adahessian",
              opt_eps=1e-3, lr=0.01, mixup=0.0)
    jargs, jmix, jstate, jstep, pstate, pstep, flat, _ = _both(kw, "convnext", 2)
    images, labels = _batch()
    rng = jax.random.key(42)
    jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels, jnp.int32)}
    pbatch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    model = pstate.model
    carry = carry_for(model)
    names = [k for k, _ in model.named_parameters()]
    for s in range(2):
        draws = jax_draws.step_draws(rng, s, images.shape[0], 32, 32, jargs, jmix)
        z = carry.to_port(jax_draws.hessian_z(rng, s, jstate.params))[0]
        draws["hessian_z"] = [z[k] for k in names]
        jstate, jm = jstep(jstate, jbatch, rng)
        pm = pstep(pstate, pbatch, draws)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    jflat = _flat(jstate.params)
    pflat = carry.to_jax(dict(model.named_parameters()))
    scale = max(np.abs(jflat[k] - flat[k]).max() for k in flat)
    assert scale > 1e-4
    for k in flat:
        np.testing.assert_allclose(pflat[k] - flat[k], jflat[k] - flat[k], atol=1e-4 * scale,
                                   rtol=0, err_msg=k)
    want = _flatten(jstate.opt_state)
    got = optimizer_to_jax(pstate.optimizer, model, carry)
    nu = {k: v for k, v in want.items() if "/nu/" in k}
    assert nu and max(np.abs(v).max() for v in nu.values()) > 0
    top = max(np.abs(v).max() for v in nu.values())
    for k, v in nu.items():
        np.testing.assert_allclose(got[k], v, atol=1e-4 * top, rtol=0, err_msg=k)
