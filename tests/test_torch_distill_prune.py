"""Distillation and prune masks in the port's train step
(imageclassification_tpu_torch/engine/step.py, checkpoint/io.py
`derive_prune_masks`, train.py) against the JAX package: a narrow ViT (dim
128, 2 heads of 64, depth 2, 32x32 input, plain attention, fp32) distilled
from another with the --aa RandAugment recipe, on the same weights, batch
and draws; the masks' sparsity and zero pattern; masked entries through
momentum steps; and chip_smoke.py's recipe phase rehearsed on the CPU
through `train.main`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import jax_draws
from imageclassification_tpu.checkpoint import io as jax_io
from imageclassification_tpu.data.mixup import build_mixup as jax_build_mixup
from imageclassification_tpu.engine.state import TrainState as JaxTrainState
from imageclassification_tpu.engine.step import build_train_step as jax_build_train_step
from imageclassification_tpu.models.vit import ViT as JaxViT
from imageclassification_tpu.optim.factory import create_optimizer as jax_create_optimizer
from imageclassification_tpu_torch import config, train
from imageclassification_tpu_torch.checkpoint import io as port_io
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for
from imageclassification_tpu_torch.data.mixup import build_mixup
from imageclassification_tpu_torch.engine.state import create_train_state
from imageclassification_tpu_torch.engine.step import build_train_step
from imageclassification_tpu_torch.models import vit as port_vit
from imageclassification_tpu_torch.optim.factory import create_optimizer
from test_torch_train_step import SMALL, _batch, _configs, _flat, _flat_of, _nest

B = 8
RECIPE = dict(aa="rand-m9-mstd0.5-inc1", distillation_alpha=0.5, distillation_tau=2.0,
              flash_attn=False, opt="adamw", opt_eps=1.0, lr=0.01, train_acc_mode="mixed")


@pytest.fixture(autouse=True)
def one_torch_thread():
    # several pytest workers run at once; one thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_vit(flat):
    model = port_vit.ViT(**SMALL, img_size=32, flash_attn=False)
    model.load_state_dict(carry_for(model).to_port(flat)[0])
    return model


def _port_step(pargs, flat, teacher=None, prune_masks=None, steps=4):
    model = _port_vit(flat)
    opt = create_optimizer(pargs.opt, model.parameters(), lr=pargs.lr,
                           weight_decay=pargs.weight_decay, opt_eps=pargs.opt_eps)
    state = create_train_state(model, opt, use_ema=True)
    step = build_train_step(model, pargs, 5, build_mixup(pargs, 5),
                            np.linspace(pargs.lr, pargs.lr / 2, steps),
                            np.linspace(pargs.weight_decay, pargs.weight_decay / 2, steps),
                            ema_decay=pargs.model_ema_decay, teacher=teacher,
                            prune_masks=prune_masks)
    return state, step


def test_distillation_step_matches_jax():
    # the DeiT-style recipe on the narrow ViT: RandAugment, mixup, label
    # smoothing and the KD term against a teacher of other weights, two
    # steps; AdamW with a large eps (a near-zero gradient's rounding stays
    # small in m / sqrt(v))
    jargs, pargs = _configs(**RECIPE)
    flat, tflat = _flat(0), _flat(1)
    lr = np.linspace(jargs.lr, jargs.lr / 2, 2)
    wd = np.linspace(jargs.weight_decay, jargs.weight_decay / 2, 2)
    jmodel = JaxViT(**SMALL, flash_attn=False, dtype=jnp.float32)
    tx = jax_create_optimizer(jargs.opt, jargs.lr, jargs.weight_decay, opt_eps=jargs.opt_eps)
    # the state made directly (no model.init: its eager compile costs seconds)
    jstate = JaxTrainState(step=jnp.zeros([], jnp.int32), params=_nest(flat), batch_stats={},
                           opt_state=tx.init(_nest(flat)), ema_params=_nest(flat),
                           ema_batch_stats=None, grad_accum=None)
    jmix = jax_build_mixup(jargs, 5)
    jstep = jax.jit(jax_build_train_step(jmodel, tx, jargs, 5, jmix, lr, wd,
                                         ema_decay=jargs.model_ema_decay,
                                         teacher=(jmodel, _nest(tflat), {})))
    teacher = _port_vit(tflat).eval()
    pstate, pstep = _port_step(pargs, flat, teacher=teacher, steps=2)

    images, labels = _batch()
    rng = jax.random.key(42)
    jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels, jnp.int32)}
    pbatch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    for s in range(2):
        jstate, jm = jstep(jstate, jbatch, rng)
        draws = jax_draws.step_draws(rng, s, B, 32, 32, jargs, jmix)
        assert "aa" in draws["augment"]
        pm = pstep(pstate, pbatch, draws)
        # fp32, the same functions: the loss (base and KD blended) to 1e-5
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    # the update of every parameter and of the EMA to 1e-4 of the largest
    jflat, jema = _flat_of(jstate.params), _flat_of(jstate.ema_params)
    carry = carry_for(pstate.model)
    pflat, pema = carry.to_jax(dict(pstate.model.named_parameters())), carry.to_jax(pstate.ema)
    scale = max(np.abs(jflat[k] - flat[k]).max() for k in flat)
    assert scale > 1e-4
    for k in flat:
        np.testing.assert_allclose(pflat[k] - flat[k], jflat[k] - flat[k], atol=1e-4 * scale,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(pema[k] - flat[k], jema[k] - flat[k], atol=1e-4 * scale,
                                   rtol=0, err_msg=f"ema {k}")


def test_alpha_zero_is_the_step_without_a_teacher():
    # as in JAX, a teacher with --distillation_alpha 0 is not run: the step
    # equals the one built without it, bitwise
    _, pargs = _configs(**{**RECIPE, "distillation_alpha": 0.0})
    flat = _flat(0)
    images, labels = _batch()
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    runs = []
    for teacher in (_port_vit(_flat(1)).eval(), None):
        state, step = _port_step(pargs, flat, teacher=teacher)
        calls = []
        if teacher is not None:
            teacher.register_forward_hook(lambda *a: calls.append(1))
        metrics = [step(state, batch, step.sample_draws(B, 32, 32)) for _ in range(2)]
        assert not calls
        runs.append((metrics, state.model.state_dict()))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a["loss"], b["loss"])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def _pruned_flat():
    """The narrow ViT's JAX parameters with the 50 % smallest |w| of every
    kernel zeroed, the head's and a bias's too (which JAX does not hold)."""
    flat = {k: v.copy() for k, v in _flat(0).items()}
    for k, v in flat.items():
        if k.endswith("kernel") or k == "block0/Mlp_0/Dense_0/bias":
            cut = np.argsort(np.abs(v), axis=None)[: v.size // 2]
            v.reshape(-1)[cut] = 0.0
    return flat


def test_derive_prune_masks_matches_jax():
    flat = _pruned_flat()
    want, want_sparsity = jax_io.derive_prune_masks(_nest(flat))
    model = _port_vit(flat)
    masks, sparsity = port_io.derive_prune_masks(model)
    assert sparsity == pytest.approx(want_sparsity, abs=1e-12) and 0.49 < sparsity < 0.51
    want = {k: np.asarray(v) for k, v in _flat_of(want).items()}
    got = carry_for(model).to_jax({k: m.float() for k, m in masks.items()})
    eligible = {k for k, v in want.items() if v.ndim}
    assert set(got) == eligible  # the qkv weight carries query, key and value
    assert "head/kernel" not in eligible and not any(k.endswith("bias") for k in eligible)
    for k in eligible:
        np.testing.assert_array_equal(got[k] > 0.5, want[k], err_msg=k)
    assert all(m.dtype == torch.bool for m in masks.values())


def test_masked_entries_stay_zero_through_momentum_steps():
    _, pargs = _configs(flash_attn=False, opt="momentum", lr=0.05, model_ema_decay=0.5)
    flat = _pruned_flat()
    masks, _ = port_io.derive_prune_masks(_port_vit(flat))
    state, step = _port_step(pargs, flat, prune_masks=masks)
    start = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    images, labels = _batch()
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    for _ in range(4):
        m = step(state, batch, step.sample_draws(B, 32, 32))
        assert float(m["skipped"]) == 0.0
    params = dict(state.model.named_parameters())
    for k, keep in masks.items():
        for what, t in (("model", params[k].detach()), ("ema", state.ema[k])):
            held = t[~keep]
            assert held.numel() and torch.equal(held, torch.zeros_like(held)), f"{what} {k}"
            assert not torch.signbit(held).any(), f"{what} {k}: -0.0"
        assert (params[k].detach()[keep] != start[k][keep]).any(), k
    assert (params["head.weight"] != start["head.weight"]).all()  # not masked


@pytest.mark.parametrize("argv", [
    ["--teacher_path", "t.pth", "--distillation_alpha", "0.5"], ["--prune_mask", "true"],
    ["--aa", "rand-m9-mstd0.5-inc1"], ["--aa", "original"], ["--aa", "abel-n2"],
])
def test_training_recipe_flags_pass(argv):
    config.check_ported(config.parse_args(argv))


def test_chip_smoke_recipes_rehearsal_on_cpu(tmp_path, capsys):
    # chip_smoke.py's phase 12 at a tiny size on the CPU, through train.main:
    # the recipe (--aa RandAugment, distillation from a JAX-layout
    # checkpoint), each policy against itself, --prune_mask from that
    # checkpoint with half of each eligible weight zeroed
    model = dict(name="vit_tiny_patch16", dim=192, depth=12, heads=3, patch=16)
    cfg = dict(img=32, batch=4, epochs=1, num_classes=3, per_class=6)
    teacher = chip_smoke.write_checkpoint(str(tmp_path / "teacher"), np.random.default_rng(0),
                                          model, cfg["img"], cfg["num_classes"])
    images = chip_smoke._train_images(str(tmp_path), cfg["num_classes"], cfg["per_class"], 0)
    out = chip_smoke.recipes_phase(str(tmp_path / "work"), "cpu", model, cfg, teacher, images)
    printed = capsys.readouterr().out
    # on the CPU the plain versions run: no kernel launch
    assert not any(out["recipe"]["totals"].values()) and not any(out["prune"]["totals"].values())
    assert len(out["recipe"]["losses"]) == 3 and np.isfinite(out["recipe"]["losses"]).all()
    assert [r["policy"] for r in out["policies"]] == [*chip_smoke.POLICIES, "color_jitter"]
    assert all(r["share_off"] == 0.0 for r in out["policies"] if "share_off" in r)
    assert abs(out["prune"]["sparsity"] - 0.5) <= chip_smoke.PRUNE_TOL
    assert out["prune"]["held"] > 0 and out["prune"]["moved"] > 0
    assert "Prune-mask fine-tune: enforcing 0.500 sparsity" in printed


def test_flash_step_pattern_counts_the_teacher():
    assert chip_smoke.flash_step_pattern(2, teacher=True) == \
        ["fwd"] * 4 + ["dq", "dkv"] * 2 + ["fwd"] * 2
    assert chip_smoke.flash_step_pattern(2, remat=True, teacher=True)[:6] == ["fwd"] * 6


def test_teacher_of_another_class_count_raises(tmp_path, toy_dataset):
    model = dict(name="vit_tiny_patch16", dim=192, depth=12, heads=3, patch=16)
    teacher = chip_smoke.write_checkpoint(str(tmp_path / "t"), np.random.default_rng(0), model,
                                          32, 4)
    args = config.parse_args(["--data_path", toy_dataset, "--model", "vit_tiny_patch16",
                              "--input_size", "32", "--batch_size", "4", "--device", "cpu",
                              "--teacher_path", teacher, "--distillation_alpha", "0.5",
                              "--output_dir", str(tmp_path / "o"),
                              "--log_dir", str(tmp_path / "l")])
    with pytest.raises(ValueError, match="teacher has 4 classes, dataset has 3"):
        train.main(args)
