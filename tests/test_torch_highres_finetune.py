"""The high-resolution fine-tuning recipe of the port on the CPU, end to end:
`imageclassification_tpu_torch.train.main` on a narrow ViT (depth 2, dim 64,
4 heads) with --flash_attn (its plain path on the CPU), --remat,
--layer_decay 0.65 and --opt lamb, fed from a folder of JPEGs through the
port's native decoder, held step by step against the JAX package's train
step (--remat under jax.checkpoint, its Pallas flash kernels in interpret
mode) on the same batches and random draws; then the JAX package resumes
the port's checkpoint, optimizer state included. fp32 on both sides."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import jax_draws
from imageclassification_tpu import config as jax_config
from imageclassification_tpu.checkpoint import io as jax_io
from imageclassification_tpu.checkpoint.io import _flatten
from imageclassification_tpu.data.mixup import build_mixup as jax_build_mixup
from imageclassification_tpu.engine.state import create_train_state as jax_create_state
from imageclassification_tpu.engine.step import build_train_step as jax_build_train_step
from imageclassification_tpu.models.vit import ViT as JaxViT
from imageclassification_tpu.optim.factory import create_optimizer as jax_create_optimizer
from imageclassification_tpu.optim.layer_decay import layer_decay_scales as jax_scales
from imageclassification_tpu_torch import models, train
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for, optimizer_to_jax
from imageclassification_tpu_torch.data import native_decode
from imageclassification_tpu_torch.models import vit as port_vit

NARROW = dict(patch_size=16, dim=64, depth=2, num_heads=4)
IMG, BATCH, NUM_CLASSES = 32, 4, 2


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


def _jpeg_folder(root):
    rng = np.random.default_rng(0)
    for c in range(NUM_CLASSES):
        d = root / f"class_{c}"
        d.mkdir(parents=True)
        for i in range(10):
            h, w = 40 + i, 48 - i
            yy, xx = np.mgrid[0:h, 0:w]
            arr = np.stack([xx * 5 + 60 * c, yy * 5, (xx + yy) * 2], -1) + rng.normal(0, 20, (h, w, 3))
            Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
                d / f"img_{i}.jpg", quality=90)
    return str(root)


def _nest(flat):
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


def test_finetune_recipe_matches_jax_and_jax_resumes(tmp_path, monkeypatch, capsys,
                                                     interpret_mode):
    assert native_decode.get_lib() is not None, native_decode.build_error()
    images = _jpeg_folder(tmp_path / "jpegs")
    out = tmp_path / "train_cls" / "output"
    args = train.parse_args([
        "--data_path", images, "--model", "vit_tiny_patch16", "--flash_attn", "true",
        "--remat", "true", "--layer_decay", "0.65", "--opt", "lamb", "--opt_eps", "1.0",
        "--clip_grad", "1.0", "--input_size", str(IMG), "--batch_size", str(BATCH),
        "--epochs", "1", "--warmup_epochs", "0", "--half_precision", "false",
        "--pretrained", "false", "--drop_path", "0", "--device", "cpu", "--num_workers", "2",
        "--output_dir", str(out), "--log_dir", str(tmp_path / "train_cls" / "log_dir")])
    # the JAX keys of every step, as the JAX step folds them (no drop path:
    # JAX's dropout draws cannot be reproduced in torch)
    jargs = jax_config.TrainConfig(**{k: v for k, v in args.to_dict().items() if k != "device"})
    jmix = jax_build_mixup(jargs, NUM_CLASSES)
    rng = jax.random.key(42)
    seen = {}
    monkeypatch.setitem(models._REGISTRY, "vit_tiny_patch16", port_vit._make(
        NARROW["patch_size"], NARROW["dim"], NARROW["depth"], NARROW["num_heads"]))
    build = train.build_train_step

    def recording_build(model, a, num_classes, mixup_cfg, lr_schedule, wd_schedule, **kw):
        # copies: the carry's arrays of untransposed fp32 CPU tensors share
        # their memory, which training goes on to change
        seen.update(start={k: v.copy() for k, v in
                           carry_for(model).to_jax(model.state_dict()).items()},
                    lr=np.asarray(lr_schedule), wd=np.asarray(wd_schedule), batches=[],
                    metrics=[])
        step = build(model, a, num_classes, mixup_cfg, lr_schedule, wd_schedule, **kw)

        def recorded(state, batch, draws=None):
            seen["batches"].append({k: v.numpy().copy() for k, v in batch.items()})
            m = step(state, batch, jax_draws.step_draws(rng, state.step, BATCH, IMG, IMG, jargs,
                                                        jmix))
            seen["metrics"].append(m)
            return m

        return recorded

    monkeypatch.setattr(train, "build_train_step", recording_build)
    state = train.main(args)
    steps = len(seen["batches"])
    assert steps == 4 and state.optimizer.name == "lamb" and len(state.optimizer.groups) == 4

    # the JAX step from the same weights on the same batches and keys
    jmodel = JaxViT(**NARROW, num_classes=NUM_CLASSES, flash_attn=True, dtype=jnp.float32)
    params = _nest(seen["start"])
    scales = jax_scales(params, args.model, args.layer_decay)
    leaves = [float(x) for x in jax.tree_util.tree_leaves(scales)]
    tx = jax_create_optimizer("lamb", args.lr, args.weight_decay, opt_eps=args.opt_eps,
                              clip_grad=args.clip_grad, layer_scales=scales)
    jstate = jax_create_state(jmodel, tx, jax.random.key(0), (1, IMG, IMG, 3))
    jstate = jstate.replace(params=params, opt_state=tx.init(params))
    jstep = jax.jit(jax_build_train_step(jmodel, tx, jargs, NUM_CLASSES, jmix, seen["lr"],
                                         seen["wd"], lr_scale_bounds=(min(leaves), max(leaves))))
    for b, pm in zip(seen["batches"], seen["metrics"]):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(b["image"]),
                                    "label": jnp.asarray(b["label"], jnp.int32)}, rng)
        # fp32, the same function: as tests/test_torch_train_step.py holds it
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        for k in ("lr", "min_lr"):
            assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-6), k
        for k in ("class_acc", "tp", "fp", "fn"):
            np.testing.assert_array_equal(np.asarray(pm[k]), np.asarray(jm[k]), err_msg=k)
    carry = carry_for(state.model)
    got = carry.to_jax(dict(state.model.named_parameters()))
    want = {k: np.asarray(v) for k, v in _flatten(jstate.params).items()}
    scale = max(np.abs(want[k] - seen["start"][k]).max() for k in want)
    assert scale > 1e-4
    for k in want:
        np.testing.assert_allclose(got[k] - seen["start"][k], want[k] - seen["start"][k],
                                   atol=1e-4 * scale, rtol=0, err_msg=k)

    # the JAX package resumes the port's checkpoint: weights and the lamb
    # state exactly as the port wrote them, the epoch after it
    capsys.readouterr()
    fresh = jax_create_state(jmodel, tx, jax.random.key(1), (1, IMG, IMG, 3))
    jres = jax_config.TrainConfig(output_dir=str(out))
    fresh, _ = jax_io.auto_load_model(jres, fresh)
    assert "With optim & sched!" in capsys.readouterr().out
    assert jres.start_epoch == 1 and int(fresh.step) == steps
    resumed = _flatten(fresh.params)
    for k, v in got.items():
        np.testing.assert_array_equal(resumed[k], v, err_msg=k)
    port_opt = optimizer_to_jax(state.optimizer, state.model, carry)
    jopt = _flatten(fresh.opt_state)
    assert set(jopt) == set(port_opt) and int(jopt["count"]) == steps
    for k, v in port_opt.items():
        np.testing.assert_array_equal(jopt[k], v, err_msg=k)
    assert os.path.exists(out / "checkpoint-0.pth")
