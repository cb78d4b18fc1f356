"""Port training CLI (imageclassification_tpu_torch/train.py, config.py,
checkpoint/io.py write side and resume) against the JAX package: the same
flags, checkpoints that resume in either package with their optimizer state,
an end-to-end CPU run of `python -m imageclassification_tpu_torch.train`
followed by the port's val.py, and chip_smoke.py's training phase rehearsed
on the CPU."""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import imageclassification_tpu_torch.val as port_val
from imageclassification_tpu import config as jax_config
from imageclassification_tpu.checkpoint import io as jax_io
from imageclassification_tpu.engine.state import create_train_state as jax_create_state
from imageclassification_tpu.models import create_model as jax_create_model
from imageclassification_tpu.models.vit import ViT as JaxViT
from imageclassification_tpu.optim.factory import create_optimizer as jax_create_optimizer
from imageclassification_tpu_torch import config, train
from imageclassification_tpu_torch.checkpoint import io as port_io
from imageclassification_tpu_torch.checkpoint.to_jax import optimizer_to_jax
from imageclassification_tpu_torch.engine.state import create_train_state
from imageclassification_tpu_torch.models import create_model
from imageclassification_tpu_torch.models import vit as port_vit
from imageclassification_tpu_torch.optim.ema import ema_update
from imageclassification_tpu_torch.optim.factory import create_optimizer

ROOT = Path(__file__).resolve().parent.parent
SPEC = {"name": "vit_tiny_patch16", "kwargs": {"num_classes": 3, "flash_attn": True}}
SMALL = dict(patch_size=16, dim=128, depth=2, num_heads=2, num_classes=3, img_size=32)
INPUT_SHAPE = [1, 32, 32, 3]


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_flags_and_defaults_match_jax():
    port, want = _actions(config.get_args_parser()), _actions(jax_config.get_args_parser())
    assert set(port) == set(want)
    for dest, a in want.items():
        p = port[dest]
        if dest == "device":
            assert p.default == "cuda" and p.choices == ["cuda", "cpu"]
            continue
        assert (p.default, p.nargs, getattr(p.type, "__name__", p.type)) == \
            (a.default, a.nargs, getattr(a.type, "__name__", a.type)), dest
    fields = {f for f in config.TrainConfig.__dataclass_fields__}
    assert fields == set(jax_config.TrainConfig.__dataclass_fields__)


@pytest.mark.parametrize("argv,item", [
    (["--fsdp", "true"], "A9"), (["--mesh_shape", "data:4"], "A9"),
    (["--teacher_path", "t.pth", "--distillation_alpha", "0.5"], "A17"),
    (["--prune_mask", "true"], "A17"), (["--remat", "true"], "A17"),
    (["--layer_decay", "0.75"], "A16"), (["--aa", "rand-m9-mstd0.5-inc1"], "A10"),
    (["--enable_wandb", "true"], "A6"), (["--profile_dir", "p"], "A6"),
    (["--check_nans", "true"], "A6"), (["--opt", "lamb"], "A16"),
])
def test_unported_flags_raise(argv, item):
    args = config.parse_args(argv)
    with pytest.raises(NotImplementedError, match=item):
        config.check_ported(args)
    with pytest.raises(NotImplementedError, match=item):
        train.main(args)


def test_ported_flags_pass():
    for argv in ([], ["--opt", "sgd", "--mesh_shape", "data:1", "--teacher_path", "t.pth"],
                 ["--opt", "momentum", "--clip_grad", "1.0", "--layer_decay", "1.0"]):
        config.check_ported(config.parse_args(argv))


def test_train_refuses_silent_cpu(monkeypatch, toy_dataset, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = config.parse_args(["--data_path", toy_dataset, "--model", "vit_tiny_patch16",
                              "--output_dir", str(tmp_path / "out")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(args)


def test_train_refuses_unported_models(toy_dataset, tmp_path):
    args = config.parse_args(["--data_path", toy_dataset, "--model", "resnet50", "--batch_size",
                              "4", "--device", "cpu", "--output_dir", str(tmp_path / "o"),
                              "--log_dir", str(tmp_path / "l")])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train.main(args)


def _port_state(seed, updates=2, small=False):
    """A port ViT-Ti/32 (or, `small`, a ViT of dim 128, depth 2, 2 heads)
    with an AdamW state and an EMA after `updates` updates on seeded
    gradients."""
    if small:
        model = port_vit.ViT(**SMALL, generator=torch.Generator().manual_seed(seed))
    else:
        model = create_model("vit_tiny_patch16", num_classes=3, img_size=32, flash_attn=True,
                             generator=torch.Generator().manual_seed(seed))
    opt = create_optimizer("adamw", model.parameters(), lr=0.01, weight_decay=0.05)
    state = create_train_state(model, opt, use_ema=True)
    _updates(state, seed, updates)
    return state


def _updates(state, seed, n):
    g = torch.Generator().manual_seed(seed + 100)
    for _ in range(n):
        for p in state.model.parameters():
            p.grad = 0.01 * torch.randn(p.shape, generator=g)
        state.optimizer.step()
        ema_update(state.ema, state.model, 0.9)
        state.step += 1


def _jax_flat(tree):
    return jax_io._flatten(tree)


def _jax_state():
    # the flash path has the einsum path's parameter tree; the einsum model
    # initialises without running a Pallas kernel
    jmodel = JaxViT(**{k: v for k, v in SMALL.items() if k != "img_size"})
    tx = jax_create_optimizer("adamw", 0.01, 0.05)
    return jax_create_state(jmodel, tx, jax.random.key(1), INPUT_SHAPE, use_ema=True), tx


def _assert_flat_equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{what} {k}")


def test_checkpoints_resume_across_packages(tmp_path, capsys):
    # port -> JAX: a checkpoint written by the port's save_model resumes in
    # the JAX auto_load_model with its optimizer, EMA, step and epoch
    state = _port_state(seed=0, small=True)
    pargs = config.TrainConfig(output_dir=str(tmp_path / "port"), model_ema=True, device="cpu")
    port_io.save_model(pargs, INPUT_SHAPE, 0, state, 3, SPEC)
    jstate, tx = _jax_state()
    jargs = jax_config.TrainConfig(output_dir=str(tmp_path / "port"), model_ema=True)
    jstate, _ = jax_io.auto_load_model(jargs, jstate)
    assert "With optim & sched!" in capsys.readouterr().out
    assert jargs.start_epoch == 1 and int(jstate.step) == 2
    with open(tmp_path / "port" / "checkpoint-0.pth", "rb") as f:
        ck = pickle.load(f)
    _assert_flat_equal(_jax_flat(jstate.params), ck["model"], "params")
    _assert_flat_equal(_jax_flat(jstate.ema_params), ck["model_ema"], "ema")
    _assert_flat_equal(_jax_flat(jstate.opt_state), ck["optimizer"], "optimizer")

    # one more update with the same gradients on both sides: the carried
    # optimizer state continues the same (fp32, atol 1e-6 on weights ~0.02)
    import optax

    _updates(state, seed=7, n=1)
    g = torch.Generator().manual_seed(107)
    grads = {k: 0.01 * torch.randn(p.shape, generator=g)
             for k, p in state.model.named_parameters()}
    from imageclassification_tpu_torch.checkpoint.to_jax import vit_flat_from_state_dict

    jgrads = jax.tree_util.tree_map(jnp.asarray, _nest(vit_flat_from_state_dict(grads, 2)))
    updates, opt_state = tx.update(jgrads, jstate.opt_state, jstate.params)
    jstate = jstate.replace(params=optax.apply_updates(jstate.params, updates),
                            opt_state=opt_state, step=jstate.step + 1)
    want = vit_flat_from_state_dict(state.model.state_dict(), 2)
    got = _jax_flat(jstate.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)

    # JAX -> port: a checkpoint written by the JAX save_model resumes in the
    # port's auto_load_model, exactly
    jsave = jax_config.TrainConfig(output_dir=str(tmp_path / "jax"), model_ema=True)
    jax_io.save_model(jsave, INPUT_SHAPE, 1, jstate, 3, SPEC)
    jax_io.wait_for_pending_saves()
    fresh = _port_state(seed=5, updates=0, small=True)
    pargs2 = config.TrainConfig(output_dir=str(tmp_path / "jax"), model_ema=True, device="cpu")
    fresh, _ = port_io.auto_load_model(pargs2, fresh)
    assert "With optim & sched!" in capsys.readouterr().out
    assert pargs2.start_epoch == 2 and fresh.step == 3 and fresh.optimizer.num_updates == 3
    _assert_flat_equal(vit_flat_from_state_dict(fresh.model.state_dict(), 2),
                       _jax_flat(jstate.params), "params")
    _assert_flat_equal(vit_flat_from_state_dict(fresh.ema, 2), _jax_flat(jstate.ema_params),
                       "ema")
    got_opt = optimizer_to_jax(fresh.optimizer, fresh.model, 2)
    want_opt = _jax_flat(jstate.opt_state)
    _assert_flat_equal({k: v for k, v in got_opt.items() if "hyperparams" not in k},
                       {k: v for k, v in want_opt.items() if "hyperparams" not in k},
                       "optimizer")


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_resume_with_mismatched_model_keeps_fresh_optimizer(tmp_path, capsys):
    # a checkpoint whose head has another class count: the head is skipped,
    # and neither the optimizer nor the epoch is restored (JAX rule)
    state = _port_state(seed=0)
    pargs = config.TrainConfig(output_dir=str(tmp_path), model_ema=True, device="cpu")
    port_io.save_model(pargs, INPUT_SHAPE, 4, state, 3, SPEC)
    model = create_model("vit_tiny_patch16", num_classes=5, img_size=32)
    other = create_train_state(model, create_optimizer("adamw", model.parameters(), 0.01, 0.05),
                               use_ema=True)
    args = config.TrainConfig(output_dir=str(tmp_path), model_ema=True, device="cpu")
    other, _ = port_io.auto_load_model(args, other)
    out = capsys.readouterr().out
    assert "Skipping mismatched key: head/kernel" in out and "With optim & sched!" not in out
    assert args.start_epoch == 0 and other.optimizer.num_updates == 0
    torch.testing.assert_close(other.model.blocks[0].mlp.fc1.weight,
                               state.model.blocks[0].mlp.fc1.weight, rtol=0, atol=0)


def test_rolling_retention_and_latest(tmp_path):
    state = _port_state(seed=0, updates=1)
    args = config.TrainConfig(output_dir=str(tmp_path), save_ckpt_num=2, device="cpu")
    for epoch in range(4):
        port_io.save_model(args, INPUT_SHAPE, epoch, state, 3, SPEC)
    port_io.save_model(args, INPUT_SHAPE, "best", state, 3, SPEC)
    names = sorted(os.listdir(tmp_path))
    assert names == ["checkpoint-2.pth", "checkpoint-3.pth", "checkpoint-best.pth"]
    assert port_io.find_latest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint-3.pth")
    assert port_io.find_latest_checkpoint(str(tmp_path / "none")) is None


def _run_cli(argv, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "imageclassification_tpu_torch.train", *argv],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_cli_trains_on_cpu_then_resumes_and_val_reads_it(toy_dataset, tmp_path, capsys):
    out_dir = tmp_path / "train_cls" / "output"
    argv = ["--device", "cpu", "--data_path", toy_dataset, "--model", "vit_tiny_patch16",
            "--input_size", "32", "--flash_attn", "true", "--batch_size", "4",
            "--warmup_epochs", "1", "--num_workers", "2", "--model_ema", "true",
            "--output_dir", str(out_dir), "--log_dir", str(tmp_path / "train_cls" / "log_dir")]
    out = _run_cli(argv + ["--epochs", "1"])
    assert "TRAINING FROM SCRATCH" in out and "Mixup is activated!" in out
    assert "Averaged stats:" in out and "Accuracy of the model EMA" in out
    assert {"checkpoint-0.pth", "checkpoint-best.pth", "class_indices.json"} <= \
        set(os.listdir(out_dir))
    logs = [json.loads(l) for l in (tmp_path / "train_cls" / "log.txt").read_text().splitlines()]
    assert logs[0]["epoch"] == 0 and np.isfinite(logs[0]["train_loss"])
    assert "test_acc1" in logs[0] and "test_acc1_ema" in logs[0]

    out = _run_cli(argv + ["--epochs", "2"])
    assert "With optim & sched!" in out and "checkpoint-0.pth" in out
    assert "checkpoint-1.pth" in os.listdir(out_dir)
    with open(out_dir / "checkpoint-1.pth", "rb") as f:
        ck = pickle.load(f)
    assert ck["epoch"] == 1 and ck["model_spec"] == SPEC and ck["input_shape"] == INPUT_SHAPE

    port_val.main(["--img_path", toy_dataset, "--model_weight_path",
                   str(out_dir / "checkpoint-1.pth"), "--img_size", "32", "--batch_size", "16",
                   "--device", "cpu"])
    assert "Precision2:" in capsys.readouterr().out


def test_jax_val_reads_a_port_checkpoint(tmp_path, monkeypatch, toy_dataset):
    # the JAX val.py on a port checkpoint: the same probabilities as the
    # port's val.py (fp32, the JAX Pallas flash kernel in interpret mode)
    import functools

    import jax.experimental.pallas as pl

    import imageclassification_tpu.data.native_decode as jax_native
    import val as jax_val

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    state = _port_state(seed=3)
    with torch.no_grad():
        state.model.head.weight.normal_(0, 0.1, generator=torch.Generator().manual_seed(0))
    args = config.TrainConfig(output_dir=str(tmp_path), device="cpu")
    path = port_io.save_model(args, INPUT_SHAPE, 0, state, 3, SPEC)
    jm, jp, jbs, _ = jax_val.initialize_model(path, False, half_precision=False)
    pm, _ = port_val.initialize_model(path, False, half_precision=False, device="cpu")
    imgs = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(jax_val._predict_fn(jm)(jp, jbs, jnp.asarray(imgs)))
    got = port_val._predict_fn(pm)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)  # fp32, summation order
    del functools


def test_chip_smoke_training_rehearsal_on_cpu(tmp_path):
    # chip_smoke.py's training phase at a tiny size on the CPU: plain
    # versions, so no kernel launches; the gradient check on trained weights
    model = dict(name="vit_tiny_patch16", dim=192, depth=12, heads=3, patch=16)
    run = chip_smoke.run_training(str(tmp_path), "cpu", model, img=32, num_classes=3,
                                  per_class=10, batch=4, epochs=2)
    assert len(run["records"]) == 2 * run["steps_per_epoch"] == 12
    assert run["totals"] == {"fwd": 0, "fwd_lse": 0, "bwd_dkv": 0, "bwd_dq": 0}
    chk = chip_smoke.train_step_checks(run, model, "cpu", timed=False)
    assert chk["grad_flash_vs_fp32"] <= chip_smoke.GRAD_RTOL


def test_backward_bound_numbers():
    ms, by = chip_smoke.backward_bound(64, 197, 12, 64)
    assert by == "bytes" and ms == pytest.approx(
        (8 * 64 * 197 * 12 * 64 * 2 + 2 * 64 * 12 * 197 * 4) / 3.35e12 * 1e3, rel=1e-12)
    ms, by = chip_smoke.backward_bound(2, 4097, 12, 64)
    assert by == "operations" and ms == pytest.approx(
        10 * 2 * 12 * 4097 ** 2 * 64 / 989e12 * 1e3, rel=1e-12)
    assert chip_smoke.backward_bound(64, 197, 12, 64, "dq")[0] < ms


@pytest.mark.parametrize("n", [37, 65])
def test_chip_smoke_backward_check_sees_a_dropped_last_key(n):
    # the backward check of chip_smoke.py on the CPU: bf16-rounded plain
    # gradients pass, gradients that leave out the last key fail
    from imageclassification_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.standard_normal((2, n, 3, 2, 64)).astype(np.float32))
    q, k, v = qkv.to(torch.bfloat16).unbind(2)
    do = torch.from_numpy(rng.standard_normal((2, n, 2, 64)).astype(np.float32)).bfloat16()

    def grads(kk, vv):
        qf, kf, vf = (t.float() for t in (q, kk, vv))
        return fa.flash_attention_bwd_ref(q, kk, vv, fa.flash_attention_ref(qf, kf, vf),
                                          fa.flash_attention_lse_ref(qf, kf), do)

    for name, (err, tol, tail) in chip_smoke.compare_backward(grads(k, v), q, k, v, do).items():
        assert err <= tol < tail, name
    dq, dk, dv = grads(k[:, :-1], v[:, :-1])
    pad = torch.zeros((2, 1, 2, 64), dtype=dk.dtype)
    with pytest.raises(AssertionError, match="max"):
        chip_smoke.compare_backward((dq, torch.cat([dk, pad], 1), torch.cat([dv, pad], 1)),
                                    q, k, v, do)
