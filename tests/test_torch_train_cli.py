"""Port training CLI (imageclassification_tpu_torch/train.py, config.py,
checkpoint/io.py write side and resume) against the JAX package: the same
flags, checkpoints that resume in either package with their optimizer state,
an end-to-end CPU run of `python -m imageclassification_tpu_torch.train`
followed by the port's val.py, and chip_smoke.py's training phases rehearsed
on the CPU; for ViT, ConvNeXt and ResNet (with its BatchNorm statistics and
their EMA)."""

import functools
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
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for, optimizer_to_jax
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
    (["--fsdp", "true"], "A9"),  # "A9b (--fsdp)"; a --mesh_shape over the world is ported
])
def test_unported_flags_raise(argv, item):
    args = config.parse_args(argv)
    with pytest.raises(NotImplementedError, match=item):
        config.check_ported(args)
    with pytest.raises(NotImplementedError, match=item):
        train.main(args)


def test_ported_flags_pass():
    for argv in ([], ["--opt", "sgd", "--mesh_shape", "data:1", "--teacher_path", "t.pth"],
                 ["--opt", "momentum", "--clip_grad", "1.0", "--layer_decay", "1.0"],
                 ["--opt", "lookahead_lamb", "--layer_decay", "0.65", "--remat", "true"],
                 ["--opt", "fusedadam"], ["--opt", "rmsproptf"], ["--opt", "sgdp"],
                 ["--opt", "adahessian"], ["--opt", "lookahead_nvnovograd"],
                 ["--opt", "adafactor"], ["--opt", "adahessian", "--model", "convnext_tiny",
                                          "--flash_attn", "true"],
                 ["--enable_wandb", "true", "--profile_dir", "p", "--check_nans", "true"]):
        config.check_ported(config.parse_args(argv))


@pytest.mark.parametrize("argv,env,joins", [
    (["--dist_on_itp", "true"], {"OMPI_COMM_WORLD_RANK": "0", "OMPI_COMM_WORLD_SIZE": "2"}, True),
    ([], {"RANK": "0", "WORLD_SIZE": "2"}, True),
    ([], {"SLURM_PROCID": "0", "SLURM_NTASKS": "2"}, True),
    ([], {"RANK": "0", "WORLD_SIZE": "1"}, False),
    ([], {"SLURM_NTASKS": "1"}, False),
    ([], {}, False),
])
def test_multi_process_launch_raises(monkeypatch, tmp_path, argv, env, joins):
    # the launcher environments in which the JAX train.py joins processes
    # (parallel/dist.py:40-53): the port no longer raises (ROADMAP A9 is
    # ported) but joins a process group before it builds anything or writes
    # a file (here init_process_group stops the run); a world of one process
    # runs as a single process does, with no group
    monkeypatch.chdir(tmp_path)
    for name in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    args = config.parse_args([*argv, "--device", "cpu"])
    config.check_ported(args)

    def init_process_group(backend, **kw):
        raise RuntimeError(f"joined: {backend} world {kw['world_size']} rank {kw['rank']}")

    monkeypatch.setattr(torch.distributed, "init_process_group", init_process_group)
    from imageclassification_tpu_torch.parallel import init_distributed_mode

    if not joins:
        init_distributed_mode(args)
        assert not args.distributed and args.world_size == 1
        return
    with pytest.raises(RuntimeError, match="joined: gloo world 2 rank 0"):
        train.main(args)
    assert not any(tmp_path.iterdir())


def test_train_refuses_silent_cpu(monkeypatch, toy_dataset, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = config.parse_args(["--data_path", toy_dataset, "--model", "vit_tiny_patch16",
                              "--output_dir", str(tmp_path / "out")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(args)


def test_train_refuses_unknown_models(toy_dataset, tmp_path):
    args = config.parse_args(["--data_path", toy_dataset, "--model", "mobilenetv4_huge",
                              "--batch_size", "4", "--device", "cpu",
                              "--output_dir", str(tmp_path / "o"),
                              "--log_dir", str(tmp_path / "l")])
    with pytest.raises(ValueError, match="Unknown model 'mobilenetv4_huge'"):
        train.main(args)


def test_train_refuses_adahessian_with_flash_attention(toy_dataset, tmp_path):
    # before it builds anything or writes a file (the JAX package cannot
    # differentiate its flash attention twice either)
    args = config.parse_args(["--data_path", toy_dataset, "--model", "vit_tiny_patch16",
                              "--flash_attn", "true", "--opt", "adahessian", "--device", "cpu",
                              "--output_dir", str(tmp_path / "o"),
                              "--log_dir", str(tmp_path / "l")])
    with pytest.raises(ValueError, match="flash attention"):
        train.main(args)
    assert not any(tmp_path.iterdir())


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
    got_opt = optimizer_to_jax(fresh.optimizer, fresh.model, carry_for(fresh.model))
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


def test_replay_launches_reads_each_call_and_retraces_a_dropped_launch(monkeypatch):
    # chip_smoke.py reads a captured step's flash launches from traces: the
    # kinds in device order, once a call; a trace that dropped a launch is
    # taken again, and no trace holding the pattern fails the phase
    from collections import Counter

    pattern = chip_smoke.flash_step_pattern(2)
    assert pattern == ["fwd", "fwd", "dq", "dkv", "dq", "dkv", "fwd", "fwd"]
    traces = iter([(pattern * 3)[1:], pattern * 3])
    monkeypatch.setattr(chip_smoke, "flash_kernel_sequence", lambda fn, calls: next(traces))
    assert chip_smoke.replay_launches(None, pattern) == [Counter(fwd=4, dq=2, dkv=2)] * 3
    swapped = pattern[:2] + ["dkv", "dq"] + pattern[4:]
    monkeypatch.setattr(chip_smoke, "flash_kernel_sequence", lambda fn, calls: swapped * calls)
    with pytest.raises(AssertionError, match="no trace"):
        chip_smoke.replay_launches(None, pattern)


def test_backward_bound_numbers():
    # the function reads q, k, v, o, dO (bf16) and lse (fp32) and writes dq,
    # dk, dv; di is the two kernels' own intermediate. Five products, seven
    # in the two-kernel design; the dQ kernel also writes di, which the
    # dK/dV kernel reads
    ms, by = chip_smoke.backward_bound(64, 197, 12, 64)
    assert by == "bytes" and ms == pytest.approx(
        (8 * 64 * 197 * 12 * 64 * 2 + 64 * 12 * 197 * 4) / 3.35e12 * 1e3, rel=1e-12)
    assert chip_smoke.backward_bound(64, 197, 12, 64, "two_kernel") == (ms, by)
    ms, by = chip_smoke.backward_bound(2, 4097, 12, 64)
    assert by == "operations" and ms == pytest.approx(
        10 * 2 * 12 * 4097 ** 2 * 64 / 989e12 * 1e3, rel=1e-12)
    assert chip_smoke.backward_bound(2, 4097, 12, 64, "two_kernel")[0] == pytest.approx(
        ms * 7 / 5, rel=1e-12)
    for part, products in (("dq", 3), ("dkv", 4)):
        t_ms, t_by = chip_smoke.backward_bound(64, 197, 12, 64, part)
        assert t_by == "bytes" and t_ms == pytest.approx(
            (6 * 64 * 197 * 12 * 64 * 2 + 2 * 64 * 12 * 197 * 4) / 3.35e12 * 1e3, rel=1e-12)
        assert chip_smoke.backward_bound(2, 4097, 12, 64, part)[0] == pytest.approx(
            ms * products / 5, rel=1e-12)


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


# ConvNeXt: convnext_atto (dims 40-320) at 32x32, 3 classes
CONVNEXT_SPEC = {"name": "convnext_atto", "kwargs": {"num_classes": 3, "drop_path_rate": 0.1}}


def _jax_probs(path, imgs, monkeypatch):
    """The JAX val.py's probabilities on uint8 NHWC `imgs` from checkpoint
    `path`, fp32 (JPEGs through PIL; no Pallas kernel on this path)."""
    import imageclassification_tpu.data.native_decode as jax_native
    import val as jax_val

    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    jm, jp, jbs, _ = jax_val.initialize_model(path, False, half_precision=False)
    return np.asarray(jax_val._predict_fn(jm)(jp, jbs, jnp.asarray(imgs)))


def _convnext_jax_state(seed):
    """A JAX convnext_atto train state (AdamW, EMA) whose parameters and EMA
    are numpy draws (test_torch_convnext.jax_convnext_flat)."""
    from test_torch_convnext import _nest as nest_jnp
    from test_torch_convnext import jax_convnext_flat

    jmodel = jax_create_model("convnext_atto", num_classes=3, drop_path_rate=0.1)
    tx = jax_create_optimizer("adamw", 0.01, 0.05)
    jstate = jax_create_state(jmodel, tx, jax.random.key(seed), INPUT_SHAPE, use_ema=True)
    flat = jax_convnext_flat(jmodel, 32, seed)
    params = nest_jnp(flat)
    return jstate.replace(params=params, ema_params=params, opt_state=tx.init(params)), tx, flat


def test_convnext_cli_trains_on_cpu_and_jax_val_reads_it(toy_dataset, tmp_path, monkeypatch,
                                                          capsys):
    # train.main --model convnext_atto --device cpu (drop_path 0.1, mixup,
    # EMA): the checkpoint is in the JAX layout, and the JAX val.py reads it
    # to the port's probabilities (fp32, summation order: 1e-5)
    out_dir = tmp_path / "train_cls" / "output"
    args = config.parse_args([
        "--device", "cpu", "--data_path", toy_dataset, "--model", "convnext_atto",
        "--input_size", "32", "--batch_size", "4", "--epochs", "1", "--warmup_epochs", "1",
        "--num_workers", "2", "--model_ema", "true", "--drop_path", "0.1",
        "--output_dir", str(out_dir), "--log_dir", str(tmp_path / "train_cls" / "log_dir")])
    state = train.main(args)
    out = capsys.readouterr().out
    assert "Mixup is activated!" in out and "Accuracy of the model EMA" in out
    path = str(out_dir / "checkpoint-0.pth")
    with open(path, "rb") as f:
        ck = pickle.load(f)
    assert ck["model_spec"] == CONVNEXT_SPEC and ck["input_shape"] == INPUT_SHAPE
    jmodel = jax_create_model("convnext_atto", num_classes=3)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros(INPUT_SHAPE))
    want = {"/".join(p.key for p in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    assert {k: v.shape for k, v in ck["model"].items()} == want
    assert {k: v.shape for k, v in ck["model_ema"].items()} == want
    assert int(ck["optimizer"]["count"]) == state.optimizer.num_updates > 0

    imgs = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    pm, _ = port_val.initialize_model(path, False, half_precision=False, device="cpu")
    got = port_val._predict_fn(pm)(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, _jax_probs(path, imgs, monkeypatch), atol=1e-5, rtol=0)


def test_convnext_checkpoints_resume_across_packages(tmp_path, capsys):
    # JAX -> port: a ConvNeXt checkpoint of the JAX save_model resumes in the
    # port's auto_load_model with its optimizer, exactly
    jstate, tx, flat = _convnext_jax_state(seed=2)
    jsave = jax_config.TrainConfig(output_dir=str(tmp_path / "jax"), model_ema=True)
    jax_io.save_model(jsave, INPUT_SHAPE, 3, jstate, 3, CONVNEXT_SPEC)
    jax_io.wait_for_pending_saves()
    model = create_model("convnext_atto", num_classes=3, drop_path_rate=0.1)
    state = create_train_state(model, create_optimizer("adamw", model.parameters(), 0.01, 0.05),
                               use_ema=True)
    pargs = config.TrainConfig(output_dir=str(tmp_path / "jax"), model_ema=True, device="cpu")
    state, _ = port_io.auto_load_model(pargs, state)
    assert "With optim & sched!" in capsys.readouterr().out and pargs.start_epoch == 4
    carry = carry_for(model)
    _assert_flat_equal(carry.to_jax(model.state_dict()), flat, "params")
    _assert_flat_equal(carry.to_jax(state.ema), flat, "ema")

    # port -> JAX: after two updates the port's checkpoint resumes in the JAX
    # auto_load_model with its parameters, EMA and optimizer state, exactly
    _updates(state, seed=4, n=2)
    port_io.save_model(config.TrainConfig(output_dir=str(tmp_path / "port"), device="cpu"),
                       INPUT_SHAPE, 0, state, 3, CONVNEXT_SPEC)
    with open(tmp_path / "port" / "checkpoint-0.pth", "rb") as f:
        ck = pickle.load(f)
    fresh, _, _ = _convnext_jax_state(seed=5)
    jargs = jax_config.TrainConfig(output_dir=str(tmp_path / "port"), model_ema=True)
    fresh, _ = jax_io.auto_load_model(jargs, fresh)
    assert "With optim & sched!" in capsys.readouterr().out and jargs.start_epoch == 1
    _assert_flat_equal(_jax_flat(fresh.params), ck["model"], "params")
    _assert_flat_equal(_jax_flat(fresh.ema_params), ck["model_ema"], "ema")
    _assert_flat_equal(_jax_flat(fresh.opt_state), ck["optimizer"], "optimizer")
    assert int(fresh.step) == state.step == 2


def test_port_val_serves_a_jax_convnext_checkpoint(toy_dataset, tmp_path, monkeypatch, capsys):
    # a ConvNeXt checkpoint written by the JAX save_model, served by the
    # port's val.py: probabilities to 1e-5 (fp32) against the JAX val.py, and
    # the same per-class counts
    import val as jax_val

    jstate, _, _ = _convnext_jax_state(seed=6)
    jsave = jax_config.TrainConfig(output_dir=str(tmp_path), model_ema=False)
    jax_io.save_model(jsave, INPUT_SHAPE, 0, jstate, 3, CONVNEXT_SPEC)
    jax_io.wait_for_pending_saves()
    path = str(tmp_path / "checkpoint-0.pth")
    imgs = np.random.default_rng(1).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    want = _jax_probs(path, imgs, monkeypatch)
    pm, _ = port_val.initialize_model(path, False, half_precision=False, device="cpu")
    got = port_val._predict_fn(pm)(torch.from_numpy(imgs)).numpy()
    assert len(set(want.argmax(1).tolist())) > 1  # predictions are not all one class
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    for fn in (jax_val, port_val):
        monkeypatch.setattr(fn, "initialize_model",
                            functools.partial(fn.initialize_model, half_precision=False))
    counts = [jax_val.val_precision(toy_dataset, path, 32, model_ema=False, batch_size=16),
              port_val.val_precision(toy_dataset, path, 32, model_ema=False, batch_size=16,
                                     device="cpu")]
    for g, w in zip(counts[1], counts[0]):
        np.testing.assert_array_equal(g, w)


def test_chip_smoke_convnext_training_and_replay_rehearsal_on_cpu(tmp_path):
    # chip_smoke.py's phases 6 and 6b at a tiny size on the CPU (bf16 model,
    # the ops' plain versions, so no kernel launches): 17 LayerNorms and 12
    # depthwise convs of convnext_atto captured and held against the model's
    # own results
    model = dict(name="convnext_atto", depths=(2, 2, 6, 2), dims=(40, 80, 160, 320))
    run = chip_smoke.run_convnext_training(str(tmp_path), "cpu", model, img=32, num_classes=3,
                                           per_class=10, batch=4, epochs=2)
    assert len(run["records"]) == 2 * run["steps_per_epoch"] == 12
    rep = chip_smoke.replay_convnext_ops(run, "cpu")
    assert (rep["n_ln"], rep["n_dw"]) == (1 + 3 + 12 + 1, 12)
    assert sum(rep["dw_counts"].values()) == 12 and set(rep["dw_counts"]) == set(rep["dw_shapes"])
    assert rep["launches"] == {"ln_fwd": 0, "ln_bwd": 0, "dw_fwd": 0, "dw_dx": 0, "dw_dw": 0}
    assert rep["errs"]["layer_norm_fwd vs model"] > 0 or rep["errs"]["dwconv7x7_fwd vs model"] > 0


def test_chip_smoke_convnext_layout_is_the_jax_layout():
    model = jax_create_model("convnext_tiny", num_classes=5)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros(INPUT_SHAPE))
    want = {"/".join(p.key for p in path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    assert chip_smoke.jax_convnext_shapes((3, 3, 9, 3), (96, 192, 384, 768), 5) == want


def test_layernorm_and_dwconv_bound_numbers():
    # ConvNeXt-T stage 0 at batch 64, bf16: LayerNorm two passes (forward)
    # and three (backward) of 200,704 x 96 over 3.35 TB/s; the depthwise conv
    # two passes over 3.35 TB/s (in bf16 its flops at the tensor-core rate
    # take less)
    ms, by = chip_smoke.layernorm_bound(200704, 96, "fwd")
    assert by == "bytes" and ms == pytest.approx(
        (2 * 200704 * 96 * 2 + 2 * 96 * 4) / 3.35e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.0230, abs=1e-4)
    assert chip_smoke.layernorm_bound(200704, 96, "bwd")[0] == pytest.approx(0.0345, abs=1e-4)
    ms, by = chip_smoke.dwconv_bound(64, 56, 56, 96)
    assert by == "bytes" and ms == pytest.approx(
        (2 * 64 * 56 * 56 * 96 + 49 * 96) * 2 / 3.35e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.0230, abs=1e-4)
    assert chip_smoke.dwconv_bound(64, 7, 7, 768)[0] == pytest.approx(0.0029, abs=1e-4)
    # in fp32, 2 * 49 flops per element over 66.9 TFLOP/s (0.0282 ms) take
    # less than the bytes, twice bf16's
    ms, by = chip_smoke.dwconv_bound(64, 56, 56, 96, itemsize=4)
    assert by == "bytes" and ms == pytest.approx(
        (2 * 64 * 56 * 56 * 96 + 49 * 96) * 4 / 3.35e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.0460, abs=1e-4)



def test_launch_gap_sums_the_timed_shapes_only():
    # launches x (device - bound) over a replayed step: shapes with a timed
    # row count, the others are counted apart and left out
    rows = [{"shape": [8, 4], "device_ms": 0.5, "bound": (0.2, "bytes")},
            {"shape": [2, 2], "device_ms": 0.1, "bound": (0.1, "bytes")}]
    counts = {(8, 4): 3, (2, 2): 2, (9, 9): 5}
    total, counted, left = chip_smoke.launch_gap(rows, counts, lambda r: tuple(r["shape"]),
                                                 lambda r: r["device_ms"] - r["bound"][0])
    assert total == pytest.approx(3 * 0.3, rel=1e-12) and (counted, left) == (5, 5)


def test_device_ms_survives_dropped_launches(monkeypatch):
    # a trace may keep none of a kernel's launches (traced again) or only
    # some of them (a mean per launch times the launches of one call)
    kept = {"conv1x1_bn_kernel<true, true>": (0.3, 0.5),   # half its launches
            "sum_partials_kernel<float>": (0.04, 2.0), "other": (9.0, 1.0)}
    traces = iter([{"conv1x1_bn_kernel<true, true>": (0.5, 1.0)},  # no sum_partials
                   kept, kept, kept])
    monkeypatch.setattr(chip_smoke, "trace", lambda fn, steps=10: (0.0, 0.0, next(traces)))
    _host_and_events(monkeypatch, 0.01, 1.0)
    got = chip_smoke._device_ms(None, {"conv1x1_bn_kernel": 1, "sum_partials": 2})
    assert got == pytest.approx(0.3 / 0.5 * 1 + 0.04 / 2.0 * 2, rel=1e-12)
    monkeypatch.setattr(chip_smoke, "trace", lambda fn, steps=10: (0.0, 0.0, {"other": (1.0, 1.0)}))
    with pytest.raises(AssertionError, match="no launch"):
        chip_smoke._device_ms(None, {"conv1x1_bn_kernel": 1})


def test_device_ms_counts_whole_launches_and_retraces_a_misreading(monkeypatch):
    # a trace that lists one launch as two events of half its time reads half
    # the kernel's time at its mean per event: whole launches count both; a
    # reading of a device-bound call below half its CUDA events ms is traced
    # again, and raises when it stays there (as 0.1106 against 0.249 ms did)
    _host_and_events(monkeypatch, 0.03, 0.249)
    split = {"flash_attention_fwd_kernel": (0.2352, 2.0)}
    monkeypatch.setattr(chip_smoke, "trace", lambda fn, steps=10: (0.0, 0.0, split))
    assert chip_smoke._device_ms(None, {"flash_attention_fwd_kernel": 1}) == \
        pytest.approx(0.2352, rel=1e-12)
    low, right = {"flash_attention_fwd_kernel": (0.1106, 1.0)}, {"flash_attention_fwd_kernel":
                                                                 (0.2352, 1.0)}
    traces = iter([low] * 3 + [right] * 3)
    monkeypatch.setattr(chip_smoke, "trace", lambda fn, steps=10: (0.0, 0.0, next(traces)))
    assert chip_smoke._device_ms(None, {"flash_attention_fwd_kernel": 1}) == \
        pytest.approx(0.2352, rel=1e-12)
    monkeypatch.setattr(chip_smoke, "trace", lambda fn, steps=10: (0.0, 0.0, low))
    with pytest.raises(AssertionError, match="misreading"):
        chip_smoke._device_ms(None, {"flash_attention_fwd_kernel": 1})
    # the same reading of a host-bound call (host ms above half its events
    # ms) stands: its device is idle between launches
    _host_and_events(monkeypatch, 0.2, 0.249)
    assert chip_smoke._device_ms(None, {"flash_attention_fwd_kernel": 1}) == \
        pytest.approx(0.1106, rel=1e-12)
    # inside a step, the other kernels count toward the check
    step = {"flash_attention_fwd_kernel": (24 * 0.242, 24.0), "gemm": (90.0, 200.0)}
    _host_and_events(monkeypatch, 0.5, 96.9)
    monkeypatch.setattr(chip_smoke, "trace", lambda fn, steps=10: (0.0, 0.0, step))
    assert chip_smoke._device_ms(None, {"flash_attention_fwd": 24}, events_ms=96.9) == \
        pytest.approx(24 * 0.242, rel=1e-12)


def _host_and_events(monkeypatch, host, events):
    # the call's host ms and CUDA events ms, read on the same calls
    monkeypatch.setattr(chip_smoke, "host_and_events_ms",
                        lambda fn, calls=20, reps=3: (host, events))


def _host_bound(monkeypatch):
    # host-bound, so no reading is held to its events ms
    _host_and_events(monkeypatch, 0.9, 1.0)


def test_library_device_ms_retraces_and_refuses_a_misreading(monkeypatch):
    # a device-bound library call read below half its CUDA events ms is
    # traced again, and raises when it stays there; a host-bound one stands
    _host_and_events(monkeypatch, 0.05, 0.7055)
    low, right = {"fmha_bwd": (0.30, 1.0)}, {"fmha_bwd": (0.65, 1.0)}
    traces = iter([low] * 3 + [right] * 3)
    monkeypatch.setattr(chip_smoke, "trace", lambda fn: (0.0, 0.0, next(traces)))
    assert chip_smoke._library_device_ms(None) == pytest.approx(0.65, rel=1e-12)
    monkeypatch.setattr(chip_smoke, "trace", lambda fn: (0.0, 0.0, low))
    with pytest.raises(AssertionError, match="misreading"):
        chip_smoke._library_device_ms(None)
    # the events ms of the call may be given (timed once by the caller)
    assert chip_smoke._library_device_ms(None, events_ms=0.5) == pytest.approx(0.30, rel=1e-12)
    _host_and_events(monkeypatch, 0.6, 0.7055)
    assert chip_smoke._library_device_ms(None) == pytest.approx(0.30, rel=1e-12)


def test_device_ms_floors_a_kernel_inside_a_step(monkeypatch):
    # inside a 332 ms step the other kernels alone pass the whole-call check;
    # the kernel's own reading is held to half its CUDA events alone
    _host_and_events(monkeypatch, 5.0, 332.0)
    low = {"flash_attention_fwd_kernel": (36 * 1.0, 36.0), "gemm": (240.0, 400.0)}
    right = {"flash_attention_fwd_kernel": (36 * 2.3, 36.0), "gemm": (240.0, 400.0)}
    traces = iter([low] * 3 + [right] * 3)
    monkeypatch.setattr(chip_smoke, "trace", lambda fn, steps=10: (0.0, 0.0, next(traces)))
    floor = chip_smoke.alone_floor(2.4, 0.05) * 36
    assert floor == pytest.approx(1.2 * 36)
    got = chip_smoke._device_ms(None, {"flash_attention_fwd": 36}, events_ms=332.0,
                                floor_ms=floor)
    assert got == pytest.approx(36 * 2.3, rel=1e-12)
    monkeypatch.setattr(chip_smoke, "trace", lambda fn, steps=10: (0.0, 0.0, low))
    assert chip_smoke._device_ms(None, {"flash_attention_fwd": 36}, events_ms=332.0) == \
        pytest.approx(36.0, rel=1e-12)  # the whole-call check alone lets it through
    with pytest.raises(AssertionError, match="misreading"):
        chip_smoke._device_ms(None, {"flash_attention_fwd": 36}, events_ms=332.0,
                              floor_ms=floor)
    # a kernel alone that is host-bound gives no floor
    assert chip_smoke.alone_floor(0.02, 0.03) == 0.0


def test_device_ms_readers_judge_a_call_on_the_same_calls(monkeypatch):
    # a host-bound call whose events the caller read at a slow moment of the
    # host (0.3926 ms, about twice their usual) is judged on host and events
    # ms of the same calls: host-bound, so its reading stands
    monkeypatch.setattr(chip_smoke, "trace", lambda fn: (0.0, 0.0, {"ln_bwd": (0.078, 1.0)}))
    _host_and_events(monkeypatch, 0.17, 0.18)
    assert chip_smoke._library_device_ms(None, events_ms=0.3926) == \
        pytest.approx(0.078, rel=1e-12)
    # a device-bound call is held to the lesser of the two events readings,
    # neither of which can be shorter than its device time
    _host_and_events(monkeypatch, 0.02, 0.14)
    assert chip_smoke._library_device_ms(None, events_ms=0.3926) == \
        pytest.approx(0.078, rel=1e-12)
    # and a reading far below its events is still refused
    monkeypatch.setattr(chip_smoke, "trace", lambda fn: (0.0, 0.0, {"ln_bwd": (0.01, 1.0)}))
    with pytest.raises(AssertionError, match="misreading"):
        chip_smoke._library_device_ms(None, events_ms=0.3926)
    # the caller's events ms sizes the run: at least 2 calls, at most 20
    sizes = []
    monkeypatch.setattr(chip_smoke, "host_and_events_ms",
                        lambda fn, calls=20, reps=3: sizes.append(calls) or (0.9, 1.0))
    for events_ms in (None, 0.01, 1.0, 332.0):
        chip_smoke._library_device_ms(None, events_ms=events_ms)
    assert sizes == [20, 20, 10, 2]


def test_library_device_ms_survives_dropped_launches(monkeypatch):
    # a library call's kernels, unknown by name, over three traces: each at
    # its mean per launch, times the most launches per call one trace kept
    traces = iter([
        {"wgrad": (0.2, 2.0), "reduce": (0.1, 1.0)},
        {"wgrad": (0.1, 1.0)},  # half of wgrad's launches, none of reduce's
        {"wgrad": (0.2, 2.0), "reduce": (0.1, 1.0)},
    ])
    monkeypatch.setattr(chip_smoke, "trace", lambda fn: (0.0, 0.0, next(traces)))
    _host_bound(monkeypatch)
    got = chip_smoke._library_device_ms(None)
    assert got == pytest.approx(0.5 / 5.0 * 2 + 0.2 / 2.0 * 1, rel=1e-12)


def test_library_device_ms_counts_whole_launches(monkeypatch):
    # a kernel that every trace kept only some launches of counts as the
    # whole launches a call makes (a fifth of one kept: one launch a call)
    monkeypatch.setattr(chip_smoke, "trace", lambda fn: (0.0, 0.0, {"fmha": (0.05, 0.2),
                                                                    "copy": (0.02, 2.0)}))
    _host_bound(monkeypatch)
    got = chip_smoke._library_device_ms(None)
    assert got == pytest.approx(0.25 * 1 + 0.01 * 2, rel=1e-12)


def test_library_device_ms_retraces_a_trace_without_kernels(monkeypatch):
    # a trace that kept no kernel of the call is taken again; when none of
    # fifteen keeps one, the reading fails instead of giving 0
    traces = iter([{}, {"fmha": (0.3, 1.0)}, {}, {}, {"fmha": (0.1, 1.0)},
                   {"fmha": (0.2, 1.0)}])
    monkeypatch.setattr(chip_smoke, "trace", lambda fn: (0.0, 0.0, next(traces)))
    _host_bound(monkeypatch)
    assert chip_smoke._library_device_ms(None) == pytest.approx(0.2, rel=1e-12)
    monkeypatch.setattr(chip_smoke, "trace", lambda fn: (0.0, 0.0, {}))
    with pytest.raises(AssertionError, match="no kernel"):
        chip_smoke._library_device_ms(None)


@pytest.mark.parametrize("spans, want", [
    ([], 0.0),
    ([(0, 2), (5, 6)], 3.0),               # apart: their sum
    ([(0, 4), (1, 3), (2, 6)], 6.0),       # overlapping and nested
    ([(3, 5), (0, 3), (5, 5)], 5.0),       # touching, unordered, empty
])
def test_busy_time_is_the_union_of_kernel_intervals(spans, want):
    # the idle share reads busy time, which overlapping kernels (in some CUDA
    # graphs) would count twice in a sum
    assert chip_smoke.busy_us(spans) == want


@pytest.mark.parametrize("shape, want", [((64, 56, 56, 96), 0.0230), ((64, 28, 28, 192), 0.0115),
                                         ((64, 14, 14, 384), 0.0058), ((64, 7, 7, 768), 0.0029)])
def test_dwconv_dw_bound_is_its_bytes_at_the_tensor_core_rate(shape, want):
    # dw is per channel a 7 x 7 product of depth B*H*W: its 98 flops per
    # element over 989 TFLOP/s of bf16 take less time than reading x and dy
    B, H, W, C = shape
    ms, by = chip_smoke.dwconv_bound(*shape)
    assert by == "bytes" and ms == pytest.approx(
        (2 * B * H * W * C + 49 * C) * 2 / 3.35e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(want, abs=1e-4)

# ResNet: resnet18 at 32x32 (BasicBlock; the stem's 7x7/s2 and the max pool
# leave 8x8 for the blocks), and a narrow Bottleneck for the replay
RESNET_SPEC = {"name": "resnet18", "kwargs": {"num_classes": 3}}


def _jax_trees(name):
    jmodel = jax_create_model(name, num_classes=3)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros(INPUT_SHAPE))
    return {tree: {"/".join(p.key for p in path): leaf.shape for path, leaf in
                   jax.tree_util.tree_flatten_with_path(shapes[tree])[0]}
            for tree in ("params", "batch_stats")}


def test_resnet_cli_trains_on_cpu_and_jax_val_reads_it(toy_dataset, tmp_path, monkeypatch,
                                                        capsys):
    # train.main --model resnet18 --device cpu (mixup, EMA): the checkpoint
    # holds the parameters, batch_stats, the EMA and its batch statistics in
    # the JAX layout, and the JAX val.py reads it to the port's probabilities
    # with the model's statistics and with the EMA's (fp32, summation order:
    # 1e-5)
    out_dir = tmp_path / "train_cls" / "output"
    args = config.parse_args([
        "--device", "cpu", "--data_path", toy_dataset, "--model", "resnet18",
        "--input_size", "32", "--batch_size", "4", "--epochs", "1", "--warmup_epochs", "1",
        "--num_workers", "2", "--model_ema", "true", "--model_ema_decay", "0.5",
        "--output_dir", str(out_dir), "--log_dir", str(tmp_path / "train_cls" / "log_dir")])
    state = train.main(args)
    out = capsys.readouterr().out
    assert "Mixup is activated!" in out and "Accuracy of the model EMA" in out
    path = str(out_dir / "checkpoint-0.pth")
    with open(path, "rb") as f:
        ck = pickle.load(f)
    assert ck["model_spec"] == RESNET_SPEC and ck["input_shape"] == INPUT_SHAPE
    want = _jax_trees("resnet18")
    for key, tree in (("model", "params"), ("model_ema", "params"),
                      ("batch_stats", "batch_stats"), ("model_ema_batch_stats", "batch_stats")):
        assert {k: v.shape for k, v in ck[key].items()} == want[tree], key
    assert int(ck["optimizer"]["count"]) == state.optimizer.num_updates > 0
    assert not np.allclose(ck["batch_stats"]["bn_stem/var"], 1.0)  # the statistics moved
    assert not np.allclose(ck["batch_stats"]["bn_stem/var"],
                           ck["model_ema_batch_stats"]["bn_stem/var"])

    imgs = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    import imageclassification_tpu.data.native_decode as jax_native
    import val as jax_val

    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    probs = {}
    for ema in (False, True):
        jm, jp, jbs, _ = jax_val.initialize_model(path, ema, half_precision=False)
        want_p = np.asarray(jax_val._predict_fn(jm)(jp, jbs, jnp.asarray(imgs)))
        pm, _ = port_val.initialize_model(path, ema, half_precision=False, device="cpu")
        probs[ema] = port_val._predict_fn(pm)(torch.from_numpy(imgs)).numpy()
        np.testing.assert_allclose(probs[ema], want_p, atol=1e-5, rtol=0, err_msg=f"ema {ema}")
    assert np.abs(probs[True] - probs[False]).max() > 1e-4  # the EMA's weights were used


def _narrow_resnets(seed):
    """A JAX train state (AdamW, EMA) and a port train state of the same
    narrow BasicBlock ResNet; the JAX one holds numpy-drawn parameters and
    statistics, its EMA other draws."""
    from imageclassification_tpu.models.resnet import BasicBlock as JaxBasicBlock
    from imageclassification_tpu.models.resnet import ResNet as JaxResNet
    from imageclassification_tpu_torch.models import resnet as port_resnet
    from test_torch_resnet import jax_resnet_flat, nest

    jmodel = JaxResNet([1, 1, 1, 1], JaxBasicBlock, num_classes=3, width=8)
    tx = jax_create_optimizer("adamw", 0.01, 0.05)
    jstate = jax_create_state(jmodel, tx, jax.random.key(seed), INPUT_SHAPE, use_ema=True)
    params, stats = jax_resnet_flat(jmodel, 32, seed)
    ema, ema_stats = jax_resnet_flat(jmodel, 32, seed + 1)
    jstate = jstate.replace(params=nest(params), batch_stats=nest(stats), ema_params=nest(ema),
                            ema_batch_stats=nest(ema_stats), opt_state=tx.init(nest(params)))
    pmodel = port_resnet.ResNet([1, 1, 1, 1], port_resnet.BasicBlock, num_classes=3, width=8)
    pstate = create_train_state(pmodel, create_optimizer("adamw", pmodel.parameters(), 0.01, 0.05),
                                use_ema=True)
    return jstate, pstate, {"model": params, "batch_stats": stats, "model_ema": ema,
                            "model_ema_batch_stats": ema_stats}


def test_resnet_checkpoints_resume_across_packages(tmp_path, capsys):
    # JAX -> port: a ResNet checkpoint of the JAX save_model resumes in the
    # port's auto_load_model with its optimizer, statistics and both EMAs,
    # exactly
    jstate, state, trees = _narrow_resnets(seed=2)
    jsave = jax_config.TrainConfig(output_dir=str(tmp_path / "jax"), model_ema=True)
    jax_io.save_model(jsave, INPUT_SHAPE, 3, jstate, 3, RESNET_SPEC)
    jax_io.wait_for_pending_saves()
    pargs = config.TrainConfig(output_dir=str(tmp_path / "jax"), model_ema=True, device="cpu")
    state, _ = port_io.auto_load_model(pargs, state)
    assert "With optim & sched!" in capsys.readouterr().out and pargs.start_epoch == 4
    carry = carry_for(state.model)
    _assert_flat_equal(carry.to_jax(dict(state.model.named_parameters())), trees["model"],
                       "params")
    _assert_flat_equal(carry.to_jax(dict(state.model.named_buffers())), trees["batch_stats"],
                       "batch_stats")
    _assert_flat_equal(carry.to_jax(state.ema), trees["model_ema"], "ema")
    _assert_flat_equal(carry.to_jax(state.ema_stats), trees["model_ema_batch_stats"], "ema stats")

    # port -> JAX: after two updates (and statistics moved by a train-mode
    # step's commit) the port's checkpoint resumes in the JAX auto_load_model
    # with every tree, exactly
    _updates(state, seed=4, n=2)
    from imageclassification_tpu_torch.models.layers import commit_batch_stats

    state.model.train()(torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)))
    commit_batch_stats(state.model)
    port_io.save_model(config.TrainConfig(output_dir=str(tmp_path / "port"), device="cpu"),
                       INPUT_SHAPE, 0, state, 3, RESNET_SPEC)
    with open(tmp_path / "port" / "checkpoint-0.pth", "rb") as f:
        ck = pickle.load(f)
    fresh, _, _ = _narrow_resnets(seed=5)
    jargs = jax_config.TrainConfig(output_dir=str(tmp_path / "port"), model_ema=True)
    fresh, _ = jax_io.auto_load_model(jargs, fresh)
    assert "With optim & sched!" in capsys.readouterr().out and jargs.start_epoch == 1
    for key, tree in (("model", fresh.params), ("batch_stats", fresh.batch_stats),
                      ("model_ema", fresh.ema_params),
                      ("model_ema_batch_stats", fresh.ema_batch_stats),
                      ("optimizer", fresh.opt_state)):
        _assert_flat_equal(_jax_flat(tree), ck[key], key)
    assert not np.array_equal(ck["batch_stats"]["bn_stem/mean"],
                              trees["batch_stats"]["bn_stem/mean"])


def test_ema_eval_and_val_use_the_ema_statistics(tmp_path):
    # train.py's EMA eval swaps the BatchNorm statistics with the parameters,
    # and restores both; val.initialize_model(model_ema=True) loads the EMA's
    # statistics, model_ema=False the model's
    model = create_model("resnet18", num_classes=3, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, create_optimizer("adamw", model.parameters(), 0.01, 0.05),
                               use_ema=True)
    with torch.no_grad():
        for t in (*state.ema.values(), *state.ema_stats.values()):
            t.add_(0.5)
    own = {k: v.clone() for k, v in model.state_dict().items()}
    with train._EmaWeights(model, state.ema, state.ema_stats):
        for k, v in model.state_dict().items():
            want = state.ema_stats[k] if k in state.ema_stats else state.ema[k]
            assert torch.equal(v, want), k
    for k, v in model.state_dict().items():
        assert torch.equal(v, own[k]), k
    with train._EmaWeights(model, None, state.ema_stats):  # --model_ema false: no swap
        assert all(torch.equal(v, own[k]) for k, v in model.state_dict().items())

    path = port_io.save_model(config.TrainConfig(output_dir=str(tmp_path), device="cpu"),
                              INPUT_SHAPE, 0, state, 3, RESNET_SPEC)
    for ema, want in ((True, state.ema_stats), (False, own)):
        loaded, _ = port_val.initialize_model(path, ema, half_precision=False, device="cpu")
        for k, v in loaded.named_buffers():
            assert torch.equal(v, want[k]), (ema, k)


def test_chip_smoke_resnet_training_and_replay_rehearsal_on_cpu(tmp_path):
    # chip_smoke.py's phases 7 and 7b at a tiny size on the CPU (bf16 models,
    # the op's plain version, so no kernel launches): resnet18 through
    # train.main (its 3 strided downsamples replayed), and a narrow
    # Bottleneck net's 12 1x1 convs (conv1, conv3 with the prologue, the
    # downsamples) held against the model's own results
    from imageclassification_tpu_torch.models import resnet as port_resnet

    model = dict(name="resnet18", stage_sizes=(2, 2, 2, 2), block="BasicBlock", width=64)
    run = chip_smoke.run_resnet_training(str(tmp_path), "cpu", model, img=32, num_classes=3,
                                         per_class=10, batch=4, epochs=2)
    assert len(run["records"]) == 2 * run["steps_per_epoch"] == 12
    batch = chip_smoke._fixed_batch(run, "cpu")
    rep = chip_smoke.replay_resnet_convs(run["state"].model, run["args"], batch, 3)
    assert rep["n"] == {"conv1": 0, "conv3": 0, "downsample": 3}
    narrow = port_resnet.ResNet([1, 1, 1, 1], port_resnet.Bottleneck, num_classes=3, width=8,
                                dtype=torch.bfloat16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for blk in narrow.modules():
            if isinstance(blk, port_resnet.Bottleneck):
                blk.bn3.weight.fill_(1.0)  # zero-initialised: make conv3's path count
    rep = chip_smoke.replay_resnet_convs(narrow, run["args"], batch, 3)
    assert rep["n"] == {"conv1": 4, "conv3": 4, "downsample": 4}
    assert sum(rep["counts"].values()) == 12 and set(rep["counts"]) == set(rep["shapes"])
    assert rep["launches"] == {"k2": 0, "k2_bn_in": 0}
    assert rep["errs"]["y vs model"] <= 2.0 ** -6 and rep["errs"]["batch var vs model"] > 0


@pytest.mark.parametrize("name,stages,block", [("resnet50", (3, 4, 6, 3), "Bottleneck"),
                                               ("resnet18", (2, 2, 2, 2), "BasicBlock")])
def test_chip_smoke_resnet_layout_is_the_jax_layout(name, stages, block):
    want = _jax_trees(name)
    params, stats = chip_smoke.jax_resnet_shapes(stages, block, 64, 3)
    assert params == want["params"] and stats == want["batch_stats"]


def test_conv1x1_bound_numbers():
    # ResNet-50's 1x1 convs at batch 64, 224x224, bf16: x, w and y once over
    # 3.35 TB/s against 2MKN flops over 989 TFLOP/s; bytes bind at stages
    # 1-3, operations at stage 4
    for (M, K, N, bn_in), want_ms, want_by in zip(chip_smoke.K2_SHAPES, (
            0.0384, 0.0384, 0.0192, 0.0192, 0.0097, 0.0097, 0.0067, 0.0067, 0.0133),
            ["bytes"] * 6 + ["operations"] * 3):
        ms, by = chip_smoke.conv1x1_bound(M, K, N, bn_in)
        assert by == want_by and ms == pytest.approx(want_ms, abs=1e-4), (M, K, N)
    ms, _ = chip_smoke.conv1x1_bound(200704, 64, 256, True)
    assert ms == pytest.approx(((200704 * 64 + 64 * 256 + 200704 * 256) * 2 + 2 * 256 * 4
                                + 2 * 64 * 4) / 3.35e12 * 1e3, rel=1e-12)


def _tiny_train_args(toy_dataset, tmp_path, *extra):
    return config.parse_args([
        "--device", "cpu", "--data_path", toy_dataset, "--model", "vit_tiny_patch16",
        "--input_size", "32", "--batch_size", "8", "--epochs", "1", "--warmup_epochs", "1",
        "--num_workers", "2", "--output_dir", str(tmp_path / "out"),
        "--log_dir", str(tmp_path / "log"), *extra])


def test_check_nans_raises_naming_the_first_module_with_a_nan(toy_dataset, tmp_path):
    # a NaN in the first block's MLP weights: the JAX step under
    # jax_debug_nans raises FloatingPointError, and so does train.main with
    # --check_nans, naming the module whose output first holds the NaN
    from imageclassification_tpu.config import TrainConfig as JaxConfig
    from imageclassification_tpu.data.mixup import build_mixup as jax_build_mixup
    from imageclassification_tpu.engine.step import build_train_step as jax_build_train_step

    state = _port_state(seed=2)
    with torch.no_grad():
        state.model.blocks[0].mlp.fc1.weight[0, 0] = float("nan")
    ck = port_io.save_model(config.TrainConfig(output_dir=str(tmp_path / "ck"), device="cpu"),
                            INPUT_SHAPE, 0, state, 3, SPEC)

    jmodel = jax_create_model("vit_tiny_patch16", num_classes=3)
    jargs = JaxConfig(model="vit_tiny_patch16", half_precision=False)
    tx = jax_create_optimizer("adamw", 0.01, 0.05)
    jstate = jax_create_state(jmodel, tx, jax.random.key(1), INPUT_SHAPE)
    with open(ck, "rb") as f:
        jstate = jstate.replace(params=_nest(pickle.load(f)["model"]))
    jstep = jax.jit(jax_build_train_step(jmodel, tx, jargs, 3, jax_build_mixup(jargs, 3),
                                         np.full(4, 0.01), np.full(4, 0.05)))
    batch = {"image": jnp.zeros((4, 32, 32, 3), jnp.uint8), "label": jnp.zeros(4, jnp.int32)}
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(jstep(jstate, batch, jax.random.key(0)))
    finally:
        jax.config.update("jax_debug_nans", False)

    args = _tiny_train_args(toy_dataset, tmp_path, "--check_nans", "true", "--pretrained",
                            "true", "--pretrained_path", ck)
    # fc1 is applied through models/layers.py::linear, which runs its hooks
    with pytest.raises(FloatingPointError, match=r"blocks\.0\.mlp\.fc1 \(Linear\)"):
        train.main(args)


def test_profile_dir_writes_a_trace(toy_dataset, tmp_path, capsys):
    prof = tmp_path / "prof"
    state = train.main(_tiny_train_args(toy_dataset, tmp_path, "--profile_dir", str(prof)))
    assert state.step > 0
    assert f"profiler trace written to {prof}" in capsys.readouterr().out
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)  # the steps' ops


def test_enable_wandb_logs_the_jax_keys(toy_dataset, tmp_path, monkeypatch):
    # a fake wandb module (the package is not installed): the port logs the
    # keys the JAX loop logs batch by batch, numbered by the global step, the
    # epoch metrics under Global Train/Test, and the checkpoint artifact
    import types

    from imageclassification_tpu.engine import loop as jax_loop

    def fake_wandb():
        m = types.ModuleType("wandb")
        m.run, m.logged, m.defined, m.artifacts = None, [], [], []

        class Artifact:
            def __init__(self, name, type):
                self.name, self.type, self.dirs = name, type, []

            def add_dir(self, d):
                self.dirs.append(d)

        def init(project=None, config=None):
            m.run = types.SimpleNamespace(id="run0", summary={})

        m.init, m.Artifact = init, Artifact
        m.log = lambda payload, commit=True: m.logged.append(dict(payload))
        m.define_metric = lambda name, step_metric=None: m.defined.append((name, step_metric))
        m.log_artifact = lambda art, aliases=None: m.artifacts.append((art, aliases))
        return m

    jax_wandb = fake_wandb()
    monkeypatch.setitem(sys.modules, "wandb", jax_wandb)
    from imageclassification_tpu.utils.loggers import WandbLogger as JaxWandbLogger

    metrics = {"loss": 1.0, "class_acc": 0.5, "lr": 1e-3, "min_lr": 1e-3, "weight_decay": 0.05,
               "grad_norm": 2.0, "tp": np.zeros(3), "fp": np.zeros(3), "fn": np.zeros(3),
               "skipped": 0.0}
    jax_loop._drain((metrics, 0), jax_loop.MetricLogger(), np.zeros(3), np.zeros(3),
                    np.zeros(3), None, JaxWandbLogger(jax_config.TrainConfig()))
    want_keys = set(jax_wandb.logged[-1])

    port_wandb = fake_wandb()
    monkeypatch.setitem(sys.modules, "wandb", port_wandb)
    args = _tiny_train_args(toy_dataset, tmp_path, "--enable_wandb", "true", "--wandb_ckpt",
                            "true", "--epochs", "2")
    state = train.main(args)
    batch_wise = [p for p in port_wandb.logged if "Rank-0 Batch Wise/train_loss" in p]
    assert batch_wise and all(set(p) == want_keys for p in batch_wise)
    assert [p["Rank-0 Batch Wise/global_train_step"] for p in batch_wise] == \
        list(range(state.step))
    assert all(np.isfinite(p["Rank-0 Batch Wise/train_loss"]) for p in batch_wise)
    keys = {k for p in port_wandb.logged for k in p}
    assert {"Global Train/train_loss", "Global Test/test_acc1", "epoch"} <= keys
    assert ("Rank-0 Batch Wise/*", "Rank-0 Batch Wise/global_train_step") in port_wandb.defined
    (art, aliases), = port_wandb.artifacts
    assert art.name == "run0_model" and art.dirs == [args.output_dir]
    assert aliases == ["latest", "best"]


def test_chip_smoke_feed_rehearsal_on_cpu(tmp_path):
    # chip_smoke.py's phase 11 at a tiny size on the CPU: BatchLoader's rate
    # with the native decoder and with PIL (which decode the same JPEG into
    # other pixels, so the switch is seen), and train.main's epochs split
    cfg = dict(chip_smoke.FEED, size=(50, 40), batch=4, img=32, steps=3, workers=(2,), reps=1,
               num_classes=3)
    feed = chip_smoke.measure_feed(str(tmp_path), "cpu", cfg)
    assert feed["native_built"] and feed["native_2"] > 0 and feed["pil_2"] > 0
    assert feed["cpu_count"] == os.cpu_count()
    from imageclassification_tpu_torch.data import loader, native_decode

    path = os.path.join(feed["images"], "class_0", "img_0.jpg")
    native = loader.decode_image(path, 32, train=False)
    with pytest.MonkeyPatch.context() as mp:  # as phase 11 switches to PIL
        mp.setattr(native_decode, "get_lib", lambda: None)
        assert native_decode.get_lib() is None
        pil = loader.decode_image(path, 32, train=False)
    assert native_decode.get_lib() is not None and not np.array_equal(native, pil)
    model = dict(name="vit_tiny_patch16", dim=192, depth=12, heads=3, patch=16)
    epochs = chip_smoke.feed_epochs(str(tmp_path / "run"), feed["images"], "cpu", model, 32, 4)
    assert len(epochs) == 2 and epochs[0]["steps"] == 2  # 9 - 1 val a class of 3: 8 // 4
    for ep in epochs:
        assert ep["steps_s"] > ep["loader_wait_s"] >= 0 and ep["eval_s"] > 0
    assert epochs[-1]["checkpoint_s"] > 0
    from imageclassification_tpu_torch.engine import loop

    # train.py's functions are its own again after the run
    assert train.train_one_epoch is loop.train_one_epoch and train.evaluate is loop.evaluate
    assert train.BatchLoader is loader.BatchLoader
