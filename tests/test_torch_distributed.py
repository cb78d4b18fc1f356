"""Data-parallel training of the port (imageclassification_tpu_torch/parallel/,
the train step, BatchNorm, the loop, checkpoints, train.main) at a world of
two processes over gloo on the CPU, against the JAX package's train step on
one process over the global batch.

The global batch is the rank-major concatenation of the ranks' local batches
(JAX `make_global_batch`). The parent runs the JAX step (its Pallas flash
kernels in interpret mode) and the port at a world of one on the global
batch of 8, on the same weights (the weight carry) and the same mixup and
pixel draws (`jax_draws`); two port workers (tests/torch_dist_worker.py,
which import no JAX) run the step on 4 rows each, fed the same global
draws. Cases, fp32: a narrow ResNet (BatchNorm over the global batch, its
gradient across the ranks) with mixup and cutmix in 'pair' mode (every
pair crosses the ranks) and --update_freq 2, SGD at lr 0.01, 4 steps; a
narrow ViT with --flash_attn (the plain path on the CPU), 2 steps.
Tolerances: the loss 1e-5 relative of JAX's, the gradient norm 1e-4, the
updates of the parameters (the gradients through SGD) and of the EMA 1e-4
of the largest update, the BatchNorm statistics 1e-5; the two ranks bitwise
equal; the world of two against the port's world of one (summation order
only): the loss 1e-6 relative on the weights both start from (the steps up
to the first update) and 1e-5 after it (from there the weights differ by
the update's rounding, which the next steps carry), the parameters 1e-6 of
the largest |p|, the gradient norm 1e-5 relative (a norm over gradients
whose small elements carry the relative rounding of two orders of
summation).

Why lr 0.01 for the ResNet: its first block's conv weight gradients are a
sum that BatchNorm makes cancel (it removes the mean of dy), and the CPU's
fp32 order of that sum sits up to 0.86 % from a float64 evaluation on some
inputs (batch-mode cutmix with colour jitter and erasing; JAX's order stays
within 4e-6 there); at lr 0.05 four SGD steps grow such rounding past 1e-4
of the update in every package, one process or two."""

import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jax_draws
import torch_dist_worker
from imageclassification_tpu_torch import config, train
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for
from imageclassification_tpu_torch.data.sampler import eval_batches
from imageclassification_tpu_torch.engine.loop import evaluate
from imageclassification_tpu_torch.engine.step import build_eval_step
from imageclassification_tpu_torch.models import vit as port_vit
from imageclassification_tpu_torch.parallel import dist as pdist
from imageclassification_tpu_torch.parallel import mesh as pmesh
from test_torch_train_step import RESNET, SMALL, _both, _flat_of

G, IMG, NC = 8, 32, 5  # the global batch, the input size, the classes
CASES = {
    # name: (config overrides, family, steps)
    "resnet_mixup_cutmix_pair_update_freq_2": (
        dict(RESNET, opt="sgd", update_freq=2, cutmix=1.0, mixup_mode="pair", lr=0.01),
        "resnet", 4),
    "vit_flash_attn_mixup": (dict(opt="sgd"), "vit", 2),
}
# held against the port's world of one only, one step: adahessian (its
# Hessian-vector product differentiates BatchNorm's all-reduces twice; z is
# drawn alike on every rank and z * Hz averaged with the gradients)
PORT_ONLY = {"resnet_adahessian": (dict(RESNET, opt="adahessian", opt_eps=1e-3, lr=0.01),
                                   "resnet", 1)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(steps):
    rng = np.random.default_rng(11)
    return (rng.integers(0, 256, (steps, G, IMG, IMG, 3), dtype=np.uint8),
            rng.integers(0, NC, (steps, G)).astype(np.int64))


def _reference(name):
    """The JAX step's (not for PORT_ONLY) and the port's (world of one)
    metrics and final states on the global batches, and the worker's
    inputs."""
    kw, family, steps = CASES.get(name) or PORT_ONLY[name]
    jargs, jmix, jstate, jstep, pstate, pstep, flat, stats = _both(kw, family, steps)
    images, labels = _batches(steps)
    rng = jax.random.key(42)
    jm, pm, draws = [], [], []
    state_dict0 = {k: v.clone() for k, v in pstate.model.state_dict().items()}
    for s in range(steps):
        if name in CASES:
            jstate, m = jstep(jstate, {"image": jnp.asarray(images[s]),
                                       "label": jnp.asarray(labels[s], jnp.int32)}, rng)
            jm.append({k: np.asarray(v) for k, v in m.items()})
        d = jax_draws.step_draws(rng, s, G, IMG, IMG, jargs, jmix)
        draws.append(d)
        m = pstep(pstate, {"image": torch.from_numpy(images[s]),
                           "label": torch.from_numpy(labels[s])}, d)
        pm.append({k: np.asarray(m[k]) for k in m})
    carry = carry_for(pstate.model)
    job = {"family": family, "args": _both_args(kw), "num_classes": NC, "img": IMG,
           "vit": SMALL, "state_dict": state_dict0, "images": images, "labels": labels,
           "draws": draws, "lr_sched": np.linspace(jargs.lr, jargs.lr / 2, steps),
           "wd_sched": np.linspace(jargs.weight_decay, jargs.weight_decay / 2, steps)}
    return {"jax": {"metrics": jm, "params": _flat_of(jstate.params),
                    "ema": _flat_of(jstate.ema_params),
                    "stats": _flat_of(jstate.batch_stats) if stats else {}},
            "port1": {"metrics": pm, "state": pstate, "carry": carry},
            "flat0": flat, "job": job}


def _both_args(kw):
    from test_torch_train_step import _configs

    return _configs(**kw)[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every reference in the parent, then one run of two workers holding
    every job; returns (references, [rank 0's results, rank 1's], outputs,
    seconds of the workers' run)."""
    import jax.experimental.pallas as pl

    torch.set_num_threads(1)
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call
        mp.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
        for name in (*CASES, *PORT_ONLY):
            refs[name] = _reference(name)
    # the sharded eval: 23 samples at local batch 4, the ViT case's weights
    rng = np.random.default_rng(5)
    ev = {"vit": SMALL, "img": IMG, "num_classes": NC, "eval_bs": 4,
          "state_dict": refs["vit_flash_attn_mixup"]["job"]["state_dict"],
          "images": rng.integers(0, 256, (23, IMG, IMG, 3), dtype=np.uint8),
          "labels": rng.integers(0, NC, 23).astype(np.int64)}
    out_dir = str(tmp_path_factory.mktemp("dist"))
    open(os.path.join(out_dir, "resume.pth"), "wb").close()  # what rank 0 resumes from
    job = {"jobs": ["collectives", "steps", "eval"], "eval": ev,
           "cases": {name: r["job"] for name, r in refs.items()}}
    t0 = time.perf_counter()
    got = torch_dist_worker.launch(job, out_dir)
    seconds = time.perf_counter() - t0
    print(f"two gloo workers: {seconds:.1f} s")
    return refs, [g[0] for g in got], [g[1] for g in got], ev, seconds


def _updates(params, flat0):
    return {k: np.asarray(params[k]) - flat0[k] for k in flat0}


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_jax_step_on_the_global_batch(runs, case):
    refs, ranks, _, _, _ = runs
    ref, flat0 = refs[case], refs[case]["flat0"]
    carry = ref["port1"]["carry"]
    for rank, res in enumerate(ranks):
        got = res["steps"][case]
        for s, (pm, jm) in enumerate(zip(got["metrics"], ref["jax"]["metrics"])):
            np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5, err_msg=f"loss {s}")
            np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=1e-4)
            assert float(pm["skipped"]) == float(jm["skipped"]) == 0.0
            for k in ("class_acc", "tp", "fp", "fn"):
                np.testing.assert_array_equal(pm[k], np.asarray(jm[k]), err_msg=f"{k} {s}")
        want = _updates(ref["jax"]["params"], flat0)
        scale = max(np.abs(v).max() for v in want.values())
        assert scale > 1e-4  # the steps moved the weights
        for part, src in (("params", got["params"]), ("ema", got["ema"])):
            have = _updates(carry.to_jax(src), flat0)
            ref_part = want if part == "params" else _updates(ref["jax"]["ema"], flat0)
            for k in flat0:
                np.testing.assert_allclose(have[k], ref_part[k], atol=1e-4 * scale, rtol=0,
                                           err_msg=f"rank {rank} {part} {k}")
        if ref["jax"]["stats"]:  # BatchNorm over the global batch
            stats = carry.to_jax(got["buffers"])
            assert set(stats) == set(ref["jax"]["stats"])
            for k, v in ref["jax"]["stats"].items():
                np.testing.assert_allclose(stats[k], v, atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_one_rank_on_the_global_batch(runs, case):
    # the same function at a world of one on the concatenated batch: only the
    # order of the sums differs (the gradient mean, the BatchNorm sums); the
    # ranks hold one state, bitwise
    refs, ranks, _, _, _ = runs
    ref = refs[case]
    one = ref["port1"]
    r0, r1 = (r["steps"][case] for r in ranks)
    for part in ("params", "buffers", "ema", "ema_stats"):
        for k, v in r0[part].items():
            assert torch.equal(v, r1[part][k]), f"{part} {k} differs between the ranks"
    first_update = ref["job"]["args"].update_freq
    for s, (pm, m1) in enumerate(zip(r0["metrics"], one["metrics"])):
        np.testing.assert_allclose(pm["loss"], m1["loss"], rtol=1e-6 if s < first_update else 1e-5,
                                   err_msg=f"loss {s}")
        np.testing.assert_allclose(pm["grad_norm"], m1["grad_norm"], rtol=1e-5)
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(pm[k], m1[k], err_msg=f"{k} {s}")
    model = one["state"].model
    flat0 = ref["flat0"]
    base = one["carry"].to_jax(dict(model.named_parameters()))
    scale = max(np.abs(v).max() for v in base.values())
    have = one["carry"].to_jax(r0["params"])
    assert max(np.abs(base[k] - flat0[k]).max() for k in flat0) > 1e-3  # they moved
    for k in flat0:
        np.testing.assert_allclose(have[k], base[k], atol=1e-6 * scale, rtol=0, err_msg=k)
    for k, v in model.named_buffers():
        # the statistics of forwards after the first update: 1e-5, as the loss
        np.testing.assert_allclose(r0["buffers"][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_adahessian_two_ranks_equal_one_rank(runs):
    # the loss, the gradient (Adam's first moment, 0.1 g) and the Hutchinson
    # diagonal (the second moment, 0.001 (z Hz)^2 spatially averaged) of one
    # step: 1e-6 relative, 1e-5 of each tensor's largest for the first
    # moment and 1e-4 for the second (the square of a second backward's
    # result, whose small elements cancel: twice its relative rounding and
    # more; summation order only). The parameters are not held: adahessian's first update,
    # lr m / (sqrt(d) + eps), is lr / eps g where d is near 0, so the
    # rounding of a small d is a large share of its update in any order
    refs, ranks, _, _, _ = runs
    one = refs["resnet_adahessian"]["port1"]
    got = [r["steps"]["resnet_adahessian"] for r in ranks]
    for k, ts in got[0]["moments"].items():
        for a, b in zip(ts, got[1]["moments"][k]):
            assert torch.equal(a, b), k
    np.testing.assert_allclose(got[0]["metrics"][0]["loss"], one["metrics"][0]["loss"], rtol=1e-6)
    moments = one["state"].optimizer.moments
    assert set(moments) == {"exp_avg", "exp_avg_hessian"}
    for k, ts in moments.items():
        for i, (a, b) in enumerate(zip(got[0]["moments"][k], ts)):
            assert float(b.abs().max()) > 0 or k == "exp_avg", f"{k}[{i}]"
            tol = (1e-5 if k == "exp_avg" else 1e-4) * float(b.abs().max()) + 1e-12
            assert float((a - b).abs().max()) <= tol, f"{k}[{i}]"


def test_workers_join_by_torchrun_convention_and_gate_prints(runs):
    _, ranks, outs, _, seconds = runs
    assert [r["init"] for r in ranks] == [(True, 0, 2, 0), (True, 1, 2, 1)]
    assert "| distributed init (rank 0): tcp://127.0.0.1:" in outs[0]
    assert "RANK0 gated line" in outs[0] and "RANK1 gated line" not in outs[1]
    # force=True prints on every rank, after a timestamp
    forced = [ln for ln in outs[1].splitlines() if "RANK1 forced line" in ln]
    assert len(forced) == 1 and forced[0].startswith("[") and "] RANK1" in forced[0]
    assert seconds < 120


def test_any_process_and_metric_sync(runs):
    _, ranks, _, _, _ = runs
    for r in ranks:
        c = r["collectives"]
        assert c["any_one"] is True and c["any_none"] is False
        # [count, total] summed: 1.0 x 2 and 2.0 x 2; the loss meters 0 and 1
        assert c["sync"] == (4, 1.5, 2, 0.5)


def test_resume_broadcast_and_missing_checkpoint(runs):
    _, ranks, _, _, _ = runs
    paths = [r["collectives"]["resume"] for r in ranks]
    assert paths[0] == paths[1] and paths[0].endswith("resume.pth")
    for rank, r in enumerate(ranks):
        # rank 0 decides a file no rank can read: both raise
        assert r["collectives"]["missing"] and "cannot read" in r["collectives"]["missing"]
        assert f"process {rank}" in r["collectives"]["missing"]


def test_checkpoint_fingerprint_mismatch_raises(runs):
    _, ranks, _, _, _ = runs
    for r in ranks:
        assert "checkpoint content differs across processes" in r["collectives"]["fingerprint"]


def test_mesh_shape_of_the_world(runs):
    _, ranks, _, _, _ = runs
    for r in ranks:
        assert r["collectives"]["mesh"] == [[("data", 2)], [("data", 2)],
                                            [("data", 1), ("fsdp", 2)]]
        assert r["collectives"]["mesh_error"] == "mesh data:4 needs 4 devices, have 2"


def test_sharded_eval_counts_every_sample_once(runs):
    # 23 samples at local batch 4: 3 global batches of 8, the last two padded
    # rows on rank 1; every sample counted once, the stats those of one
    # process over all 23
    _, ranks, _, ev, _ = runs
    seen = ranks[0]["eval"]["seen"] + ranks[1]["eval"]["seen"]
    assert sorted(seen) == list(range(23))
    model = port_vit.ViT(**SMALL, img_size=IMG, flash_attn=True)
    model.load_state_dict(ev["state_dict"])
    batches = []
    for idx in eval_batches(23, 8):
        safe = np.maximum(idx, 0)
        batches.append({"image": torch.from_numpy(ev["images"][safe]),
                        "label": torch.from_numpy(np.where(idx >= 0, ev["labels"][safe], -1))})
    want = evaluate(build_eval_step(model, NC), batches, NC)
    for r in ranks:
        got = r["eval"]["stats"]
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


@pytest.mark.parametrize("env,argv,want", [
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.2",
      "MASTER_PORT": "29500"}, [], (1, 4, 1, "tcp://10.0.0.2:29500")),
    ({"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_LOCALID": "3"},
     ["--dist_url", "tcp://node7:23456"], (3, 8, 3, "tcp://node7:23456")),
    ({"OMPI_COMM_WORLD_RANK": "2", "OMPI_COMM_WORLD_SIZE": "4",
      "OMPI_COMM_WORLD_LOCAL_RANK": "0"}, ["--dist_on_itp", "true"],
     (2, 4, 0, "tcp://127.0.0.1:12355")),
    ({"RANK": "0", "WORLD_SIZE": "1"}, [], None),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}, [], None),
    ({}, ["--dist_on_itp", "true"], None),
])
def test_init_conventions(monkeypatch, capsys, env, argv, want):
    # the JAX package's three launcher conventions; a world of one makes no
    # group ("Not using distributed mode")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                 "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(pdist.dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(pdist, "setup_for_distributed", lambda is_master: None)
    args = config.parse_args(["--device", "cpu", *argv])
    config.check_ported(args)  # no launcher convention raises any more
    pdist.init_distributed_mode(args)
    if want is None:
        assert not calls and not args.distributed and (args.rank, args.world_size) == (0, 1)
        assert "Not using distributed mode" in capsys.readouterr().out
        return
    rank, world, local, method = want
    assert calls == [(("gloo",), dict(init_method=method, world_size=world, rank=rank))]
    assert args.distributed and (args.rank, args.world_size, args.local_rank) == (rank, world,
                                                                                  local)


def test_world_of_one_helpers_are_the_identity():
    t = torch.arange(6.0).reshape(3, 2)
    assert pmesh.all_gather_rows(t) is t
    assert pmesh.mean_across([t])[0] is t and pmesh.sum_across([t])[0] is t
    assert pmesh.sum_across_grad(t) is t
    assert pmesh.rows_of(8) == slice(0, 8) and pmesh.rows_of(8, 1, 2) == slice(4, 8)
    assert pdist.any_process(True) and not pdist.any_process(False)
    assert (pdist.get_rank(), pdist.get_world_size(), pdist.is_main_process()) == (0, 1, True)
    assert pdist.save_on_master(lambda x: x + 1, 1) == 2


def test_mesh_shape_other_than_the_world_raises(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for name in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    assert pmesh.check_mesh("data:1", 1) == [("data", 1)]
    for shape in ("data:4", "data:2,fsdp:2"):
        args = config.parse_args(["--mesh_shape", shape, "--device", "cpu"])
        config.check_ported(args)
        with pytest.raises(ValueError, match=f"mesh {shape} needs"):
            train.main(args)


def test_fsdp_raises_naming_a9b():
    args = config.parse_args(["--fsdp", "true"])
    with pytest.raises(NotImplementedError, match=r"A9b \(--fsdp\)"):
        config.check_ported(args)
    with pytest.raises(NotImplementedError, match=r"A9b \(--fsdp\)"):
        train.main(args)


def test_draw_rows_split_the_global_draws():
    # a rank's rows of the global batch's pixel draws: the policy draws hold
    # the batch on their last axis, the others on their first
    from imageclassification_tpu_torch.data.augment import AugmentPipeline, draw_rows

    for aa in ("", "rand-m9-mstd0.5-inc1", "original", "abel"):
        args = config.TrainConfig(aa=aa, reprob=0.5, color_jitter=0.3, recount=2)
        pipe = AugmentPipeline(args)
        draws = pipe.sample(8, 16, 16, torch.Generator().manual_seed(0))
        halves = [draw_rows(draws, pmesh.rows_of(8, r, 2)) for r in range(2)]
        images = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (8, 16, 16, 3), dtype=np.uint8))
        whole = pipe(images, draws)
        parts = torch.cat([pipe(images[pmesh.rows_of(8, r, 2)], halves[r]) for r in range(2)])
        assert torch.equal(whole, parts), aa


def test_train_main_two_processes(tmp_path, toy_dataset):
    # `python -m imageclassification_tpu_torch.train` under torchrun's
    # environment: two ranks train one epoch; rank 0 alone writes log.txt,
    # TensorBoard and the checkpoints, and the ranks end on one state
    out = tmp_path / "train_cls" / "output"
    t0 = time.perf_counter()
    outs = torch_dist_worker.spawn(
        ["-m", "imageclassification_tpu_torch.train", "--data_path", toy_dataset,
         "--model", "vit_tiny_patch16", "--input_size", "32", "--flash_attn", "true",
         "--batch_size", "4", "--epochs", "1", "--warmup_epochs", "0", "--device", "cpu",
         "--num_workers", "0", "--pretrained", "false", "--half_precision", "false",
         "--output_dir", str(out), "--log_dir", str(tmp_path / "train_cls" / "log_dir")],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(f"train.main at a world of two: {time.perf_counter() - t0:.1f} s")
    assert "| distributed init (rank 0)" in outs[0]
    assert "Batch size = 8" in outs[0] and "Number of training steps per epoch = 3" in outs[0]
    assert "Batch size" not in outs[1]  # rank 1's prints are gated
    assert (out / "checkpoint-0.pth").exists()
    lines = (tmp_path / "train_cls" / "log.txt").read_text().splitlines()
    assert len(lines) == 1  # one rank wrote it


def test_chip_smoke_phase_16_rehearsed_on_the_cpu(monkeypatch, tmp_path):
    # chip_smoke.py's phase 16 at a small size on the CPU (its workers read
    # the configs from their job files): 16a's world of one through the
    # launcher bitwise a plain launch, 16b/16c's two gloo ranks bitwise equal
    # and held against one process on the global batch
    import chip_smoke

    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' threads, beside other tests
    monkeypatch.setitem(chip_smoke.DP_LAUNCH, "model", "vit_tiny_patch16")
    for cfg, small in ((chip_smoke.DP_LAUNCH, dict(img=32, batch=8, per_class=6)),
                       (chip_smoke.DP_VIT, dict(model="vit_tiny_patch16", img=32, local_batch=4)),
                       (chip_smoke.DP_RESNET, dict(model="resnet18", img=32, local_batch=4))):
        for k, v in dict(small, device="cpu").items():
            monkeypatch.setitem(cfg, k, v)
    t0 = time.perf_counter()
    res = chip_smoke.dp_phase(str(tmp_path))
    print(f"phase 16 rehearsed: {time.perf_counter() - t0:.1f} s")
    assert res["16a"]["steps"] == 3
    for name in ("16b", "16c"):
        assert res[name]["loss_max_rel_err"] <= chip_smoke.DP_LOSS_RTOL
        assert res[name]["update_rel_l2"] <= chip_smoke.DP_UPDATE_RTOL
    assert "stats_max_abs_err" in res["16c"] and "stats_max_abs_err" not in res["16b"]

