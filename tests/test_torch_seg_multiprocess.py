"""The port's segmentation over two processes (gloo on the CPU), as
tests/test_seg_multiprocess.py runs the JAX package's, through
tests/torch_dist_worker.py (two ranks that import no JAX):

* `sharded_whole_eval` (rank-strided shards, all-ignore pad batches, each
  step's counts summed over the ranks, float64 on the host) over 5 val pairs
  at global batch 4, so that rank 0 pads its last batch and rank 1 runs out
  and feeds an all-ignore batch: the global confusion matrix equals the
  port's one-process matrix and the JAX package's `sharded_whole_eval` on
  one process, exactly, on every rank;
* one UPerNet train iteration (`build_seg_train_step`: the loss over the
  global batch's valid pixels, BatchNorm over the global batch, AdamW) at a
  narrow width (ConvNeXt depths 1, dims 16-128, channels 32, 64² crop,
  global batch 4, fp32, drop path and dropout 0) at a world of two against
  the port's world of one on the same global batch: the loss 1e-6 relative,
  AdamW's first moments (0.1 of the gradient) 1e-5 of each tensor's largest
  plus 1e-8 (a vanishing gradient's rounding noise),
  the parameters within 2 lr of each other (AdamW's first update is lr
  times the sign of the gradient wherever |g| >> eps, and follows g's
  rounding where |g| is near eps) and all but 0.1 % within 1e-6 relative,
  the BatchNorm statistics 1e-6 relative; the ranks bitwise equal."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import torch_dist_worker
from imageclassification_tpu.downstream import seg_engine as jax_engine
from imageclassification_tpu.downstream.seg_data import scan_pairs as jax_scan_pairs
from imageclassification_tpu.engine.state import TrainState as JaxTrainState
from imageclassification_tpu.parallel.mesh import make_mesh
from imageclassification_tpu_torch.downstream import seg_engine as port_engine
from imageclassification_tpu_torch.downstream.seg_data import scan_pairs
from test_seg_multiprocess import _make_seg_folder

NC, CROP, BATCH = 3, 32, 4
STEP = dict(num_classes=5, crop=64, batch=4, lr=1e-3, wd=0.05)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JaxTinyHead(fnn.Module):
    """The worker's tiny (main, aux) model in flax: a 3x3 conv, ReLU, a 1x1
    classifier."""

    @fnn.compact
    def __call__(self, x, train=False):
        h = fnn.relu(fnn.Conv(8, (3, 3), padding="SAME")(x))
        return fnn.Conv(NC, (1, 1))(h), None


def _tiny_weights():
    model = torch_dist_worker.tiny_seg_model(NC)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    return model


def _jax_params(model):
    def conv(c):
        return {"kernel": jnp.asarray(c.weight.detach().numpy().transpose(2, 3, 1, 0)),
                "bias": jnp.asarray(c.bias.detach().numpy())}

    return {"Conv_0": conv(model.conv), "Conv_1": conv(model.cls)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("seg")
    _make_seg_folder(str(root / "ds"), n_train=2, n_val=5)
    tiny = _tiny_weights()
    step_model = torch_dist_worker.narrow_upernet(STEP["num_classes"])
    rng = np.random.default_rng(7)
    labels = rng.integers(0, STEP["num_classes"], (STEP["batch"], STEP["crop"], STEP["crop"]))
    labels[:, :5] = 255  # an ignored stripe
    labels[0, :40] = 255  # more of it on rank 0: the ranks' valid counts differ
    job = {"jobs": ["seg_eval", "seg_step"],
           "seg_eval": {"num_classes": NC, "crop": CROP, "batch": BATCH,
                        "seg_dir": str(root / "ds"), "state_dict": tiny.state_dict()},
           "seg_step": {**STEP, "state_dict": step_model.state_dict(),
                        "images": rng.integers(0, 256, (STEP["batch"], STEP["crop"],
                                                        STEP["crop"], 3), dtype=np.uint8),
                        "labels": labels.astype(np.int32)}}
    t0 = time.perf_counter()
    got = torch_dist_worker.launch(job, str(root / "out"))
    seconds = time.perf_counter() - t0
    print(f"two gloo workers: {seconds:.1f} s")
    return job, tiny, [g[0] for g in got], seconds


def test_two_process_seg_eval_matches_one_process_and_jax(runs):
    job, tiny, ranks, seconds = runs
    se = job["seg_eval"]
    pairs = scan_pairs(se["seg_dir"], "validation")
    assert len(pairs) == 5
    one = port_engine.sharded_whole_eval(port_engine.build_seg_eval_step(tiny, NC), pairs, CROP,
                                         BATCH, NC, torch.device("cpu"))
    # the JAX package's function on one process, one device
    jm = _JaxTinyHead()
    state = JaxTrainState(step=jnp.zeros([], jnp.int32), params=_jax_params(tiny),
                          batch_stats={}, opt_state=())
    mesh = make_mesh("data:1", devices=jax.devices()[:1])
    want = jax_engine.sharded_whole_eval(jax.jit(jax_engine.build_seg_eval_step(jm, NC)), state,
                                         jax_scan_pairs(se["seg_dir"], "validation"), CROP,
                                         BATCH, NC, mesh)
    assert want.sum() > 0
    np.testing.assert_array_equal(one, want)
    for r in ranks:
        np.testing.assert_array_equal(r["seg_eval"], one)
    assert seconds < 120


def test_upernet_iteration_two_ranks_equal_one_rank(runs):
    job, _, ranks, _ = runs
    r0, r1 = (r["seg_step"] for r in ranks)
    for k, v in r0["state_dict"].items():
        assert torch.equal(v, r1["state_dict"][k]), k
    assert r0["loss"] == r1["loss"]
    one = torch_dist_worker.seg_step(job)  # this process: a world of one
    assert r0["loss"] == pytest.approx(one["loss"], rel=1e-6)
    assert set(one["moments"]) == {"exp_avg", "exp_avg_sq"}
    for k, ts in one["moments"].items():
        if k != "exp_avg":  # 0.1 of the gradient
            continue
        for i, (a, b) in enumerate(zip(r0["moments"][k], ts)):
            # + 1e-8: a gradient that vanishes (the backbone's stage-0 and
            # stage-1 out-norm biases feed a 1x1 conv whose train-mode
            # BatchNorm removes any per-channel shift) is rounding noise of
            # ~1e-10 in either world
            tol = 1e-5 * float(b.abs().max()) + 1e-8
            assert float((a - b).abs().max()) <= tol, f"{k}[{i}]"
    lr, off, total = STEP["lr"], 0, 0
    for k, v in one["state_dict"].items():
        a = r0["state_dict"][k]
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(a.numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
            continue
        err = (a - v).abs()
        assert float(err.max()) <= 2 * lr, k
        off += int((err > 1e-6 * v.abs().clamp(min=1e-3)).sum())
        total += err.numel()
    assert off <= 1e-3 * total, (off, total)
