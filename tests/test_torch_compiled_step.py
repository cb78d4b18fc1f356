"""The compiled step (imageclassification_tpu_torch/engine/compiled.py) and
the device-side pieces it needs: the mixup draws packed into one vector, the
metrics copied off the device, the optimizer, EMA and BatchNorm gates, the
NaN checks of --check_nans. The CPU tests need no JAX; the train step's
agreement with the JAX step under the gate is in test_torch_train_step.py.

The `cuda` tests need a card: captured ViT-B/16 --flash_attn steps against
eager steps from the same state and generators, a non-finite step inside a
replay sequence, the eager step under torch's sync debug mode, and fresh
random draws at each replay. JAX is not imported, so they run where it is
absent:

    python -m pytest --noconftest tests/test_torch_compiled_step.py -m cuda
"""

import math

import numpy as np
import pytest
import torch

from imageclassification_tpu_torch.config import TrainConfig
from imageclassification_tpu_torch.data import augment as port_augment
from imageclassification_tpu_torch.data.mixup import (MixupConfig, build_mixup, pack_draws,
                                                      sample_mixup, unpack_draws)
from imageclassification_tpu_torch.engine import compiled
from imageclassification_tpu_torch.engine import step as port_step
from imageclassification_tpu_torch.engine.state import create_train_state
from imageclassification_tpu_torch.engine.step import (TRAIN_SCALARS, StepMetrics,
                                                       build_train_step)
from imageclassification_tpu_torch.models import create_model
from imageclassification_tpu_torch.models import vit as port_vit
from imageclassification_tpu_torch.models.layers import BatchNorm, commit_batch_stats
from imageclassification_tpu_torch.optim.ema import ema_update, init_ema
from imageclassification_tpu_torch.optim.factory import create_optimizer

TINY = dict(patch_size=16, dim=128, depth=2, num_heads=2, num_classes=5, img_size=32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the captured step runs only on a card)")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["batch", "pair", "elem"])
@pytest.mark.parametrize("minmax", [None, (0.2, 0.8)])
def test_packed_draws_unpack_to_the_draws(mode, minmax):
    # one float64 vector carries every draw exactly: the float32 lam, the
    # bool choice and the integer box
    cfg = MixupConfig(mixup_alpha=0.8, cutmix_alpha=1.0, cutmix_minmax=minmax, mode=mode,
                      num_classes=5)
    draws = sample_mixup(cfg, 6, 12, 10, torch.Generator().manual_seed(3))
    got = unpack_draws(cfg, torch.from_numpy(pack_draws(cfg, draws)), 6)
    assert set(got) == set(draws)
    for k, v in draws.items():
        want = v.to(torch.bool) if k == "use_cutmix" else v
        assert got[k].dtype == (torch.float32 if k == "lam" else want.dtype), k
        assert torch.equal(got[k], want.to(got[k].dtype)), k


def test_step_metrics_read_the_packed_vector():
    flat = torch.arange(len(TRAIN_SCALARS) + 3 * 4, dtype=torch.float32)
    m = StepMetrics(flat, TRAIN_SCALARS, 4)
    flat.zero_()  # a copy: the step's buffer may be overwritten
    assert len(m) == len(dict(m)) == len(TRAIN_SCALARS) + 3
    assert float(m["loss"]) == 0.0 and float(m["skipped"]) == len(TRAIN_SCALARS) - 1
    n = len(TRAIN_SCALARS)
    assert m["fn"].tolist() == [float(n + 8 + i) for i in range(4)]


def _params(seed, shapes=((3, 4), (5,))):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(s, generator=g)) for s in shapes]


@pytest.mark.parametrize("opt", ["adamw", "sgd", "momentum"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_skipped_update_keeps_the_optimizer_state_bitwise(opt, clip):
    # keep = False: parameters (one of them infinite), moments and count
    # exactly as before, whatever the gradients hold; keep = True updates
    params = _params(0)
    popt = create_optimizer(opt, params, lr=0.1, weight_decay=0.05, clip_grad=clip)
    for _ in range(2):
        popt.step([torch.randn_like(p) for p in params])
    with torch.no_grad():
        params[1][0] = float("inf")
    before = ([p.detach().clone() for p in params],
              {k: [t.clone() for t in ts] for k, ts in popt.moments.items()})
    popt.set_hyperparams(0.2, 0.1)
    popt.step([torch.full_like(p, float("nan")) for p in params], keep=torch.tensor(False))
    for a, b in zip(before[0], params):
        assert torch.equal(a, b.detach())
    for k, ts in popt.moments.items():
        assert all(torch.equal(a, b) for a, b in zip(before[1][k], ts)), k
    assert popt.num_updates == 2
    popt.step([torch.ones_like(p) for p in params], keep=torch.tensor(True))
    assert popt.num_updates == 3 and not torch.equal(before[0][0], params[0].detach())


def test_skipped_ema_and_batch_norm_commit_keep_their_values():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), BatchNorm(4))
    ema = init_ema(model)
    with torch.no_grad():
        model[0].weight[0, 0] = float("inf")
    before = {k: v.clone() for k, v in ema.items()}
    ema_update(ema, model, torch.tensor(0.9), torch.tensor(False))
    assert all(torch.equal(before[k], ema[k]) for k in ema)
    ema_update(ema, model, 0.9, torch.tensor(True))
    assert torch.isinf(ema["0.weight"][0, 0])

    bn = model[1].train()
    bn(torch.full((2, 1, 1, 4), float("nan")))
    running = (bn.running_mean.clone(), bn.running_var.clone())
    commit_batch_stats(model, torch.tensor(False))
    assert torch.equal(bn.running_mean, running[0]) and torch.equal(bn.running_var, running[1])
    assert bn.batch_stats is None
    bn(torch.randn(2, 1, 1, 4, generator=torch.Generator().manual_seed(0)))
    commit_batch_stats(model, torch.tensor(True))
    assert not torch.equal(bn.running_mean, running[0])


def _tiny_state(device, seed=0, **model_kw):
    model = port_vit.ViT(**{**TINY, **model_kw}, generator=torch.Generator().manual_seed(seed))
    model = model.to(device)
    opt = create_optimizer("adamw", model.parameters(), lr=0.01, weight_decay=0.05)
    return create_train_state(model, opt, use_ema=True)


def _tiny_step(state, device, **kw):
    args = TrainConfig(model="vit_tiny_patch16", flash_attn=True, model_ema=True,
                       device=device.type, **kw)
    return build_train_step(state.model, args, 5, build_mixup(args, 5), [0.01] * 16,
                            [0.05] * 16, ema_decay=0.9, seed=7)


def _batch(device, n=4, size=32, seed=1):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.integers(0, 256, (n, size, size, 3),
                                                   dtype=np.uint8)).to(device),
            "label": torch.from_numpy(rng.integers(0, 5, n)).to(device)}


def test_nan_checks_name_the_first_module_with_a_nan():
    device = torch.device("cpu")
    state = _tiny_state(device)
    step = compiled.nan_checked(_tiny_step(state, device), state.model)
    with torch.no_grad():
        state.model.blocks[1].attn.qkv.weight[0, 0] = float("nan")
    # qkv is applied through models/layers.py::linear, which runs its hooks
    with pytest.raises(FloatingPointError, match=r"blocks\.1\.attn\.qkv \(Linear\)"):
        step(state, _batch(device))
    assert not any(m._forward_hooks for m in state.model.modules())  # hooks removed


def test_nan_checks_raise_on_a_nan_loss():
    # logits inf - inf: no module's output holds a NaN, the loss does
    device = torch.device("cpu")
    state = _tiny_state(device)
    step = compiled.nan_checked(_tiny_step(state, device), state.model)
    step(state, _batch(device))  # a finite step passes
    with torch.no_grad():
        state.model.head.bias[0] = float("inf")
    with pytest.raises(FloatingPointError, match="nan|NaN"):
        step(state, _batch(device))


# ---- on the card ----------------------------------------------------------

def _snapshot(state):
    opt = state.optimizer
    return {**{f"p.{k}": v.detach().clone() for k, v in state.model.state_dict().items()},
            **{f"ema.{k}": v.clone() for k, v in state.ema.items()},
            **{f"{k}.{i}": t.clone() for k, ts in opt.moments.items() for i, t in enumerate(ts)},
            "count": opt.count.clone()}


def _max_diff(a, b):
    return max((x.double() - b[k].double()).abs().max().item() for k, x in a.items())


def _vit_b16(device, remat=False, **model_kw):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = create_model("vit_base_patch16", num_classes=5, half_precision=True, img_size=224,
                         flash_attn=True, generator=torch.Generator().manual_seed(0),
                         **model_kw).to(device)
    opt = create_optimizer("adamw", model.parameters(), lr=1e-3, weight_decay=0.05)
    state = create_train_state(model, opt, use_ema=True)
    args = TrainConfig(model="vit_base_patch16", flash_attn=True, model_ema=True,
                       model_ema_warmup=True, remat=remat, device="cuda")
    step = build_train_step(model, args, 5, build_mixup(args, 5), np.linspace(1e-3, 1e-4, 8),
                            np.linspace(0.05, 0.01, 8), ema_decay=0.999, seed=3)
    return state, step


@pytest.mark.cuda
@pytest.mark.parametrize("model_kw", [
    {"drop_path_rate": 0.1},                     # the flash kernels, stochastic depth
    {"drop_path_rate": 0.1, "drop_rate": 0.1},   # dropout too: the plain attention path
    # --remat: the recompute redraws the masks from a generator of its own
    {"drop_path_rate": 0.1, "drop_rate": 0.1, "remat": True},
], ids=["drop_path", "drop_path_and_dropout", "drop_path_and_dropout_remat"])
def test_captured_vit_b16_steps_equal_eager_steps_on_card(cuda_device, model_kw):
    # 6 steps at full width (mixup, colour jitter, random erasing, EMA with
    # warmup), eager twice and captured once from the same state and
    # generators: where the two eager runs are bitwise equal, the captured
    # run is too; otherwise it is within what two eager runs differ by
    batches = [_batch(cuda_device, n=64, size=224, seed=s) for s in range(6)]
    runs, losses = [], []
    for captured in (False, False, True):
        state, step = _vit_b16(cuda_device, **model_kw)
        if captured:
            step = compiled.CapturedTrainStep(step, cuda_device)
        metrics = [step(state, b) for b in batches]
        losses.append([float(m["loss"]) for m in metrics])
        runs.append(_snapshot(state))
        del state, step
    assert all(math.isfinite(x) for x in losses[2])
    eager_gap = _max_diff(runs[0], runs[1])
    captured_gap = _max_diff(runs[0], runs[2])
    if eager_gap == 0.0:
        assert captured_gap == 0.0 and losses[2] == losses[0]
    else:
        assert captured_gap <= eager_gap, (captured_gap, eager_gap)


@pytest.mark.cuda
def test_non_finite_step_inside_replays_leaves_the_state_on_card(cuda_device):
    state = _tiny_state(cuda_device)
    step = compiled.CapturedTrainStep(_tiny_step(state, cuda_device), cuda_device)
    batch = _batch(cuda_device)
    for _ in range(compiled.TRAIN_WARMUP_STEPS + 2):  # the capture and a replay
        assert float(step(state, batch)["skipped"]) == 0.0
    bias = state.model.head.bias.detach()
    keep = bias[0].item()
    bias[0] = float("inf")  # in place: the graph reads the parameter's memory
    before = _snapshot(state)
    m = step(state, batch)
    assert float(m["skipped"]) == 1.0 and float(m["grad_norm"]) == 0.0
    after = _snapshot(state)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    bias[0] = keep
    m = step(state, batch)
    assert float(m["skipped"]) == 0.0 and state.optimizer.num_updates == before["count"] + 1


@pytest.mark.cuda
def test_eager_step_makes_no_host_synchronisation_on_card(cuda_device):
    state = _tiny_state(cuda_device, drop_path_rate=0.1)
    step = _tiny_step(state, cuda_device)
    batch = _batch(cuda_device)
    step(state, batch)  # first call: the kernels' libraries, cached constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = [step(state, batch) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(math.isfinite(float(m["loss"])) for m in metrics)


@pytest.mark.cuda
def test_replays_draw_afresh_at_each_step_on_card(cuda_device, monkeypatch):
    # references to the draws made inside the graph: after each replay they
    # hold that replay's draws, which differ from step to step and are the
    # draws of the eager step from identically seeded generators
    seen = {"aug": [], "mix": []}
    sample, mixup_cutmix = port_augment.AugmentPipeline.sample, port_step.mixup_cutmix

    def recording_sample(self, *a, **kw):
        seen["aug"].append(sample(self, *a, **kw))
        return seen["aug"][-1]

    def recording_mixup(images, labels, draws, cfg):
        seen["mix"].append(draws)
        return mixup_cutmix(images, labels, draws, cfg)

    monkeypatch.setattr(port_augment.AugmentPipeline, "sample", recording_sample)
    monkeypatch.setattr(port_step, "mixup_cutmix", recording_mixup)
    runs = {}
    for captured in (False, True):
        seen["aug"].clear()
        seen["mix"].clear()
        state = _tiny_state(cuda_device)
        step = _tiny_step(state, cuda_device)
        if captured:
            step = compiled.CapturedTrainStep(step, cuda_device)
        draws = []
        for _ in range(compiled.TRAIN_WARMUP_STEPS + 3):
            step(state, _batch(cuda_device))
            torch.cuda.synchronize()
            aug, mix = seen["aug"][-1], seen["mix"][-1]
            draws.append((aug["flip_h"].clone(), aug["erase"]["area"].clone(),
                          aug["jitter"][0].clone(), mix["lam"].clone(), mix["cy"].clone()))
        runs[captured] = draws
    replays = runs[True][compiled.TRAIN_WARMUP_STEPS:]
    assert len(seen["aug"]) == compiled.TRAIN_WARMUP_STEPS + 1  # the replays sample no more
    for a, b in zip(replays, replays[1:]):
        assert not torch.equal(a[1], b[1]) and not torch.equal(a[3], b[3])
    for got, want in zip(runs[True], runs[False]):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
