"""Port EfficientViT (imageclassification_tpu_torch/models/efficientvit.py)
and its weight carry (checkpoint/from_jax.py, to_jax.py) against the JAX
package's EfficientViT, `build_train_step`, checkpoints and val.py, on the
same numpy-drawn weights, batch statistics, inputs and draws: EfficientViT-M0
at full width, at 224x224 (no stage pads its windows: 14, 7 and 4) and at
160x160 (stage 0's 10x10 map padded to 14x14 for its 7x7 windows, whose
padded positions enter the qkv BatchNorm's batch statistics), fp32; and the
CLI's default model through train.main on the CPU."""

import pickle
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import jax_draws
from imageclassification_tpu import config as jax_config
from imageclassification_tpu.checkpoint import io as jax_io
from imageclassification_tpu.data.mixup import build_mixup as jax_build_mixup
from imageclassification_tpu.engine.state import create_train_state as jax_create_state
from imageclassification_tpu.engine.step import build_train_step as jax_build_train_step
from imageclassification_tpu.models import efficientvit as jax_efficientvit
from imageclassification_tpu.optim.factory import create_optimizer as jax_create_optimizer
from imageclassification_tpu_torch import config, train
from imageclassification_tpu_torch import val as port_val
from imageclassification_tpu_torch.checkpoint import io as port_io
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for
from imageclassification_tpu_torch.data.mixup import build_mixup
from imageclassification_tpu_torch.engine.state import create_train_state
from imageclassification_tpu_torch.engine.step import build_train_step
from imageclassification_tpu_torch.models import create_model
from imageclassification_tpu_torch.models import efficientvit as port_efficientvit
from imageclassification_tpu_torch.models.layers import (BatchNorm, batch_norm_stats,
                                                         commit_batch_stats)
from imageclassification_tpu_torch.optim.factory import create_optimizer

NUM_CLASSES = 5


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flatten(tree):
    return {"/".join(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def nest(flat):
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


# the BatchNorms that end a residual branch (zero-initialised where JAX sets
# bn_weight_init=0)
_BRANCH_END = r"(^|/)(sub\d_)?(dw[01]|ffn[01]/ConvBN_1|mixer/attn/proj)/BatchNorm_0/"


def jax_efficientvit_flat(model, img: int, seed: int):
    """(flat parameters, flat batch statistics) of a JAX EfficientViT at
    `img` x `img`, drawn with numpy: conv kernels of std sqrt(1 / fan_in)
    with each output channel's kernel centred on zero (small BatchNorm input
    means: flax takes the variance as E[x^2] - E[x]^2 in fp32), conv biases
    N(0, 0.1), BatchNorm scales 1 + N(0, 0.2) (N(0, 0.2) where one ends a
    residual branch, so the activations stay of magnitude ~1 through the
    stages) and biases N(0, 0.2), attention
    biases N(0, 0.5), a head N(0, 0.05); running means N(0, 0.2) and
    variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, img, img, 3)))
    params = {}
    for k, s in _flatten(shapes["params"]).items():
        if k.endswith("kernel") and len(s.shape) == 4:
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            v -= v.mean(axis=(0, 1, 2), keepdims=True)
        elif k.endswith("attention_biases"):
            v = 0.5 * rng.standard_normal(s.shape)
        elif k.endswith("scale") and re.search(_BRANCH_END, k):
            v = 0.2 * rng.standard_normal(s.shape)
        else:
            std = 0.05 if k.startswith("head/") else (0.1 if "SqueezeExcite" in k else 0.2)
            v = std * rng.standard_normal(s.shape) + (1.0 if k.endswith("scale") else 0.0)
        params[k] = v.astype(np.float32)
    stats = {k: (rng.uniform(0.5, 1.5, s.shape) if k.endswith("var")
                 else 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
             for k, s in _flatten(shapes["batch_stats"]).items()}
    return params, stats


# a narrow EfficientViT for the train step: every module of M0 (two cascaded
# heads a stage, the subsample sandwiches, padded windows at 160x160) with
# about an eighth of M0's ReLU inputs. Two fp32 implementations put a ReLU
# input within their rounding (~1e-5 at M0's depth) of zero on opposite
# sides about once in 3e5 inputs, and such a gate gives its element's whole
# gradient to one side only; M0 at 160x160 and batch 4 has 1.06e6 ReLU inputs
NARROW = dict(embed_dims=(16, 32, 48), depths=(1, 1, 1), num_heads=(2, 2, 2))


def models(img: int, seed: int = 0, narrow: bool = False):
    """(JAX model, its flat parameters, its flat batch statistics, the port
    model carrying both) at `img` x `img`: EfficientViT-M0, or with `narrow`
    the NARROW EfficientViT."""
    if narrow:
        jmodel = jax_efficientvit.EfficientViT(**NARROW, num_classes=NUM_CLASSES, img_size=img)
        pmodel = port_efficientvit.EfficientViT(**NARROW, num_classes=NUM_CLASSES, img_size=img)
    else:
        jmodel = jax_efficientvit.efficientvit_m0(num_classes=NUM_CLASSES, img_size=img)
        pmodel = create_model("efficientvit_m0", num_classes=NUM_CLASSES, img_size=img)
    params, stats = jax_efficientvit_flat(jmodel, img, seed)
    sd, _, unused = carry_for(pmodel).to_port({**params, **stats})
    assert not unused
    assert set(sd) == set(pmodel.state_dict())
    pmodel.load_state_dict(sd)
    return jmodel, params, stats, pmodel


def _images(img: int, seed: int = 0, batch: int = 4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, img, img, 3)).astype(np.float32)


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("img", [224, 160])
def test_logits_match_jax(img, train_mode):
    # fp32, the same function: summation order, the conv algorithm and the
    # batch variance's formula differ; 1e-5 on logits of magnitude ~1
    jmodel, params, stats, pmodel = models(img)
    x = _images(img)
    variables = {"params": nest(params), "batch_stats": nest(stats)}
    if train_mode:
        want, _ = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jmodel.apply(variables, jnp.asarray(x), train=False)
    want = np.asarray(want)
    got = pmodel.train(train_mode)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (4, NUM_CLASSES) and got.dtype == np.float32
    assert np.abs(want).max() > 0.1  # the logits are not degenerate
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_padded_windows_enter_the_batch_statistics():
    # at 160x160 stage 0's 10x10 map is padded to 14x14: the committed
    # statistics match JAX's (1e-5), and the first qkv BatchNorm's batch
    # mean is the unpadded positions' mean times 100 / 196 (its bias-free
    # conv maps the zero padding to zero)
    jmodel, params, stats, pmodel = models(160, seed=1)
    x = _images(160, seed=1)
    _, mutated = jmodel.apply({"params": nest(params), "batch_stats": nest(stats)},
                              jnp.asarray(x), train=True, mutable=["batch_stats"])
    window_attn = pmodel.blocks1[0].mixer.m
    seen = {}

    def keep_input(module, inputs, output):
        seen["x"] = inputs[0].detach()

    hook = window_attn.register_forward_hook(keep_input)
    pmodel.train()(torch.from_numpy(x))
    hook.remove()
    qkv = window_attn.attn.qkvs[0]
    mean = qkv.bn.batch_stats[0]
    commit_batch_stats(pmodel)
    got = carry_for(pmodel).to_jax(batch_norm_stats(pmodel))
    want = _flatten(mutated["batch_stats"])
    assert set(got) == set(want) == set(stats)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    feat = seen["x"]
    assert feat.shape[1:3] == (10, 10)
    y = torch.nn.functional.conv2d(feat[..., :16].permute(0, 3, 1, 2), qkv.c.weight)
    unpadded = y.mean(dim=(0, 2, 3))
    torch.testing.assert_close(mean, unpadded * 100 / 196, atol=1e-6, rtol=1e-5)
    assert (mean - unpadded).abs().max() > 1e-3


@pytest.mark.parametrize("name", port_efficientvit.NAMES)
def test_every_variant_has_the_jax_tree(name):
    # all six constructors at 224x224: the carry gives the JAX model's
    # parameter and batch-statistics trees, and the JAX package's converter
    # reads the port's state_dict (Cream's naming) to the same keys
    from imageclassification_tpu.checkpoint import torch_convert

    pmodel = create_model(name, num_classes=NUM_CLASSES)
    jmodel = getattr(jax_efficientvit, name)(num_classes=NUM_CLASSES)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 224, 224, 3)))
    carry = carry_for(pmodel)
    for tree, tensors in (("params", dict(pmodel.named_parameters())),
                          ("batch_stats", batch_norm_stats(pmodel))):
        want = {k: tuple(v.shape) for k, v in _flatten(shapes[tree]).items()}
        assert {k: v.shape for k, v in carry.to_jax(tensors).items()} == want, tree
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    params, stats = torch_convert.convert_efficientvit(sd, name)
    assert set(params) == set(_flatten(shapes["params"]))
    assert set(stats) == set(_flatten(shapes["batch_stats"]))


def test_weight_carry_round_trips_exactly():
    _, params, stats, pmodel = models(160, seed=2)
    carry = carry_for(pmodel)
    back = carry.to_jax(dict(pmodel.named_parameters()))
    back_stats = carry.to_jax(batch_norm_stats(pmodel))
    assert set(back) == set(params) and set(back_stats) == set(stats)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k], err_msg=k)
    for k in stats:
        np.testing.assert_array_equal(back_stats[k], stats[k], err_msg=k)


def test_m0_parameter_count_and_init():
    # timm efficientvit_m0 at 1000 classes: 2,349,436 parameters; the JAX
    # initializers: zero head and attention biases, BatchNorm scale 0 where
    # JAX sets bn_weight_init=0, lecun_normal convs (std sqrt(1 / fan_in)
    # after flax's truncation)
    model = create_model("efficientvit_m0", num_classes=1000,
                         generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 2_349_436
    assert set(model.state_dict()) == {k for k in model.state_dict()
                                       if not k.endswith(("attention_bias_idxs",
                                                          "num_batches_tracked"))}
    assert torch.count_nonzero(model.head.l.weight) == 0
    assert torch.count_nonzero(model.head.l.bias) == 0
    blk = model.blocks2[3]
    for bn in (blk.dw0.m.bn, blk.dw1.m.bn, blk.ffn0.m.pw2.bn, blk.mixer.m.attn.proj[1].bn):
        assert torch.count_nonzero(bn.weight) == 0
    for bn in (blk.ffn0.m.pw1.bn, model.blocks2[0][0].m.bn, model.head.bn):
        assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert torch.count_nonzero(blk.mixer.m.attn.attention_biases) == 0
    for m in model.modules():
        if isinstance(m, BatchNorm):
            assert torch.count_nonzero(m.running_mean) == 0
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))
    w = model.blocks3[4].ffn0.m.pw1.c.weight
    std = (1.0 / w[0].numel()) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 * std / 0.87962566 * 1.0001


def test_bf16_model_keeps_an_fp32_head_and_fp32_statistics():
    model = create_model("efficientvit_m0", num_classes=NUM_CLASSES, half_precision=True,
                         img_size=64, drop_rate=0.5)
    g = torch.Generator().manual_seed(0)
    out = model.train()(torch.from_numpy(_images(64, batch=2)), generator=g)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    commit_batch_stats(model)
    assert {b.dtype for b in batch_norm_stats(model).values()} == {torch.float32}
    assert torch.isfinite(model.eval()(torch.from_numpy(_images(64, batch=2)))).all()
    with pytest.raises(ValueError, match="Generator"):  # the head's dropout draws
        model.train()(torch.from_numpy(_images(64, batch=2)))


def test_registry_builds_every_variant_with_the_cli_kwargs():
    from imageclassification_tpu_torch.models import list_models, model_kwargs_for

    assert set(port_efficientvit.NAMES) <= set(list_models())
    args = config.TrainConfig(drop_path=0.3, input_size=160)
    assert args.model == "efficientvit_m0"  # the CLI's default
    kw = model_kwargs_for(args, 7)
    assert kw == {"pretrained": args.pretrained, "num_classes": 7, "drop_rate": 0.3,
                  "img_size": 160}
    model = create_model(args.model, **kw)
    assert model.head.drop_rate == 0.3 and model.head.l.out_features == 7


# one train step of the NARROW EfficientViT at 160x160 in train mode (padded
# windows in the batch statistics), fp32, AdamW with a large eps (a small eps turns a near-zero
# gradient's rounding into a full-size update of either sign), mixup on,
# EMA, no dropout (JAX's and torch's masks cannot be made equal)
STEP_B = 4


def test_train_step_matches_jax():
    img = 160
    common = dict(model="efficientvit_m0", half_precision=False, model_ema=True,
                  model_ema_decay=0.9, lr=0.01, weight_decay=0.05, opt="adamw", opt_eps=1.0,
                  drop_path=0.0, reprob=0.5, color_jitter=0.3, input_size=img)
    jargs = jax_config.TrainConfig(**common)
    pargs = config.TrainConfig(**common, device="cpu")
    jmodel, flat, stats, pmodel = models(img, seed=3, narrow=True)
    lr_sched, wd_sched = np.full(2, jargs.lr), np.full(2, jargs.weight_decay)

    tx = jax_create_optimizer(jargs.opt, jargs.lr, jargs.weight_decay, opt_eps=jargs.opt_eps)
    jstate = jax_create_state(jmodel, tx, jax.random.key(0), (1, img, img, 3), use_ema=True)
    jstate = jstate.replace(params=nest(flat), ema_params=nest(flat), batch_stats=nest(stats),
                            ema_batch_stats=nest(stats), opt_state=tx.init(nest(flat)))
    jmix = jax_build_mixup(jargs, NUM_CLASSES)
    jstep = jax.jit(jax_build_train_step(jmodel, tx, jargs, NUM_CLASSES, jmix, lr_sched,
                                         wd_sched, ema_decay=jargs.model_ema_decay))
    popt = create_optimizer(pargs.opt, pmodel.parameters(), lr=pargs.lr,
                            weight_decay=pargs.weight_decay, opt_eps=pargs.opt_eps)
    pstate = create_train_state(pmodel, popt, use_ema=True)
    pstep = build_train_step(pmodel, pargs, NUM_CLASSES, build_mixup(pargs, NUM_CLASSES),
                             lr_sched, wd_sched, ema_decay=pargs.model_ema_decay)

    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (STEP_B, img, img, 3), dtype=np.uint8)
    labels = rng.integers(0, NUM_CLASSES, STEP_B)
    key = jax.random.key(42)
    jstate, jm = jstep(jstate, {"image": jnp.asarray(images),
                                "label": jnp.asarray(labels, jnp.int32)}, key)
    pm = pstep(pstate, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)},
               jax_draws.step_draws(key, 0, STEP_B, img, img, jargs, jmix))
    # the loss to 1e-5 relative, the gradient norm to 1e-4; the exact-mode
    # accuracy counts exactly
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert float(pm["skipped"]) == float(jm["skipped"]) == 0.0
    for k in ("class_acc", "tp", "fp", "fn"):
        np.testing.assert_array_equal(np.asarray(pm[k]), np.asarray(jm[k]), err_msg=k)

    # the updates of every parameter and of the EMA to 1e-4 of the largest
    # update; the running statistics and their EMA to 1e-5 (fp32 batch means
    # and biased variances of the same activations, values of magnitude ~1)
    carry = carry_for(pmodel)
    jflat, jema = _flatten(jstate.params), _flatten(jstate.ema_params)
    pflat, pema = carry.to_jax(dict(pmodel.named_parameters())), carry.to_jax(pstate.ema)
    scale = max(np.abs(np.asarray(jflat[k]) - flat[k]).max() for k in flat)
    assert scale > 1e-4
    for k in flat:
        np.testing.assert_allclose(pflat[k] - flat[k], np.asarray(jflat[k]) - flat[k],
                                   atol=1e-4 * scale, rtol=0, err_msg=k)
        np.testing.assert_allclose(pema[k] - flat[k], np.asarray(jema[k]) - flat[k],
                                   atol=1e-4 * scale, rtol=0, err_msg=f"ema {k}")
    jst, jema_st = _flatten(jstate.batch_stats), _flatten(jstate.ema_batch_stats)
    pst, pema_st = carry.to_jax(batch_norm_stats(pmodel)), carry.to_jax(pstate.ema_stats)
    assert set(pst) == set(jst) == set(pema_st) == set(jema_st) == set(stats)
    assert max(np.abs(np.asarray(jst[k]) - stats[k]).max() for k in stats) > 1e-2
    for k in stats:
        np.testing.assert_allclose(pst[k], np.asarray(jst[k]), atol=1e-5, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(pema_st[k], np.asarray(jema_st[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=f"ema {k}")


# checkpoints at 64x64: stage sizes 4, 2, 1, no window partition
CKPT_IMG = 64
CKPT_SPEC = {"name": "efficientvit_m0",
             "kwargs": {"num_classes": NUM_CLASSES, "drop_rate": 0.0, "img_size": CKPT_IMG}}


def test_jax_checkpoint_resumes_in_the_port(tmp_path, capsys):
    # JAX -> port: the JAX save_model's checkpoint resumes in the port's
    # auto_load_model with its parameters, statistics, both EMAs and the
    # optimizer, exactly
    jmodel, params, stats, _ = models(CKPT_IMG, seed=5)
    ema, ema_stats = jax_efficientvit_flat(jmodel, CKPT_IMG, 6)
    tx = jax_create_optimizer("adamw", 0.01, 0.05)
    jstate = jax_create_state(jmodel, tx, jax.random.key(0), (1, CKPT_IMG, CKPT_IMG, 3),
                              use_ema=True)
    jstate = jstate.replace(params=nest(params), batch_stats=nest(stats), ema_params=nest(ema),
                            ema_batch_stats=nest(ema_stats), opt_state=tx.init(nest(params)))
    jax_io.save_model(jax_config.TrainConfig(output_dir=str(tmp_path), model_ema=True),
                      [1, CKPT_IMG, CKPT_IMG, 3], 2, jstate, NUM_CLASSES, CKPT_SPEC)
    jax_io.wait_for_pending_saves()
    pmodel = create_model("efficientvit_m0", num_classes=NUM_CLASSES, img_size=CKPT_IMG)
    state = create_train_state(pmodel, create_optimizer("adamw", pmodel.parameters(), 0.01, 0.05),
                               use_ema=True)
    pargs = config.TrainConfig(output_dir=str(tmp_path), model_ema=True, device="cpu")
    state, _ = port_io.auto_load_model(pargs, state)
    assert "With optim & sched!" in capsys.readouterr().out and pargs.start_epoch == 3
    carry = carry_for(pmodel)
    for got, want in ((carry.to_jax(dict(pmodel.named_parameters())), params),
                      (carry.to_jax(batch_norm_stats(pmodel)), stats),
                      (carry.to_jax(state.ema), ema), (carry.to_jax(state.ema_stats), ema_stats)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_default_model_trains_on_cpu_and_jax_val_reads_it(toy_dataset, tmp_path,
                                                              monkeypatch, capsys):
    # train.main with no --model (efficientvit_m0, drop_path 0.05 as the head's
    # dropout, mixup, EMA) on the CPU: finite losses, a checkpoint in the
    # JAX layout with batch_stats and the EMA's, which the JAX val.py serves
    # to the port's probabilities (fp32, summation order: 1e-5) with the
    # model's statistics and the EMA's
    out_dir = tmp_path / "train_cls" / "output"
    args = config.parse_args([
        "--device", "cpu", "--data_path", toy_dataset, "--input_size", str(CKPT_IMG),
        "--batch_size", "4", "--epochs", "1", "--warmup_epochs", "1", "--num_workers", "2",
        "--model_ema", "true", "--model_ema_decay", "0.5",
        "--output_dir", str(out_dir), "--log_dir", str(tmp_path / "train_cls" / "log_dir")])
    assert args.model == "efficientvit_m0"
    state = train.main(args)
    out = capsys.readouterr().out
    assert "TRAINING FROM SCRATCH" in out and "Mixup is activated!" in out
    path = str(out_dir / "checkpoint-0.pth")
    with open(path, "rb") as f:
        ck = pickle.load(f)
    assert ck["model_spec"] == {"name": "efficientvit_m0",
                                "kwargs": {"num_classes": 3, "drop_rate": 0.05,
                                           "img_size": CKPT_IMG}}
    jmodel = jax_efficientvit.efficientvit_m0(num_classes=3, img_size=CKPT_IMG)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, CKPT_IMG, CKPT_IMG, 3)))
    for key, tree in (("model", "params"), ("model_ema", "params"),
                      ("batch_stats", "batch_stats"), ("model_ema_batch_stats", "batch_stats")):
        want = {k: tuple(v.shape) for k, v in _flatten(shapes[tree]).items()}
        assert {k: v.shape for k, v in ck[key].items()} == want, key
    assert int(ck["optimizer"]["count"]) == state.optimizer.num_updates > 0
    assert not np.allclose(ck["batch_stats"]["patch_embed0/BatchNorm_0/var"], 1.0)

    import imageclassification_tpu.data.native_decode as jax_native
    import val as jax_val

    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    imgs = np.random.default_rng(0).integers(0, 256, (4, CKPT_IMG, CKPT_IMG, 3), dtype=np.uint8)
    for ema in (False, True):
        jm, jp, jbs, _ = jax_val.initialize_model(path, ema, half_precision=False)
        want_p = np.asarray(jax_val._predict_fn(jm)(jp, jbs, jnp.asarray(imgs)))
        pm, _ = port_val.initialize_model(path, ema, half_precision=False, device="cpu")
        got_p = port_val._predict_fn(pm)(torch.from_numpy(imgs)).numpy()
        np.testing.assert_allclose(got_p, want_p, atol=1e-5, rtol=0, err_msg=f"ema {ema}")


def test_chip_smoke_default_model_rehearsal_on_cpu(tmp_path):
    # chip_smoke.py's phase 9 at a tiny size on the CPU: train.main with no
    # --model, no kernel launched, the checkpoint in the JAX layout with
    # batch_stats, reloaded exactly and served by val_precision
    run = chip_smoke.run_default_model_training(str(tmp_path), "cpu", img=64, num_classes=3,
                                                per_class=10, batch=4, epochs=2)
    assert run["args"].model == "efficientvit_m0"
    assert len(run["records"]) == 2 * run["steps_per_epoch"] == 12
    assert 0.0 <= run["val_top1"] <= 1.0


@pytest.mark.parametrize("img", [224, 160, 384])
def test_chip_smoke_efficientvit_layout_is_the_jax_layout(img):
    # chip_smoke.py writes the JAX tree out by hand (it imports no JAX); the
    # attention biases' shapes follow each stage's window
    jmodel = jax_efficientvit.efficientvit_m0(num_classes=3, img_size=img)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, img, img, 3)))
    params, stats = chip_smoke.jax_efficientvit_shapes(chip_smoke.EFFICIENTVIT_M0, img, 3)
    assert params == {k: tuple(v.shape) for k, v in _flatten(shapes["params"]).items()}
    assert stats == {k: tuple(v.shape) for k, v in _flatten(shapes["batch_stats"]).items()}
