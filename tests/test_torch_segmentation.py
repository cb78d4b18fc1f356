"""The port's UPerNet segmentation (imageclassification_tpu_torch/downstream/
and imageclassification_tpu_torch/seg_train.py) against the JAX package's
(imageclassification_tpu/downstream/, the root seg_train.py) on the same
numpy inputs and carried weights: ConvNeXt-T at a 64 x 64 crop, batch 2,
5 classes, fp32, drop path 0. The JAX weights are the port's carried
through the weight carry (checkpoint/to_jax.py), so no JAX init runs; each
JAX function is jitted once a case. Tolerances are stated per case."""

import copy
import functools
import os
import pickle
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict
from PIL import Image

from imageclassification_tpu.downstream import fpn as jax_fpn
from imageclassification_tpu.downstream import seg_data as jax_data
from imageclassification_tpu.downstream import seg_engine as jax_engine
from imageclassification_tpu.downstream.upernet import UPerNet as JaxUPerNet
from imageclassification_tpu.engine.state import TrainState as JaxTrainState
from imageclassification_tpu.models import create_model as jax_create_model
from imageclassification_tpu_torch import seg_train
from imageclassification_tpu_torch.checkpoint import io as port_io
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for
from imageclassification_tpu_torch.downstream import fpn as port_fpn
from imageclassification_tpu_torch.downstream import seg_data as port_data
from imageclassification_tpu_torch.downstream import seg_engine as port_engine
from imageclassification_tpu_torch.downstream import upernet as port_upernet
from imageclassification_tpu_torch.engine.state import TrainState
from imageclassification_tpu_torch.models import create_model
from imageclassification_tpu_torch.models.layers import batch_norm_stats, clear_batch_stats

CROP, B, NC = 64, 2, 5
KEEP = 0.9  # the heads' dropout 0.1


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


@functools.lru_cache(maxsize=1)
def _base_upernet():
    """A port UPerNet whose ConvNeXt blocks matter (layer scales ~0.3, not
    1e-6) and whose BatchNorms hold non-trivial running statistics; built
    once (its init takes seconds on one thread), copied by each user."""
    seed = 1
    g = torch.Generator().manual_seed(seed)
    backbone = create_model("convnext_tiny", num_classes=0, features_only=True,
                            drop_path_rate=0.0, generator=g)
    model = port_upernet.UPerNet(backbone, num_classes=NC, generator=g)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(torch.from_numpy(rng.uniform(0.1, 0.5, p.shape).astype(np.float32)))
        for name, t in batch_norm_stats(model).items():
            a = (rng.uniform(0.5, 1.5, t.shape) if name.endswith("running_var")
                 else rng.normal(0, 0.1, t.shape))
            t.copy_(torch.from_numpy(a.astype(np.float32)))
    return model


def _port_upernet():
    return copy.deepcopy(_base_upernet())


@pytest.fixture(scope="module")
def pair():
    """(port model, JAX model, JAX params, JAX batch_stats, jitted JAX eval
    forward), the JAX weights carried from the port model."""
    torch.set_num_threads(1)
    port = _port_upernet()
    carry = carry_for(port)
    params = _tree(carry.to_jax(dict(port.named_parameters())))
    stats = _tree(carry.to_jax(batch_norm_stats(port)))
    jm = JaxUPerNet(backbone=jax_create_model(
        "convnext_tiny", num_classes=0, features_only=True, out_indices=(0, 1, 2, 3),
        drop_path_rate=0.0, half_precision=False), num_classes=NC)
    forward = jax.jit(lambda p, b, x: jm.apply({"params": p, "batch_stats": b}, x, train=False))
    return SimpleNamespace(port=port, jax=jm, params=params, stats=stats, forward=forward)


def _images(seed, n=B, size=CROP):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _labels(seed, n=B, size=CROP):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, NC, (n, size, size)).astype(np.int32)
    y[:, :3] = 255  # an ignored stripe
    return y


def test_jax_tree_from_the_carry_is_the_jax_models(pair):
    # the carried tree has the JAX UPerNet's parameter and statistic paths
    # and shapes exactly (so a checkpoint of either loads in the other)
    shapes = jax.eval_shape(lambda: pair.jax.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, CROP, CROP, 3)), train=False))
    for col, tree in (("params", pair.params), ("batch_stats", pair.stats)):
        want = {k: v.shape for k, v in flatten_dict(shapes[col]).items()}
        got = {k: v.shape for k, v in flatten_dict(tree).items()}
        assert got == want, col


def test_upernet_logits_match_jax(pair):
    # eval mode, fp32: the same function through ~30 conv layers, 12
    # LayerNorm'd blocks and 8 bilinear resizes (including the PPM's shrink
    # from 3x3 and 6x6 to 2x2 at this crop, antialiased on both sides): only
    # the summation order differs. Measured max|d| ~1e-5 on logits of
    # magnitude ~5; tolerance 1e-4 of max|ref|.
    x = jax_engine._normalize(_images(0))
    main, aux = pair.forward(pair.params, pair.stats, x)
    pair.port.eval()
    with torch.no_grad():
        pmain, paux = pair.port(torch.from_numpy(np.array(x)))
    for name, want, got in (("main", main, pmain), ("aux", aux, paux)):
        want = np.asarray(want)
        assert got.shape == want.shape == (B, CROP, CROP, NC) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0,
                                   err_msg=name)


def test_resize_matches_jax_image_resize_both_ways():
    # half-pixel bilinear enlarging, antialiased bilinear shrinking (the PPM
    # at small crops) and a mixed resize: fp32, 1e-5
    rng = np.random.default_rng(1)
    for src, dst in (((3, 3), (16, 16)), ((6, 6), (2, 2)), ((5, 9), (8, 4)), ((4, 4), (4, 4))):
        x = rng.standard_normal((2, *src, 3)).astype(np.float32)
        want = np.asarray(jax.image.resize(x, (2, *dst, 3), method="bilinear"))
        got = port_upernet._resize(torch.from_numpy(x), dst).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=f"{src}->{dst}")


def test_seg_loss_matches_jax():
    # per-pixel CE over the non-ignored pixels (+0.4 aux): fp32 sums of
    # 8,192 terms in another order, 1e-6 relative
    rng = np.random.default_rng(2)
    main, aux = (rng.standard_normal((B, CROP, CROP, NC)).astype(np.float32) for _ in range(2))
    y = _labels(3)
    want = float(jax_engine.seg_loss(main, aux, y))
    got = port_engine.seg_loss(torch.from_numpy(main), torch.from_numpy(aux),
                               torch.from_numpy(y)).item()
    assert got == pytest.approx(want, rel=1e-6)
    assert port_engine.seg_loss(torch.from_numpy(main), None, torch.from_numpy(y)).item() == \
        pytest.approx(float(jax_engine.seg_loss(main, None, y)), rel=1e-6)


def _dropout_masks(seed):
    """The heads' dropout keep masks: decode head (stride 4, 512 channels),
    aux head (stride 16, 256 channels)."""
    rng = np.random.default_rng(seed)
    return {512: rng.random((B, CROP // 4, CROP // 4, 512)) < KEEP,
            256: rng.random((B, CROP // 16, CROP // 16, 256)) < KEEP}


def _jax_dropout(masks):
    """An interceptor that makes flax's Dropout use `masks` (by channels)."""
    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            x = args[0]
            return jnp.where(masks[x.shape[-1]], x / KEEP, 0.0)
        return next_fun(*args, **kwargs)
    return fnn.intercept_methods(interceptor)


def _port_dropout(monkeypatch, masks):
    def dropout(x, rate, generator, mask_shape=None):
        if rate == 0.0:
            return x
        m = torch.from_numpy(masks[x.shape[-1]])
        return torch.where(m, x / KEEP, torch.zeros_like(x))
    monkeypatch.setattr(port_upernet, "dropout", dropout)


def test_decay_scales_match_jax(pair):
    # stage-wise 0.9 with the tiny recipe's 6 layers, and layer-wise:
    # float32 scales, bitwise
    for decay_type, layers in (("stage_wise", 6), ("stage_wise", 12), ("layer_wise", 12)):
        want = _flat(jax_engine.seg_decay_scales(pair.params, decay_type, 0.9, layers))
        got = port_engine.seg_decay_scales(pair.port, decay_type, 0.9, layers)
        keys = list(carry_for(pair.port).to_jax(dict(pair.port.named_parameters())))
        assert len(got) == len(keys) == len(want)
        assert {k: float(want[k]) for k in keys} == dict(zip(keys, got)), decay_type
        assert len(set(got)) > 1


def test_train_step_loss_grads_stats_and_adamw_update_match_jax(pair, monkeypatch):
    # one train step, fp32, drop path 0, the heads' dropout on the same
    # masks: the JAX loss, gradients and new BatchNorm statistics from
    # jax.value_and_grad of the step's loss_fn, and its AdamW update (the
    # step's set_hyperparams / tx.update / apply_updates on those gradients,
    # stage-wise scales, no decay on vectors), all in one jitted function,
    # against the port's step.
    # Tolerances: loss 1e-5 relative; gradients 1e-3 of each tensor's
    # max|ref| (fp32 through the backward of ~60 layers, measured ~1e-5)
    # plus 1e-7 for a gradient that vanishes (the stage-0 out norm's bias
    # feeds a 1x1 conv whose train-mode BatchNorm removes any per-channel
    # shift: both sides give rounding noise of ~1e-9 there);
    # statistics 1e-5 of max|ref|. The parameters after the port's step:
    # Adam's first update is lr * s * g / (|g| + eps), +-lr * s wherever |g|
    # >> eps = 1e-8, and follows the rounding of g for the few elements whose
    # |g| is within rounding noise of eps: all but 0.1% of the elements
    # within 2e-6 and every one within 2 lr. The AdamW update alone, the
    # port's optimizer on the JAX gradients: 1e-7 absolute.
    # The JAX side takes flax's two-pass batch variance E[(x - E[x])^2], as
    # the port's BatchNorm (torch's) does: flax's default one-pass
    # E[x^2] - E[x]^2 cancels in fp32 on the post-ReLU inputs of the heads'
    # 16x16 level and moves the fpn0 kernel's gradient by up to 6% at this
    # size (measured), an error of the reference and not of the function:
    # the next test holds the port to the unpatched JAX step in float64.
    import flax.linen.normalization as flax_norm

    one_pass = flax_norm._compute_stats
    monkeypatch.setattr(flax_norm, "_compute_stats",
                        lambda *a, **kw: one_pass(*a, **{**kw, "use_fast_variance": False}))
    lr, wd = 1e-3, 0.05
    port = _port_upernet()
    carry = carry_for(port)
    # copies: on the CPU the carry's 1-D arrays share the parameters' memory
    params0 = {k: v.copy() for k, v in carry.to_jax(dict(port.named_parameters())).items()}
    stats0 = {k: v.copy() for k, v in carry.to_jax(batch_norm_stats(port)).items()}
    images, labels = _images(4), _labels(5)
    masks = _dropout_masks(6)

    import optax

    from imageclassification_tpu.optim.factory import set_hyperparams

    jm = pair.jax
    x = jax_engine._normalize(images)

    def loss_fn(p, b):
        (main, aux), mut = jm.apply({"params": p, "batch_stats": b}, x, train=True,
                                    rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
        return jax_engine.seg_loss(main, aux, labels), mut["batch_stats"]

    scales = jax_engine.seg_decay_scales(_tree(params0), "stage_wise", 0.9, 6)
    tx = jax_engine.create_seg_optimizer(lr, wd, decay_scales=scales)

    @jax.jit
    def jax_step(params, stats, opt_state):
        # the body of the JAX build_seg_train_step, returning the gradients too
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, stats)
        opt_state = set_hyperparams(opt_state, lr, wd)
        updates, _ = tx.update(grads, opt_state, params)
        return loss, new_stats, grads, optax.apply_updates(params, updates)

    with _jax_dropout(masks):
        loss, new_stats, grads, new_params = jax_step(_tree(params0), _tree(stats0),
                                                      tx.init(_tree(params0)))
    new_params = _flat(new_params)

    # the port: gradients of the same loss, then its train step
    _port_dropout(monkeypatch, masks)
    xt, yt = torch.from_numpy(images), torch.from_numpy(labels)
    port.train()
    main, aux = port(port_engine._normalize(xt))
    pgrads = torch.autograd.grad(port_engine.seg_loss(main, aux, yt), list(port.parameters()))
    clear_batch_stats(port)
    opt = port_engine.create_seg_optimizer(
        port, lr, wd, port_engine.seg_decay_scales(port, "stage_wise", 0.9, 6))
    state = TrainState(model=port, optimizer=opt)
    step = port_engine.build_seg_train_step(port, np.full(10, lr), wd)
    ploss = step(state, xt, yt, None)
    assert state.step == 1 and int(opt.count) == 1

    assert ploss.item() == pytest.approx(float(loss), rel=1e-5)
    names = [n for n, _ in port.named_parameters()]
    got_grads = carry.to_jax(dict(zip(names, pgrads)))
    for k, want in _flat(grads).items():
        err = np.abs(got_grads[k] - want).max()
        assert err <= 1e-3 * np.abs(want).max() + 1e-7, f"grad {k}: {err}"
    for k, want in _flat(new_stats).items():
        got = carry.to_jax(batch_norm_stats(port))[k]
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0,
                                   err_msg=f"stats {k}")
    got_params = carry.to_jax(dict(port.named_parameters()))
    moved, off, total = 0, 0, 0
    for k, want in new_params.items():
        err = np.abs(got_params[k] - want)
        assert err.max() <= 2 * lr, k
        off += int((err > 2e-6).sum())
        total += err.size
        moved += int((np.asarray(want) != params0[k]).any())
    assert moved == len(new_params) and off <= 1e-3 * total, (moved, off, total)

    # the AdamW update alone: the port's optimizer on the JAX gradients
    exact = _port_upernet()
    opt = port_engine.create_seg_optimizer(
        exact, lr, wd, port_engine.seg_decay_scales(exact, "stage_wise", 0.9, 6))
    opt.set_hyperparams(lr, wd)
    jgrads = carry.to_port(_flat(grads))[0]
    opt.step([jgrads[n].reshape(p.shape) for n, p in exact.named_parameters()])
    got_params = carry.to_jax(dict(exact.named_parameters()))
    for k, want in new_params.items():
        np.testing.assert_allclose(got_params[k], want, atol=1e-7, rtol=3e-7, err_msg=k)


def test_train_step_grads_match_the_unpatched_jax_step_in_float64(pair, monkeypatch):
    # the witness for the two-pass batch variance of the test above: the JAX
    # package's own loss and gradients, flax's default one-pass variance
    # included, traced with float64 parameters, inputs and backbone and heads
    # (the classifier convs and the logits stay fp32, as the JAX package
    # writes them). Every port gradient (fp32, two-pass) is within the test
    # above's tolerance of it, 1e-3 of max|ref| + 1e-7; where the unpatched
    # JAX step in fp32 is not (the one-pass variance cancels at the heads'
    # 16x16 level), the port is the closer of the two.
    port = _port_upernet()
    carry = carry_for(port)
    params0 = {k: v.copy() for k, v in carry.to_jax(dict(port.named_parameters())).items()}
    stats0 = {k: v.copy() for k, v in carry.to_jax(batch_norm_stats(port)).items()}
    images, labels = _images(4), _labels(5)
    masks = _dropout_masks(6)

    def jax_grads(dtype):
        jm = pair.jax.clone(dtype=dtype, backbone=pair.jax.backbone.clone(dtype=dtype))
        x = jnp.asarray(jax_engine._normalize(images), dtype)

        def loss_fn(p, b):
            (main, aux), _ = jm.apply({"params": p, "batch_stats": b}, x, train=True,
                                      rngs={"dropout": jax.random.key(0)},
                                      mutable=["batch_stats"])
            return jax_engine.seg_loss(main, aux, labels)

        cast = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, dtype))
        with _jax_dropout(masks):
            grads = jax.jit(jax.grad(loss_fn))(cast(_tree(params0)), cast(_tree(stats0)))
        return {k: np.asarray(v, np.float64) for k, v in _flat(grads).items()}

    with jax.enable_x64(True):
        exact = jax_grads(jnp.float64)
    one_pass = jax_grads(jnp.float32)

    _port_dropout(monkeypatch, masks)
    port.train()
    main, aux = port(port_engine._normalize(torch.from_numpy(images)))
    pgrads = torch.autograd.grad(
        port_engine.seg_loss(main, aux, torch.from_numpy(labels)), list(port.parameters()))
    got = carry.to_jax(dict(zip([n for n, _ in port.named_parameters()], pgrads)))
    for k, want in exact.items():
        tol = 1e-3 * np.abs(want).max() + 1e-7
        err = np.abs(got[k] - want).max()
        assert err <= tol, f"grad {k}: {err} > {tol}"
        jax_err = np.abs(one_pass[k] - want).max()
        if jax_err > tol:
            assert err < jax_err, f"grad {k}: port {err}, one-pass fp32 JAX {jax_err}"


def test_confusion_and_miou_match_jax():
    # counts exact (int64 bincount against the one-hot einsum), mIoU / aAcc
    # from them in float64: equal
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((B, 16, 16, NC)).astype(np.float32)
    y = rng.integers(0, NC, (B, 16, 16)).astype(np.int32)
    y[0, :2] = 255
    y[1, 0, :3] = NC + 2  # out of range: ignored by both
    want = np.asarray(jax_engine.confusion_update(jnp.zeros((NC, NC)), logits, y, NC))
    got = port_engine.confusion_update(torch.zeros((NC, NC), dtype=torch.int64),
                                       torch.from_numpy(logits), torch.from_numpy(y), NC)
    np.testing.assert_array_equal(got.numpy(), want)
    conf = want * 3.0
    conf[4] = 0  # a class absent from labels and predictions
    conf[:, 4] = 0
    jm, jiou, jacc = jax_engine.miou_from_confusion(conf)
    pm, piou, pacc = port_engine.miou_from_confusion(conf)
    assert (pm, pacc) == (jm, jacc)
    np.testing.assert_array_equal(piou, jiou)


def test_slide_inference_and_ms_average_match_jax(pair):
    # windowed logits of one 40 x 52 image (padded to the crop) and one
    # 72 x 90 image (2 x 2 windows at stride 43), then the ms protocol's
    # summed softmax probabilities over 6 scales x hflip resized back: JAX's
    # slide_inference over the jitted JAX forward and PIL's BILINEAR resize
    # of each class's map (as the JAX seg_train's _evaluate_slide composes
    # them) against the port's slide_probabilities (softmax and torch's
    # antialiased bilinear on the logits' device). Logits 1e-4 of max|ref|
    # (as the model case); probabilities, summed over 12 passes, 1e-4
    # absolute
    stride = 43
    jax_window = lambda w: pair.forward(pair.params, pair.stats, jax_engine._normalize(w))[0]
    port_window = seg_train.window_logits_fn(pair.port, torch.device("cpu"))
    rng = np.random.default_rng(8)
    for hw in ((40, 52), (72, 90)):
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        want = jax_engine.slide_inference(jax_window, img, NC, CROP, stride, window_batch=B)
        got = port_engine.slide_inference(port_window, img, NC, CROP, stride, window_batch=B)
        assert got.shape == want.shape == (*hw, NC)
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)

    pil = Image.fromarray(rng.integers(0, 256, (44, 50, 3), dtype=np.uint8))
    H, W = 44, 50
    want = np.zeros((H, W, NC), np.float64)
    for r in (0.5, 0.75, 1.0, 1.25, 1.5, 1.75):
        im = pil if r == 1.0 else pil.resize(
            (max(1, round(pil.width * r)), max(1, round(pil.height * r))), Image.BILINEAR)
        arr = np.asarray(im, np.uint8)
        for flip in (False, True):
            a = arr[:, ::-1] if flip else arr
            logits = jax_engine.slide_inference(jax_window, np.ascontiguousarray(a), NC, CROP,
                                                stride, window_batch=B)
            if flip:
                logits = logits[:, ::-1]
            e = np.exp(logits - logits.max(-1, keepdims=True))
            p = e / e.sum(-1, keepdims=True)
            if p.shape[:2] != (H, W):
                p = np.stack([np.asarray(Image.fromarray(p[..., c]).resize(
                    (W, H), Image.BILINEAR)) for c in range(NC)], axis=-1)
            want += p

    got = seg_train.slide_probabilities(port_window, pil, (H, W), NC, CROP, stride, ms=True)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.allclose(got.sum(-1), 12.0, atol=1e-3)


def _seg_folder(root, n_train=6, n_val=3, seed=3):
    """Images of several sizes in the mmseg layout, masks of 5 classes with
    ignored pixels."""
    rng = np.random.default_rng(seed)
    for split, n in (("training", n_train), ("validation", n_val)):
        os.makedirs(f"{root}/images/{split}", exist_ok=True)
        os.makedirs(f"{root}/annotations/{split}", exist_ok=True)
        for i in range(n):
            h, w = 40 + 7 * i, 56 - 3 * i
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                f"{root}/images/{split}/s{i}.jpg")
            mask = rng.integers(0, NC, (h, w)).astype(np.uint8)
            mask[: h // 8] = 255
            Image.fromarray(mask).save(f"{root}/annotations/{split}/s{i}.png")
    return str(root)


def test_train_and_val_batches_are_the_jax_packages_bitwise(tmp_path):
    root = _seg_folder(tmp_path)
    for split in ("training", "validation"):
        assert port_data.scan_pairs(root, split) == jax_data.scan_pairs(root, split)
    pairs = port_data.scan_pairs(root, "training")
    assert port_data.num_classes_from_masks(pairs) == jax_data.num_classes_from_masks(pairs) == NC
    got = list(port_data.train_batches(pairs, 32, 3, 3, seed=5, start=1))
    want = list(jax_data.train_batches(pairs, 32, 3, 3, seed=5, start=1))
    assert len(got) == len(want) == 2
    for (gi, gx, gy), (wi, wx, wy) in zip(got, want):
        assert gi == wi and gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    val = port_data.scan_pairs(root, "validation")
    for (gx, gy), (wx, wy) in zip(port_data.val_batches(val, 32, 2),
                                  jax_data.val_batches(val, 32, 2)):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_fpn_neck_matches_jax():
    # FPN over a ConvNeXt-style pyramid with odd sizes (the nearest resize
    # off the 2x grid) and the extra stride-2 level: fp32, 1e-5 of max|ref|
    rng = np.random.default_rng(9)
    sizes, chans = (17, 9, 5, 3), (8, 16, 24, 32)
    feats = [rng.standard_normal((2, s, s + 1, c)).astype(np.float32)
             for s, c in zip(sizes, chans)]
    jm = jax_fpn.FPN(out_channels=16, num_outs=5)
    variables = jm.init(jax.random.key(0), feats)
    want = jm.apply(variables, feats)
    port = port_fpn.FPN(chans, out_channels=16, num_outs=5)
    assert port_io.load_params_with_pruning(port, _flat(variables["params"])) == 0
    got = port([torch.from_numpy(f) for f in feats])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)


def _classifier_checkpoint(path):
    """A JAX-layout classification checkpoint of a seeded port ConvNeXt-T
    (1000 classes): its head and head norm exist in no pyramid view."""
    model = create_model("convnext_tiny", num_classes=1000,
                         generator=torch.Generator().manual_seed(11))
    ck = {"model": carry_for(model).to_jax(dict(model.named_parameters())),
          "model_spec": {"name": "convnext_tiny", "kwargs": {}}, "num_classes": 1000}
    with open(path, "wb") as f:
        pickle.dump(ck, f)
    return str(path), ck["model"]


def test_backbone_transfer_matches_jax(pair, tmp_path, capsys):
    # the same classifier file seeds both backbones: the same skipped count
    # (the head and head norm) and the backbone equal to the file, bitwise
    path, flat = _classifier_checkpoint(tmp_path / "cls.pth")
    variables = jax_engine.transfer_backbone(pair.jax, {"params": pair.params}, path)
    jax_line = [ln for ln in capsys.readouterr().out.splitlines() if "backbone transfer" in ln]
    port = _port_upernet()
    skipped = port_engine.transfer_backbone(port, path)
    port_line = [ln for ln in capsys.readouterr().out.splitlines() if "backbone transfer" in ln]
    assert port_line == jax_line == [f"backbone transfer: {skipped} mismatched keys skipped"]
    assert skipped == 4  # head_norm/{scale,bias}, head/{kernel,bias}
    got = carry_for(port).to_jax(dict(port.named_parameters()))
    want = _flat(variables["params"])
    for k, v in want.items():
        if k.startswith("backbone/") and k[len("backbone/"):] in flat:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            np.testing.assert_array_equal(v, flat[k[len("backbone/"):]], err_msg=k)
    # and through the adapter
    from imageclassification_tpu_torch.downstream.backbone import (
        ConvNeXtBackbone, load_backbone_from_classifier)

    bb = ConvNeXtBackbone("convnext_tiny", half_precision=False)
    assert load_backbone_from_classifier(bb, path) == skipped
    assert bb.feature_channels == [96, 192, 384, 768] and bb.feature_strides == [4, 8, 16, 32]


def _seg_save_args(out_dir):
    return SimpleNamespace(output_dir=str(out_dir), model_ema=False, save_ckpt_num=3,
                           save_ckpt_freq=1)


def test_checkpoints_load_across_packages(pair, tmp_path, capsys):
    # a port checkpoint-iter{N}.pth loads in the JAX package as the JAX
    # seg_train's resume reads it (parameters, statistics and the optimizer
    # state by name and shape, nothing skipped), and a JAX one in the port's
    # resume ("With optim & sched!", the step restored), values exact
    from imageclassification_tpu.checkpoint import io as jax_io

    port = _port_upernet()
    opt = port_engine.create_seg_optimizer(
        port, 1e-4, 0.05, port_engine.seg_decay_scales(port, "stage_wise", 0.9, 6))
    with torch.no_grad():
        for i, m in enumerate(opt.moments["exp_avg"]):
            m.fill_(0.001 * (i + 1))
    opt.count.fill_(7)
    state = TrainState(model=port, optimizer=opt, step=7)
    spec = {"task": "segmentation", "config": "upernet_convnext_tiny_512_160k",
            "num_classes": NC, "crop_size": CROP}
    path = port_io.save_model(_seg_save_args(tmp_path / "port"), (1, CROP, CROP, 3), "iter7",
                              state, NC, spec)
    ck = jax_io.load_checkpoint(path)
    tx = jax_engine.create_seg_optimizer(
        1e-4, 0.05, decay_scales=jax_engine.seg_decay_scales(pair.params, "stage_wise", 0.9, 6))
    jax_opt = tx.init(pair.params)
    _, missing = jax_io.load_params_with_pruning(pair.params, ck["model"])
    _, missing_stats = jax_io.load_params_with_pruning(pair.stats, ck["batch_stats"])
    loaded_opt, missing_opt = jax_io.load_params_with_pruning(jax_opt, ck["optimizer"])
    assert (missing, missing_stats, missing_opt) == (0, 0, 0) and ck["step"] == 7
    assert set(jax_io._flatten(jax_opt)) == set(ck["optimizer"])
    assert int(jax_io._flatten(loaded_opt)["inner_state/0/count"]) == 7

    # the JAX package's checkpoint in the port's resume
    jstate = JaxTrainState(step=jnp.asarray(5, jnp.int32), params=_tree(ck["model"]),
                           batch_stats=_tree(ck["batch_stats"]), opt_state=loaded_opt)
    jax_io.save_model(_seg_save_args(tmp_path / "jax"), (1, CROP, CROP, 3), "iter5", jstate, NC,
                      spec)
    jax_io.wait_for_pending_saves()
    fresh = _port_upernet()
    fopt = port_engine.create_seg_optimizer(
        fresh, 1e-4, 0.05, port_engine.seg_decay_scales(fresh, "stage_wise", 0.9, 6))
    fstate = TrainState(model=fresh, optimizer=fopt)
    capsys.readouterr()
    assert seg_train.resume(fstate, str(tmp_path / "jax")) == 5
    assert "With optim & sched!" in capsys.readouterr().out
    assert fstate.step == 5 and int(fopt.count) == 7
    carry = carry_for(fresh)
    for k, v in carry.to_jax(dict(fresh.named_parameters())).items():
        np.testing.assert_array_equal(v, ck["model"][k], err_msg=k)
    for k, v in carry.to_jax(batch_norm_stats(fresh)).items():
        np.testing.assert_array_equal(v, ck["batch_stats"][k], err_msg=k)
    for a, b in zip(fopt.moments["exp_avg"], opt.moments["exp_avg"]):
        assert torch.equal(a, b)
    for d in ("port", "jax"):  # ~0.7 GB a checkpoint
        shutil.rmtree(tmp_path / d)


def test_seg_train_runs_three_iterations_with_auto_resume(tmp_path, capsys):
    # seg_train.main on the CPU: 2 iterations with a checkpoint each, whole
    # eval, then a third from the auto-resumed checkpoint-iter2.pth (the
    # step restored, the optimizer with it); losses finite, the schedule's
    # lr continuing where it stopped
    root = _seg_folder(tmp_path / "data")
    out = tmp_path / "out" / "output"
    argv = ["--data_path", root, "--crop_size", str(CROP), "--batch_size", str(B),
            "--output_dir", str(out), "--device", "cpu", "--log_interval", "1",
            "--save_ckpt_interval", "1", "--warmup_iters", "1", "--half_precision", "false"]
    parser = seg_train.get_args_parser()
    row = seg_train.main(parser.parse_args(argv + ["--total_iters", "2"]))
    first = capsys.readouterr().out
    assert "iter 2/2 loss" in first and np.isfinite(row["miou"]) and 0 <= row["aacc"] <= 1
    assert sorted(os.listdir(out)) == ["checkpoint-best.pth", "checkpoint-iter1.pth",
                                       "checkpoint-iter2.pth"]
    row = seg_train.main(parser.parse_args(argv + ["--total_iters", "3", "--eval_mode",
                                                   "slide"]))
    second = capsys.readouterr().out
    assert "Auto resume checkpoint:" in second and "checkpoint-iter2.pth" in second
    assert "With optim & sched!" in second
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in (first + second).splitlines()
              if ln.startswith("iter ") and " loss " in ln]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "iter 3/3" in second and "iter 1/3" not in second
    ck = port_io.load_checkpoint(str(out / "checkpoint-iter3.pth"))
    assert ck["step"] == 3 and ck["model_spec"]["task"] == "segmentation"
    assert int(ck["optimizer"]["inner_state/0/count"]) == 3
    shutil.rmtree(out)  # ~0.7 GB a checkpoint (parameters and both moments)


def test_multiprocess_launch_raises_naming_a9(tmp_path, monkeypatch):
    root = _seg_folder(tmp_path / "data", n_train=1, n_val=1)
    args = seg_train.get_args_parser().parse_args(["--data_path", root, "--device", "cpu"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(NotImplementedError, match="A9"):
        seg_train.main(args)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    for extra in (["--dist_on_itp"], ["--mesh_shape", "data:2"]):
        with pytest.raises(NotImplementedError, match="A9"):
            seg_train.main(seg_train.get_args_parser().parse_args(
                ["--data_path", root, "--device", "cpu", *extra]))
