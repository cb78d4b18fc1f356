"""Port data pieces of the training slice (imageclassification_tpu_torch/data:
augment, mixup, sampler, folder.build_dataset, loader.BatchLoader) against
the JAX package's functions. Random functions get the JAX draws, reproduced
from the same keys by tests/jax_draws.py."""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import imageclassification_tpu.data.native_decode as jax_native
from imageclassification_tpu.data import augment as jax_augment
from imageclassification_tpu.data import folder as jax_folder
from imageclassification_tpu.data import loader as jax_loader
from imageclassification_tpu.data import mixup as jax_mixup
from imageclassification_tpu.data import sampler as jax_sampler
from imageclassification_tpu_torch.data import augment, folder, loader, mixup, native_decode, sampler

import jax_draws


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, shape=(6, 16, 12, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _aug_args(**kw):
    base = dict(color_jitter=0.3, aa="", reprob=0.25, remode="pixel", recount=1)
    base.update(kw)
    return argparse.Namespace(**base)


def test_random_flips_match_jax():
    imgs = _images(0)
    key = jax.random.key(3)
    want = np.asarray(jax_augment.random_flips(jnp.asarray(imgs), key))
    d = jax_draws.flip_draws(key, len(imgs))
    assert d["flip_h"].any() and not d["flip_h"].all()
    got = augment.random_flips(torch.from_numpy(imgs), d["flip_h"], d["flip_v"])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("strength", [0.3, 0.8])
def test_color_jitter_matches_jax(strength):
    imgs = _images(1).astype(np.float32)
    key = jax.random.key(4)
    want = np.asarray(jax_augment.color_jitter_batch(jnp.asarray(imgs), key, strength))
    fb, fc, fs = jax_draws.jitter_draws(key, len(imgs), strength)
    got = augment.color_jitter_batch(torch.from_numpy(imgs), fb, fc, fs)
    # the same fp32 arithmetic in the same order; XLA fuses the multiply-adds
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("mode,count", [("pixel", 1), ("rand", 1), ("const", 2), ("pixel", 3)])
def test_random_erasing_matches_jax(mode, count):
    imgs = np.random.default_rng(2).standard_normal((8, 20, 16, 3)).astype(np.float32)
    key = jax.random.key(5)
    want = np.asarray(jax_augment.random_erasing(jnp.asarray(imgs), key, 0.9, mode, count))
    d = jax_draws.erase_draws(key, 8, 20, 16, 0.9, mode, count)
    got = augment.random_erasing(torch.from_numpy(imgs), d, mode)
    assert (want != imgs).any()  # something was erased
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"color_jitter": 0.0, "reprob": 0.0},
                                {"remode": "rand", "recount": 2}])
def test_augment_pipeline_matches_jax(kw):
    args = _aug_args(**kw)
    imgs = _images(6, (8, 16, 16, 3))
    key = jax.random.key(7)
    want = np.asarray(jax_augment.AugmentPipeline(args)(jnp.asarray(imgs), key))
    draws = jax_draws.augment_draws(key, 8, 16, 16, args)
    got = augment.AugmentPipeline(args)(torch.from_numpy(imgs), draws)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_augment_pipeline_samples_its_own_draws():
    args = _aug_args(recount=2)
    pipe = augment.AugmentPipeline(args)
    g = torch.Generator().manual_seed(0)
    d = pipe.sample(8, 16, 12, g)
    assert d["flip_h"].shape == (8,) and d["flip_h"].dtype == torch.bool
    lo, hi = 0.7, 1.3
    assert all(((f >= lo) & (f <= hi)).all() for f in d["jitter"])
    e = d["erase"]
    assert e["area"].shape == (8, 2) and e["fill"].shape == (8, 2, 16, 12, 3)
    assert ((e["top"] >= 0) & (e["top"] < 16)).all() and ((e["left"] < 12)).all()
    out = pipe(torch.from_numpy(_images(8, (8, 16, 12, 3))), d)
    assert out.shape == (8, 16, 12, 3) and torch.isfinite(out).all()
    again = pipe.sample(8, 16, 12, torch.Generator().manual_seed(0))
    torch.testing.assert_close(again["erase"]["fill"], e["fill"], rtol=0, atol=0)


def test_augment_pipeline_refuses_aa():
    # --aa runs (tests/test_torch_augment_policies.py); a name that is no
    # policy raises as in JAX
    augment.AugmentPipeline(_aug_args(aa="rand-m9-mstd0.5-inc1"))
    with pytest.raises(ValueError, match="unknown AutoAugment policy"):
        augment.AugmentPipeline(_aug_args(aa="augmix-m5"))


def test_one_hot_smooth_matches_jax():
    labels = np.array([0, 2, 1, 4])
    want = np.asarray(jax_mixup.one_hot_smooth(jnp.asarray(labels), 5, 0.1))
    got = mixup.one_hot_smooth(torch.from_numpy(labels), 5, 0.1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("cfg_kw", [
    dict(mode="batch"),
    dict(mode="batch", mixup_alpha=0.0, cutmix_alpha=1.0),
    dict(mode="batch", cutmix_alpha=1.0, switch_prob=0.5),
    dict(mode="elem", cutmix_alpha=1.0),
    dict(mode="pair", cutmix_alpha=1.0),
    dict(mode="batch", cutmix_minmax=[0.2, 0.8], prob=0.7),
    dict(mode="elem", cutmix_minmax=[0.2, 0.8]),
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_cutmix_matches_jax(cfg_kw, seed):
    kw = dict(mixup_alpha=0.8, cutmix_alpha=0.0, label_smoothing=0.1, num_classes=5)
    kw.update(cfg_kw)
    jcfg, pcfg = jax_mixup.MixupConfig(**kw), mixup.MixupConfig(**kw)
    imgs = np.random.default_rng(seed).standard_normal((6, 12, 10, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4, 1])
    key = jax.random.key(seed + 10)
    want_x, want_y = jax_mixup.mixup_cutmix(jnp.asarray(imgs), jnp.asarray(labels), key, jcfg)
    draws = jax_draws.mixup_draws(key, jcfg, 6, 12, 10)
    got_x, got_y = mixup.mixup_cutmix(torch.from_numpy(imgs), torch.from_numpy(labels),
                                      draws, pcfg)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-6, rtol=0)


@pytest.mark.parametrize("cfg_kw", [dict(mode="batch"), dict(mode="pair", cutmix_alpha=1.0),
                                    dict(mode="elem", cutmix_minmax=[0.2, 0.8])])
def test_sample_mixup_draws_are_in_range(cfg_kw):
    cfg = mixup.MixupConfig(**{"num_classes": 5, **cfg_kw})
    d = mixup.sample_mixup(cfg, 8, 12, 10, torch.Generator().manual_seed(0))
    assert ((d["lam"] >= 0) & (d["lam"] <= 1)).all()
    if cfg.mode == "pair":
        torch.testing.assert_close(d["lam"], d["lam"].flip(0), rtol=0, atol=0)
    x, y = mixup.mixup_cutmix(torch.randn(8, 12, 10, 3), torch.arange(8) % 5, d, cfg)
    assert x.shape == (8, 12, 10, 3)
    torch.testing.assert_close(y.sum(-1), torch.ones(8))


def test_build_mixup_matches_jax_activation():
    for mix, cut in ((0.8, 0.0), (0.0, 0.0), (0.0, 1.0)):
        args = argparse.Namespace(mixup=mix, cutmix=cut, cutmix_minmax=None, mixup_prob=1.0,
                                  mixup_switch_prob=0.5, mixup_mode="batch", smoothing=0.1)
        assert (mixup.build_mixup(args, 3) is None) == (jax_mixup.build_mixup(args, 3) is None)


@pytest.mark.parametrize("n,batch,epoch,rank,world", [
    (30, 8, 0, 0, 1), (30, 8, 3, 1, 2), (675, 64, 1, 0, 1), (7, 4, 0, 2, 3),
])
def test_epoch_samplers_match_jax(n, batch, epoch, rank, world):
    for fn, jfn in ((sampler.epoch_batch_indices, jax_sampler.epoch_batch_indices),
                    (sampler.ra_epoch_batch_indices, jax_sampler.ra_epoch_batch_indices)):
        np.testing.assert_array_equal(fn(n, batch, epoch, 88, rank, world),
                                      jfn(n, batch, epoch, 88, rank, world))


@pytest.mark.parametrize("ratio", [0.5, 0.0])
def test_build_dataset_matches_jax(toy_dataset, toy_split_dataset, tmp_path, ratio):
    root = toy_split_dataset if ratio == 0 else toy_dataset
    out = {}
    for side, fn in (("port", folder.build_dataset), ("jax", jax_folder.build_dataset)):
        args = argparse.Namespace(data_path=root, train_split_rato=ratio, seed=3,
                                  output_dir=str(tmp_path / side))
        out[side] = fn(args)
        out[side + "_json"] = (tmp_path / side / "class_indices.json").read_text()
    (ptr, pval, pn), (jtr, jval, jn) = out["port"], out["jax"]
    assert ptr.samples == jtr.samples and pval.samples == jval.samples and pn == jn
    assert out["port_json"] == out["jax_json"]


def test_batch_loader_decodes_like_the_jax_loader(monkeypatch, toy_dataset):
    # the JAX loader's per-sample crop seed and decode: the toy JPEGs through
    # each package's native decoder (PIL on both where neither builds)
    assert (jax_native.get_lib() is None) == (native_decode.get_lib() is None)
    ds = folder.scan_folder(toy_dataset)
    idx = np.array([[3, 17, 0], [29, -1, -1]])
    batches = list(loader.BatchLoader(ds, idx, 24, train=True, device="cpu", seed=5,
                                      num_workers=2, prefetch=2))
    assert len(batches) == 2
    for step, b in zip(idx, batches):
        assert b["image"].dtype == torch.uint8 and b["image"].shape == (3, 24, 24, 3)
        for j, i in enumerate(step):
            if i < 0:
                assert b["label"][j] == -1 and not b["image"][j].any()
                continue
            seed = int(np.random.SeedSequence([5, int(i) + 1]).generate_state(1)[0])
            want = jax_loader.decode_image(ds.samples[i][0], 24, True, seed)
            np.testing.assert_array_equal(b["image"][j].numpy(), want)
            assert b["label"][j] == ds.samples[i][1]
