"""The port's `--aa` policies against the JAX package's: each op of
imageclassification_tpu_torch/ops/image.py against JAX `ops/image.py` on a
batch (JAX's single-image ops under vmap, per-sample parameters), RandAugment
(increasing and not), AutoAugment 'original' and 'v0', AbelAugment and its
latent ops on the JAX draws (tests/jax_draws.py repeats the JAX key
splits), and `AugmentPipeline` with --aa. One JAX compile per policy.

Tolerances: 1e-3 absolute on values in [0, 255] (the same fp32 formulas;
XLA may fuse a multiply-add where torch rounds twice); exact where the op's
result is an integer decided by integer sums or truncation (equalize's
histogram, posterize, the thresholds). A whole policy chains ops, and where
a truncation or rounding (posterize, equalize, contrast's mean, sharpness,
autocontrast) follows a geometric op, a 1-ulp difference of the bilinear
sample can move a value across a level and change it by a whole level or
more; so every value is held to 1e-3 except a share of at most 1e-3 of the
elements."""

import argparse
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jax_draws
from imageclassification_tpu.data import abel as jax_abel
from imageclassification_tpu.data import augment as jax_augment
from imageclassification_tpu.data import randaugment as jax_ra
from imageclassification_tpu.ops import image as jax_image
from imageclassification_tpu_torch.data import abel, augment, randaugment
from imageclassification_tpu_torch.ops import image

SHAPE = (6, 16, 12, 3)  # H != W
POLICY_SHAPE = (24, 16, 12, 3)
ATOL = 1e-3
# the share of elements a whole policy may hold beyond ATOL (module docstring)
POLICY_SHARE = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    # several pytest workers run at once; one thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(kind, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uint8":
        x = rng.integers(0, 256, shape).astype(np.float32)
    else:
        x = rng.uniform(0.0, 255.0, shape).astype(np.float32)
    x[0, ..., 1] = 77.0  # a constant channel (autocontrast, equalize keep it)
    return x


def _p(rng, lo, hi, B=SHAPE[0]):
    return rng.uniform(lo, hi, B).astype(np.float32)


FILL = np.array([124.0, 116.0, 104.0], np.float32)


def _op_cases():
    """name -> (JAX single-image fn(img, *params), port batch fn(img,
    *params), params as [B] arrays, exact)."""
    rng = np.random.default_rng(1)
    B = SHAPE[0]
    bits = np.array([0, 1, 3, 4, 7, 8], np.int32)
    coeffs = np.stack([_p(rng, 0.8, 1.2), _p(rng, -0.3, 0.3), _p(rng, -4, 4),
                       _p(rng, -0.3, 0.3), _p(rng, 0.8, 1.2), _p(rng, -4, 4)], 1)
    return {
        "affine_inverse": (lambda x, c: jax_image.affine_inverse(x, tuple(c), FILL),
                           lambda x, c: image.affine_inverse(x, c, torch.from_numpy(FILL)),
                           (coeffs,), False),
        "shear_x": (lambda x, v: jax_image.shear_x(x, v, FILL),
                    lambda x, v: image.shear_x(x, v, torch.from_numpy(FILL)),
                    (_p(rng, -0.3, 0.3),), False),
        "shear_y": (lambda x, v: jax_image.shear_y(x, v, FILL),
                    lambda x, v: image.shear_y(x, v, torch.from_numpy(FILL)),
                    (_p(rng, -0.3, 0.3),), False),
        "translate_x": (lambda x, v: jax_image.translate_x(x, v, FILL),
                        lambda x, v: image.translate_x(x, v, torch.from_numpy(FILL)),
                        (_p(rng, -5.4, 5.4),), False),
        "translate_y": (lambda x, v: jax_image.translate_y(x, v, FILL),
                        lambda x, v: image.translate_y(x, v, torch.from_numpy(FILL)),
                        (_p(rng, -7.2, 7.2),), False),
        "rotate": (lambda x, d: jax_image.rotate(x, d, FILL),
                   lambda x, d: image.rotate(x, d, torch.from_numpy(FILL)),
                   (_p(rng, -30, 30),), False),
        "grayscale": (jax_image.grayscale, image.grayscale, (), False),
        "brightness": (jax_image.adjust_brightness, image.adjust_brightness,
                       (_p(rng, 0.1, 1.9),), False),
        "saturation": (jax_image.adjust_saturation, image.adjust_saturation,
                       (_p(rng, 0.1, 1.9),), False),
        "contrast": (jax_image.adjust_contrast, image.adjust_contrast,
                     (_p(rng, 0.1, 1.9),), False),
        "sharpness": (jax_image.adjust_sharpness, image.adjust_sharpness,
                      (_p(rng, 0.1, 1.9),), False),
        "invert": (jax_image.invert, image.invert, (), True),
        "posterize": (jax_image.posterize, image.posterize, (bits,), True),
        "solarize": (jax_image.solarize, image.solarize, (_p(rng, 0, 256),), True),
        "solarize_add": (jax_image.solarize_add, image.solarize_add, (_p(rng, 0, 110),), False),
        "equalize": (jax_image.equalize, image.equalize, (), True),
        "autocontrast": (jax_image.autocontrast, image.autocontrast, (), False),
        "cutout": (lambda x, p, cy, cx: jax_image.cutout(x, p, cy, cx, 127.0),
                   lambda x, p, cy, cx: image.cutout(x, p, cy, cx, torch.full((3,), 127.0)),
                   (rng.integers(1, 6, B), rng.integers(-2, 18, B), rng.integers(-2, 14, B)),
                   True),
    }


OPS = _op_cases()


@functools.lru_cache(maxsize=None)
def _jax_ops(kind):
    """Every JAX op's output on the `kind` images, in one compile."""
    x = _images(kind)

    def run(x, params):
        return {name: jax.vmap(OPS[name][0])(x, *params[name]) for name in OPS}

    params = {name: tuple(jnp.asarray(p) for p in OPS[name][2]) for name in OPS}
    return {k: np.asarray(v) for k, v in jax.jit(run)(jnp.asarray(x), params).items()}


@pytest.mark.parametrize("kind", ["uint8", "float"])
@pytest.mark.parametrize("name", list(OPS))
def test_image_op_matches_jax(name, kind):
    _, pfn, params, exact = OPS[name]
    x = _images(kind)
    want = _jax_ops(kind)[name]
    got = pfn(torch.from_numpy(x), *(torch.from_numpy(np.asarray(p)) for p in params)).numpy()
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if name == "posterize":
        assert not got[0].any()  # 0 bits: black
        np.testing.assert_array_equal(got[-1], np.trunc(x[-1]))  # 8 bits: the truncation


def test_contrast_mean_of_integers_is_divided():
    # the rounded luma's mean exactly 126.5 (96 of 192 pixels at 253): the
    # sum divided by the pixel count rounds half to even, to 126, as in JAX
    x = np.zeros((1, 16, 12, 3), np.float32)
    x[0, :8] = 253.0
    want = np.asarray(jax.vmap(jax_image.adjust_contrast)(jnp.asarray(x), jnp.zeros(1)))
    got = image.adjust_contrast(torch.from_numpy(x), torch.zeros(1)).numpy()
    assert want.max() == 126.0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("aa,want", [
    ("rand-m9-mstd0.5-inc1", dict(magnitude=9.0, mstd=0.5, increasing=True, num_layers=2)),
    ("rand-m7-n3-mstd0-p0.7-mmax15", dict(magnitude=7.0, num_layers=3, mstd=0.0, prob=0.7,
                                          mmax=15.0, increasing=False)),
    ("rand-w0-t5", dict(magnitude=10.0, mstd=0.5)),
])
def test_parse_policy_matches_jax(aa, want, capsys):
    got, ref = randaugment.parse_policy(aa), jax_ra.parse_policy(aa)
    port_out = capsys.readouterr().out
    for k, v in want.items():
        assert getattr(got, k) == getattr(ref, k) == v, k
    assert len(got.ops) == len(ref.ops) == 15
    assert port_out.count("accepted but ignored") == (2 if "w0" in aa else 0) * 2


@pytest.mark.parametrize("aa", ["rand-m9-std0.5", "rand-x3", "augmix-m5", "v1"])
def test_unknown_policies_raise_as_in_jax(aa):
    args = argparse.Namespace(aa=aa, color_jitter=0.3, reprob=0.0, remode="pixel", recount=1)
    with pytest.raises(ValueError) as want:
        jax_augment.AugmentPipeline(args)
    with pytest.raises(ValueError) as got:
        augment.AugmentPipeline(args)
    assert str(got.value) == str(want.value)


def _policy(aa):
    if aa.startswith("rand"):
        return jax_ra.parse_policy(aa), randaugment.parse_policy(aa), jax_ra.rand_augment_batch
    if aa.startswith("abel"):
        return (jax_abel.parse_abel_policy(aa), abel.parse_abel_policy(aa),
                jax_abel.abel_augment_batch)
    return (jax_ra.AutoAugmentConfig(aa), randaugment.AutoAugmentConfig(aa),
            jax_ra.auto_augment_batch)


def _hold_policy(got, want):
    """Every value to ATOL but a share of at most POLICY_SHARE (module
    docstring)."""
    assert got.shape == want.shape and np.isfinite(got).all()
    off = np.abs(got - want) > ATOL
    assert off.mean() <= POLICY_SHARE, (off.mean(), np.abs(got - want).max())


@pytest.mark.parametrize("aa", ["rand-m9-mstd0.5-inc1", "rand-m9-n3-mstd0.5", "original", "v0",
                                "abel-n2"])
def test_policy_matches_jax(aa):
    jcfg, pcfg, batch_fn = _policy(aa)
    x = _images("uint8", POLICY_SHAPE, seed=2)
    key = jax.random.key(9)
    want = np.asarray(jax.jit(lambda im, k: batch_fn(im, k, jcfg))(jnp.asarray(x), key))
    draws = jax_draws.policy_draws(key, POLICY_SHAPE[0], aa, jcfg)
    got = pcfg(torch.from_numpy(x), draws).numpy()
    assert (np.abs(want - x) > 1).any()  # the policy changed the images
    _hold_policy(got, want)
    # the port draws its own in the same layout
    own = pcfg.sample(POLICY_SHAPE[0], torch.Generator().manual_seed(0))
    assert {k: (v.shape, v.dtype) for k, v in own.items()} == \
        {k: (v.shape, v.dtype) for k, v in draws.items()}
    assert torch.isfinite(pcfg(torch.from_numpy(x), own)).all()


def test_augment_pipeline_with_aa_matches_jax():
    args = argparse.Namespace(aa="abel-n2", color_jitter=0.3, reprob=0.25,
                              remode="pixel", recount=1)
    x = _images("uint8", (8, 16, 16, 3), seed=3).astype(np.uint8)
    key = jax.random.key(7)
    want = np.asarray(jax.jit(jax_augment.AugmentPipeline(args))(jnp.asarray(x), key))
    draws = jax_draws.augment_draws(key, 8, 16, 16, args)
    assert "jitter" not in draws  # the policy replaces ColorJitter
    pipe = augment.AugmentPipeline(args)
    got = pipe(torch.from_numpy(x), draws).numpy()
    # normalized values: ATOL / (255 * std) is ~1.7e-5; 1e-4 as the pipeline test
    assert (np.abs(got - want) > 1e-4).mean() <= POLICY_SHARE
    own = pipe.sample(8, 16, 16, torch.Generator().manual_seed(0))
    assert "aa" in own and "jitter" not in own


def _latent_cases():
    """name -> (JAX fn(img, key), port fn(img, the JAX draws of key))."""
    H, W = SHAPE[1:3]

    def thr(lo, hi):
        return lambda k: jax.random.uniform(k, minval=lo, maxval=hi)

    def cut_draws(k):
        ky, kx = jax.random.split(k)
        return jnp.stack([jax.random.randint(ky, (), 0, H), jax.random.randint(kx, (), 0, W)])

    return {
        "set_dark_pixels_to_zero": (lambda x, k: jax_abel.set_dark_pixels_to_zero(x, thr(1, 60)(k)),
                                    thr(1, 60), abel.set_dark_pixels_to_zero),
        "anti_solarize": (lambda x, k: jax_abel.anti_solarize(x, thr(60, 200)(k)),
                          thr(60, 200), abel.anti_solarize),
        "solarize_add_abel": (
            lambda x, k: jax_abel.solarize_add_abel(x, 128.0, thr(0, 120)(k)), thr(0, 120),
            lambda x, a: abel.solarize_add_abel(x, torch.full_like(a, 128.0), a)),
        "lighting": (lambda x, k: jax_abel.lighting(x, k, 0.3),
                     lambda k: jax.random.normal(k, (3,)),
                     lambda x, n: abel.lighting(x, n, 0.3)),
        "lighting_gray": (lambda x, k: jax_abel.lighting_gray(x, k, 0.3),
                          lambda k: jax.random.normal(k, (3,)),
                          lambda x, n: abel.lighting_gray(x, n, 0.3)),
        "sample_pairing": (lambda x, k: jax_abel.sample_pairing(x, x[::-1, ::-1], k),
                           lambda k: jax.random.uniform(k, minval=0.0, maxval=0.4),
                           lambda x, w: abel.sample_pairing(x, x.flip(1, 2), w)),
        "cutout_abs": (lambda x, k: jax_abel.cutout_abs(x, k, 6), cut_draws,
                       lambda x, c: abel.cutout_abs(x, c[:, 0], c[:, 1], 6)),
    }


LATENT = _latent_cases()


@functools.lru_cache(maxsize=None)
def _jax_latent():
    """Every latent op's output and draws on the float images, in one
    compile."""
    x = _images("float", seed=4)
    keys = jax.random.split(jax.random.key(5), SHAPE[0])

    def run(x, keys):
        return {name: (jax.vmap(jfn)(x, keys), jax.vmap(draw)(keys))
                for name, (jfn, draw, _) in LATENT.items()}

    return {k: tuple(np.array(a) for a in v) for k, v in jax.jit(run)(jnp.asarray(x), keys).items()}


@pytest.mark.parametrize("name", list(LATENT))
def test_abel_latent_op_matches_jax(name):
    x = _images("float", seed=4)
    want, drawn = _jax_latent()[name]
    got = LATENT[name][2](torch.from_numpy(x), torch.from_numpy(drawn)).numpy()
    assert (np.abs(want - x) > 1e-3).any()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
