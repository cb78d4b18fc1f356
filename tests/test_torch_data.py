"""Port data path (imageclassification_tpu_torch/data, utils/metrics.py)
against the JAX package's own functions on the same folders and seeds."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import imageclassification_tpu.data.native_decode as jax_native
from imageclassification_tpu.data import augment as jax_augment
from imageclassification_tpu.data import folder as jax_folder
from imageclassification_tpu.data import loader as jax_loader
from imageclassification_tpu.data import sampler as jax_sampler
from imageclassification_tpu.utils.metrics import per_class_precision_recall as jax_pr
from imageclassification_tpu_torch.data import augment, folder, loader, native_decode, sampler
from imageclassification_tpu_torch.utils.metrics import per_class_precision_recall


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pil_only(monkeypatch):
    # both decoders route JPEGs through their native libjpeg build when it
    # exists; with neither library, both decode through PIL: compare PIL
    # with PIL
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(native_decode, "get_lib", lambda: None)


@pytest.fixture
def native_both():
    # the native route on both sides: each package's own build of decode.cpp
    assert jax_native.get_lib() is not None, "the JAX package's native decoder did not build"
    assert native_decode.get_lib() is not None, native_decode.build_error()


def test_scan_folder_matches(toy_dataset):
    got, want = folder.scan_folder(toy_dataset), jax_folder.scan_folder(toy_dataset)
    assert got.samples == want.samples
    assert got.class_to_idx == want.class_to_idx
    assert got.num_classes == want.num_classes and got.targets == want.targets


def test_scan_folder_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        folder.scan_folder(str(tmp_path))
    (tmp_path / "a").mkdir()
    with pytest.raises(FileNotFoundError):
        folder.scan_folder(str(tmp_path))


@pytest.mark.parametrize("ratio,seed", [(0.5, 0), (0.9, 3), (0.0, 1)])
def test_split_dataset_matches(toy_dataset, ratio, seed):
    got = folder.split_dataset(toy_dataset, ratio, seed=seed)
    want = jax_folder.split_dataset(toy_dataset, ratio, seed=seed)
    assert got[0].samples == want[0].samples
    assert got[1].samples == want[1].samples
    assert got[2] == want[2]


def test_write_class_indices_matches(tmp_path):
    c2i = {"cat": 0, "dog": 1, "fox": 2}
    folder.write_class_indices(c2i, str(tmp_path / "port"))
    jax_folder.write_class_indices(c2i, str(tmp_path / "jax"))
    got = (tmp_path / "port" / "class_indices.json").read_text()
    assert got == (tmp_path / "jax" / "class_indices.json").read_text()
    assert json.loads(got) == {"0": "cat", "1": "dog", "2": "fox"}


@pytest.mark.parametrize("n,batch,rank,world", [
    (30, 16, 0, 1), (30, 8, 1, 2), (5, 8, 1, 2), (64, 64, 0, 1), (0, 4, 0, 1),
])
def test_eval_batches_match(n, batch, rank, world):
    got = sampler.eval_batches(n, batch, rank, world)
    want = jax_sampler.eval_batches(n, batch, rank, world)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_eval_preprocess_matches():
    imgs = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    want = np.asarray(jax_augment.eval_preprocess(jnp.asarray(imgs)))
    got = augment.eval_preprocess(torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 8, 3)
    # same fp32 ops in the same order; 1 ulp for XLA's fused division
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("train,seed", [(False, 0), (True, 0), (True, 7)])
@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_decode_image_matches(pil_only, tmp_path, train, seed, ext):
    arr = np.random.default_rng(seed).integers(0, 256, (45, 37, 3), dtype=np.uint8)
    path = str(tmp_path / f"img{ext}")
    Image.fromarray(arr).save(path)
    kw = dict(scale=(0.3, 1.0), ratio=(3 / 4, 4 / 3)) if train else {}
    got = loader.decode_image(path, 24, train=train, seed=seed, **kw)
    want = jax_loader.decode_image(path, 24, train=train, seed=seed, **kw)
    assert got.dtype == np.uint8 and got.shape == (24, 24, 3)
    np.testing.assert_array_equal(got, want)


def _jpeg(path, seed, size, quality, subsampling, mode="RGB"):
    """A seeded JPEG: smooth colour ramps with noise, which exercise the DCT
    (unlike flat colour) and the chroma subsampling."""
    w, h = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramps = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (w + h)], -1)
    arr = np.clip(ramps + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)
    img = Image.fromarray(arr)
    if mode != "RGB":
        img = img.convert(mode)
    img.save(path, quality=quality, subsampling=subsampling)
    return str(path)


# (width, height, quality, subsampling: 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0, mode)
JPEGS = [(45, 37, 95, 0, "RGB"), (300, 200, 75, 2, "RGB"), (131, 97, 30, 1, "RGB"),
         (500, 375, 90, 2, "RGB"), (64, 480, 85, 0, "L")]


@pytest.mark.parametrize("w,h,quality,subsampling,mode", JPEGS)
@pytest.mark.parametrize("train,seed", [(False, 0), (True, 0), (True, 7)])
def test_decode_image_native_matches_jax_native(native_both, tmp_path, w, h, quality,
                                                subsampling, mode, train, seed):
    # C2: the port's copy of the native decoder gives the JAX native path's
    # pixels bit for bit, on the train path (seeded RandomResizedCrop boxes,
    # bicubic) and the eval path (squash resize, bilinear)
    path = _jpeg(tmp_path / "img.jpg", seed, (w, h), quality, subsampling, mode)
    kw = dict(scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)) if train else {}
    for size in (24, 224):
        got = loader.decode_image(path, size, train=train, seed=seed, **kw)
        want = jax_loader.decode_image(path, size, train=train, seed=seed, **kw)
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)
    if mode == "RGB":  # the native route ran: PIL would give other pixels here
        assert loader._decode_native(path, 224, train, seed, kw.get("scale", (1.0, 1.0)),
                                     kw.get("ratio", (1.0, 1.0))) is not None


def test_native_decoder_differs_from_pil_on_jpegs(native_both, tmp_path):
    # what C2 was: on the same JPEG the native route and PIL disagree by a
    # uint8 level or two on some pixels, so the two packages must take the
    # same route
    path = _jpeg(tmp_path / "img.jpg", 3, (500, 375), 90, 2)
    native = loader.decode_image(path, 224, train=False)
    with Image.open(path) as img:
        pil = np.asarray(img.convert("RGB").resize((224, 224), Image.BILINEAR))
    diff = np.abs(native.astype(int) - pil.astype(int))
    assert 0 < diff.max() <= 2


def test_native_decoder_builds_under_build_not_beside_the_source(native_both):
    lib = native_decode.library_path()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert lib.exists() and lib.parent == native_decode.BUILD_DIR
    assert str(lib.parent) == os.path.join(root, "build", "native")
    # the name carries a hash of the source and the flags
    assert lib.name.startswith("libimgdecode-") and lib.suffix == ".so"
    assert not [f for f in os.listdir(native_decode.SRC.parent) if f.endswith(".so")]


def test_native_decoder_first_use_from_many_threads_blocks_on_the_build(monkeypatch, tmp_path):
    # the loader's thread pool meets the first build: every thread waits for
    # it and gets the library, none sees a half-initialised state and falls
    # back to PIL
    import sys
    import threading

    monkeypatch.setattr(native_decode, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_decode, "_lib", None)
    monkeypatch.setattr(native_decode, "_tried", False)
    got, barrier = [], threading.Barrier(8)

    def first_use():
        barrier.wait()
        got.append(native_decode.get_lib())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_use) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and got[0] is not None and all(g is got[0] for g in got)
    assert [p.name for p in (tmp_path / "native").iterdir()] == \
        [native_decode.library_path().name]


def test_native_decoder_build_failure_falls_back_to_pil_once(monkeypatch, tmp_path, capsys):
    # no toolchain: the error is printed once and JPEGs decode through PIL,
    # as the JAX loader's do without its library
    import subprocess

    def no_compiler(*a, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native_decode, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_decode, "_lib", None)
    monkeypatch.setattr(native_decode, "_tried", False)
    monkeypatch.setattr(subprocess, "run", no_compiler)
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    path = _jpeg(tmp_path / "img.jpg", 1, (131, 97), 75, 2)
    for train in (False, True):
        got = loader.decode_image(path, 24, train=train, seed=2)
        np.testing.assert_array_equal(got, jax_loader.decode_image(path, 24, train=train, seed=2))
    assert native_decode.get_lib() is None and "g++" in native_decode.build_error()
    assert capsys.readouterr().out.count("native decoder build failed") == 1


@pytest.mark.parametrize("w,h,seed", [(37, 45, 0), (200, 10, 1), (10, 10, 2)])
def test_rrc_params_match(w, h, seed):
    args = (w, h, (0.08, 1.0), (3 / 4, 4 / 3))
    got = loader._rrc_params(*args, loader._rng(seed))
    assert got == jax_loader._rrc_params(*args, jax_loader._rng(seed))


def test_per_class_precision_recall_matches():
    tp, fp, fn = [3, 0, 2], [1, 0, 0], [0, 0, 5]
    assert per_class_precision_recall(tp, fp, fn) == jax_pr(tp, fp, fn)


def test_port_imports_no_jax_in_subprocess(tmp_path):
    # importing the port's entry points (val, train) pulls in every module of
    # the slices; jax must stay out
    import subprocess
    import sys

    code = ("import sys, imageclassification_tpu_torch.val, imageclassification_tpu_torch.train, "
            "imageclassification_tpu_torch.engine.step, imageclassification_tpu_torch.engine.loop, "
            "imageclassification_tpu_torch.checkpoint.to_jax, "
            "imageclassification_tpu_torch.utils.loggers, imageclassification_tpu_torch.optim.ema;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('imageclassification_tpu.') or m == 'imageclassification_tpu'];"
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_native_decoder_that_does_not_load_falls_back_to_pil_once(monkeypatch, tmp_path, capsys):
    # built, but it does not load (built on another host and copied with the
    # checkout, whose libjpeg this host lacks): the load error is printed
    # once and JPEGs decode through PIL
    import ctypes

    def no_libjpeg(path, *a, **kw):
        raise OSError("libjpeg.so.62: cannot open shared object file")

    monkeypatch.setattr(native_decode, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_decode, "_lib", None)
    monkeypatch.setattr(native_decode, "_tried", False)
    monkeypatch.setattr(ctypes, "CDLL", no_libjpeg)
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    path = _jpeg(tmp_path / "img.jpg", 4, (97, 131), 85, 1)
    for train in (False, True):
        got = loader.decode_image(path, 24, train=train, seed=3)
        np.testing.assert_array_equal(got, jax_loader.decode_image(path, 24, train=train, seed=3))
    assert native_decode.get_lib() is None and "libjpeg.so.62" in native_decode.build_error()
    assert native_decode.library_path().exists()  # it built
    assert capsys.readouterr().out.count("native decoder build failed") == 1
