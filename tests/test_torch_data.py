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
from imageclassification_tpu_torch.data import augment, folder, loader, sampler
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
    # the JAX decoder routes JPEGs through its native libjpeg build when it
    # exists; the port decodes through PIL, so compare PIL with PIL
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)


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
