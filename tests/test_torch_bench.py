"""The port's training-throughput bench (imageclassification_tpu_torch/
bench.py): its JSON line from a tiny CPU run, and its roofline with the
H100's peaks. The numbers of a CPU run are CPU times, never a device
metric; the bench on the card runs in chip_smoke.py phase 7c."""

import functools
import json

import pytest
import torch

from imageclassification_tpu_torch import bench


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_main_prints_one_json_line_on_cpu(capsys, monkeypatch):
    # one timed step: a ResNet-50 step takes about half a second on one CPU thread
    monkeypatch.setattr(bench, "run", functools.partial(bench.run, warmup=1, iters=1, reps=1))
    out = bench.main(["--device", "cpu", "--batch", "2", "--size", "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert line == out
    assert line["metric"] == "resnet50_train_images_per_sec_per_chip"
    assert line["unit"] == "images/sec" and line["value"] > 0 and line["ms_per_step"] > 0
    # no roofline share at 32x32, and none from the CPU
    assert line["vs_baseline"] is None and line["device"] == "cpu"


def test_bench_refuses_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--batch", "2", "--size", "32"])


def test_roofline_is_bench_py_formula_with_h100_peaks():
    # bench.py's composite roofline at batch 128: four forward-equivalents of
    # 8.2 GFLOP an image over 989 TFLOP/s against 7 activation passes of
    # 22.8 MB an image, 8 passes over the fp32 parameters and the input over
    # 3.35 TB/s; the memory term binds
    t_flops = 128 * 4 * 8.2e9 / 989e12
    t_bytes = (7 * 22.8e6 * 128 + 8 * 25.6e6 * 4 + 224 * 224 * 3 * 9 * 128) / 3.35e12
    assert t_bytes > t_flops
    assert bench.roofline_img_s(128) == pytest.approx(128 / t_bytes, rel=1e-12)
    assert bench.TARGET_IMG_S == pytest.approx(0.9 * 128 / t_bytes, rel=1e-12)
