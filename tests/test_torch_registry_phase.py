"""chip_smoke.py's phase 13 rehearsed on the CPU (`--device cpu`, small
inputs, so the kernels' plain versions run): the rest of the optimizer table
and of the model registry through `train.main`, each checkpoint in the JAX
layout, reloaded and served; and a resume of a new family with a new
optimizer, its optax-layout state carried through the checkpoint."""

import numpy as np
import pytest
import torch

import chip_smoke
from imageclassification_tpu_torch import config, train

VIT_TI = dict(name="vit_tiny_patch16", dim=192, depth=12, heads=3, patch=16)
CONVNEXT_ATTO = dict(name="convnext_atto", depths=(2, 2, 6, 2), dims=(40, 80, 160, 320))
CFG = dict(img=32, batch=4, epochs=1, num_classes=3, per_class=6)


@pytest.fixture(autouse=True)
def few_torch_threads():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_phase13_optimizers_rehearsal_on_cpu(tmp_path):
    # 13a and 13b at a tiny size: nvnovograd and adafactor on a ViT with
    # --flash_attn (no kernel launched on the CPU), adahessian on ConvNeXt,
    # the refusal of adahessian with --flash_attn
    images = chip_smoke._train_images(str(tmp_path), CFG["num_classes"], CFG["per_class"], 0)
    opts = chip_smoke.optimizer_rest_runs(str(tmp_path / "opt"), "cpu", VIT_TI, CFG, images)
    assert set(opts) == set(chip_smoke.NEW_OPTS)
    for row in opts.values():
        assert not any(row["totals"].values())
        assert len(row["losses"]) == 3 and np.isfinite(row["losses"]).all()
    ah = chip_smoke.adahessian_run(str(tmp_path / "ah"), "cpu", CONVNEXT_ATTO, CFG, images)
    assert len(ah["losses"]) == 3 and np.isfinite(ah["losses"]).all()
    assert "cannot differentiate its flash attention twice" in ah["refused"]


def test_phase13_families_rehearsal_on_cpu(tmp_path, capsys):
    # 13c at a tiny size: MobileNetV3-Large, EfficientNet-B0 and DenseNet-121
    # at full width on 32x32 inputs, Swin-T (224x224, the smallest size its
    # windows take) from a seeded timm-layout state_dict
    images = chip_smoke._train_images(str(tmp_path), CFG["num_classes"], CFG["per_class"], 0)
    small = [n for n in chip_smoke.NEW_FAMILIES if not n.startswith("swin")]
    rows = chip_smoke.family_runs(str(tmp_path / "fam"), "cpu", CFG, images, small)
    assert list(rows) == small
    for row in rows.values():
        assert len(row["losses"]) == 3 and np.isfinite(row["losses"]).all()
    swin_cfg = dict(CFG, img=224, batch=2, per_class=2)
    swin_images = chip_smoke._train_images(str(tmp_path / "swin"), 3, 2, 1)
    rows = chip_smoke.family_runs(str(tmp_path / "swin"), "cpu", swin_cfg, swin_images,
                                  ["swin_tiny"])
    assert rows["swin_tiny"]["losses"] and np.isfinite(rows["swin_tiny"]["losses"]).all()
    printed = capsys.readouterr().out
    assert "Converted torch state_dict" in printed and "Skipping mismatched key" in printed


def test_new_family_with_new_optimizer_resumes(toy_dataset, tmp_path, capsys):
    # train.main of mobilenetv3_small_100 with --opt adafactor and the EMA
    # for one epoch, then resumed for a second: the optax-layout state, the
    # EMA and the statistics come back ("With optim & sched!") and the run
    # goes on with finite losses
    out = tmp_path / "train_cls" / "output"
    argv = ["--device", "cpu", "--data_path", toy_dataset, "--model", "mobilenetv3_small_100",
            "--input_size", "32", "--batch_size", "4", "--warmup_epochs", "1",
            "--num_workers", "2", "--opt", "adafactor", "--model_ema", "true",
            "--output_dir", str(out), "--log_dir", str(tmp_path / "train_cls" / "log_dir")]
    first = train.main(config.parse_args(argv + ["--epochs", "1"]))
    n = first.optimizer.num_updates
    assert n > 0
    second = train.main(config.parse_args(argv + ["--epochs", "2"]))
    printed = capsys.readouterr().out
    assert "With optim & sched!" in printed
    assert second.optimizer.num_updates == 2 * n
    assert (out / "checkpoint-1.pth").exists()
