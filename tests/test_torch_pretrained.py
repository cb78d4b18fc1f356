"""Fine-tuning from pretrained weights in the port
(imageclassification_tpu_torch/checkpoint/torch_convert.py and
train.py's --pretrained_path) against the JAX package's
`checkpoint/torch_convert.py` and train.py on the same files: torch/timm
state_dicts written from the port's own seeded models (ViT-Ti, ConvNeXt-atto
in timm and facebookresearch naming, ConvNeXt-V2-atto, ResNet-18 with
running statistics, EfficientViT-M0 in microsoft/Cream's layout), each as a
torch zip, in a pickled {"model": ...} container and under a `module.`
prefix; the bicubic pos_embed resample; and both packages' train.main
loading one ViT state_dict at another --input_size. fp32 throughout."""

import pickle
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import jax_draws
from imageclassification_tpu.checkpoint import torch_convert as jax_convert
from imageclassification_tpu_torch.checkpoint import torch_convert as port_convert
from imageclassification_tpu_torch.models import create_model


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(model: torch.nn.Module, seed: int):
    """The model's state_dict with every tensor drawn anew from numpy
    (N(0, 1) floats, running variances U(0.5, 1.5)), so no zero-initialised
    tensor hides a mix-up."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        a = (rng.uniform(0.5, 1.5, v.shape) if k.endswith("running_var")
             else rng.standard_normal(v.shape))
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


_FB_BLOCK = {"conv_dw": "dwconv", "norm": "norm", "mlp.fc1": "pwconv1",
             "mlp.fc2": "pwconv2", "gamma": "gamma"}


def _facebook_naming(sd):
    """The port's (timm-named) ConvNeXt state_dict in facebookresearch's
    naming: downsample_layers, stages.{s}.{b}.<dwconv|norm|pwconv1|
    pwconv2|gamma|grn>, norm, head (GRN stored [1, 1, 1, 4C])."""
    out = {}
    for k, v in sd.items():
        if (m := re.fullmatch(r"stem\.([01])\.(\w+)", k)):
            out[f"downsample_layers.0.{m[1]}.{m[2]}"] = v
        elif (m := re.fullmatch(r"stages\.(\d)\.downsample\.([01])\.(\w+)", k)):
            out[f"downsample_layers.{m[1]}.{m[2]}.{m[3]}"] = v
        elif (m := re.fullmatch(r"stages\.(\d)\.blocks\.(\d+)\.mlp\.grn\.(weight|bias)", k)):
            leaf = "gamma" if m[3] == "weight" else "beta"
            out[f"stages.{m[1]}.{m[2]}.grn.{leaf}"] = v.reshape(1, 1, 1, -1)
        elif (m := re.fullmatch(r"stages\.(\d)\.blocks\.(\d+)\.(.+)\.(weight|bias)", k)):
            out[f"stages.{m[1]}.{m[2]}.{_FB_BLOCK[m[3]]}.{m[4]}"] = v
        elif (m := re.fullmatch(r"stages\.(\d)\.blocks\.(\d+)\.gamma", k)):
            out[f"stages.{m[1]}.{m[2]}.gamma"] = v
        elif k.startswith("head.norm."):
            out["norm." + k.split(".")[-1]] = v
        elif k.startswith("head.fc."):
            out["head." + k.split(".")[-1]] = v
        else:
            raise KeyError(k)
    return out


def _cream_layout(sd):
    """The port's EfficientViT state_dict as a microsoft/Cream hub file holds
    it: the same keys plus each attention's `attention_bias_idxs` buffer and
    each BatchNorm's `num_batches_tracked`, which the conversion ignores."""
    out = dict(sd)
    for k in sd:
        if k.endswith("attention_biases"):
            out[k.replace("attention_biases", "attention_bias_idxs")] = torch.zeros(
                49, 49, dtype=torch.int64)
        if k.endswith("running_var"):
            out[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    return out


# family: (registry name, state_dict of the port's seeded model in the
# family's hub layout)
FAMILIES = {
    "vit_tiny": ("vit_tiny_patch16", lambda: _seeded(create_model("vit_tiny_patch16"), 0)),
    "convnext_atto_timm": ("convnext_atto", lambda: _seeded(create_model("convnext_atto"), 1)),
    "convnext_atto_fb": ("convnext_atto",
                         lambda: _facebook_naming(_seeded(create_model("convnext_atto"), 2))),
    "convnextv2_atto_timm": ("convnextv2_atto",
                             lambda: _seeded(create_model("convnextv2_atto"), 3)),
    "convnextv2_atto_fb": ("convnextv2_atto",
                           lambda: _facebook_naming(_seeded(create_model("convnextv2_atto"), 4))),
    "resnet18": ("resnet18", lambda: _seeded(create_model("resnet18"), 5)),
    "efficientvit_m0_cream": ("efficientvit_m0",
                              lambda: _cream_layout(_seeded(create_model("efficientvit_m0"), 6))),
}


def _write(path, sd, form: str):
    """Write `sd` as a torch zip ("zip"), a torch zip of a {"state_dict":
    ...} container under a DataParallel `module.` prefix ("zip_module"), a
    pickled {"model": numpy arrays} ("pickle_model") or a pickled {"model":
    tensors} under the prefix ("pickle_model_module")."""
    prefixed = {f"module.{k}": v for k, v in sd.items()}
    if form == "zip":
        torch.save(sd, path)
    elif form == "zip_module":
        torch.save({"state_dict": prefixed, "epoch": 3}, path)
    else:
        inner = ({k: v.numpy() for k, v in sd.items()} if form == "pickle_model"
                 else prefixed)
        with open(path, "wb") as f:
            pickle.dump({"model": inner}, f)
    return str(path)


def _assert_same_flat(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("form", ["zip", "zip_module", "pickle_model", "pickle_model_module"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_same_file_through_both_loaders(tmp_path, family, form):
    # exact: both are the same numpy re-layouts of the same arrays
    name, make = FAMILIES[family]
    sd = make()
    path = _write(tmp_path / "pretrained.pth", sd, form)
    want = jax_convert.load_pretrained_flat(path, name)
    got = port_convert.load_pretrained_flat(path, name)
    _assert_same_flat(got["model"], want["model"], "model")
    _assert_same_flat(got["batch_stats"], want["batch_stats"], "batch_stats")
    assert len(got["model"]) > 40
    assert bool(got["batch_stats"]) == (family.startswith(("resnet", "efficientvit")))
    if family.startswith("convnextv2"):
        assert "stage0_block0/GRN_0/gamma" in got["model"]


def test_repo_checkpoint_and_converted_file_through_both_loaders(tmp_path, capsys):
    # convert_torch_checkpoint writes the same checkpoint in both packages;
    # each loader takes it as a checkpoint of this project (no conversion)
    sd = FAMILIES["resnet18"][1]()
    src = _write(tmp_path / "resnet18.pth", sd, "zip")
    outs = {}
    for pkg, conv in (("jax", jax_convert), ("port", port_convert)):
        out = conv.convert_torch_checkpoint(src, "resnet18", str(tmp_path / f"{pkg}.pth"),
                                            num_classes=None)
        with open(out, "rb") as f:
            outs[pkg] = pickle.load(f)
    assert outs["port"]["num_classes"] == outs["jax"]["num_classes"] == 1000
    assert outs["port"]["model_spec"] == outs["jax"]["model_spec"]
    for tree in ("model", "batch_stats"):
        _assert_same_flat(outs["port"][tree], outs["jax"][tree], tree)
    capsys.readouterr()
    got = port_convert.load_pretrained_flat(str(tmp_path / "port.pth"), "resnet18")
    want = jax_convert.load_pretrained_flat(str(tmp_path / "port.pth"), "resnet18")
    assert "Converted torch state_dict" not in capsys.readouterr().out
    for tree in ("model", "batch_stats"):
        _assert_same_flat(got[tree], want[tree], tree)


@pytest.mark.parametrize("name,item", [("swin_tiny", "A14"), ("mobilenetv3_large_100", "A15"),
                                       ("mobilenet_v3_small", "A15"), ("efficientnet_b0", "A15"),
                                       ("densenet121", "A15")])
def test_unported_family_names_its_roadmap_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        port_convert.convert_state_dict({"x.weight": np.zeros(2)}, name)


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="no torch converter"):
        port_convert.convert_state_dict({"x.weight": np.zeros(2)}, "lenet5")


def _pos(grid: int, d: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, grid * grid + 1, d)).astype(np.float32)


# 14 -> 64: ViT-B/16's 224x224 grid fine-tuned at 1024x1024 (N = 4097)
@pytest.mark.parametrize("src,dst", [(14, 24), (14, 7), (24, 14), (7, 14), (14, 64)])
def test_resample_pos_embed_matches_jax(src, dst, capsys):
    # the same Keys cubic (a = -0.5) with border renormalisation, at ViT-B's
    # width D = 768: fp32 rounding only, 1e-5 on values of magnitude ~1
    d = 768
    flat = {"pos_embed": _pos(src, d), "cls_token": np.ones((1, 1, d), np.float32)}
    target = {"pos_embed": np.zeros((1, dst * dst + 1, d), np.float32)}
    want = jax_convert.resample_pos_embed(flat, target)
    got = port_convert.resample_pos_embed(flat, target)
    out = capsys.readouterr().out
    assert out.count(f"Resized pos_embed grid {src}x{src} -> {dst}x{dst}") == 2
    assert got["pos_embed"].shape == want["pos_embed"].shape == (1, dst * dst + 1, d)
    assert got["pos_embed"].dtype == np.float32
    np.testing.assert_array_equal(got["pos_embed"][:, 0], flat["pos_embed"][:, 0])  # cls token
    np.testing.assert_allclose(got["pos_embed"], want["pos_embed"], atol=1e-5, rtol=0)
    assert got["cls_token"] is flat["cls_token"] and flat["pos_embed"].shape[1] == src * src + 1


def test_resample_pos_embed_without_antialias_is_another_function():
    # torch's non-antialiased bicubic (a = -0.75, clamped indices) is not
    # JAX's resize: the test above would catch the flag going missing
    flat = {"pos_embed": _pos(14)}
    want = jax_convert.resample_pos_embed(flat, {"pos_embed": np.zeros((1, 577, 32))})
    grid = torch.from_numpy(flat["pos_embed"][:, 1:]).reshape(1, 14, 14, 32).permute(0, 3, 1, 2)
    plain = torch.nn.functional.interpolate(grid, size=(24, 24), mode="bicubic",
                                            align_corners=False)
    plain = plain.permute(0, 2, 3, 1).reshape(1, 576, 32).numpy()
    assert np.abs(plain - want["pos_embed"][:, 1:]).max() > 1e-2


@pytest.mark.parametrize("src_tokens,dst_tokens,width", [
    (197, 197, 32),      # equal shapes: the same dict back
    (1 + 14 * 15, 577, 32),  # a non-square source grid
    (197, 1 + 24 * 25, 32),  # a non-square target grid
    (197, 577, 48),      # another width
])
def test_resample_pos_embed_leaves_other_shapes_alone(src_tokens, dst_tokens, width, capsys):
    flat = {"pos_embed": np.zeros((1, src_tokens, 32), np.float32)}
    target = {"pos_embed": np.zeros((1, dst_tokens, width), np.float32)}
    assert port_convert.resample_pos_embed(flat, target) is flat
    assert jax_convert.resample_pos_embed(flat, target) is flat
    assert port_convert.resample_pos_embed({"cls_token": 1}, target) == {"cls_token": 1}
    assert "Resized" not in capsys.readouterr().out


# both train.main: vit_small_patch32 trained at 64x64 (a 2x2 grid) fine-tuned
# at 96x96 (3x3), --flash_attn true (the JAX side's Pallas kernels in
# interpret mode, the port's plain version), fp32, no drop path (the JAX and
# torch drop-path draws cannot be made equal), batch 8
FINE_TUNE = ["--model", "vit_small_patch32", "--flash_attn", "true", "--input_size", "96",
             "--batch_size", "8", "--epochs", "1", "--warmup_epochs", "1",
             "--half_precision", "false", "--drop_path", "0", "--num_workers", "2"]


class _Stop(Exception):
    pass


def _first_epoch_of(main, module, monkeypatch, args):
    """Run `main(args)` of a train module up to its first epoch: its
    train_one_epoch records the step and the state it is given and stops
    the run. Returns (train step, state)."""
    seen = {}

    def stop(train_step, state, *a, **kw):
        seen.update(step=train_step, state=state)
        raise _Stop

    monkeypatch.setattr(module, "train_one_epoch", stop)
    with pytest.raises(_Stop):
        main(args)
    return seen["step"], seen["state"]


def test_train_main_of_both_packages_fine_tunes_from_one_state_dict(
        toy_dataset, tmp_path, monkeypatch, capsys):
    # the same file at another --input_size: the parameters after the load
    # agree to 1e-6 (the pos_embed resample's fp32 rounding; every other
    # tensor exactly), and so does the first step's loss to 1e-5 relative
    # (fp32, summation order) on the same batch and draws
    import jax.experimental.pallas as pl

    import train as jax_train
    from imageclassification_tpu.config import parse_args as jax_parse_args
    from imageclassification_tpu.data.mixup import build_mixup as jax_build_mixup
    from imageclassification_tpu_torch import train as port_train
    from imageclassification_tpu_torch.checkpoint.to_jax import carry_for

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    src = create_model("vit_small_patch32", num_classes=3, img_size=64,
                       generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        src.head.weight.normal_(0, 0.1, generator=torch.Generator().manual_seed(4))
        src.pos_embed.normal_(0, 0.5, generator=torch.Generator().manual_seed(5))
    path = _write(tmp_path / "vit_s32_64.pth", src.state_dict(), "zip")
    flags = FINE_TUNE + ["--data_path", toy_dataset, "--pretrained_path", path]

    jargs = jax_parse_args(flags + ["--output_dir", str(tmp_path / "jax" / "out"),
                                    "--log_dir", str(tmp_path / "jax" / "log"),
                                    "--device", "cpu"])
    jstep, jstate = _first_epoch_of(jax_train.main, jax_train, monkeypatch, jargs)
    pargs = port_train.parse_args(flags + ["--output_dir", str(tmp_path / "port" / "out"),
                                           "--log_dir", str(tmp_path / "port" / "log"),
                                           "--device", "cpu"])
    pstep, pstate = _first_epoch_of(port_train.main, port_train, monkeypatch, pargs)
    out = capsys.readouterr().out
    assert out.count("Resized pos_embed grid 2x2 -> 3x3") == 2
    assert out.count("Converted torch state_dict") == 2

    want = {"/".join(p.key for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    got = carry_for(pstate.model).to_jax(dict(pstate.model.named_parameters()))
    source = carry_for(src).to_jax(dict(src.named_parameters()))
    assert set(got) == set(want) == set(source)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
        if k != "pos_embed":
            np.testing.assert_array_equal(got[k], source[k], err_msg=k)
    assert got["pos_embed"].shape == (1, 10, 384)
    np.testing.assert_array_equal(got["pos_embed"][:, 0], source["pos_embed"][:, 0])

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (8, 96, 96, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, 8)
    base_rng = jax.random.key(jargs.seed)
    _, jm = jstep(jstate, {"image": jnp.asarray(images),
                           "label": jnp.asarray(labels, jnp.int32)}, base_rng)
    draws = jax_draws.step_draws(base_rng, 0, 8, 96, 96, jargs, jax_build_mixup(jargs, 3))
    pm = pstep(pstate, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)},
               draws)
    assert abs(float(jm["loss"]) - np.log(3)) > 1e-3  # the loaded weights decide the loss
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)


def test_train_main_loads_batch_stats_and_reseeds_the_ema(toy_dataset, tmp_path, capsys):
    # an EfficientViT-M0 file in Cream's layout through --pretrained_path:
    # parameters and running statistics as the file holds them (exactly),
    # and the EMA of both restarts from them
    from imageclassification_tpu_torch import train as port_train
    from imageclassification_tpu_torch.models.layers import batch_norm_stats

    src = create_model("efficientvit_m0", num_classes=3, img_size=64)
    sd = _cream_layout(_seeded(src, 7))
    path = _write(tmp_path / "evit_m0.pth", sd, "zip_module")
    args = port_train.parse_args([
        "--data_path", toy_dataset, "--input_size", "64", "--batch_size", "4", "--epochs", "1",
        "--warmup_epochs", "1", "--num_workers", "2", "--model_ema", "true", "--device", "cpu",
        "--pretrained_path", path, "--output_dir", str(tmp_path / "out"),
        "--log_dir", str(tmp_path / "log")])
    seen = {}

    def stop(train_step, state, *a, **kw):
        seen["state"] = state
        raise _Stop

    port_train.train_one_epoch, keep = stop, port_train.train_one_epoch
    try:
        with pytest.raises(_Stop):
            port_train.main(args)
    finally:
        port_train.train_one_epoch = keep
    out = capsys.readouterr().out
    assert "Skipping mismatched key" not in out and "Loaded pretrained weights" in out
    state = seen["state"]
    got = state.model.state_dict()
    assert set(got) == {k for k in sd if not k.endswith(("attention_bias_idxs",
                                                          "num_batches_tracked"))}
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k
    for k, v in state.ema.items():
        assert torch.equal(v, sd[k]) and v is not got[k], k
    assert set(state.ema_stats) == set(batch_norm_stats(state.model))
    for k, v in state.ema_stats.items():
        assert torch.equal(v, sd[k]), k


def test_chip_smoke_finetune_rehearsal_on_cpu(tmp_path):
    # chip_smoke.py's phase 8 at a tiny size on the CPU (plain attention, no
    # kernel launches): a 1000-class vit_tiny_patch16 file at 32x32 fine-
    # tuned at 48x48 (2x2 -> 3x3), its load checks, 2 epochs and serving
    model = dict(name="vit_tiny_patch16", dim=192, depth=12, heads=3, patch=16)
    cfg = dict(name="vit_tiny_patch16", src_img=32, img=48, batch=4)
    run = chip_smoke.run_finetune(str(tmp_path), "cpu", model, cfg, num_classes=3,
                                  per_class=10, epochs=2)
    assert run["resized"] == "Resized pos_embed grid 2x2 -> 3x3"
    assert run["skipped"] == ["head/bias", "head/kernel"]
    assert run["pos_err"] <= chip_smoke.POS_EMBED_ATOL
    assert len(run["records"]) == 2 * run["steps_per_epoch"] == 12
    assert run["input_shape"] == [1, 48, 48, 3] and run["serve_launches"] == 0
    assert run["totals"] == {"fwd": 0, "fwd_lse": 0, "bwd_dkv": 0, "bwd_dq": 0}


def test_chip_smoke_hires_rehearsal_on_cpu(tmp_path):
    # chip_smoke.py's phase 10 at a tiny size on the CPU (plain attention, no
    # kernel launches): a 1000-class vit_tiny_patch16 file at 32x32
    # fine-tuned at 64x64 (2x2 -> 4x4) with --layer_decay 0.65 and --remat,
    # fed JPEGs, 2 epochs and serving
    model = dict(name="vit_tiny_patch16", dim=192, depth=12, heads=3, patch=16)
    cfg = dict(chip_smoke.HIRES, name="vit_tiny_patch16", src_img=32, img=64, batch=4)
    images = chip_smoke.write_jpeg_folder(str(tmp_path / "jpegs"), np.random.default_rng(3), 3,
                                          10, (80, 60))
    assert "30 JPEGs" in chip_smoke.feed_note(images)
    run = chip_smoke.run_finetune(str(tmp_path), "cpu", model, cfg, num_classes=3,
                                  per_class=10, epochs=2, images=images)
    assert run["resized"] == "Resized pos_embed grid 2x2 -> 4x4"
    assert run["skipped"] == ["head/bias", "head/kernel"]
    assert run["args"].remat and run["args"].layer_decay == 0.65
    assert len(run["state"].optimizer.groups) == 14  # the stem, 12 blocks, the head
    assert len(run["records"]) == 2 * run["steps_per_epoch"] == 12
    assert run["input_shape"] == [1, 64, 64, 3] and run["serve_launches"] == 0
    assert run["totals"] == {"fwd": 0, "fwd_lse": 0, "bwd_dkv": 0, "bwd_dq": 0}
    assert chip_smoke.flash_step_pattern(2, remat=True) == \
        ["fwd"] * 4 + ["dq", "dkv"] * 2 + ["fwd"] * 2
