"""Port visualization (imageclassification_tpu_torch/visualize.py) against
the JAX package's visualize.py on the same seeded checkpoints and images:
the automatic Grad-CAM layer (named by its JAX path), the Grad-CAM maps and
probabilities, the feature maps, the summary's parameter count, and the CLI.
Both sides compute in fp32 on the CPU."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import visualize as jax_viz
from imageclassification_tpu_torch import val as port_val
from imageclassification_tpu_torch import visualize as port_viz

sys.path.insert(0, os.path.dirname(__file__))

from jax_ckpt import seeded_checkpoint  # noqa: E402

IMG = 64  # the JAX test's size: every family keeps a >1x1 map at its last stage
NUM_CLASSES = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(tmp_path, name, img=IMG):
    """(JAX model, variables), the port model (fp32, frozen) of one seeded
    checkpoint."""
    import val as jax_val

    ck = seeded_checkpoint(tmp_path / f"{name}.pth", name, img, NUM_CLASSES)
    jm, params, bs, _ = jax_val.initialize_model(ck, False, half_precision=False)
    variables = {"params": params, **({"batch_stats": bs} if bs else {})}
    pm, _ = port_val.initialize_model(ck, False, half_precision=False, device="cpu")
    return jm, variables, pm.requires_grad_(False), ck


# the JAX test's families and the layer each picks (tests/test_visualize.py)
FAMILIES = [
    ("resnet18", "BasicBlock_7"),
    ("convnext_atto", "stage3_block1"),
    ("efficientvit_m0", "sub2_merge/ConvBN_0"),
    ("vit_tiny_patch16", "block11/LayerNorm_0"),
    ("mobilenet_v3_small", "bn_last"),
    ("densenet121", "norm5"),
]
# fp32 on both sides: the probabilities to 1e-5; the maps, min-max
# normalised to [0, 1], to 1e-4 (fp32 sums over the channels of the
# activation and its gradient, in another order in each package)
PROBS_ATOL = 1e-5
CAM_ATOL = 1e-4


@pytest.mark.parametrize("name,layer", FAMILIES)
def test_gradcam_and_its_layer_match_jax(tmp_path, name, layer):
    jm, variables, pm, _ = _both(tmp_path, name)
    x0 = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    jax_order = jax_viz.module_call_order(jm, variables, x0)
    assert jax_viz.pick_cam_layer(jax_order) == layer
    got_layer, module, shape = port_viz.resolve_layer(pm, IMG)
    assert got_layer == layer
    assert shape == dict(jax_order)[layer]
    batch = 2
    images = np.random.default_rng(0).integers(0, 256, (batch, IMG, IMG, 3), dtype=np.uint8)
    fn = jax_viz.make_gradcam_fn(jm, layer, (batch,) + shape[1:], IMG)
    port_fn = port_viz.make_gradcam_fn(pm, module, IMG)
    for cls in (-1, 1):
        jp, jc = fn(variables["params"], variables.get("batch_stats", {}), jnp.asarray(images),
                    jnp.int32(cls))
        pp, pc = port_fn(torch.from_numpy(images), cls)
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=PROBS_ATOL, rtol=0)
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=CAM_ATOL, rtol=0)


def test_layer_flag_takes_a_jax_path(tmp_path):
    _, _, pm, _ = _both(tmp_path, "resnet18")
    layer, module, shape = port_viz.resolve_layer(pm, IMG, "BasicBlock_5")
    assert module is pm.get_submodule("layer3.1") and shape == (1, 4, 4, 256)
    with pytest.raises(SystemExit, match="unknown --layer 'layer3.1'"):
        port_viz.resolve_layer(pm, IMG, "layer3.1")


def test_feature_maps_match_jax(tmp_path):
    import flax.linen as nn
    from imageclassification_tpu.data.augment import eval_preprocess

    jm, variables, pm, _ = _both(tmp_path, "convnext_atto")
    img = np.random.default_rng(2).integers(0, 256, (1, IMG, IMG, 3), dtype=np.uint8)
    acts = {}

    def interceptor(next_fun, args, kwargs, context):
        # the JAX CLI's feature interceptor (visualize.py run_features)
        out = next_fun(*args, **kwargs)
        path = "/".join(str(p) for p in context.module.path)
        if (context.method_name == "__call__" and hasattr(out, "ndim") and out.ndim == 4
                and "/" not in path and out.shape[1] > 1):
            acts[path] = out
        return out

    with nn.intercept_methods(interceptor):
        jm.apply(variables, eval_preprocess(jnp.asarray(img)), train=False)
    got = port_viz.feature_maps(pm, torch.from_numpy(img))
    assert list(got) == list(acts)
    for k, v in acts.items():
        ref = np.linalg.norm(np.asarray(v, np.float32), axis=-1)[0]
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=1e-4, atol=1e-4)


SUMMARY_FAMILIES = ["resnet18", "convnext_atto", "efficientvit_m0", "vit_tiny_patch16",
                    "mobilenet_v3_small", "densenet121", "efficientnet_b0", "swin_tiny"]


@pytest.mark.parametrize("name", SUMMARY_FAMILIES)
def test_summary_counts_the_jax_parameters(name):
    import jax

    from imageclassification_tpu.models import create_model as jax_create
    from imageclassification_tpu_torch.models import create_model

    img = 224 if name.startswith("swin") else 32
    jm = jax_create(name, num_classes=5, half_precision=False)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        jnp.zeros((1, img, img, 3), jnp.float32), train=False))
    want = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes["params"]))
    res = port_viz.summary(create_model(name, num_classes=5, img_size=img).eval(), img)
    assert res["params"] == want
    assert res["flops"] > 0 and res["peak_bytes"] is None  # no device memory on the CPU


def test_gradcam_and_summary_cli(tmp_path, capsys):
    from PIL import Image

    ck = seeded_checkpoint(tmp_path / "resnet18.pth", "resnet18", 32, NUM_CLASSES)
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(d / f"x{i}.jpg")
    out_dir = tmp_path / "viz"
    port_viz.main(["--mode", "gradcam", "--model_weight_path", ck, "--img_path", str(d),
                   "--img_size", "32", "--batch_size", "2", "--out_dir", str(out_dir),
                   "--device", "cpu"])
    pngs = sorted(os.listdir(out_dir))
    assert len(pngs) == 3 and all(p.endswith(".png") for p in pngs)
    # as the JAX CLI test: at 32 px the last two blocks are 1x1 maps
    assert "Grad-CAM layer: BasicBlock_5" in capsys.readouterr().out
    port_viz.main(["--mode", "summary", "--model", "resnet18", "--num_classes", "5",
                   "--img_size", "32", "--model_weight_path", str(tmp_path / "missing.pth"),
                   "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "number of params:" in printed and "GFLOPs" in printed


def test_flash_checkpoint_loads_in_fp32_on_the_card(tmp_path, monkeypatch, capsys):
    # as the JAX CLI (half_precision=False for every model): a --flash_attn
    # checkpoint asked for on the card is built in fp32, whose attention
    # runs the fp32 flash-attention kernels there; initialize_model is
    # stubbed here (no card), so what _load asks of it is what is checked
    ck = seeded_checkpoint(tmp_path / "vit.pth", "vit_tiny_patch16", 32, NUM_CLASSES,
                           flash_attn=True)
    seen, initialize = {}, port_val.initialize_model

    def fake_initialize(path, model_ema, half_precision=True, dequantize=False, device="cuda"):
        seen.update(path=path, half_precision=half_precision, device=device)
        return initialize(path, model_ema, half_precision=half_precision,
                          dequantize=dequantize, device="cpu")

    monkeypatch.setattr(port_val, "initialize_model", fake_initialize)
    args = SimpleNamespace(model_weight_path=ck, model_ema=False, device="cuda")
    model, num_classes = port_viz._load(args, dequantize=True)
    assert seen == {"path": ck, "half_precision": False, "device": "cuda"}
    assert num_classes == NUM_CLASSES and model.flash_attn
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.dtype == torch.float32 and "bf16" not in capsys.readouterr().out
