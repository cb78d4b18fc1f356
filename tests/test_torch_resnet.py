"""Port ResNet (imageclassification_tpu_torch/models/resnet.py), its BatchNorm
(models/layers.py) and its weight carry (checkpoint/from_jax.py, to_jax.py)
against the JAX package's ResNet and `torch_convert.convert_resnet`, on the
same numpy-drawn weights, batch statistics and inputs: narrow nets
(`ResNet([1, 1, 1, 1], block, width=8)`, Bottleneck, BasicBlock and a
grouped ResNeXt-style Bottleneck) at 32x32 with 3 classes, fp32."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imageclassification_tpu.checkpoint import torch_convert
from imageclassification_tpu.models import create_model as jax_create_model
from imageclassification_tpu.models import resnet as jax_resnet
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for
from imageclassification_tpu_torch.models import create_model
from imageclassification_tpu_torch.models import resnet as port_resnet
from imageclassification_tpu_torch.models.layers import (BatchNorm, batch_norm_stats,
                                                         clear_batch_stats, commit_batch_stats)
from imageclassification_tpu_torch.optim.ema import init_ema_stats

NUM_CLASSES = 3
BLOCKS = {
    "bottleneck": (jax_resnet.Bottleneck, port_resnet.Bottleneck, 8),
    "basic": (jax_resnet.BasicBlock, port_resnet.BasicBlock, 8),
    # grouped 3x3 of 16 channels in 4 groups: int(16 * 16 / 64) * 4
    "resnext": (functools.partial(jax_resnet.Bottleneck, groups=4, base_width=16),
                functools.partial(port_resnet.Bottleneck, groups=4, base_width=16), 16),
}


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


def jax_resnet_flat(model, img: int, seed: int):
    """(flat parameters, flat batch statistics) of a JAX ResNet `model` at
    `img` x `img`, drawn with numpy: conv kernels of std sqrt(1 / fan_in)
    with each output channel's kernel centred on zero, BatchNorm scales
    1 + N(0, 0.2) and biases N(0, 0.2), a head N(0, 0.05), running means
    N(0, 0.2) and variances U(0.5, 1.5). Centred kernels keep the means of
    the BatchNorm inputs small: flax takes the variance as E[x^2] - E[x]^2
    in fp32, which loses digits to cancellation when the mean is large
    against the spread (1e-5 of error on these logits with uncentred
    kernels, against 4e-6 for the port's batch norm)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, img, img, 3)))
    params = {}
    for k, s in _flatten(shapes["params"]).items():
        if k.endswith("kernel") and len(s.shape) == 4:
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            v -= v.mean(axis=(0, 1, 2), keepdims=True)
        else:
            std = 0.05 if k.startswith("head/") else 0.2
            v = std * rng.standard_normal(s.shape) + (1.0 if k.endswith("scale") else 0.0)
        params[k] = v.astype(np.float32)
    stats = {k: (rng.uniform(0.5, 1.5, s.shape) if k.endswith("var")
                 else 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
             for k, s in _flatten(shapes["batch_stats"]).items()}
    return params, stats


def models(block: str, seed: int = 0):
    """(JAX model, its flat parameters, its flat batch statistics, the port
    model carrying both) of a narrow ResNet."""
    jblock, pblock, width = BLOCKS[block]
    jmodel = jax_resnet.ResNet([1, 1, 1, 1], jblock, num_classes=NUM_CLASSES, width=width)
    pmodel = port_resnet.ResNet([1, 1, 1, 1], pblock, num_classes=NUM_CLASSES, width=width)
    params, stats = jax_resnet_flat(jmodel, 32, seed)
    sd, _, unused = carry_for(pmodel).to_port({**params, **stats})
    assert not unused
    assert set(sd) == set(pmodel.state_dict())
    pmodel.load_state_dict(sd)
    return jmodel, params, stats, pmodel


def _images(seed=0, batch=8):
    return np.random.default_rng(seed).standard_normal((batch, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_logits_match_jax(block, train):
    # fp32, the same function: summation order, the conv algorithm (the JAX
    # stem runs as its space-to-depth re-layout) and the batch variance's
    # formula differ; 1e-5 on logits of magnitude ~1
    jmodel, params, stats, pmodel = models(block)
    x = _images()
    variables = {"params": nest(params), "batch_stats": nest(stats)}
    if train:
        want, _ = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jmodel.apply(variables, jnp.asarray(x), train=False)
    want = np.asarray(want)
    got = pmodel.train(train)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (8, NUM_CLASSES) and got.dtype == np.float32
    assert np.abs(want).max() > 0.1  # the logits are not degenerate
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
def test_committed_batch_stats_match_jax(block):
    # a train-mode forward leaves the buffers alone; the step's commit moves
    # them as flax does: 0.9 * running + 0.1 * batch, with the biased batch
    # variance (fp32; 1e-5 on statistics of magnitude ~1)
    jmodel, params, stats, pmodel = models(block, seed=1)
    x = _images(seed=1)
    _, mutated = jmodel.apply({"params": nest(params), "batch_stats": nest(stats)},
                              jnp.asarray(x), train=True, mutable=["batch_stats"])
    before = {k: b.clone() for k, b in pmodel.named_buffers()}
    pmodel.train()(torch.from_numpy(x))
    for k, b in pmodel.named_buffers():
        assert torch.equal(b, before[k]), k
    commit_batch_stats(pmodel)
    assert all(m.batch_stats is None for m in pmodel.modules() if isinstance(m, BatchNorm))
    got = carry_for(pmodel).to_jax(dict(pmodel.named_buffers()))
    want = _flatten(mutated["batch_stats"])
    assert set(got) == set(want) == set(stats)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    moved = max(np.abs(got[k] - stats[k]).max() for k in stats)
    assert moved > 1e-2


def test_uncommitted_statistics_are_dropped():
    _, _, _, pmodel = models("basic", seed=2)
    before = {k: b.clone() for k, b in pmodel.named_buffers()}
    pmodel.train()(torch.from_numpy(_images(seed=2)))
    clear_batch_stats(pmodel)
    commit_batch_stats(pmodel)  # nothing to commit
    for k, b in pmodel.named_buffers():
        assert torch.equal(b, before[k]), k


def test_batch_norm_stats_are_the_batchnorm_buffers_only():
    _, _, stats, pmodel = models("basic", seed=4)
    # a buffer of another kind is not a statistic: the EMA and the
    # checkpoint's batch_stats leave it out
    pmodel.register_buffer("index_table", torch.arange(4))
    got = batch_norm_stats(pmodel)
    assert set(got) == {k for k in pmodel.state_dict()
                        if k.endswith(("running_mean", "running_var"))}
    assert got["bn1.running_mean"] is pmodel.bn1.running_mean
    assert set(carry_for(pmodel).to_jax(got)) == set(stats)
    ema = init_ema_stats(pmodel)
    assert set(ema) == set(got) and "index_table" not in ema
    assert ema["bn1.running_var"] is not pmodel.bn1.running_var
    assert batch_norm_stats(create_model("convnext_atto", num_classes=3)) == {}
    assert init_ema_stats(create_model("convnext_atto", num_classes=3)) is None


@pytest.mark.parametrize("block", list(BLOCKS))
def test_weight_carry_round_trips_exactly(block, monkeypatch):
    _, params, stats, pmodel = models(block, seed=3)
    carry = carry_for(pmodel)
    # JAX -> port -> JAX is exact, parameters and statistics apart
    back = carry.to_jax(dict(pmodel.named_parameters()))
    back_stats = carry.to_jax(dict(pmodel.named_buffers()))
    assert set(back) == set(params) and set(back_stats) == set(stats)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k], err_msg=k)
    for k in stats:
        np.testing.assert_array_equal(back_stats[k], stats[k], err_msg=k)
    # and the JAX package's own converter reads the port's state_dict
    # (torchvision names) to the same parameters and statistics; its stage
    # table is the registry's, so the narrow net's stages go in under a name
    name = "resnet18" if block == "basic" else "resnet50"
    monkeypatch.setitem(torch_convert._RESNET_STAGES, name, [1, 1, 1, 1])
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    got_params, got_stats = torch_convert.convert_resnet(sd, name)
    assert set(got_params) == set(params) and set(got_stats) == set(stats)
    for k in params:
        np.testing.assert_array_equal(got_params[k], params[k], err_msg=k)
    for k in stats:
        np.testing.assert_array_equal(got_stats[k], stats[k], err_msg=k)


class _Recording(dict):
    """A dict that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


@pytest.mark.parametrize("name", port_resnet.NAMES)
def test_every_registry_name_has_the_jax_tree(name):
    # all nine constructors, built on the meta device (no forward): the
    # state_dict holds exactly the keys torch_convert.convert_resnet reads
    # (torchvision naming), and the carry gives the JAX model's parameter
    # and batch-statistics trees (shapes do not depend on the input size)
    with torch.device("meta"):
        pmodel = create_model(name, num_classes=NUM_CLASSES)
    sd = _Recording({k: np.zeros((1,) * v.dim(), np.float32)
                     for k, v in pmodel.state_dict().items()})
    torch_convert.convert_resnet(sd, name)
    assert sd.read == set(sd)
    jmodel = jax_create_model(name, num_classes=NUM_CLASSES)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    carry = carry_for(pmodel)
    for tree, tensors in (("params", pmodel.named_parameters()),
                          ("batch_stats", pmodel.named_buffers())):
        want = {k: tuple(v.shape) for k, v in _flatten(shapes[tree]).items()}
        got = {k: v.shape for k, v in carry.to_jax(
            {k: torch.zeros(()).expand(v.shape) for k, v in tensors}).items()}
        assert got == want, tree


def test_resnet50_parameter_count():
    # torchvision resnet50 at 1000 classes: 25,557,032 parameters
    with torch.device("meta"):
        model = create_model("resnet50", num_classes=1000)
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    assert not any(k.endswith("num_batches_tracked") for k in model.state_dict())


def test_init_follows_the_jax_initializers():
    model = create_model("resnet50", num_classes=NUM_CLASSES,
                         generator=torch.Generator().manual_seed(0))
    assert torch.count_nonzero(model.fc.weight) == 0 and torch.count_nonzero(model.fc.bias) == 0
    for stage in model.stages():
        for blk in stage:
            assert torch.count_nonzero(blk.bn3.weight) == 0  # zero-init last BN scale
            assert torch.equal(blk.bn1.weight, torch.ones_like(blk.bn1.weight))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            assert torch.count_nonzero(m.running_mean) == 0
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))
    # he_normal: std sqrt(2 / fan_in) after truncation (flax draws a unit
    # normal truncated to [-2, 2] and divides by its std, 0.8796)
    w = model.layer3[0].conv2.weight
    std = (2.0 / w[0].numel()) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 * std / 0.87962566 * 1.0001


def test_bf16_model_keeps_an_fp32_head_and_fp32_statistics():
    # the JAX head is nn.Dense(dtype=float32) even in a bf16 model; BatchNorm
    # parameters and statistics stay fp32
    model = create_model("resnet18", num_classes=NUM_CLASSES, half_precision=True)
    out = model.train()(torch.from_numpy(_images(batch=2)))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    commit_batch_stats(model)
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    assert torch.isfinite(model.eval()(torch.from_numpy(_images(batch=2)))).all()


def test_registry_builds_resnets_and_gives_no_extra_kwargs():
    from imageclassification_tpu_torch.config import TrainConfig
    from imageclassification_tpu_torch.models import list_models, model_kwargs_for

    assert set(port_resnet.NAMES) <= set(list_models())
    args = TrainConfig(model="wide_resnet50_2", drop_path=0.3)
    assert model_kwargs_for(args, 7) == {"pretrained": args.pretrained, "num_classes": 7}
