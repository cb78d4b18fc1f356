"""Port layer-wise lr decay (imageclassification_tpu_torch/optim/layer_decay.py)
against the JAX package's `layer_decay_scales` on the same models: every port
parameter's scale equals the JAX scale of each of its counterparts, mapped
through the weight carry (`checkpoint/to_jax.py::carry_for`), for the five
ported families at small width."""

import jax
import numpy as np
import pytest
import torch

from imageclassification_tpu.optim.layer_decay import layer_decay_scales as jax_scales
from imageclassification_tpu_torch.checkpoint.to_jax import carry_for
from imageclassification_tpu_torch.models import create_model
from imageclassification_tpu_torch.optim.layer_decay import layer_decay_scales


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _path(path):
    return "/".join(str(getattr(p, "key", p)) for p in path)


# one model of each ported family (ConvNeXt V1 and V2, whose stage 2 of six
# blocks takes two slots), small enough for a CPU test
MODELS = ["vit_tiny_patch16", "convnext_atto", "convnextv2_atto", "resnet18", "efficientvit_m0"]


@pytest.mark.parametrize("decay", [0.65, 0.75])
@pytest.mark.parametrize("name", MODELS)
def test_layer_decay_scales_match_jax(name, decay):
    model = create_model(name, num_classes=5, generator=torch.Generator().manual_seed(0))
    named = dict(model.named_parameters())
    got = dict(zip(named, layer_decay_scales(named, name, decay)))
    carry = carry_for(model)
    flat = carry.to_jax(named)
    want = {_path(p): float(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax_scales(_nest(flat), name, decay))[0]}
    assert set(want) == set(flat)
    for k, p in named.items():
        for jax_name in carry.to_jax({k: p}):
            # both compute decay ** k in double and round it to float32
            assert got[k] == want[jax_name], (k, jax_name)
    scales = set(got.values())
    assert max(scales) == 1.0 and len(scales) > 1
    if name.startswith("vit"):  # depth 12: the stem, 12 blocks, the head
        assert len(scales) == 14 and min(scales) == np.float32(decay ** 13)
