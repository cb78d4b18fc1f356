"""A seeded checkpoint of any model of the JAX registry, in the layout the
JAX train.py writes, for tests that hand the same file to both packages.
Every array is drawn with numpy from one seed (JAX only gives the shapes):
kernels and biases N(0, 0.05), LayerNorm / BatchNorm scales 1 + N(0, 0.1),
BatchNorm variances U(0.5, 1.5)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np

from imageclassification_tpu.models import create_model


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)


def seeded_checkpoint(path, name: str, img: int, num_classes: int, seed: int = 0,
                      ema: bool = False, **kwargs) -> str:
    """Write the checkpoint of `name` (constructor kwargs `kwargs`) at
    img x img to `path`; with `ema`, a second draw under "model_ema" (and
    the batch statistics under "model_ema_batch_stats"). Returns `path`."""
    model = create_model(name, num_classes=num_classes, half_precision=False, **kwargs)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        jnp.zeros((1, img, img, 3), jnp.float32), train=False))
    rng = np.random.default_rng(seed)

    def draw(tree):
        flat = {}
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = _key(p)
            if key.endswith("var"):
                a = rng.uniform(0.5, 1.5, leaf.shape)
            elif key.endswith("scale"):
                a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
            else:
                a = 0.05 * rng.standard_normal(leaf.shape)
            flat[key] = a.astype(np.float32)
        return flat

    ck = {"format_version": 1, "model_spec": {"name": name, "kwargs": dict(kwargs)},
          "num_classes": num_classes, "input_shape": [1, img, img, 3], "epoch": 0, "step": 3,
          "optimizer": {"count": np.asarray(3, np.int32)}}
    for col, tree in shapes.items():
        ck["model" if col == "params" else col] = draw(tree)
        if ema:
            ck["model_ema" if col == "params" else "model_ema_" + col] = draw(tree)
    with open(path, "wb") as f:
        pickle.dump(ck, f, protocol=pickle.HIGHEST_PROTOCOL)
    return str(path)
