"""The random draws of the JAX package's train step, reproduced from its keys
in the layout the port's functions take them (data/augment.py
`AugmentPipeline.sample`, data/mixup.py `sample_mixup`), so a test hands both
packages the same draws. Each function repeats the JAX code's key splits
exactly; a change there shows up as a mismatch in the tests that use it."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imageclassification_tpu.data import mixup as jax_mixup


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def flip_draws(k_flip, B):
    kh, kv = jax.random.split(k_flip)
    return {"flip_h": _t(jax.random.bernoulli(kh, 0.5, (B, 1, 1, 1)).reshape(B)),
            "flip_v": _t(jax.random.bernoulli(kv, 0.5, (B, 1, 1, 1)).reshape(B))}


def jitter_draws(k_aa, B, strength):
    lo, hi = max(0.0, 1.0 - strength), 1.0 + strength
    return [_t(jax.random.uniform(k, (B, 1, 1, 1), minval=lo, maxval=hi).reshape(B))
            for k in jax.random.split(k_aa, 3)]


def erase_draws(k_erase, B, H, W, prob, mode, count, C=3):
    log_aspect = (jnp.log(0.3), jnp.log(10 / 3))

    def one(key):
        k_on, key = jax.random.split(key)
        out = {"enabled": jax.random.bernoulli(k_on, prob), "area": [], "log_aspect": [],
               "top": [], "left": [], "fill": []}
        for i in range(count):
            ka, kr, ky, kx, kn = jax.random.split(jax.random.fold_in(key, i), 5)
            out["area"].append(jax.random.uniform(ka, minval=0.02, maxval=1 / 3))
            out["log_aspect"].append(
                jax.random.uniform(kr, minval=log_aspect[0], maxval=log_aspect[1]))
            out["top"].append(jax.random.randint(ky, (), 0, H))
            out["left"].append(jax.random.randint(kx, (), 0, W))
            if mode == "pixel":
                out["fill"].append(jax.random.normal(kn, (H, W, C)))
            elif mode == "rand":
                out["fill"].append(jax.random.normal(kn, (1, 1, C)).reshape(C))
        return {k: jnp.stack(v) if isinstance(v, list) and v else v for k, v in out.items()}

    d = jax.vmap(one)(jax.random.split(k_erase, B))
    draws = {k: _t(v) for k, v in d.items() if not (isinstance(v, list))}
    draws["top"] = draws["top"].long()
    draws["left"] = draws["left"].long()
    return draws


def augment_draws(k_aug, B, H, W, args):
    """The draws of the JAX AugmentPipeline(args)(images, k_aug)."""
    k_flip, k_aa, k_erase = jax.random.split(k_aug, 3)
    draws = flip_draws(k_flip, B)
    if args.color_jitter and args.color_jitter > 0:
        draws["jitter"] = jitter_draws(k_aa, B, args.color_jitter)
    if args.reprob and args.reprob > 0:
        draws["erase"] = erase_draws(k_erase, B, H, W, args.reprob, args.remode, args.recount)
    return draws


def mixup_draws(k_mix, cfg, B, H, W):
    """The draws of the JAX mixup_cutmix(images, labels, k_mix, cfg)."""
    k_lam, k_box = jax.random.split(k_mix)
    shape = () if cfg.mode == "batch" else (B,)
    lam, use_cutmix = jax_mixup._sample_lam(k_lam, cfg, shape)
    if cfg.mode == "batch":
        box_keys = k_box
    else:
        box_keys = jax.random.split(k_box, B)
        if cfg.mode == "pair":
            first = jnp.arange(B) < B // 2
            lam = jnp.where(first, lam, lam[::-1])
            use_cutmix = jnp.where(first, use_cutmix, use_cutmix[::-1])
            kd = jax.random.key_data(box_keys)
            box_keys = jax.random.wrap_key_data(jnp.where(first[:, None], kd, kd[::-1]))

    def box(k):
        if cfg.cutmix_minmax is not None:
            lo, hi = cfg.cutmix_minmax
            kh, kw, ky, kx = jax.random.split(k, 4)
            cut_h = jax.random.randint(kh, (), int(H * lo), int(H * hi))
            cut_w = jax.random.randint(kw, (), int(W * lo), int(W * hi))
            return {"cut_h": cut_h, "cut_w": cut_w,
                    "yl": jax.random.randint(ky, (), 0, H - cut_h),
                    "xl": jax.random.randint(kx, (), 0, W - cut_w)}
        ky, kx = jax.random.split(k)
        return {"cy": jax.random.randint(ky, (), 0, H), "cx": jax.random.randint(kx, (), 0, W)}

    boxes = box(box_keys) if cfg.mode == "batch" else jax.vmap(box)(box_keys)
    draws = {"lam": _t(lam), "use_cutmix": _t(use_cutmix)}
    draws.update({k: _t(v).long() for k, v in boxes.items()})
    return draws


def step_draws(rng, step, B, H, W, args, mixup_cfg):
    """The draws of the JAX train_step(state, batch, rng) at state.step = step."""
    k_aug, k_mix, _, _ = jax.random.split(jax.random.fold_in(rng, step), 4)
    return {"augment": augment_draws(k_aug, B, H, W, args),
            "mixup": mixup_draws(k_mix, mixup_cfg, B, H, W) if mixup_cfg else None}

