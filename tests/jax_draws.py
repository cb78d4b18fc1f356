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
from imageclassification_tpu.data.abel import AbelAugmentConfig
from imageclassification_tpu.data.randaugment import AutoAugmentConfig, RandAugmentConfig


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


def _signs(k_inner):
    """The four signs of one application: k_inner, then fold_in(k_inner,
    1 / 2 / 3) (randaugment.py:239-242)."""
    return jnp.stack([jax.random.bernoulli(k_inner)]
                     + [jax.random.bernoulli(jax.random.fold_in(k_inner, i)) for i in (1, 2, 3)])


def _batched(one, k_aa, B):
    """one(key) -> {name: [...]} under vmap over split(k_aa, B) (one
    compile: op by op the key splits take seconds), each array with its
    batch axis moved last, as torch tensors."""
    d = jax.jit(jax.vmap(one))(jax.random.split(k_aa, B))
    return {k: _t(jnp.moveaxis(v, 0, -1)) for k, v in d.items()}


def rand_augment_draws(k_aa, B, cfg: RandAugmentConfig):
    """The draws of the JAX rand_augment_batch(images, k_aa, cfg)
    (randaugment.py:294-308)."""

    def one(rng):
        out = {"op": [], "m": [], "apply": [], "sign": []}
        for _ in range(cfg.num_layers):
            k_op, k_mag, k_apply, k_inner, rng = jax.random.split(rng, 5)
            out["op"].append(jax.random.randint(k_op, (), 0, len(cfg.ops)))
            if cfg.mstd > 0:
                m = cfg.magnitude + cfg.mstd * jax.random.normal(k_mag)
            else:
                m = jnp.asarray(cfg.magnitude, jnp.float32)
            out["m"].append(jnp.clip(m, 0.0, cfg.mmax))
            out["apply"].append(jax.random.bernoulli(k_apply, cfg.prob))
            out["sign"].append(_signs(k_inner))
        return {k: jnp.stack(v) for k, v in out.items()}

    d = _batched(one, k_aa, B)
    d["op"] = d["op"].long()
    return d


def auto_augment_draws(k_aa, B, cfg: AutoAugmentConfig):
    """The draws of the JAX auto_augment_batch(images, k_aa, cfg)
    (randaugment.py:412-429)."""
    probs = jnp.asarray(cfg.probs)

    def one(rng):
        k_sp, rng = jax.random.split(rng)
        sp = jax.random.randint(k_sp, (), 0, probs.shape[0])
        apply, sign = [], []
        for slot in range(probs.shape[1]):
            k_apply, k_inner, rng = jax.random.split(rng, 3)
            apply.append(jax.random.bernoulli(k_apply, probs[sp, slot]))
            sign.append(_signs(k_inner))
        return {"sub": sp, "apply": jnp.stack(apply), "sign": jnp.stack(sign)}

    d = _batched(one, k_aa, B)
    d["sub"] = d["sub"].long()
    return d


def abel_draws(k_aa, B, cfg: AbelAugmentConfig):
    """The draws of the JAX abel_augment_batch(images, k_aa, cfg)
    (abel.py:103-130); v_sharp and v_shear from the one key k_v."""

    def one(rng):
        k_dark, k_dark_t, k_skip, rng = jax.random.split(rng, 4)
        k_max, k_thr = jax.random.split(k_dark_t)
        tmax = jax.random.randint(k_max, (), 1, 11)
        out = {"dark": jax.random.bernoulli(k_dark, 0.3),
               "thr": jax.random.randint(k_thr, (), 1, tmax + 1).astype(jnp.float32),
               "skip": jax.random.bernoulli(k_skip, 0.1), "op": [], "v_sharp": [],
               "v_shear": []}
        for _ in range(cfg.n):
            k_op, k_v, k_sign, rng = jax.random.split(rng, 4)
            out["op"].append(jax.random.randint(k_op, (), 0, 3))
            out["v_sharp"].append(jax.random.uniform(k_v, minval=0.4, maxval=1.9))
            v = jax.random.uniform(k_v, minval=0.0, maxval=0.1)
            out["v_shear"].append(jnp.where(jax.random.bernoulli(k_sign), v, -v))
        return {k: jnp.stack(v) if isinstance(v, list) else v for k, v in out.items()}

    d = _batched(one, k_aa, B)
    d["op"] = d["op"].long()
    return d


def policy_draws(k_aa, B, aa: str, jax_policy):
    """The draws of the JAX policy object `jax_policy` of --aa `aa`."""
    if aa.startswith("rand"):
        return rand_augment_draws(k_aa, B, jax_policy)
    if aa.startswith("abel"):
        return abel_draws(k_aa, B, jax_policy)
    return auto_augment_draws(k_aa, B, jax_policy)


def augment_draws(k_aug, B, H, W, args):
    """The draws of the JAX AugmentPipeline(args)(images, k_aug)."""
    from imageclassification_tpu.data.augment import AugmentPipeline

    k_flip, k_aa, k_erase = jax.random.split(k_aug, 3)
    draws = flip_draws(k_flip, B)
    if args.aa:
        draws["aa"] = policy_draws(k_aa, B, args.aa, AugmentPipeline(args).aa)
    elif args.color_jitter and args.color_jitter > 0:
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



def hessian_z(rng, step, params):
    """The Rademacher draws of the JAX train step's Hutchinson estimate
    (adahessian) at state.step = step, as a flat {JAX name: array} dict:
    one key a leaf of `params`, split from fold_in(fold_in(rng, step),
    0x5E55) (engine/step.py:186-201)."""
    k_hess = jax.random.fold_in(jax.random.fold_in(rng, step), 0x5E55)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    keys = jax.random.split(k_hess, len(flat))
    return {"/".join(p.key for p in path): np.asarray(
        jax.random.rademacher(k, leaf.shape, jnp.float32).astype(leaf.dtype))
        for k, (path, leaf) in zip(keys, flat)}
