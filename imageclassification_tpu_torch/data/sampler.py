"""Epoch and eval batch index math (own copy of
imageclassification_tpu/data/sampler.py): pure numpy on the host, so the same
seed gives the same index streams as the JAX package."""

from __future__ import annotations

import math
from typing import List

import numpy as np


def epoch_batch_indices(
    n_samples: int,
    global_batch: int,
    epoch: int,
    seed: int,
    rank: int = 0,
    world: int = 1,
    shuffle: bool = True,
) -> np.ndarray:
    """Local indices for one epoch, shape [steps, local_batch]:
    DistributedSampler semantics (a global permutation seeded by seed + epoch,
    round-robin sharding over ranks), truncated to full global batches."""
    if shuffle:
        perm = np.random.default_rng(seed + epoch).permutation(n_samples)
    else:
        perm = np.arange(n_samples)
    # pad to a multiple of world (DistributedSampler wraps around)
    total = int(math.ceil(n_samples / world)) * world
    if total > n_samples:
        perm = np.concatenate([perm, perm[: total - n_samples]])
    local = perm[rank::world]
    local_batch = global_batch // world
    steps = len(local) // local_batch
    return local[: steps * local_batch].reshape(steps, local_batch)


def ra_epoch_batch_indices(
    n_samples: int,
    global_batch: int,
    epoch: int,
    seed: int,
    rank: int = 0,
    world: int = 1,
    num_repeats: int = 3,
) -> np.ndarray:
    """Repeated-augmentation sampler: each index appears `num_repeats` times in
    the seeded shuffled sequence, round-robin sharded so the copies land on
    different ranks, truncated to floor(n/256)*256/world per rank."""
    perm = np.random.default_rng(seed + epoch).permutation(n_samples)
    repeated = np.repeat(perm, num_repeats)
    total_size = int(math.ceil(num_repeats * n_samples / world)) * world
    if total_size > len(repeated):
        repeated = np.concatenate([repeated, repeated[: total_size - len(repeated)]])
    local = repeated[rank::world]
    num_selected = int(math.floor(n_samples // 256 * 256 / world))
    if num_selected > 0:
        local = local[:num_selected]
    local_batch = global_batch // world
    steps = len(local) // local_batch
    return local[: steps * local_batch].reshape(steps, local_batch)


def eval_batches(
    n_samples: int, batch_size: int, rank: int = 0, world: int = 1
) -> List[np.ndarray]:
    """Sequential eval batches, sharded across processes.

    `batch_size` is the local per-process batch; global step s covers samples
    [s*B*world, (s+1)*B*world) with process r taking the r-th contiguous
    slice, so the shards are disjoint. Short or empty slices are padded with
    -1, which the eval step masks out of every statistic."""
    global_batch = batch_size * world
    steps = max(1, math.ceil(n_samples / global_batch))
    out = []
    for s in range(steps):
        start = s * global_batch + rank * batch_size
        stop = min(start + batch_size, n_samples)
        idx = np.arange(start, max(start, stop))
        if len(idx) < batch_size:
            idx = np.concatenate(
                [idx, np.full(batch_size - len(idx), -1, dtype=np.int64)]
            )
        out.append(idx)
    return out
