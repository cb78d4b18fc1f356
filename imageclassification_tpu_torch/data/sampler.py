"""Eval batch index math (own copy of imageclassification_tpu/data/sampler.py
`eval_batches`)."""

from __future__ import annotations

import math
from typing import List

import numpy as np


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
