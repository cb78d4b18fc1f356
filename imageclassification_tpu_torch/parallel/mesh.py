"""The mesh of the port (port of the JAX package's `parallel/mesh.py`): the
process group, one device a process, the batch sharded over every axis of
--mesh_shape (JAX's data parallelism without --fsdp, whose parameter
sharding is ROADMAP A9b).

A step at a world of W is the function of the global batch that the JAX jit
step is: the rank-major concatenation of the ranks' local batches
(`make_global_batch`). The helpers here are what the port's step needs for
that, written with `all_reduce` and `broadcast` alone (gloo takes no other
collective on CUDA tensors, NCCL takes both): a rank's rows of the global
batch, an all-gather written as a sum into zeros, and flat-buffer sums and
means over the ranks, one of them differentiable (BatchNorm's statistics).
At a world of one each is the identity.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from .dist import get_rank, get_world_size


def mesh_axes(mesh_shape: str) -> list:
    """[(axis name, size)] of 'data:4,fsdp:2'; [] for ''."""
    out = []
    for part in filter(None, (p.strip() for p in mesh_shape.split(","))):
        name, size = part.split(":")
        out.append((name.strip(), int(size)))
    return out


def check_mesh(mesh_shape: str, world: int) -> list:
    """The axes of --mesh_shape over `world` processes of one device each
    ('' is one 'data' axis over all of them); the JAX make_mesh's ValueError
    when the sizes' product is not the device count."""
    axes = mesh_axes(mesh_shape) or [("data", world)]
    total = 1
    for _, size in axes:
        total *= size
    if total != world:
        raise ValueError(f"mesh {mesh_shape} needs {total} devices, have {world}")
    return axes


def rows_of(n_global: int, rank: int = None, world: int = None) -> slice:
    """The rows of the global batch of `n_global` that `rank` holds."""
    rank = get_rank() if rank is None else rank
    world = get_world_size() if world is None else world
    local = n_global // world
    return slice(rank * local, (rank + 1) * local)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The rank-major concatenation of every rank's `t` (the global batch of
    a local one) on every rank: each rank writes its rows into zeros and the
    zeros are summed, so every value arrives exactly."""
    world = get_world_size()
    if world == 1:
        return t
    out = t.new_zeros((world * t.shape[0],) + tuple(t.shape[1:]))
    out[rows_of(out.shape[0])] = t
    dist.all_reduce(out)
    return out


def _flat_all_reduce(tensors: Sequence[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def sum_across(tensors: Sequence[torch.Tensor],
               dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, through one flat all-reduce in
    `dtype` (not differentiated); the tensors themselves at a world of one."""
    return list(tensors) if get_world_size() == 1 else _flat_all_reduce(tensors, dtype)


def mean_across(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor averaged over the ranks (`sum_across` / W)."""
    world = get_world_size()
    if world == 1:
        return list(tensors)
    return [t / world for t in _flat_all_reduce(tensors, torch.float32)]


class _SumAcross(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the gradient
    (itself, so it differentiates again under create_graph)."""

    @staticmethod
    def forward(ctx, x):
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _SumAcross.apply(grad)


def sum_across_grad(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, with the gradient summed over the ranks in
    the backward: a rank's loss then sees how its values moved every rank's
    (a statistic of the global batch)."""
    return t if get_world_size() == 1 else _SumAcross.apply(t)
