"""Process-group bootstrap (port of the JAX package's `parallel/dist.py`).

The JAX package joins its processes with `jax.distributed.initialize`; the
port joins a `torch.distributed` process group from the same three launcher
conventions:
  * OMPI (`OMPI_COMM_WORLD_RANK` / `_SIZE` / `_LOCAL_RANK`) with
    --dist_on_itp, the coordinator at MASTER_ADDR:MASTER_PORT;
  * torchrun's RANK / WORLD_SIZE (and LOCAL_RANK), the coordinator at
    MASTER_ADDR:MASTER_PORT;
  * SLURM when SLURM_NTASKS > 1 (SLURM_PROCID, SLURM_LOCALID), the
    coordinator from --dist_url tcp://host:port (else MASTER_ADDR:MASTER_PORT).
MASTER_ADDR and MASTER_PORT default to 127.0.0.1 and 12355, as in JAX. The
backend is NCCL for --device cuda (each process on the card of its local
rank) and gloo for --device cpu. A default group that the caller already
made is adopted as it is (a test, or two processes sharing one card over
gloo). A world of one process creates no group: "Not using distributed
mode". The JAX package's Cloud TPU pod branch has no GPU counterpart.

Rank-0 print gating (`setup_for_distributed`) mirrors the JAX function:
`print(..., force=True)` prints on every rank with a timestamp.
"""

from __future__ import annotations

import builtins
import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_ADDR, DEFAULT_PORT = "127.0.0.1", "12355"


def _env_int(*names, default=None):
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return default


def _coordinator() -> str:
    return (f"tcp://{os.environ.get('MASTER_ADDR', DEFAULT_ADDR)}:"
            f"{os.environ.get('MASTER_PORT', DEFAULT_PORT)}")


def _launch_env(args) -> Optional[Tuple[int, int, int, str]]:
    """(rank, world, local rank, init_method) of the launcher convention the
    environment holds (see the module docstring), or None without one."""
    if getattr(args, "dist_on_itp", False):
        rank, world = _env_int("OMPI_COMM_WORLD_RANK"), _env_int("OMPI_COMM_WORLD_SIZE")
        if rank is None or world is None:
            return None
        return rank, world, _env_int("OMPI_COMM_WORLD_LOCAL_RANK", default=0), _coordinator()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return (_env_int("RANK"), _env_int("WORLD_SIZE"), _env_int("LOCAL_RANK", default=0),
                _coordinator())
    if "SLURM_PROCID" in os.environ and _env_int("SLURM_NTASKS", default=1) > 1:
        url = getattr(args, "dist_url", "")
        return (_env_int("SLURM_PROCID"), _env_int("SLURM_NTASKS"),
                _env_int("SLURM_LOCALID", default=0),
                url if url.startswith("tcp://") else _coordinator())
    return None


def init_distributed_mode(args) -> None:
    """Join the process group of the launcher environment, or adopt the
    caller's; sets args.rank, args.world_size, args.local_rank and
    args.distributed (False at a world of one, where no group is made)."""
    if dist.is_available() and dist.is_initialized():
        args.rank, args.world_size = dist.get_rank(), dist.get_world_size()
        args.local_rank = _env_int("LOCAL_RANK", default=0)
        args.distributed = args.world_size > 1
        if args.distributed:
            print(f"| distributed (rank {args.rank} of {args.world_size}): the caller's "
                  f"{dist.get_backend()} group", flush=True)
            setup_for_distributed(args.rank == 0)
        return
    found = _launch_env(args)
    if found is None or found[1] <= 1:
        print("Not using distributed mode")
        args.distributed, args.rank, args.world_size, args.local_rank = False, 0, 1, 0
        return
    rank, world, local_rank, init_method = found
    cuda = getattr(args, "device", "cuda") == "cuda"
    if cuda:
        torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method,
                            world_size=world, rank=rank)
    args.distributed, args.rank, args.world_size, args.local_rank = True, rank, world, local_rank
    print(f"| distributed init (rank {rank}): {init_method}", flush=True)
    setup_for_distributed(rank == 0)


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def collective_device() -> torch.device:
    """Where host values go for a collective: the current card under NCCL
    (which takes no CPU tensor), the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_host(values, op: str = "sum") -> np.ndarray:
    """`values` (numpy, float64 kept) reduced over the ranks by `op` ("sum"
    or "max"); unchanged at a world of one."""
    a = np.asarray(values)
    if get_world_size() == 1:
        return a
    t = torch.as_tensor(np.ascontiguousarray(a)).to(collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
    return t.cpu().numpy()


def broadcast_host(values) -> np.ndarray:
    """Rank 0's `values` (numpy) on every rank."""
    a = np.asarray(values)
    if get_world_size() == 1:
        return a
    t = torch.as_tensor(np.ascontiguousarray(a)).to(collective_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def any_process(flag: bool) -> bool:
    """True iff `flag` is True on any rank (a max-reduce), so that every rank
    takes the same branch before an action that runs collectives or ends
    the loop (the preemption decision of train.py)."""
    return bool(all_reduce_host(np.asarray([1.0 if flag else 0.0], np.float32), "max")[0] > 0)


def setup_for_distributed(is_master: bool) -> None:
    """Print on the master rank only; `print(..., force=True)` prints on any
    rank, after a timestamp."""
    builtin_print = getattr(builtins.print, "ungated", builtins.print)

    def print_gated(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            if force:
                builtin_print("[{}] ".format(datetime.datetime.now().time()), end="")
            builtin_print(*args, **kwargs)

    print_gated.ungated = builtin_print
    builtins.print = print_gated


def save_on_master(save_fn, *args, **kwargs):
    """save_fn(*args, **kwargs) on rank 0 only."""
    if is_main_process():
        return save_fn(*args, **kwargs)
    return None
