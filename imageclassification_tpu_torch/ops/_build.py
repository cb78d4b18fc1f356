"""Build the port's CUDA kernels at first use and load them through ctypes,
and the helpers the kernel wrappers share around a launch.

Each source `csrc/<name>.cu` has a plain C interface and is compiled by
`nvcc -gencode arch=compute_90a,code=sm_90a` into its own shared library
under `build/kernels/` at the root of the checkout (listed in .gitignore).
The library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. Nothing here
runs at import time: the CPU tests import every module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); cannot build kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    # the headers of csrc/ go into the hash too: an edited header rebuilds
    # every library
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is up to date. Returns the
    compiler output (ptxas register/shared-memory report), empty when nothing
    was compiled."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited {proc.returncode}\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file
    return proc.stdout


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def sms(device: int) -> int:
    """The SM count of CUDA device `device`, which sizes a persistent grid."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream(t: torch.Tensor) -> int:
    """The handle of torch's current stream on t's device, for a launch: the
    raw handle, without building a `torch.cuda.Stream` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def raise_on(err: int, name: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def aligned(t: torch.Tensor, dtype=None) -> torch.Tensor:
    """t contiguous (in `dtype` when given) at a 32-byte aligned address, as
    16-byte vector loads and stores of 8 channels need."""
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    t = t.contiguous()
    return t if t.data_ptr() % 32 == 0 else t.clone()
