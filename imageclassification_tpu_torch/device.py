"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str = "cuda") -> torch.device:
    """`"cuda"` (the default) or `"cpu"`. Asking for `cuda` on a machine
    without a card raises: the port never falls back to the CPU silently."""
    if name not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return torch.device(name)
