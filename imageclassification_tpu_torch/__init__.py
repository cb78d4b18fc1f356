"""imageclassification_tpu_torch — the PyTorch/CUDA port of
`imageclassification_tpu`, for one NVIDIA H100 (sm_90a).

The layout mirrors the JAX package (data/, models/, ops/, checkpoint/,
engine/, utils/). Plain tensor code is PyTorch; every Pallas kernel the JAX
package runs on a path that is ported here is a CUDA kernel written by hand
(sources under csrc/, built at first use by ops/_build.py). Entry points run
on `cuda` unless the caller passes `device="cpu"`.

Ported so far: folder inference (`python -m imageclassification_tpu_torch.val`)
for the ViT family, with `--flash_attn` checkpoints running the
flash-attention forward kernel.
"""

__version__ = "0.1.0"
