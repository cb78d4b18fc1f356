"""imageclassification_tpu_torch — the PyTorch/CUDA port of
`imageclassification_tpu`, for one NVIDIA H100 (sm_90a).

The layout mirrors the JAX package (data/, models/, ops/, checkpoint/,
engine/, utils/). Plain tensor code is PyTorch; every Pallas kernel the JAX
package runs on a path that is ported here is a CUDA kernel written by hand
(sources under csrc/, built at first use by ops/_build.py). Entry points run
on `cuda` unless the caller passes `device="cpu"`.

Ported so far, for the ViT family: folder inference
(`python -m imageclassification_tpu_torch.val`) and training
(`python -m imageclassification_tpu_torch.train`), with `--flash_attn`
running the flash-attention forward and backward kernels.
"""

__version__ = "0.1.0"
