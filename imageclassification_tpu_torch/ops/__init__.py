"""Hand-written Hopper kernels, each with its plain PyTorch version beside it,
and the batch image ops of the --aa policies (`image.py`, plain PyTorch, as
the JAX package's are XLA)."""
