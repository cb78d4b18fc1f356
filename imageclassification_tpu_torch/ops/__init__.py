"""Hand-written Hopper kernels, each with its plain PyTorch version beside it,
and the batch image ops of the --aa policies (`image.py`, plain PyTorch, as
the JAX package's are XLA), and the int8 execution of quantized checkpoints
(`int8.py`, `torch._int_mm` on the card, as the JAX package's int8 product is
XLA's)."""
