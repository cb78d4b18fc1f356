"""Hand-written Hopper kernels, each with its plain PyTorch version beside it."""
