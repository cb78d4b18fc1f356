"""Checkpoints in the JAX package's format, read and written, and the weight
carry between the two packages' layouts."""
