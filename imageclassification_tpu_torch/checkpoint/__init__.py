"""Reading the JAX package's checkpoints into the port's modules."""
