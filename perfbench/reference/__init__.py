"""Plain references: PyTorch and the standard library only, nothing of the
program, the JAX package or JAX."""
