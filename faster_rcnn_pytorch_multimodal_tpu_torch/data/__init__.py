"""Data: the synthetic dataset and the batch loader (copied from the JAX package)."""
