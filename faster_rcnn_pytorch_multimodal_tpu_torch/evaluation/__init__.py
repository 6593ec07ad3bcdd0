"""Evaluation: box overlaps and AP (copied from the JAX package)."""
