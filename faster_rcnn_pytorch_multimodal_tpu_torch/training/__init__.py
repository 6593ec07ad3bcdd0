"""Training: the optimizer chain (optim) and the train step and loop (solver)."""
