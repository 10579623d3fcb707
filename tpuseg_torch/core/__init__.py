"""Training infrastructure: per-step generators, optimizers, checkpoints."""
