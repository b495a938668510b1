"""Training: synthetic data, optimizers, checkpoints and the loop."""
