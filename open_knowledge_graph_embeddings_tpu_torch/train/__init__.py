"""Training and evaluation: the steps, the optimizers, the trainer, metrics and checkpoints."""
