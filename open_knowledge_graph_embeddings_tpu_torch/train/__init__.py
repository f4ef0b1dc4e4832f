"""Checkpoints and top-k selection (the training loop is not ported yet)."""
