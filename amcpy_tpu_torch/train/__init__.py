"""Checkpoints (the training loop waits for a later slice)."""
