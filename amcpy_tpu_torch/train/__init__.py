"""Training, checkpoints and evaluation."""
