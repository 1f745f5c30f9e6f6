"""Training: metrics, optimizer state, checkpoints, logging and the loop."""
