"""Training: state, step, checkpoints, callbacks and the entry point."""
