"""Training of the port: state, steps, checkpoints and the trainer."""
