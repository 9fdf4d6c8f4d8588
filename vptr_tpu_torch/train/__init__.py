"""Training of the port: optimizer, states, steps, checkpoints and the
Trainer's epoch loop."""
