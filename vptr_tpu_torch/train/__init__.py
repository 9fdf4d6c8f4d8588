"""Training of the port: optimizer, state and steps (FAR stage 2)."""
