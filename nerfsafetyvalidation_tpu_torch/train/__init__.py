"""Training of the port: the trainer and its metrics."""
