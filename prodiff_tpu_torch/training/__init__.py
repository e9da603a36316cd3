"""The port's trainer and optimizer."""
