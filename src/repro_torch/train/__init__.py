"""Serving steps of the port (the training step is a later slice)."""
