"""Utilities of the torch port (checkpoint files)."""
