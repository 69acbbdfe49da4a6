"""Utilities of the torch port (checkpoint files, the solve path's spans and
reads)."""
