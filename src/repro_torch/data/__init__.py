"""Data pipeline of the port: the synthetic and memmap sources."""
