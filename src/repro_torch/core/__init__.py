"""Solver core of the torch port (single-device subset of :mod:`repro.core`)."""
