"""Kernels of the torch port: CUDA C++ sources in ``csrc/``, their ctypes
wrappers, plain PyTorch versions (:mod:`.ref`) and device dispatch
(:mod:`.ops`)."""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
