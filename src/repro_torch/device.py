"""Device selection shared by every entry point.

The port runs on the card unless the caller asks for the CPU.  Asking for
``cuda`` when no GPU is visible is an error: nothing silently falls back
to the host.
"""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, checked to be usable here."""
    dev = torch.device(device)
    if dev.type not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but no CUDA device is "
            f"visible; pass device='cpu' (-device cpu / --device cpu) to "
            f"run on the host")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
