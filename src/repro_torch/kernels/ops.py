"""Kernel dispatch by tensor device.

Counterpart of :mod:`repro.kernels.ops`.  Where the reference picks an
implementation by option (``-kernel_impl``), the port picks by where the
tensors live:

* CPU tensors run the plain PyTorch versions (:mod:`.ref`);
* CUDA tensors launch the hand-written kernels (:mod:`.bellman_ell`,
  :mod:`.spmv_ell`, :mod:`.dense_backup`), which raise if they cannot
  build or launch.

Nothing catches a kernel failure and falls back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bellman_ell, dense_backup as dense_kernel
from repro_torch.kernels import ref, spmv_ell

KERNELS = {"ell_backup": bellman_ell, "ell_matvec": spmv_ell,
           "dense_backup": dense_kernel}


def ell_backup(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
               gamma: float, v: torch.Tensor) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Bellman backup on an ELL block -> (v_new (n,), argmin (n,) int32)."""
    if v.device.type == "cpu":
        return ref.ell_backup(idx, val, cost, gamma, v)
    return bellman_ell.ell_backup(idx, val, cost, gamma, v)


def ell_matvec(idx: torch.Tensor, val: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """Policy-restricted SpMV y = P_pi @ x on (n, K) ELL rows."""
    if x.device.type == "cpu":
        return ref.ell_matvec(idx, val, x)
    return spmv_ell.ell_matvec(idx, val, x)


def dense_backup(p: torch.Tensor, cost: torch.Tensor, gamma: float,
                 v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Bellman backup on a dense block -> (v_new (n,), argmin (n,)
    int32)."""
    if v.device.type == "cpu":
        return ref.dense_backup(p, cost, gamma, v)
    return dense_kernel.dense_backup(p, cost, gamma, v)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
