"""Kernel dispatch by tensor device.

Counterpart of :mod:`repro.kernels.ops`.  Where the reference picks an
implementation by option (``-kernel_impl``), the port picks by where the
tensors live:

* CPU tensors run the plain PyTorch versions (:mod:`.ref`);
* CUDA tensors launch the hand-written kernels (:mod:`.bellman_ell`,
  :mod:`.spmv_ell`, :mod:`.dense_backup`, :mod:`.flash_attention`), which
  raise if they cannot build or launch.

Nothing catches a kernel failure and falls back.

Every MDP entry point also takes a fleet: a leading lane axis ``B`` on
``val`` / ``cost`` / ``p``, ``idx`` ``(B, ...)`` or shared, ``v`` / ``x``
``(B, n)`` or shared ``(n,)``, ``gamma`` a float or a ``(B,)`` tensor.
On the card that is one launch of the kernel's lane axis, never a loop
over lanes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bellman_ell, dense_backup as dense_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ref, spmv_ell

# kernel name -> (wrapper module, its launch counter)
KERNELS = {"ell_backup": (bellman_ell, "launches"),
           "ell_matvec": (spmv_ell, "launches"),
           "dense_backup": (dense_kernel, "launches"),
           "ell_qvalues": (bellman_ell, "qvalues_launches"),
           "flash_attention": (flash_kernel, "launches")}


def ell_backup(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
               gamma, v: torch.Tensor) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Bellman backup on an ELL block -> (v_new ([B,] n), argmin
    ([B,] n) int32)."""
    if v.device.type == "cpu":
        return ref.ell_backup(idx, val, cost, gamma, v)
    return bellman_ell.ell_backup(idx, val, cost, gamma, v)


def ell_backup_chunk(idx: torch.Tensor, val: torch.Tensor,
                     cost: torch.Tensor, gamma, v: torch.Tensor) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """The fused backup on ONE rebuilt row chunk ``(bn, m, K)`` against the
    whole value window ``v`` — the matrix-free operator's tile body
    (:mod:`repro_torch.kernels.matrix_free`), whose caller owns the row
    tiling.  It is :func:`ell_backup` (the hand-written kernel on the card,
    the plain version on the CPU), whose math is row-independent, so any
    chunking gives the bits of one call over every row.  A matrix-free
    fleet passes the chunk once for all its lanes: tables unbatched, ``v``
    ``(B, n_v)``, ``gamma`` a float or ``(B,)``."""
    return ell_backup(idx, val, cost, gamma, v)


def ell_qvalues(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
                gamma, v: torch.Tensor) -> torch.Tensor:
    """Q table ``cost + gamma * P v`` ([B,] n, m) on an ELL block."""
    if v.device.type == "cpu":
        return ref.ell_qvalues(idx, val, cost, gamma, v)
    return bellman_ell.ell_qvalues(idx, val, cost, gamma, v)


def ell_matvec(idx: torch.Tensor, val: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """Policy-restricted SpMV y = P_pi @ x on ([B,] n, K) ELL rows."""
    if x.device.type == "cpu":
        return ref.ell_matvec(idx, val, x)
    return spmv_ell.ell_matvec(idx, val, x)


def dense_backup(p: torch.Tensor, cost: torch.Tensor, gamma,
                 v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Bellman backup on a dense block -> (v_new ([B,] n), argmin
    ([B,] n) int32)."""
    if v.device.type == "cpu":
        return ref.dense_backup(p, cost, gamma, v)
    return dense_kernel.dense_backup(p, cost, gamma, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention forward: q (B, T, H, d), k/v (B, S, KV, d) -> (B, T, H,
    d) in q's dtype, scale ``d ** -0.5``, keys ``>= S`` excluded."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal)
    return flash_kernel.flash_attention(q, k, v, causal=causal)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
