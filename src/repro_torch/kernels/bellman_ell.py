"""Fused ELL Bellman backup and the ELL Q table: the CUDA kernels' wrappers.

Counterpart of :mod:`repro.kernels.bellman_ell` (the Pallas TPU kernels).
The backup's kernel is ``csrc/ell_backup.cu`` (each (state, action) row's
slots spread over neighbouring lanes for coalesced loads, pinned
roundings, a strict-``<`` argmin over the actions in order); its plain
PyTorch version is :func:`repro_torch.kernels.ref.ell_backup`, which it
equals bit for bit.  Its launcher picks 16-byte loads a lane where the
row length and the tables' alignment allow it, else 4-byte ones.

:func:`ell_qvalues` is, as in the reference, the policy SpMV kernel
(``csrc/ell_spmv.cu``) run over the ``(n*m, K)`` rows, then
``cost + gamma * pv`` as two torch ops, each rounded on its own; it equals
:func:`repro_torch.kernels.ref.ell_qvalues` bit for bit.

Both take CUDA tensors only, check them, allocate the outputs, launch on
PyTorch's current stream and raise on any launch error.  ``launches``
counts the backup's launches, ``qvalues_launches`` the Q table's.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, spmv_ell

SOURCE = "ell_backup"

launches = 0
qvalues_launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn, g in ((lib.ell_backup_f32, ctypes.c_float),
                      (lib.ell_backup_f64, ctypes.c_double)):
            fn.argtypes = [ptr, ptr, ptr, ptr, g, i64, i32, i32, ptr, ptr,
                           ptr]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(idx, val, cost, v, what: str = "ell_backup") -> torch.dtype:
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel takes CUDA tensors, got v on {dev}")
    for name, t in (("idx", idx), ("val", val), ("cost", cost)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, v on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if idx.dtype != torch.int32 or val.dtype != torch.float32 \
            or cost.dtype != torch.float32:
        raise ValueError(f"{what} takes int32 idx and float32 val/cost, "
                         f"got {idx.dtype}/{val.dtype}/{cost.dtype}")
    if v.dtype not in (torch.float32, torch.float64) or v.dim() != 1 \
            or not v.is_contiguous():
        raise ValueError(f"{what} takes a contiguous 1-D float32/float64 "
                         f"v, got {v.dtype} {tuple(v.shape)}")
    if idx.dim() != 3 or val.shape != idx.shape \
            or cost.shape != idx.shape[:2] or idx.shape[1] < 1:
        raise ValueError(f"{what} shapes: idx/val (n, m>=1, K), cost "
                         f"(n, m); got {tuple(idx.shape)} "
                         f"{tuple(val.shape)} {tuple(cost.shape)}")
    return v.dtype


def ell_backup(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
               gamma: float, v: torch.Tensor) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """``(min_a Q (n,) acc-dtype, argmin_a Q (n,) int32)`` on the card."""
    global launches
    dt = _check(idx, val, cost, v)
    n, m, k = idx.shape
    out_v = torch.empty(n, dtype=dt, device=v.device)
    out_pi = torch.empty(n, dtype=torch.int32, device=v.device)
    if n == 0:
        return out_v, out_pi
    lib = _lib()
    fn = lib.ell_backup_f64 if dt == torch.float64 else lib.ell_backup_f32
    stream = torch.cuda.current_stream(v.device).cuda_stream
    code = fn(idx.data_ptr(), val.data_ptr(), cost.data_ptr(), v.data_ptr(),
              float(gamma), n, m, k, out_v.data_ptr(), out_pi.data_ptr(),
              stream)
    build.check(code, "ell_backup launch")
    launches += 1
    return out_v, out_pi


def ell_qvalues(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
                gamma: float, v: torch.Tensor) -> torch.Tensor:
    """``Q = cost + gamma * P v`` (n, m) in the accumulation dtype, on the
    card: one SpMV launch over the ``(n*m, K)`` rows, then the epilogue as
    two torch ops (``gamma * pv`` rounded before ``+ cost``)."""
    global qvalues_launches
    _check(idx, val, cost, v, "ell_qvalues")
    n, m, k = idx.shape
    pv = spmv_ell.launch(idx.view(n * m, k), val.view(n * m, k), v)
    if pv.numel():
        qvalues_launches += 1
    return cost.to(pv.dtype) + gamma * pv.view(n, m)
