"""Fused ELL Bellman backup: the CUDA kernel's wrapper.

Counterpart of :mod:`repro.kernels.bellman_ell` (the Pallas TPU kernel).
The kernel itself is ``csrc/ell_backup.cu`` (one thread per state row,
pinned roundings, first-minimum argmin); its plain PyTorch version is
:func:`repro_torch.kernels.ref.ell_backup`, which it equals bit for bit.

:func:`ell_backup` takes CUDA tensors only, checks them, allocates the
outputs, launches on PyTorch's current stream and raises on any launch
error.  ``launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "ell_backup"

launches = 0


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


def _check(idx, val, cost, v) -> torch.dtype:
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"ell_backup kernel takes CUDA tensors, got v on "
                         f"{dev}")
    for name, t in (("idx", idx), ("val", val), ("cost", cost)):
        if t.device != dev:
            raise ValueError(f"ell_backup: {name} is on {t.device}, v on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"ell_backup: {name} must be contiguous")
    if idx.dtype != torch.int32 or val.dtype != torch.float32 \
            or cost.dtype != torch.float32:
        raise ValueError(f"ell_backup takes int32 idx and float32 val/cost, "
                         f"got {idx.dtype}/{val.dtype}/{cost.dtype}")
    if v.dtype not in (torch.float32, torch.float64) or v.dim() != 1 \
            or not v.is_contiguous():
        raise ValueError(f"ell_backup takes a contiguous 1-D float32/float64 "
                         f"v, got {v.dtype} {tuple(v.shape)}")
    if idx.dim() != 3 or val.shape != idx.shape \
            or cost.shape != idx.shape[:2] or idx.shape[1] < 1:
        raise ValueError(f"ell_backup shapes: idx/val (n, m>=1, K), cost "
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
