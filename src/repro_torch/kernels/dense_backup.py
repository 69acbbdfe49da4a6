"""Fused dense Bellman backup: the CUDA kernel's wrapper.

Counterpart of :mod:`repro.kernels.dense_backup` (the Pallas TPU kernel).
The kernel itself is ``csrc/dense_backup.cu`` (one warp per state row,
pinned summation order and roundings, first-minimum argmin); its plain
PyTorch version is :func:`repro_torch.kernels.ref.dense_backup`, which it
equals bit for bit.

:func:`dense_backup` takes CUDA tensors only, checks them, allocates the
outputs, launches on PyTorch's current stream and raises on any launch
error.  ``launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "dense_backup"

launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn, g in ((lib.dense_backup_f32, ctypes.c_float),
                      (lib.dense_backup_f64, ctypes.c_double)):
            fn.argtypes = [ptr, ptr, ptr, g, i64, i32, i64, ptr, ptr, ptr]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(p, cost, v) -> torch.dtype:
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"dense_backup kernel takes CUDA tensors, got v on "
                         f"{dev}")
    for name, t in (("p", p), ("cost", cost)):
        if t.device != dev:
            raise ValueError(f"dense_backup: {name} is on {t.device}, v on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"dense_backup: {name} must be contiguous")
        if t.dtype != torch.float32:
            raise ValueError(f"dense_backup takes float32 p/cost, got "
                             f"{name} {t.dtype}")
    if v.dtype not in (torch.float32, torch.float64) or v.dim() != 1 \
            or not v.is_contiguous():
        raise ValueError(f"dense_backup takes a contiguous 1-D "
                         f"float32/float64 v, got {v.dtype} "
                         f"{tuple(v.shape)}")
    if p.dim() != 3 or cost.shape != p.shape[:2] or p.shape[1] < 1 \
            or p.shape[2] != v.shape[0] or v.shape[0] < 1:
        raise ValueError(f"dense_backup shapes: p (n, m>=1, n_cols>=1), cost "
                         f"(n, m), v (n_cols,); got {tuple(p.shape)} "
                         f"{tuple(cost.shape)} {tuple(v.shape)}")
    return v.dtype


def dense_backup(p: torch.Tensor, cost: torch.Tensor, gamma: float,
                 v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(min_a Q (n,) acc-dtype, argmin_a Q (n,) int32)`` on the card."""
    global launches
    dt = _check(p, cost, v)
    n, m, n_cols = p.shape
    out_v = torch.empty(n, dtype=dt, device=v.device)
    out_pi = torch.empty(n, dtype=torch.int32, device=v.device)
    if n == 0:
        return out_v, out_pi
    lib = _lib()
    fn = lib.dense_backup_f64 if dt == torch.float64 else lib.dense_backup_f32
    stream = torch.cuda.current_stream(v.device).cuda_stream
    code = fn(p.data_ptr(), cost.data_ptr(), v.data_ptr(), float(gamma), n, m,
              n_cols, out_v.data_ptr(), out_pi.data_ptr(), stream)
    build.check(code, "dense_backup launch")
    launches += 1
    return out_v, out_pi
