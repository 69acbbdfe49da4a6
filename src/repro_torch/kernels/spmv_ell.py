"""Policy-restricted ELL SpMV: the CUDA kernel's wrapper.

Counterpart of :mod:`repro.kernels.spmv_ell` (the Pallas TPU kernel).
The kernel is ``csrc/ell_spmv.cu`` (a row's slots spread over
neighbouring lanes for coalesced loads, pinned roundings, the K-sum in slot
order); its plain PyTorch version is
:func:`repro_torch.kernels.ref.ell_matvec`, which it equals bit for bit.
Its launcher picks the 16-byte (int4 / float4) load path where the row
length and the tables' alignment allow it, else the 4-byte one; both are
hand-written and bit-equal.

:func:`ell_matvec` takes CUDA tensors only, checks them, allocates the
output, launches on PyTorch's current stream and raises on any launch
error.  ``launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "ell_spmv"

launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        ptr = ctypes.c_void_p
        for fn in (lib.ell_spmv_f32, lib.ell_spmv_f64):
            fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int,
                           ptr, ptr]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(idx, val, x) -> torch.dtype:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ell_matvec kernel takes CUDA tensors, got x on "
                         f"{dev}")
    for name, t in (("idx", idx), ("val", val)):
        if t.device != dev:
            raise ValueError(f"ell_matvec: {name} is on {t.device}, x on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"ell_matvec: {name} must be contiguous")
    if idx.dtype != torch.int32 or val.dtype != torch.float32:
        raise ValueError(f"ell_matvec takes int32 idx and float32 val, got "
                         f"{idx.dtype}/{val.dtype}")
    if x.dtype not in (torch.float32, torch.float64) or x.dim() != 1 \
            or not x.is_contiguous():
        raise ValueError(f"ell_matvec takes a contiguous 1-D float32/float64 "
                         f"x, got {x.dtype} {tuple(x.shape)}")
    if idx.dim() != 2 or val.shape != idx.shape:
        raise ValueError(f"ell_matvec shapes: idx/val (n, K); got "
                         f"{tuple(idx.shape)} {tuple(val.shape)}")
    return x.dtype


def launch(idx: torch.Tensor, val: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """Check, allocate and launch the kernel without counting the launch:
    :func:`ell_matvec` and :func:`repro_torch.kernels.bellman_ell.ell_qvalues`
    each count theirs under their own name."""
    dt = _check(idx, val, x)
    n, k = idx.shape
    y = torch.empty(n, dtype=dt, device=x.device)
    if n == 0:
        return y
    lib = _lib()
    fn = lib.ell_spmv_f64 if dt == torch.float64 else lib.ell_spmv_f32
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(idx.data_ptr(), val.data_ptr(), x.data_ptr(), n, k,
              y.data_ptr(), stream)
    build.check(code, "ell_matvec launch")
    return y


def ell_matvec(idx: torch.Tensor, val: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """``y[i] = sum_k val[i, k] * x[idx[i, k]]`` (n,) in x's dtype, on the
    card."""
    global launches
    y = launch(idx, val, x)
    if y.numel():
        launches += 1
    return y
