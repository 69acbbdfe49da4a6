"""Policy-restricted ELL SpMV: the CUDA kernel's wrapper.

Counterpart of :mod:`repro.kernels.spmv_ell` (the Pallas TPU kernel).
The kernel is ``csrc/ell_spmv.cu`` (a row's slots spread over
neighbouring lanes for coalesced loads, pinned roundings, the K-sum in slot
order); its plain PyTorch version is
:func:`repro_torch.kernels.ref.ell_matvec`, which it equals bit for bit.
Its launcher picks the 16-byte (int4 / float4) load path where the row
length and the tables' alignment allow it, else the 4-byte one; both are
hand-written and bit-equal.

A fleet is one launch: ``val`` ``(B, n, K)``, ``idx`` ``(B, n, K)`` or
shared ``(n, K)``, ``x`` ``(B, n_x)`` (contiguous rows at any lane stride,
such as GMRES's basis column ``V[:, j]``) or shared ``(n_x,)``, ``y``
``(B, n)``; the kernel's lane axis (``csrc/lanes.cuh``) gives each lane
the unbatched body, so lane ``b`` equals the unbatched call on lane
``b``'s operands bit for bit.

:func:`ell_matvec` takes CUDA tensors only, checks them, allocates the
output, launches on PyTorch's current stream and raises on any launch
error.  ``launches`` counts its launches (one a call, whatever B).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, lanes

SOURCE = "ell_spmv"

launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        ptr = ctypes.c_void_p
        i32 = ctypes.c_int
        for fn in (lib.ell_spmv_f32, lib.ell_spmv_f64):
            fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, i32, i32, i32,
                           ptr, ptr, ptr]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(idx, val, x) -> tuple[torch.dtype, int | None]:
    """The accumulation dtype and the lane count (``None`` unbatched)."""
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
    batch = val.shape[0] if val.dim() == 3 else None
    x_dims = (1,) if batch is None else (1, 2)
    if x.dtype not in (torch.float32, torch.float64) \
            or x.dim() not in x_dims or x.stride(-1) != 1 \
            or (x.dim() == 2 and x.shape[0] != batch):
        raise ValueError(f"ell_matvec takes a float32/float64 x of "
                         f"contiguous rows, (n_x,) or (B, n_x) for B lanes "
                         f"(any lane stride); got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if val.dim() not in (2, 3) or idx.shape[-2:] != val.shape[-2:] \
            or idx.dim() not in (2, val.dim()) \
            or (idx.dim() == 3 and idx.shape[0] != batch):
        raise ValueError(f"ell_matvec shapes: val (n, K) or (B, n, K), idx "
                         f"the same or shared (n, K); got "
                         f"{tuple(idx.shape)} {tuple(val.shape)}")
    return x.dtype, batch


def launch(idx: torch.Tensor, val: torch.Tensor, x: torch.Tensor, *,
           lane_order: str | None = None) -> torch.Tensor:
    """Check, allocate and launch the kernel without counting the launch:
    :func:`ell_matvec` and :func:`repro_torch.kernels.bellman_ell.ell_qvalues`
    each count theirs under their own name."""
    dt, batch = _check(idx, val, x)
    n, k = val.shape[-2:]
    y = torch.empty(val.shape[:-1], dtype=dt, device=x.device)
    if y.numel() == 0:
        return y
    b = batch or 1
    strides = lanes.strides(
        n * k if idx.dim() == 3 else 0, n * k if batch else 0,
        x.stride(0) if x.dim() == 2 else 0, n if batch else 0)
    lib = _lib()
    fn = lib.ell_spmv_f64 if dt == torch.float64 else lib.ell_spmv_f32
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(idx.data_ptr(), val.data_ptr(), x.data_ptr(), n, k, b,
              lanes.order_flag(lane_order), strides, y.data_ptr(),
              stream)
    build.check(code, "ell_matvec launch")
    return y


def ell_matvec(idx: torch.Tensor, val: torch.Tensor, x: torch.Tensor, *,
               lane_order: str | None = None) -> torch.Tensor:
    """``y[..., i] = sum_k val[..., i, k] * x[..., idx[..., i, k]]``
    ((n,) or (B, n)) in x's dtype, on the card, one launch."""
    global launches
    y = launch(idx, val, x, lane_order=lane_order)
    if y.numel():
        launches += 1
    return y
