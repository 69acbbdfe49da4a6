"""Fused dense Bellman backup: the CUDA kernel's wrapper.

Counterpart of :mod:`repro.kernels.dense_backup` (the Pallas TPU kernel).
The kernel itself is ``csrc/dense_backup.cu`` (one warp per state row,
pinned summation order and roundings, first-minimum argmin); its plain
PyTorch version is :func:`repro_torch.kernels.ref.dense_backup`, which it
equals bit for bit.

A fleet is one launch: ``p`` ``(B, n, m, n_cols)``, ``cost``
``(B, n, m)``, ``v`` ``(B, n_cols)`` or shared ``(n_cols,)``, ``gamma`` a
float or a ``(B,)`` tensor; the kernel's lane axis (``csrc/lanes.cuh``)
gives each lane the unbatched body, so lane ``b`` equals the unbatched
call on lane ``b``'s operands bit for bit.

:func:`dense_backup` takes CUDA tensors only, checks them, allocates the
outputs, launches on PyTorch's current stream and raises on any launch
error.  ``warps`` (4, 8 or 16: :data:`WARPS`) is the CTA size in warps;
no choice changes a bit of the result.  ``launches`` counts its launches
(one a call, whatever B); the launches that time a candidate for the
tuner (``tuning=True``) count under ``tune_launches`` instead.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, lanes

SOURCE = "dense_backup"

launches = 0
tune_launches = 0

# Warps a CTA (``csrc/dense_backup.cu``: the kernel is instantiated for
# each) and the default.  A warp takes its own row whatever its CTA holds,
# so the choice moves the grid and no bit of the result.
WARPS = (4, 8, 16)
DEFAULT_WARPS = 8


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.dense_backup_f32, lib.dense_backup_f64):
            fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i64, i32, i32, ptr,
                           ptr, ptr, ptr]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(p, cost, v) -> tuple[torch.dtype, int | None]:
    """The accumulation dtype and the lane count (``None`` unbatched)."""
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
    batch = p.shape[0] if p.dim() == 4 else None
    v_dims = (1,) if batch is None else (1, 2)
    if v.dtype not in (torch.float32, torch.float64) \
            or v.dim() not in v_dims or v.stride(-1) != 1 \
            or (v.dim() == 2 and v.shape[0] != batch):
        raise ValueError(f"dense_backup takes a float32/float64 v of "
                         f"contiguous rows, (n_cols,) or (B, n_cols) for B "
                         f"lanes (any lane stride); got {v.dtype} "
                         f"{tuple(v.shape)} strides {v.stride()}")
    if p.dim() not in (3, 4) or cost.shape != p.shape[:-1] \
            or p.shape[-2] < 1 or p.shape[-1] != v.shape[-1] \
            or v.shape[-1] < 1:
        raise ValueError(f"dense_backup shapes: p ([B,] n, m>=1, "
                         f"n_cols>=1), cost ([B,] n, m), v ([B,] n_cols); "
                         f"got {tuple(p.shape)} {tuple(cost.shape)} "
                         f"{tuple(v.shape)}")
    return v.dtype, batch


def dense_backup(p: torch.Tensor, cost: torch.Tensor, gamma,
                 v: torch.Tensor, *, warps: int | None = None,
                 tuning: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(min_a Q ([B,] n) acc-dtype, argmin_a Q ([B,] n) int32)`` on the
    card, one launch.  ``gamma``: a float, or a ``(B,)`` tensor (one value
    a lane, rounded to the accumulation dtype)."""
    global launches, tune_launches
    dt, batch = _check(p, cost, v)
    warps = DEFAULT_WARPS if warps is None else warps
    if warps not in WARPS:
        raise ValueError(f"warps must be one of {WARPS}, got {warps!r}")
    n, m, n_cols = p.shape[-3:]
    out_v = torch.empty(p.shape[:-2], dtype=dt, device=v.device)
    out_pi = torch.empty(p.shape[:-2], dtype=torch.int32, device=v.device)
    if out_v.numel() == 0:
        return out_v, out_pi
    b = batch or 1
    g, g_stride = lanes.gamma_operand(gamma, b, dt, v.device)
    strides = lanes.strides(
        n * m * n_cols if batch else 0, n * m if batch else 0,
        v.stride(0) if v.dim() == 2 else 0, n if batch else 0, g_stride)
    lib = _lib()
    fn = lib.dense_backup_f64 if dt == torch.float64 else lib.dense_backup_f32
    stream = torch.cuda.current_stream(v.device).cuda_stream
    code = fn(p.data_ptr(), cost.data_ptr(), v.data_ptr(), g.data_ptr(), n, m,
              n_cols, b, int(warps), strides, out_v.data_ptr(),
              out_pi.data_ptr(), stream)
    build.check(code, "dense_backup launch")
    if tuning:
        tune_launches += 1
    else:
        launches += 1
    return out_v, out_pi
