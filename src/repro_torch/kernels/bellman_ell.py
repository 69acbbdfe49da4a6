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

A fleet is one launch of each: ``val`` ``(B, n, m, K)``, ``cost``
``(B, n, m)``, ``idx`` ``(B, n, m, K)`` or shared ``(n, m, K)``, ``v``
``(B, n_v)`` or shared ``(n_v,)``, and ``gamma`` a float or a ``(B,)``
tensor.  The backup also takes every table shared (``idx`` / ``val`` /
``cost`` unbatched) with a batched ``v``: a matrix-free fleet's row chunk,
rebuilt once for all its lanes, whose lanes differ only in ``v`` and
gamma; the kernel's lane axis (``csrc/lanes.cuh``) gives each lane the
unbatched body, so lane ``b`` equals the unbatched call on lane ``b``'s
operands bit for bit.

Both take CUDA tensors only, check them, allocate the outputs, launch on
PyTorch's current stream and raise on any launch error.  ``launches``
counts the backup's launches, ``qvalues_launches`` the Q table's (one a
call, whatever B).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, lanes, spmv_ell

SOURCE = "ell_backup"

launches = 0
qvalues_launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.ell_backup_f32, lib.ell_backup_f64):
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32,
                           ptr, ptr, ptr, ptr]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(idx, val, cost, v, what: str = "ell_backup") \
        -> tuple[torch.dtype, int | None]:
    """The accumulation dtype and the lane count (``None`` unbatched)."""
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
    # a batched val / cost sets the lane count; shared tables take it from
    # a batched v (a matrix-free fleet's rebuilt chunk, one for all lanes)
    batch = val.shape[0] if val.dim() == 4 \
        else (v.shape[0] if v.dim() == 2 and what == "ell_backup" else None)
    v_dims = (1,) if batch is None else (1, 2)
    if v.dtype not in (torch.float32, torch.float64) \
            or v.dim() not in v_dims or v.stride(-1) != 1 \
            or (v.dim() == 2 and v.shape[0] != batch):
        raise ValueError(f"{what} takes a float32/float64 v of contiguous "
                         f"rows, (n_v,) or (B, n_v) for B lanes (any lane "
                         f"stride); got {v.dtype} {tuple(v.shape)} strides "
                         f"{v.stride()}")
    if val.dim() not in (3, 4) or idx.shape[-3:] != val.shape[-3:] \
            or idx.dim() not in (3, val.dim()) \
            or (idx.dim() == 4 and idx.shape[0] != batch) \
            or cost.shape != val.shape[:-1] or val.shape[-2] < 1:
        raise ValueError(f"{what} shapes: val ([B,] n, m>=1, K), cost "
                         f"([B,] n, m), idx as val or shared (n, m, K); got "
                         f"{tuple(idx.shape)} {tuple(val.shape)} "
                         f"{tuple(cost.shape)}")
    return v.dtype, batch


def ell_backup(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
               gamma, v: torch.Tensor, *, lane_order: str | None = None) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """``(min_a Q ([B,] n) acc-dtype, argmin_a Q ([B,] n) int32)`` on the
    card, one launch.  ``gamma``: a float, or a ``(B,)`` tensor (one value
    a lane, rounded to the accumulation dtype)."""
    global launches
    dt, batch = _check(idx, val, cost, v)
    n, m, k = val.shape[-3:]
    shape = (n,) if batch is None else (batch, n)
    out_v = torch.empty(shape, dtype=dt, device=v.device)
    out_pi = torch.empty(shape, dtype=torch.int32, device=v.device)
    if out_v.numel() == 0:
        return out_v, out_pi
    b = batch or 1
    own = val.dim() == 4      # per-lane val / cost, else shared
    g, g_stride = lanes.gamma_operand(gamma, b, dt, v.device)
    strides = lanes.strides(
        n * m * k if idx.dim() == 4 else 0, n * m * k if own else 0,
        n * m if own else 0, v.stride(0) if v.dim() == 2 else 0,
        n if batch else 0, g_stride)
    lib = _lib()
    fn = lib.ell_backup_f64 if dt == torch.float64 else lib.ell_backup_f32
    stream = torch.cuda.current_stream(v.device).cuda_stream
    code = fn(idx.data_ptr(), val.data_ptr(), cost.data_ptr(), v.data_ptr(),
              g.data_ptr(), n, m, k, b, lanes.order_flag(lane_order),
              strides, out_v.data_ptr(), out_pi.data_ptr(), stream)
    build.check(code, "ell_backup launch")
    launches += 1
    return out_v, out_pi


def ell_qvalues(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
                gamma, v: torch.Tensor, *,
                lane_order: str | None = None) -> torch.Tensor:
    """``Q = cost + gamma * P v`` ([B,] n, m) in the accumulation dtype, on
    the card: one SpMV launch over the ``(n*m, K)`` rows of every lane,
    then the epilogue as two torch ops (``gamma * pv`` rounded before
    ``+ cost``; a ``(B,)`` gamma one value a lane)."""
    global qvalues_launches
    _, batch = _check(idx, val, cost, v, "ell_qvalues")
    n, m, k = val.shape[-3:]
    rows = lambda t: t.view(*t.shape[:-3], n * m, k)
    pv = spmv_ell.launch(rows(idx), rows(val), v, lane_order=lane_order)
    if pv.numel():
        qvalues_launches += 1
    pv = pv.view(cost.shape)
    if isinstance(gamma, torch.Tensor):
        gamma = gamma.to(device=pv.device, dtype=pv.dtype).reshape(
            (-1,) + (1,) * (pv.dim() - 1))
    return cost.to(pv.dtype) + gamma * pv
