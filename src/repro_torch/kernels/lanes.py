"""The fleet lane axis's launch arguments (``csrc/lanes.cuh``), and the
ELL kernels' CTA size.

The three MDP kernels take a lane count, per-lane element strides (0 for
an operand every lane shares) and a per-lane gamma operand; the ELL
kernels also take the grid order and the CTA size.  The wrappers build
those arguments here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Grid order of the ELL kernels' lane axis: "fastest" puts the lanes of
# one row tile side by side, so a shared idx tile is read from HBM once
# and served from L2 to the other lanes; "slowest" runs each lane's tiles
# in turn.  Measured on the H100 at B = 4, n = 10^6 (PERF.md, §6): the
# two are even in float32, and lane-fastest takes 24-29% longer in
# float64, shared idx or not — the ELL kernels are bound by the gather of
# v, and lane-fastest keeps all four lanes' v (32 MB in float64) live in L2
# at once.  The dense kernel always runs lane-slowest.
LANE_ORDERS = ("fastest", "slowest")
LANE_ORDER = "slowest"

# The ELL kernels' CTA sizes (``csrc/ell_common.cuh``: each kernel is
# instantiated for every one) and the default.  A warp takes its own rows
# whatever its CTA holds, so the choice moves the grid and no bit of the
# result; the tuner (:mod:`repro_torch.kernels.ops`) picks among them.
THREADS = (128, 256, 512)
DEFAULT_THREADS = 256


def order_flag(order: str | None) -> int:
    """The ELL entry points' ``lane_fastest`` flag for ``order``."""
    order = LANE_ORDER if order is None else order
    if order not in LANE_ORDERS:
        raise ValueError(f"lane order must be one of {LANE_ORDERS}, got "
                         f"{order!r}")
    return int(order == "fastest")


def cta_threads(threads: int | None) -> int:
    """The ELL entry points' ``threads`` argument for ``threads``
    (``None``: the default), checked against :data:`THREADS`."""
    threads = DEFAULT_THREADS if threads is None else threads
    if threads not in THREADS:
        raise ValueError(f"threads must be one of {THREADS}, got "
                         f"{threads!r}")
    return int(threads)


def strides(*elements: int):
    """Per-lane element strides as the C entry points' ``long long``
    array."""
    return (ctypes.c_longlong * len(elements))(*elements)


@functools.lru_cache(maxsize=256)
def _scalar(gamma: float, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    return torch.full((1,), gamma, dtype=dtype, device=device)


def gamma_operand(gamma, lanes: int, dtype: torch.dtype,
                  device: torch.device) -> tuple[torch.Tensor, int]:
    """``(tensor, lane stride)`` of the kernels' gamma operand in the
    accumulation dtype: a ``(B,)`` tensor (stride 1), or a float (one
    cached device value, stride 0: rounded to ``dtype`` as a by-value
    argument would be, and written once, so a solve's launches add no
    copy)."""
    if isinstance(gamma, torch.Tensor):
        g = gamma.to(device=device, dtype=dtype).reshape(-1).contiguous()
        if g.numel() == 1:
            return g, 0
        if g.numel() != lanes:
            raise ValueError(f"gamma has {g.numel()} values for {lanes} "
                             f"lanes")
        return g, 1
    return _scalar(float(gamma), dtype, device), 0
