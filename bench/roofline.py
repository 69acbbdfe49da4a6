"""Peaks of the card, and the bytes and matvec counts a solve needs.

Copied from ``chip_smoke.py::bound_ms`` and the bounds of ``PERF.md``'s
kernel table: a kernel's least time is its inputs read once and its
outputs written once over the HBM bandwidth, or its operations over the
peak rate, whichever is larger.  The ELL kernels are bound by bytes.

The counts are of the work the method needs for the counts a solve
reports (``outer_iterations``, ``trace_inner``), never of launches, so
work an implementation does and its result never uses shows as a lower
share.  The per-metric readers in ``bench/metrics/`` say why each rule
counts what it counts.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "bfloat16": 989e12}

INDEX_BYTES = 4          # successor ids are int32
TABLE_BYTES = 4          # transition values and costs are float32
POLICY_BYTES = 4         # the greedy policy is int32
VALUE_BYTES = {"float32": 4, "float64": 8}


def bound_s(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least seconds for ``nbytes`` and ``flops``, and which bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def backup_bytes(n: int, m: int, k: int, dtype: str) -> int:
    """One fused Bellman backup of one instance (``PERF.md`` kernel row
    1): ``idx`` and ``val`` ``(n, m, K)``, ``cost`` ``(n, m)`` and ``v``
    read once; ``min_a Q`` and the policy written once."""
    vb = VALUE_BYTES[dtype]
    return n * m * k * (INDEX_BYTES + TABLE_BYTES) + n * m * TABLE_BYTES \
        + n * vb + n * vb + n * POLICY_BYTES


def matvec_bytes(n: int, k: int, dtype: str) -> int:
    """One policy matvec ``y = x - gamma P_pi x`` of one instance (kernel
    row 2): ``idx`` and ``val`` of ``P_pi`` ``(n, K)`` and ``x`` read
    once, ``y`` written once."""
    vb = VALUE_BYTES[dtype]
    return n * k * (INDEX_BYTES + TABLE_BYTES) + n * vb + n * vb


def gmres_matvecs(trace_inner, restart: int) -> int:
    """Matvecs restarted GMRES needs for the inner counts of one solve: at
    each outer step, the warm start's residual, which decides whether to
    iterate; one residual a restart cycle, from which the cycle's basis
    starts; and one an Arnoldi step that counted (``trace_inner``)."""
    return sum(1 + math.ceil(int(j) / restart) + int(j)
               for j in trace_inner)


def richardson_matvecs(trace_inner) -> int:
    """Matvecs Richardson needs (``mpi``): the residual of the warm start
    and one a sweep that counted, so ``mpi_sweeps`` an outer step."""
    return sum(1 + int(j) for j in trace_inner)


def backups(outer_iterations: int) -> int:
    """Backups a solve needs: the initial one and one an outer step."""
    return 1 + int(outer_iterations)


MATVEC_RULES = {"ipi_gmres": "gmres", "mpi": "richardson"}


def needed_matvecs(method: str, trace_inner, restart: int) -> int:
    rule = MATVEC_RULES[method]
    if rule == "gmres":
        return gmres_matvecs(trace_inner, restart)
    return richardson_matvecs(trace_inner)
