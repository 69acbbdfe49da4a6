"""(Damped) Richardson iteration.

Counterpart of :mod:`repro.core.solvers.richardson`.  For the
policy-evaluation system ``(I - gamma P_pi) x = g_pi`` with ``omega = 1``
one Richardson sweep is exactly one application of ``T_pi``, so
Richardson(0 sweeps) == value iteration and Richardson(L-1 sweeps) ==
modified policy iteration.  Stopping is on the sup-norm residual.

:func:`richardson_fleet` runs a fleet of ``(B, n)`` systems with ``vmap``
semantics; the reference's ``lax.while_loop`` becomes a host loop that
reads the lanes' running mask once per sweep.  :func:`richardson` is its
B = 1 case.
"""

from __future__ import annotations

import torch

from repro_torch.core.comm import Axes
from repro_torch.core.solvers import lanes
from repro_torch.utils import trace


def richardson_fleet(matvec, b: torch.Tensor, x0: torch.Tensor, *, tol,
                     maxiter: int, axes: Axes, omega: float = 1.0,
                     live: torch.Tensor | None = None):
    """Richardson on a fleet of ``(B, n)`` systems, as ``vmap`` of the
    reference's loop runs it: each lane has its own ``tol`` (a ``(B,)``
    or shared tensor), residual and count; the loop sweeps while any lane
    is running, and a lane that has stopped keeps its carry untouched.
    Lanes outside ``live`` start stopped.  Returns ``(x, iters (B,)
    int32, ||b - A x||_inf (B,))``."""

    def resid(x):
        r = b - matvec(x)
        return r, axes.norm_inf(r)

    x = x0
    r, norm = resid(x)
    run, run_h, it = lanes.start(norm > tol, live)
    for _ in range(maxiter):
        if not any(run_h):
            break
        all_run = all(run_h)
        x1 = x + omega * r
        r1, norm1 = resid(x1)
        x = lanes.keep(run, all_run, x1, x)
        r = lanes.keep(run, all_run, r1, r)
        norm = lanes.keep(run, all_run, norm1, norm)
        it = lanes.advance(it, run_h)
        run = (norm > tol) if all_run else run & (norm > tol)
        run_h = trace.to_host(run, "richardson.sweep").tolist()
    return x, lanes.counts(it, x0.device), norm


richardson = lanes.one_lane(richardson_fleet)
