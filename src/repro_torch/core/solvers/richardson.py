"""(Damped) Richardson iteration.

Counterpart of :mod:`repro.core.solvers.richardson`.  For the
policy-evaluation system ``(I - gamma P_pi) x = g_pi`` with ``omega = 1``
one Richardson sweep is exactly one application of ``T_pi``, so
Richardson(0 sweeps) == value iteration and Richardson(L-1 sweeps) ==
modified policy iteration.  Stopping is on the sup-norm residual.

The reference's ``lax.while_loop`` becomes a host loop that reads the
residual once per sweep.
"""

from __future__ import annotations

import torch

from repro_torch.core.comm import Axes


def richardson(matvec, b: torch.Tensor, x0: torch.Tensor, *, tol,
               maxiter: int, axes: Axes, omega: float = 1.0):
    """Returns ``(x, iters, ||b - A x||_inf)``."""

    def resid(x):
        r = b - matvec(x)
        return r, axes.pmax_state(torch.max(torch.abs(r)))

    x = x0
    r, norm = resid(x)
    it = 0
    while it < maxiter and bool(norm > tol):
        x = x + omega * r
        r, norm = resid(x)
        it += 1
    return x, it, norm
