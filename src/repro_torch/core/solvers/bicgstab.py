"""BiCGStab (van der Vorst) — short-recurrence Krylov inner solver.

Counterpart of :mod:`repro.core.solvers.bicgstab`: two matvecs per
iteration and O(1) memory (no stored basis), for the nonsymmetric system
``(I - gamma P_pi) x = g_pi``.  Inner products go through ``axes.dot``.

The reference's ``lax.while_loop`` becomes a host loop that reads the
loop condition (residual, breakdown) once per iteration.
"""

from __future__ import annotations

import torch

from repro_torch.core.comm import Axes

_EPS = 1e-30


def _safe(x: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    """``x`` with entries of magnitude below ``_EPS`` (``small``) replaced
    by ``_EPS``, as the reference's ``where(|x| < EPS, EPS, x)``."""
    return torch.where(small, torch.full_like(x, _EPS), x)


def bicgstab(matvec, b: torch.Tensor, x0: torch.Tensor, *, tol,
             maxiter: int, axes: Axes, precond=None):
    """Returns ``(x, iters, ||b - A x||_2)``.

    ``precond`` is an optional right preconditioner apply ``x -> M x``
    (``M ~= A^-1``); ``r`` stays the true residual ``b - A x``.  With a
    preconditioner the loop stops on the measured residual
    ``||b - A x||_2``, as the reference does; ``None`` keeps the plain
    recurrence.
    """
    M = precond if precond is not None else (lambda v: v)
    r = b - matvec(x0)
    rhat = r
    res = axes.norm2(r)
    x = x0
    p = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    one = torch.ones((), dtype=x0.dtype, device=x0.device)
    rho, alpha, omega = one, one, one
    breakdown = torch.zeros((), dtype=torch.bool, device=x0.device)
    it = 0
    while it < maxiter and bool((res > tol) & ~breakdown):
        rho_new = axes.dot(rhat, r)
        small_omega = torch.abs(omega) < _EPS
        breakdown = (torch.abs(rho_new) < _EPS) | small_omega
        beta = (rho_new / _safe(rho, torch.abs(rho) < _EPS)) * \
            (alpha / _safe(omega, small_omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        denom = axes.dot(rhat, v)
        small_denom = torch.abs(denom) < _EPS
        breakdown = breakdown | small_denom
        alpha = rho_new / _safe(denom, small_denom)
        sres = r - alpha * v
        shat = M(sres)
        t = matvec(shat)
        tt = axes.dot(t, t)
        omega = axes.dot(t, sres) / _safe(tt, tt < _EPS)
        x = x + alpha * phat + omega * shat
        r = sres - omega * t
        if precond is None:
            res = axes.norm2(r)
        else:
            # the recurrence residual drifts from the truth when M is
            # ill-conditioned; stop on the measured one so the iPI
            # safeguard never sees a falsely converged candidate
            res = axes.norm2(b - matvec(x))
        rho = rho_new
        it += 1
    return x, it, res
