"""BiCGStab (van der Vorst) — short-recurrence Krylov inner solver.

Counterpart of :mod:`repro.core.solvers.bicgstab`: two matvecs per
iteration and O(1) memory (no stored basis), for the nonsymmetric system
``(I - gamma P_pi) x = g_pi``.  Inner products go through ``axes.dot``.

The reference's ``lax.while_loop`` becomes a host loop that reads the
loop condition (residual, breakdown) once per iteration.
:func:`bicgstab_fleet` is the batched form (vmap semantics, one read an
iteration for all lanes); a fleet of one (every unbatched solve) runs
:func:`bicgstab`, as the batched body's views and masks made a single
solve on the H100 about 15% slower (PERF.md, §6).
"""

from __future__ import annotations

import torch

from repro_torch.core.comm import Axes
from repro_torch.core.solvers import lanes

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


def bicgstab_fleet(matvec, b: torch.Tensor, x0: torch.Tensor, *, tol,
                   maxiter: int, axes: Axes, precond=None,
                   live: torch.Tensor | None = None):
    """BiCGStab on a fleet of ``(B, n)`` systems, as ``vmap`` of the
    reference's loop runs it: per-lane ``tol`` (``(B,)`` or shared),
    residual, breakdown flag and count; the loop iterates while any lane
    runs, and a stopped lane keeps its carry.  Lanes outside ``live``
    start stopped.

    ``precond`` is an optional batched right preconditioner apply ``x ->
    M x`` (``M ~= A^-1``); ``r`` stays the true residual ``b - A x``.
    With a preconditioner the loop stops on the measured residual
    ``||b - A x||_2``, as the reference does; ``None`` keeps the plain
    recurrence.  Returns ``(x, iters (B,) int32, ||b - A x||_2 (B,))``.
    """
    if x0.shape[0] == 1 and live is None:
        return lanes.run_unbatched(bicgstab, matvec, b, x0, tol=tol,
                                   maxiter=maxiter, axes=axes,
                                   precond=precond)
    M = precond if precond is not None else (lambda v: v)
    col = lambda t: t[:, None]
    n_lanes = x0.shape[0]
    dev = x0.device
    r = b - matvec(x0)
    rhat = r
    res = axes.norm2_lanes(r)
    x = x0
    p = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    one = torch.ones((n_lanes,), dtype=x0.dtype, device=dev)
    rho, alpha, omega = one, one, one
    breakdown = torch.zeros((n_lanes,), dtype=torch.bool, device=dev)
    run, run_h, it = lanes.start(res > tol, live)
    for _ in range(maxiter):
        if not any(run_h):
            break
        all_run = all(run_h)
        rho_new = axes.dot_lanes(rhat, r)
        small_omega = torch.abs(omega) < _EPS
        bd = (torch.abs(rho_new) < _EPS) | small_omega
        beta = (rho_new / _safe(rho, torch.abs(rho) < _EPS)) * \
            (alpha / _safe(omega, small_omega))
        p1 = r + col(beta) * (p - col(omega) * v)
        phat = M(p1)
        v1 = matvec(phat)
        denom = axes.dot_lanes(rhat, v1)
        small_denom = torch.abs(denom) < _EPS
        bd = bd | small_denom
        alpha1 = rho_new / _safe(denom, small_denom)
        a1 = col(alpha1)
        sres = r - a1 * v1
        shat = M(sres)
        t = matvec(shat)
        tt = axes.dot_lanes(t, t)
        omega1 = axes.dot_lanes(t, sres) / _safe(tt, tt < _EPS)
        w1 = col(omega1)
        x1 = x + a1 * phat + w1 * shat
        r1 = sres - w1 * t
        if precond is None:
            res1 = axes.norm2_lanes(r1)
        else:
            # the recurrence residual drifts from the truth when M is
            # ill-conditioned; stop on the measured one so the iPI
            # safeguard never sees a falsely converged candidate
            res1 = axes.norm2_lanes(b - matvec(x1))
        keep = lambda new, old: lanes.keep(run, all_run, new, old)
        x, r, p, v = keep(x1, x), keep(r1, r), keep(p1, p), keep(v1, v)
        rho, alpha, omega = keep(rho_new, rho), keep(alpha1, alpha), \
            keep(omega1, omega)
        breakdown, res = keep(bd, breakdown), keep(res1, res)
        it = lanes.advance(it, run_h)
        go = (res > tol) & ~breakdown
        run = go if all_run else run & go
        run_h = run.tolist()
    return x, lanes.counts(it, dev), res
