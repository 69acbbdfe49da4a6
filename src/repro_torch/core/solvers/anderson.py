"""Anderson-accelerated value iteration as an inner linear solver.

Counterpart of :mod:`repro.core.solvers.anderson`.  Richardson on
``(I - gamma P_pi) x = g_pi`` is repeated application of ``T_pi``;
Anderson acceleration keeps a sliding window of the last ``m`` iterate
and residual differences and replaces each fixed-point step with the
extrapolation that minimizes the linearized residual over their span.
The history buffers start at zero, so the first iteration is a plain
(damped) Richardson step: zero rows give zero Gram rows and a zero
right-hand side, and the Tikhonov term sends their coefficients to zero.

``deterministic=True`` pins every accumulation order, as the reference's
deterministic mode does: the window Gram matrix and projection are a loop
of one reduction per (lane, lane) pair, the combine is an ordered AXPY
loop, and the small regularized ``m x m`` solve is a fixed-order
Gaussian elimination without pivoting (the regularized Gram matrix is
SPD with a positive diagonal) instead of ``torch.linalg.solve``.

The reference's ``lax.while_loop`` becomes a host loop that reads the
residual once per iteration.
"""

from __future__ import annotations

import torch

from repro_torch.core.comm import Axes

_TINY = 1e-30


def _det_gram(axes: Axes, df: torch.Tensor) -> torch.Tensor:
    """``DF DF^T`` one (i, j) lane pair at a time."""
    return axes.psum_ordered(torch.stack([
        torch.stack([torch.sum(di * dj) for dj in df]) for di in df]))


def _det_rhs(axes: Axes, df: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``DF r`` one lane at a time."""
    return axes.psum_ordered(torch.stack([torch.sum(di * r) for di in df]))


def _det_combine(w: torch.Tensor, dx: torch.Tensor, df: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
    """``(DX + beta DF)^T w`` as an ordered AXPY loop (slot order, from
    zero)."""
    acc = torch.zeros_like(dx[0])
    for j in range(dx.shape[0]):
        acc = acc + w[j] * (dx[j] + beta * df[j])
    return acc


def _det_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Fixed-order Gaussian elimination and back-substitution (no
    pivoting), the reference's ``_det_solve``: row ``i`` eliminates column
    ``i`` from every row below it, then ``y`` is filled from the last row
    up, each row reducing against the whole (partly zero) ``y``."""
    m = a.shape[0]
    below = torch.arange(m, device=a.device)
    for i in range(m):
        f = (a[:, i] / a[i, i]) * (below > i).to(a.dtype)
        a = a - f[:, None] * a[i][None, :]
        rhs = rhs - f * rhs[i]
    y = torch.zeros_like(rhs)
    for t in range(m):
        j = m - 1 - t
        y[j] = (rhs[j] - torch.sum(a[j] * y)) / a[j, j]
    return y


def anderson(matvec, b: torch.Tensor, x0: torch.Tensor, *, tol,
             maxiter: int, axes: Axes, window: int = 5, mixing: float = 1.0,
             reg: float = 1e-10, deterministic: bool = False):
    """Returns ``(x, iters, ||b - A x||_inf)``.

    ``window`` is the AA depth ``m`` (two ``(m, n_local)`` buffers);
    ``mixing`` is the damped-Richardson mixing parameter beta (the
    registry maps ``-omega`` onto it); ``reg`` scales the relative
    Tikhonov term on the window Gram matrix.
    """
    dt, dev = x0.dtype, x0.device
    m = int(window)
    beta = torch.tensor(mixing, dtype=dt, device=dev)
    x = x0
    r = b - matvec(x0)
    res = axes.norm_inf(r)
    dx = torch.zeros((m,) + tuple(x0.shape), dtype=dt, device=dev)
    df = torch.zeros_like(dx)
    eye = torch.eye(m, dtype=dt, device=dev)
    it = 0
    while it < maxiter and bool(res > tol):
        if deterministic:
            gram = _det_gram(axes, df)                       # (m, m)
            rhs = _det_rhs(axes, df, r)                      # (m,)
        else:
            gram = axes.psum_state(df @ df.T)
            rhs = axes.psum_state(df @ r)
        lam = reg * (torch.trace(gram) / m) + _TINY
        if deterministic:
            coef = _det_solve(gram + lam * eye, rhs)
            x_new = x + beta * r - _det_combine(coef, dx, df, beta)
        else:
            coef = torch.linalg.solve(gram + lam * eye, rhs)
            x_new = x + beta * r - (dx + beta * df).T @ coef
        r_new = b - matvec(x_new)
        slot = it % m
        dx[slot] = x_new - x
        df[slot] = r_new - r
        x, r = x_new, r_new
        res = axes.norm_inf(r)
        it += 1
    return x, it, res
