"""Restarted GMRES with CGS2 orthogonalization and Givens rotations.

Counterpart of :mod:`repro.core.solvers.gmres`: the inner solver behind
iGMRES-PI, with the reference's optional right preconditioner and its
deterministic mode.

Each restart cycle runs all ``restart`` Arnoldi steps, as the reference's
``fori_loop`` does, and masks every update after convergence with
``torch.where`` — so the host reads the device once per cycle, not once
per step, and the inner count comes from the masked step counter exactly
as in the reference.  The Givens rotations are a Python loop over 0-d
tensors (the reference's masked loop over ``i < j``, with ``j`` known on
the host).  ``V @ w`` and ``h @ V`` are plain products, left to
``torch.matmul`` as the reference leaves them to XLA; their summation order
differs between the two packages and between CPU and GPU, so Krylov values
agree to a tolerance, not bit for bit.

Deterministic mode (``deterministic=True``, ``-deterministic_dots``) pins
every accumulation order instead, as the reference's does: each
projection is a loop of one elementwise-multiply-and-sum per basis lane,
each basis combination an ordered AXPY loop, and the Hessenberg solve an
explicit back-substitution.  No BLAS product is left whose blocking could
depend on the library or the shape, and the partial sums of the state
shards are added in rank order (:meth:`~repro_torch.core.comm.Axes.
psum_ordered`), whatever order the collective library reduces in: the
reference's "exactness at equal state-shard count".

:func:`gmres_fleet` is the batched form for a fleet of ``(B, n)``
systems, with ``vmap`` semantics: each lane has its own tolerance, step
count and residual; the cycle loop runs while any lane has ``res > tol``
and ``it < maxiter``, and a lane that has stopped keeps its carry.  The
basis is ``(B, restart + 1, n)``, ``V @ w`` and ``h @ V`` are batched
products (``torch.bmm``), and the Givens update runs on ``(B,)`` tensors,
so the launches of a cycle do not grow with B.  A fleet of one (every
unbatched solve) runs :func:`gmres`: the batched body's views and masks
made a single solve on the H100 10-15% slower (PERF.md, §6).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.comm import Axes
from repro_torch.core.solvers import lanes
from repro_torch.utils import trace

_TINY = 1e-30


def _det_dot(axes: Axes, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> as an elementwise multiply and one reduction (never a BLAS
    dot), then the sum over state shards in rank order."""
    return axes.psum_ordered(torch.sum(x * y))


def _det_norm2(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(_det_dot(axes, x, x), 0.0))


def _det_projections(axes: Axes, V: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """The CGS2 projection ``V @ w`` one basis lane at a time."""
    return axes.psum_ordered(torch.stack([torch.sum(vj * w) for vj in V]))


def _det_combine(h: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``h @ V`` as an ordered AXPY loop (lane order, from zero)."""
    acc = torch.zeros_like(V[0])
    for j in range(V.shape[0]):
        acc = acc + h[j] * V[j]
    return acc


def _det_backsolve(R: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Upper-triangular solve by explicit back-substitution: ``y`` is
    filled from the last row up, each row reducing against the whole
    ``y`` (its unassigned entries are still zero)."""
    n = R.shape[0]
    y = torch.zeros_like(g)
    for i in range(n):
        j = n - 1 - i
        y[j] = (g[j] - torch.sum(R[j] * y)) / R[j, j]
    return y


def _arnoldi_cycle(matvec, b, x, *, restart: int, tol, axes: Axes,
                   deterministic: bool = False, precond=None):
    """One restart cycle.  Returns ``(x_new, resnorm, iters_done)`` with
    ``resnorm`` and ``iters_done`` as 0-d device tensors."""
    n_local = x.shape[0]
    dt, dev = x.dtype, x.device
    M = precond if precond is not None else (lambda v: v)
    norm2 = (lambda v: _det_norm2(axes, v)) if deterministic else axes.norm2
    r = b - matvec(x)
    beta = norm2(r)
    v0 = r / torch.where(beta > _TINY, beta, 1.0)

    V = torch.zeros((restart + 1, n_local), dtype=dt, device=dev)
    V[0] = v0
    R = torch.zeros((restart, restart), dtype=dt, device=dev)
    cs = torch.zeros((restart,), dtype=dt, device=dev)
    sn = torch.zeros((restart,), dtype=dt, device=dev)
    g = torch.zeros((restart + 1,), dtype=dt, device=dev)
    g[0] = beta
    row_ids = torch.arange(restart + 1, device=dev)
    res = beta
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = beta <= tol

    for j in range(restart):
        # right preconditioning: the Krylov space of A M, the solution
        # mapped back through M at the cycle's end, so the Givens
        # estimate stays the true residual ||b - A x||
        w = matvec(M(V[j]))
        # CGS2: two masked classical Gram-Schmidt passes
        with trace.span("gmres.orthogonalize", device=dev):
            mask = (row_ids <= j).to(dt)
            if deterministic:
                h1 = mask * _det_projections(axes, V, w)
                w = w - _det_combine(h1, V)
                h2 = mask * _det_projections(axes, V, w)
                w = w - _det_combine(h2, V)
            else:
                h1 = mask * axes.psum_state(V @ w)
                w = w - h1 @ V
                h2 = mask * axes.psum_state(V @ w)
                w = w - h2 @ V
        with trace.span("gmres.givens"):
            h = h1 + h2
            hnorm = norm2(w)
            v_next = w / torch.where(hnorm > _TINY, hnorm, 1.0)

            # Apply the j previous Givens rotations to the new column; rotation
            # i touches positions (i, i+1) <= j, so h[j+1] (== hnorm) stays.
            h[j + 1] = hnorm
            for i in range(j):
                hi, hi1 = h[i].clone(), h[i + 1].clone()
                h[i] = cs[i] * hi + sn[i] * hi1
                h[i + 1] = -sn[i] * hi + cs[i] * hi1
            hj, hj1 = h[j].clone(), hnorm

            denom = torch.sqrt(hj * hj + hj1 * hj1)
            safe = denom > _TINY
            safe_denom = torch.where(safe, denom, 1.0)
            c_new = torch.where(safe, hj / safe_denom, 1.0)
            s_new = torch.where(safe, hj1 / safe_denom, 0.0)
            gj = g[j].clone()
            g_new = g.clone()
            g_new[j + 1] = -s_new * gj
            g_new[j] = c_new * gj
            res_new = torch.abs(-s_new * gj)

            # Column j of R: rotated h (j -> denom; the subdiagonal entry j+1
            # is annihilated by the new rotation).  Every update is dropped
            # once the cycle has converged.
            col = h.clone()
            col[j] = denom
            # a slice, not an element: a scalar written into a 0-d view of
            # a CUDA tensor is copied from the host and waits for the device
            col[j + 1:j + 2] = 0.0
            live = ~done
            V[j + 1] = torch.where(live, v_next, V[j + 1])
            R[:, j] = torch.where(live, col[:restart], R[:, j])
            cs[j] = torch.where(live, c_new, cs[j])
            sn[j] = torch.where(live, s_new, sn[j])
            g = torch.where(live, g_new, g)
            res = torch.where(live, res_new, res)
            it = it + live.to(torch.int32)
            done = done | (res <= tol)

    # Solve the (iters x iters) triangular system; mask out unused columns.
    active = torch.arange(restart, device=dev) < it
    diag_fix = torch.diag(torch.where(active, 0.0, 1.0).to(dt))
    R_m = torch.where(active[None, :] & active[:, None], R, 0.0) + diag_fix
    g_m = torch.where(active, g[:restart], 0.0)
    if deterministic:
        y = _det_backsolve(R_m, g_m)
        x_new = x + M(_det_combine(y, V[:restart]))
    else:
        y = torch.linalg.solve_triangular(R_m, g_m[:, None],
                                          upper=True)[:, 0]
        x_new = x + M(y @ V[:restart])
    if precond is not None:
        # with an ill-conditioned M the rounding of x + M(V y) can leave
        # the true residual far above the Givens estimate: measure it (one
        # matvec a cycle); the plain path keeps the estimate
        res = norm2(b - matvec(x_new))
    return x_new, res, it


def gmres(matvec, b: torch.Tensor, x0: torch.Tensor, *, tol, maxiter: int,
          axes: Axes, restart: int = 32, deterministic: bool = False,
          precond=None):
    """Restarted GMRES.  Returns ``(x, iters, resnorm_2)``.

    ``deterministic=True`` pins every accumulation order (module
    docstring).  ``precond`` is an optional right preconditioner apply
    ``x -> M x`` (``M ~= A^-1``); ``None`` keeps the plain path bit for
    bit.
    """
    restart = int(restart)
    r0 = b - matvec(x0)
    res = _det_norm2(axes, r0) if deterministic else axes.norm2(r0)
    x, it = x0, 0
    go = bool(trace.to_host(res > tol, "gmres.go"))
    while go and it < maxiter:
        with trace.span("gmres.cycle"):
            x, res, done_iters = _arnoldi_cycle(
                matvec, b, x, restart=restart, tol=tol, axes=axes,
                deterministic=deterministic, precond=precond)
        # one device read per cycle: the step count and the loop condition
        more, n_it = trace.to_host(torch.stack(
            [(res > tol).to(torch.int64), done_iters.to(torch.int64)]),
            "gmres.cycle").tolist()
        go, it = bool(more), it + n_it
    return x, it, res


# --------------------------------------------------------------------------- #
# Fleets: the same cycle over (B, n) systems                                  #
# --------------------------------------------------------------------------- #

def _det_projections_lanes(axes: Axes, V: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """Batched :func:`_det_projections`: ``(B, restart + 1)``, one
    multiply-and-sum per basis lane."""
    return axes.psum_ordered(torch.stack(
        [torch.sum(V[:, j] * w, dim=-1) for j in range(V.shape[1])], dim=1))


def _det_combine_lanes(h: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Batched :func:`_det_combine`: ``h[b] @ V[b]`` as an ordered AXPY
    loop."""
    acc = torch.zeros_like(V[:, 0])
    for j in range(V.shape[1]):
        acc = acc + h[:, j:j + 1] * V[:, j]
    return acc


def _det_backsolve_lanes(R: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Batched :func:`_det_backsolve`."""
    n = R.shape[-1]
    y = torch.zeros_like(g)
    for i in range(n):
        j = n - 1 - i
        y[:, j] = (g[:, j] - torch.sum(R[:, j] * y, dim=-1)) / R[:, j, j]
    return y


def _arnoldi_cycle_fleet(matvec, b, x, *, restart: int, tol, axes: Axes,
                         deterministic: bool = False, precond=None):
    """One restart cycle of every lane: :func:`_arnoldi_cycle` over a
    leading lane axis.  Returns ``(x_new, resnorm, iters_done)``, each with
    a leading ``B``."""
    lanes, n_local = x.shape
    dt, dev = x.dtype, x.device
    M = precond if precond is not None else (lambda v: v)
    if deterministic:
        norm2 = lambda v: torch.sqrt(torch.clamp_min(
            axes.psum_ordered(torch.sum(v * v, dim=-1)), 0.0))
    else:
        norm2 = axes.norm2_lanes
    r = b - matvec(x)
    beta = norm2(r)
    v0 = r / torch.where(beta > _TINY, beta, 1.0)[:, None]

    V = torch.zeros((lanes, restart + 1, n_local), dtype=dt, device=dev)
    V[:, 0] = v0
    R = torch.zeros((lanes, restart, restart), dtype=dt, device=dev)
    cs = torch.zeros((lanes, restart), dtype=dt, device=dev)
    sn = torch.zeros((lanes, restart), dtype=dt, device=dev)
    g = torch.zeros((lanes, restart + 1), dtype=dt, device=dev)
    g[:, 0] = beta
    row_ids = torch.arange(restart + 1, device=dev)
    res = beta
    it = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    done = beta <= tol

    for j in range(restart):
        w = matvec(M(V[:, j]))
        with trace.span("gmres.orthogonalize", device=dev):
            mask = (row_ids <= j).to(dt)
            if deterministic:
                h1 = mask * _det_projections_lanes(axes, V, w)
                w = w - _det_combine_lanes(h1, V)
                h2 = mask * _det_projections_lanes(axes, V, w)
                w = w - _det_combine_lanes(h2, V)
            else:
                h1 = mask * axes.psum_state(
                    torch.bmm(V, w[:, :, None])[..., 0])
                w = w - torch.bmm(h1[:, None, :], V)[:, 0]
                h2 = mask * axes.psum_state(
                    torch.bmm(V, w[:, :, None])[..., 0])
                w = w - torch.bmm(h2[:, None, :], V)[:, 0]
        with trace.span("gmres.givens"):
            h = h1 + h2
            hnorm = norm2(w)
            v_next = w / torch.where(hnorm > _TINY, hnorm, 1.0)[:, None]

            h[:, j + 1] = hnorm
            for i in range(j):
                hi, hi1 = h[:, i].clone(), h[:, i + 1].clone()
                h[:, i] = cs[:, i] * hi + sn[:, i] * hi1
                h[:, i + 1] = -sn[:, i] * hi + cs[:, i] * hi1
            hj, hj1 = h[:, j].clone(), hnorm

            denom = torch.sqrt(hj * hj + hj1 * hj1)
            safe = denom > _TINY
            safe_denom = torch.where(safe, denom, 1.0)
            c_new = torch.where(safe, hj / safe_denom, 1.0)
            s_new = torch.where(safe, hj1 / safe_denom, 0.0)
            gj = g[:, j].clone()
            g_new = g.clone()
            g_new[:, j + 1] = -s_new * gj
            g_new[:, j] = c_new * gj
            res_new = torch.abs(-s_new * gj)

            col = h.clone()
            col[:, j] = denom
            col[:, j + 1] = 0.0
            live = ~done
            V[:, j + 1] = torch.where(live[:, None], v_next, V[:, j + 1])
            R[:, :, j] = torch.where(live[:, None], col[:, :restart],
                                     R[:, :, j])
            cs[:, j] = torch.where(live, c_new, cs[:, j])
            sn[:, j] = torch.where(live, s_new, sn[:, j])
            g = torch.where(live[:, None], g_new, g)
            res = torch.where(live, res_new, res)
            it = it + live.to(torch.int32)
            done = done | (res <= tol)

    active = torch.arange(restart, device=dev)[None, :] < it[:, None]
    diag_fix = torch.diag_embed(torch.where(active, 0.0, 1.0).to(dt))
    R_m = torch.where(active[:, None, :] & active[:, :, None], R, 0.0) \
        + diag_fix
    g_m = torch.where(active, g[:, :restart], 0.0)
    if deterministic:
        y = _det_backsolve_lanes(R_m, g_m)
        x_new = x + M(_det_combine_lanes(y, V[:, :restart]))
    else:
        y = torch.linalg.solve_triangular(R_m, g_m[..., None],
                                          upper=True)[..., 0]
        x_new = x + M(torch.bmm(y[:, None, :], V[:, :restart])[:, 0])
    if precond is not None:
        res = norm2(b - matvec(x_new))
    return x_new, res, it


def gmres_fleet(matvec, b: torch.Tensor, x0: torch.Tensor, *, tol,
                maxiter: int, axes: Axes, restart: int = 32,
                deterministic: bool = False, precond=None,
                live: torch.Tensor | None = None):
    """Restarted GMRES on a fleet of ``(B, n)`` systems (module
    docstring): ``tol`` is ``(B,)`` or shared, ``precond`` a batched
    apply, and lanes outside ``live`` start stopped.  One device read per
    cycle for all lanes.  Returns ``(x, iters (B,) int32, resnorm_2
    (B,))``."""
    restart = int(restart)
    if x0.shape[0] == 1 and live is None:
        return lanes.run_unbatched(
            gmres, matvec, b, x0, tol=tol, maxiter=maxiter, axes=axes,
            restart=restart, deterministic=deterministic, precond=precond)
    r0 = b - matvec(x0)
    if deterministic:
        res = torch.sqrt(torch.clamp_min(
            axes.psum_ordered(torch.sum(r0 * r0, dim=-1)), 0.0))
    else:
        res = axes.norm2_lanes(r0)
    x = x0
    run, run_h, it = lanes.start(res > tol, live)
    run_h = [r and maxiter > 0 for r in run_h]
    while any(run_h):
        all_run = all(run_h)
        with trace.span("gmres.cycle"):
            x1, res1, n1 = _arnoldi_cycle_fleet(
                matvec, b, x, restart=restart, tol=tol, axes=axes,
                deterministic=deterministic, precond=precond)
        x = lanes.keep(run, all_run, x1, x)
        res = lanes.keep(run, all_run, res1, res)
        # one device read per cycle: the lanes' step counts and residual
        # tests
        more, n_it = trace.to_host(torch.stack(
            [(res > tol).to(torch.int64), n1.to(torch.int64)]),
            "gmres.cycle").tolist()
        it = lanes.advance(it, run_h, n_it)
        run_h = [r and bool(m) and i < maxiter
                 for r, m, i in zip(run_h, more, it)]
        if not all(run_h):
            run = lanes.to_device(np.asarray(run_h), x.device)
    return x, lanes.counts(it, x0.device), res
