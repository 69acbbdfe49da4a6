"""Restarted GMRES with CGS2 orthogonalization and Givens rotations.

Counterpart of :mod:`repro.core.solvers.gmres` (the non-deterministic,
unpreconditioned path): the inner solver behind iGMRES-PI.

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
"""

from __future__ import annotations

import torch

from repro_torch.core.comm import Axes

_TINY = 1e-30


def _arnoldi_cycle(matvec, b, x, *, restart: int, tol, axes: Axes):
    """One restart cycle.  Returns ``(x_new, resnorm, iters_done)`` with
    ``resnorm`` and ``iters_done`` as 0-d device tensors."""
    n_local = x.shape[0]
    dt, dev = x.dtype, x.device
    r = b - matvec(x)
    beta = axes.norm2(r)
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
        w = matvec(V[j])
        # CGS2: two masked classical Gram-Schmidt passes
        mask = (row_ids <= j).to(dt)
        h1 = mask * axes.psum_state(V @ w)
        w = w - h1 @ V
        h2 = mask * axes.psum_state(V @ w)
        w = w - h2 @ V
        h = h1 + h2
        hnorm = axes.norm2(w)
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
        col[j + 1] = 0.0
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
    y = torch.linalg.solve_triangular(R_m, g_m[:, None], upper=True)[:, 0]
    x_new = x + y @ V[:restart]
    return x_new, res, it


def gmres(matvec, b: torch.Tensor, x0: torch.Tensor, *, tol, maxiter: int,
          axes: Axes, restart: int = 32):
    """Restarted GMRES.  Returns ``(x, iters, resnorm_2)``."""
    restart = int(restart)
    r0 = b - matvec(x0)
    res = axes.norm2(r0)
    x, it = x0, 0
    go = bool(res > tol)
    while go and it < maxiter:
        x, res, done_iters = _arnoldi_cycle(matvec, b, x, restart=restart,
                                            tol=tol, axes=axes)
        # one device read per cycle: the step count and the loop condition
        more, n_it = torch.stack([(res > tol).to(torch.int64),
                                  done_iters.to(torch.int64)]).tolist()
        go, it = bool(more), it + n_it
    return x, it, res
