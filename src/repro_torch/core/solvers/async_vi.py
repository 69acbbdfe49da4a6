"""Asynchronous value iteration — shards run ahead between value exchanges.

Counterpart of :mod:`repro.core.solvers.async_vi`.  The bulk-synchronous
methods pay one value-window movement (all-gather or halo exchange) per
Bellman backup.  Asynchronous VI (Bertsekas & Tsitsiklis style) relaxes
that: each shard runs ``opts.async_sweeps`` local Bellman sweeps against a
*stale* window — the last exchanged value vector, with only its own block
kept fresh — and exchanges values once per outer iteration.

Convergence stays certified: the residual and span handed to the stop
criterion always come from the *synchronous* backup at the exchange point
(a fresh window everywhere), so the span gap certificate holds exactly as
for synchronous VI.  The stale window lives in ``SolveState.win`` with the
invariant ``win == gather_v(v)`` at every outer-iteration boundary.
"""

from __future__ import annotations

import torch

from repro_torch.core import bellman


def async_vi_outer(mdp, state, opts, axes, gamma_t):
    """One async-VI outer iteration of every lane: the
    :attr:`repro_torch.core.methods.MethodSpec.outer` contract, returning
    ``(v1, tv1, pi1, res1, inner_iters (B,) int32, win1)``.  ``state.tv``
    is already one synchronous backup ahead, so ``async_sweeps - 1`` stale
    sweeps and the certifying synchronous backup give ``async_sweeps``
    Bellman updates per value exchange; ``async_sweeps=1`` is ``vi`` bit
    for bit."""
    dt = state.v.dtype
    off = bellman.window_offset(mdp, axes, opts.halo)
    v1 = state.tv
    for _ in range(opts.async_sweeps - 1):
        w = state.win.clone()
        w[..., off:off + mdp.n_local] = v1
        tv, _ = bellman.backup(mdp, w, axes, mode=opts.mode, gamma_t=gamma_t)
        v1 = tv.to(dt)
    tv1, pi1, win1 = bellman.gather_backup(
        mdp, v1, axes, plan=opts.overlap_plan, halo=opts.halo,
        mode=opts.mode, gamma_t=gamma_t)
    tv1 = tv1.to(dt)
    res1 = axes.norm_inf(tv1 - v1)
    inner = torch.full((v1.shape[0],), opts.async_sweeps - 1,
                       dtype=torch.int32, device=v1.device)
    return v1, tv1, pi1, res1, inner, win1.to(dt)
