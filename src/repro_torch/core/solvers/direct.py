"""Dense direct policy evaluation — the single-device oracle.

Counterpart of :mod:`repro.core.solvers.direct`: the exact value of a
policy, ``v_pi = (I - gamma P_pi)^{-1} g_pi``, by LU
(:func:`torch.linalg.solve`).  The test suite holds the iterative solves
against it.  It materializes the dense ``n x n`` system, so it is for
small instances.
"""

from __future__ import annotations

import torch

from repro_torch.core.mdp import MDP, EllMDP


def dense_policy_value(mdp: MDP, pi: torch.Tensor) -> torch.Tensor:
    """Exact value of policy ``pi`` (global action ids) on an unsharded MDP,
    in the reference's dtype (at least float32), on the tables' device."""
    n = mdp.n_local
    if n != mdp.n_global:
        raise ValueError("direct solve requires the full (unsharded) MDP")
    dense = mdp.as_dense() if isinstance(mdp, EllMDP) else mdp
    pi = torch.as_tensor(pi, device=dense.device).long()
    rows = torch.arange(n, device=dense.device)
    dt = torch.promote_types(torch.float32, dense.p.dtype)
    p_pi = dense.p[rows, pi]            # (n, n)
    g_pi = dense.cost[rows, pi]         # (n,)
    a = torch.eye(n, dtype=dt, device=dense.device) \
        - dense.gamma * p_pi.to(dt)
    return torch.linalg.solve(a, g_pi.to(dt))
