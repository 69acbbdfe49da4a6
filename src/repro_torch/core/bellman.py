"""Bellman operators, single-device ELL and dense subset.

Counterpart of :mod:`repro.core.bellman`.  Functions take a local MDP
block plus the :class:`~repro_torch.core.comm.Axes` it is sharded over
(always ``Axes()`` in this slice: every collective is the identity), so
the signatures match the reference's and a sharded layout can slot in.

Conventions
-----------
* ``v_local``  — (n_local,) owned slice of the value vector.
* ``v_global`` — (n_global,) gathered value vector.
* ``pi``       — (n_local,) int32 of **global** action ids.

Batched fleets
--------------
Every operator also takes a batched MDP (leading ``B``, see
:func:`repro_torch.core.mdp.stack_mdps`) with ``(B, n)`` vectors and
returns ``(B, ...)`` results, through the kernels' lane axis: one launch
for the fleet.  ``gamma_t``, a ``(B,)`` tensor in the solve dtype, gives a
heterogeneous fleet its per-lane discounts
(:func:`repro_torch.core.mdp.batch_parts`); a homogeneous fleet keeps the
Python float.  Lane ``b`` of every result equals the unbatched operator
on instance ``b``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.comm import Axes
from repro_torch.core.mdp import MDP, DenseMDP, EllMDP, batch_parts
from repro_torch.kernels import ops


def gather_v(v_local: torch.Tensor, axes: Axes) -> torch.Tensor:
    """The column window the local rows reference (the full vector)."""
    return axes.allgather_state(v_local)


# --------------------------------------------------------------------------- #
# Greedy step (policy improvement)                                            #
# --------------------------------------------------------------------------- #

def fleet_gamma(mdp: MDP, gamma_t: torch.Tensor | None,
                dtype: torch.dtype):
    """The discount operand of ``mdp``'s kernels: ``gamma_t`` if given,
    else the float of an unbatched or homogeneous MDP, else the per-lane
    tensor of a heterogeneous fleet in ``dtype``."""
    if gamma_t is not None:
        return gamma_t
    if mdp.batch is None:
        return mdp.gamma
    g = batch_parts(mdp, dtype)
    return mdp.gamma if g is None else g


def backup(mdp: MDP, v_global: torch.Tensor, axes: Axes, *,
           mode: str = "mincost", gamma_t: torch.Tensor | None = None) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """One Bellman backup: ``(Tv ([B,] n_local), pi ([B,] n_local)
    int32)``.

    ``mode="maxreward"`` reads ``cost`` as a reward and takes the argmax
    backup by negation: the backup runs on ``(-cost, -v)`` and the result
    is negated, so a maxreward solve is bit-for-bit the negation of the
    mincost solve on negated costs (IEEE negation is exact).  ``gamma_t``
    is a fleet's per-lane discount tensor (module docstring).
    """
    neg = mode == "maxreward"
    cost = -mdp.cost if neg else mdp.cost
    if neg:
        v_global = -v_global
    gamma = fleet_gamma(mdp, gamma_t, v_global.dtype)
    if isinstance(mdp, EllMDP):
        vmin, amin = ops.ell_backup(mdp.idx, mdp.val, cost, gamma, v_global)
    else:
        vmin, amin = ops.dense_backup(mdp.p, cost, gamma, v_global)
    a_glob = amin + mdp.m_local * axes.action_index()
    return (-vmin if neg else vmin), a_glob


def gather_backup(mdp: MDP, v_local: torch.Tensor, axes: Axes, *,
                  mode: str = "mincost",
                  gamma_t: torch.Tensor | None = None) \
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather the value window and run one Bellman backup; returns
    ``(tv, pi, window)`` (the synchronous path of the reference)."""
    w = gather_v(v_local, axes)
    tv, pi = backup(mdp, w, axes, mode=mode, gamma_t=gamma_t)
    return tv, pi, w


def residual_norm(mdp: MDP, v_local: torch.Tensor,
                  v_global: torch.Tensor, axes: Axes, *,
                  mode: str = "mincost",
                  gamma_t: torch.Tensor | None = None) -> torch.Tensor:
    """Sup-norm Bellman residual ``||T v - v||_inf`` (the optimality gap
    certificate: ``||v - v*||_inf <= residual / (1 - gamma)``); ``(B,)``
    per-lane residuals for a fleet."""
    tv, _ = backup(mdp, v_global, axes, mode=mode, gamma_t=gamma_t)
    return axes.norm_inf(tv - v_local)


# --------------------------------------------------------------------------- #
# Policy-restricted operators (policy evaluation)                             #
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class PolicyRows:
    """Rows of ``P_pi`` / ``g_pi`` owned by this shard: ELL rows
    (``idx``/``val``) or dense rows (``p``), the other left ``None``.  A
    fleet's rows carry a leading ``B`` and ``gamma`` is then its float or
    its ``(B,)`` per-lane tensor."""

    idx: torch.Tensor | None   # ([B,] n_local, K) int32
    val: torch.Tensor | None   # ([B,] n_local, K) f32
    p: torch.Tensor | None     # ([B,] n_local, n_global), accumulation dtype
    g: torch.Tensor            # ([B,] n_local) f32
    gamma: float | torch.Tensor

    def lane(self, b: int, gamma: float) -> "PolicyRows":
        """Lane ``b`` of a fleet's rows (views), with its discount
        ``gamma`` as the unbatched rows carry it."""
        pick = lambda t: None if t is None else t[b]
        return PolicyRows(idx=pick(self.idx), val=pick(self.val),
                          p=pick(self.p), g=self.g[b], gamma=gamma)


def policy_rows(mdp: MDP, pi: torch.Tensor, axes: Axes, *,
                dtype: torch.dtype = torch.float32,
                gamma_t: torch.Tensor | None = None) -> PolicyRows:
    """Extract the ``P_pi`` rows for a (global-id) policy ``pi``
    (``(B, n)`` for a fleet, whose rows then carry a leading ``B``).

    On one device every row owns its greedy action, so the reference's
    ownership mask is all ones (multiplying by it is exact) and is left
    out.  ``dtype`` is the value vector's: dense rows are cast once here to
    the accumulation dtype (exact), where the reference casts them in
    every matvec — at n = 16,384 a float64 ``P_pi`` is 2.1 GB."""
    a_sel = torch.clamp(pi - mdp.m_local * axes.action_index(), 0,
                        mdp.m_local - 1).long()
    gamma = fleet_gamma(mdp, gamma_t, dtype)
    g_pi = torch.gather(mdp.cost, -1, a_sel[..., None])[..., 0]
    if isinstance(mdp, DenseMDP):
        rows = torch.arange(mdp.n_local, device=a_sel.device)
        if mdp.batch is None:
            p_pi = mdp.p[rows, a_sel]
        else:
            lanes = torch.arange(mdp.batch, device=a_sel.device)
            p_pi = mdp.p[lanes[:, None], rows[None, :], a_sel]
        dt = torch.promote_types(p_pi.dtype, dtype)
        return PolicyRows(idx=None, val=None, p=p_pi.to(dt), g=g_pi,
                          gamma=gamma)
    k = mdp.nnz_per_row
    sel = a_sel[..., None, None].expand(*a_sel.shape, 1, k)
    lead = tuple(a_sel.shape[:-1])

    def take(t):
        # a shared idx is one table for every lane: gather from its view
        # broadcast over the lanes
        t = t.expand(*lead, *t.shape[-3:])
        return torch.gather(t, -2, sel)[..., 0, :].contiguous()

    return PolicyRows(idx=take(mdp.idx), val=take(mdp.val), p=None, g=g_pi,
                      gamma=gamma)


def _p_pi_matvec(rows: PolicyRows, x_eff: torch.Tensor,
                 axes: Axes) -> torch.Tensor:
    """(P_pi @ x) on local rows, reduced over action shards.

    Dense rows take a plain product (the reference's ``jnp.dot`` at
    ``Precision.HIGHEST``, outside any kernel; a batched product for a
    fleet), in the accumulation dtype and never in TF32."""
    if rows.p is None:
        return axes.psum_action(ops.ell_matvec(rows.idx, rows.val, x_eff))
    dt = torch.promote_types(rows.p.dtype, x_eff.dtype)
    p, x = rows.p.to(dt), x_eff.to(dt)
    if p.dim() == 2:
        product = lambda: torch.mv(p, x)
    elif p.shape[0] == 1:
        # a fleet of one (an unbatched solve) keeps the plain gemv: on the
        # H100 cuBLAS's batched gemv read a fleet's GMRES basis at a third
        # of the plain gemv's rate (PERF.md, §5)
        product = lambda: torch.mv(p[0], x[0])[None]
    else:
        product = lambda: torch.bmm(p, x[..., None])[..., 0]
    if p.is_cuda and dt == torch.float32 \
            and torch.backends.cuda.matmul.allow_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            y = product()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = True
    else:
        y = product()
    return axes.psum_action(y)


def _fma(a: torch.Tensor, y: torch.Tensor, scale) -> torch.Tensor:
    """``a + scale * y`` with one rounding (``torch.addcmul`` with the scale
    as a tensor): what XLA:CPU computes for the reference's contracted
    ``a + scale * y``.  A fleet's ``(B,)`` scale is one value a lane."""
    if isinstance(scale, torch.Tensor):
        s = scale.to(device=y.device, dtype=y.dtype).reshape(
            (-1,) + (1,) * (y.dim() - 1))
    else:
        s = torch.tensor(scale, dtype=y.dtype, device=y.device)
    return torch.addcmul(a.to(y.dtype), y, s)


def t_pi(rows: PolicyRows, x_local: torch.Tensor,
         axes: Axes) -> torch.Tensor:
    """Policy-restricted Bellman operator ``T_pi x = g_pi + gamma P_pi x``."""
    y = _p_pi_matvec(rows, gather_v(x_local, axes), axes)
    return _fma(axes.psum_action(rows.g), y, rows.gamma)


def a_pi_matvec(rows: PolicyRows, x_local: torch.Tensor,
                axes: Axes) -> torch.Tensor:
    """Policy-evaluation system operator ``A_pi x = (I - gamma P_pi) x``.

    The matvec handed to the inner (Krylov) solvers; the value function of
    ``pi`` solves ``A_pi v = g_pi``.  XLA:CPU contracts the reference's
    ``x - gamma * y`` into one fused multiply-add, and so does this one.
    """
    y = _p_pi_matvec(rows, gather_v(x_local, axes), axes)
    return _fma(x_local, y.to(x_local.dtype), -rows.gamma)


def b_pi(rows: PolicyRows, axes: Axes) -> torch.Tensor:
    """Right-hand side ``g_pi`` of the policy-evaluation system."""
    return axes.psum_action(rows.g)
