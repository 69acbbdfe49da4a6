"""Bellman operators on a rank's block of a (possibly sharded) MDP.

Counterpart of :mod:`repro.core.bellman`.  Functions take a local MDP
block plus the :class:`~repro_torch.core.comm.Axes` it is sharded over
(``Axes()`` on one device: every collective is the identity).

Conventions
-----------
* ``v_local``  — ([B,] n_local) owned slice of the value vector.
* ``window``   — the value window the local rows read: the gathered
  ([B,] n_global) vector, or with ``halo`` the ``[start - halo, stop +
  halo)`` window (:func:`gather_v`).  An ELL block's ``idx`` is already in
  the window's coordinates (:func:`repro_torch.core.partition.place_block`
  shifts it once, where the reference shifts it in every backup).
* ``pi``       — ([B,] n_local) int32 of **global** action ids.

Batched fleets
--------------
Every operator takes ``impl``, the kernel implementation
(:mod:`repro_torch.kernels.ops`: ``-kernel_impl``), and passes it to each
kernel call.

Every operator also takes a batched MDP (leading ``B``, see
:func:`repro_torch.core.mdp.stack_mdps`) with ``(B, n)`` vectors and
returns ``(B, ...)`` results, through the kernels' lane axis: one launch
for the fleet.  ``gamma_t``, a ``(B,)`` tensor in the solve dtype, gives a
heterogeneous fleet its per-lane discounts
(:func:`repro_torch.core.mdp.batch_parts`); a homogeneous fleet keeps the
Python float.  Lane ``b`` of every result equals the unbatched operator
on instance ``b``.

Matrix-free blocks
------------------
A :class:`~repro_torch.core.mdp.MatrixFreeMDP` has no tables: the backup
and the policy-row extraction rebuild its rows chunk by chunk from the
row spec (:mod:`repro_torch.kernels.matrix_free`) and map the rebuilt
global successor ids into the window's coordinates on the way
(:func:`_mf_window_map`), giving the materialized block's bits.  A
matrix-free fleet rebuilds each chunk once for all its lanes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.comm import Axes
from repro_torch.core.mdp import (MDP, DenseMDP, EllMDP, MatrixFreeMDP,
                                  batch_parts)
from repro_torch.core.partition import window_idx
from repro_torch.kernels import matrix_free, ops

# the dtype the reference stores transition tables in
TABLE_DTYPE = torch.float32


# --------------------------------------------------------------------------- #
# Value-vector movement (all-gather vs banded halo exchange)                   #
# --------------------------------------------------------------------------- #

def gather_v(v_local: torch.Tensor, axes: Axes, *, halo: int = 0,
             dtype=None) -> torch.Tensor:
    """The column window the local rows reference: the full gathered
    vector (``halo=0``) or the banded ``[start-halo, stop+halo)`` window.
    ``dtype`` is the wire format of a compressed gather."""
    if halo:
        return axes.halo_exchange(v_local, halo, dtype)
    return axes.allgather_state(v_local, dtype)


def window_offset(mdp: MDP, axes: Axes, halo: int) -> int:
    """Where the block's own rows sit in its value window."""
    return halo if halo else axes.state_index() * mdp.n_local


def _mf_window_map(mdp: MatrixFreeMDP, axes: Axes):
    """The map of a matrix-free block's rebuilt global successor ids into
    its window's coordinates — :func:`repro_torch.core.partition.
    window_idx`, which shifts a stored ``idx`` once — or ``None`` for the
    gathered vector, which global ids address as they are."""
    if not mdp.halo:
        return None
    return lambda idx: window_idx(idx, axes, mdp.n_local, mdp.halo)


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


def backup(mdp: MDP, window: torch.Tensor, axes: Axes, *,
           mode: str = "mincost", gamma_t: torch.Tensor | None = None,
           impl: str | None = None) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """One Bellman backup: ``(Tv ([B,] n_local), pi ([B,] n_local)
    int32)`` of the local rows against their value ``window``.

    ``mode="maxreward"`` reads ``cost`` as a reward and takes the argmax
    backup by negation: the backup runs on ``(-cost, -v)`` and the result
    is negated, so a maxreward solve is bit-for-bit the negation of the
    mincost solve on negated costs (IEEE negation is exact), and the
    action-axis reduction is reused unchanged.  ``gamma_t`` is a fleet's
    per-lane discount tensor (module docstring).
    """
    neg = mode == "maxreward"
    gamma = fleet_gamma(mdp, gamma_t, window.dtype)
    if isinstance(mdp, MatrixFreeMDP):
        # rebuild the rows inside the backup; the negation happens there
        # (no stored cost to flip), into the same negated min-space
        vmin, amin = matrix_free.mf_backup(
            mdp.spec, axes.state_index() * mdp.n_local, mdp.n_local,
            mdp.acts, gamma, window, mode=mode,
            idx_map=_mf_window_map(mdp, axes), impl=impl)
        return _finish_argmin(vmin, amin, mdp, axes, neg)
    cost = -mdp.cost if neg else mdp.cost
    if neg:
        window = -window
    if isinstance(mdp, EllMDP):
        vmin, amin = ops.ell_backup(mdp.idx, mdp.val, cost, gamma, window,
                                    impl=impl)
    else:
        vmin, amin = ops.dense_backup(mdp.p, cost, gamma, window, impl=impl)
    return _finish_argmin(vmin, amin, mdp, axes, neg)


def _finish_argmin(vmin: torch.Tensor, amin: torch.Tensor, mdp: MDP,
                   axes: Axes, neg: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Complete a per-shard (min, argmin) into the global ``(Tv, pi)``:
    lift local action ids to global ids, reduce over the action axis with a
    deterministic smallest-global-id tie-break, and undo the maxreward
    negation."""
    a_glob = amin + mdp.m_local * axes.action_index()
    if axes.action is None:
        return (-vmin if neg else vmin), a_glob
    tv = axes.pmin_action(vmin)
    # argmin across shards: owner shards (vmin == tv exactly, since the MIN
    # picks one of the exact local minima) propose their id, others
    # propose m_global
    cand = torch.where(vmin == tv, a_glob,
                       torch.full_like(a_glob, mdp.m_global))
    pi = axes.pmin_action(cand)
    return (-tv if neg else tv), pi


def gather_backup(mdp: MDP, v_local: torch.Tensor, axes: Axes, *,
                  plan: tuple[int, int] | None = None, halo: int = 0,
                  mode: str = "mincost",
                  gamma_t: torch.Tensor | None = None,
                  impl: str | None = None) \
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather the value window and run one Bellman backup; returns
    ``(tv, pi, window)``.

    ``plan=(f_lo, f_hi)`` (from :func:`repro_torch.core.partition.
    overlap_margins`) switches to the communication-overlapped path
    (:func:`backup_overlapped`); ``plan=None`` is the synchronous
    gather-then-backup reference.  Both give identical results."""
    if plan is not None:
        return backup_overlapped(mdp, v_local, axes, plan=plan, halo=halo,
                                 mode=mode, gamma_t=gamma_t, impl=impl)
    w = gather_v(v_local, axes, halo=halo)
    tv, pi = backup(mdp, w, axes, mode=mode, gamma_t=gamma_t, impl=impl)
    return tv, pi, w


def backup_overlapped(mdp: MDP, v_local: torch.Tensor, axes: Axes, *,
                      plan: tuple[int, int], halo: int = 0,
                      mode: str = "mincost",
                      gamma_t: torch.Tensor | None = None,
                      impl: str | None = None) \
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Communication-overlapped Bellman backup; returns ``(tv, pi,
    window)``.

    Starts the value-window collective (:meth:`Axes.gather_start`, an
    asynchronous all-gather or ring exchange), backs up the *interior*
    rows ``[f_lo, n_local - f_hi)`` — whose nonzero-weight successors are
    all locally owned — against ``v_local`` (through the block's
    ``own_idx``) while the window is in flight, then waits for it and
    finishes the frontier rows.  The kernels are row-independent and the
    interior rows read the same values through ``v_local`` as through the
    window, so the result is bit for bit that of :func:`gather_backup`
    without a plan (zero-weight fill entries are clamped and contribute
    exactly 0 on both paths)."""
    if isinstance(mdp, MatrixFreeMDP):
        return _mf_backup_overlapped(mdp, v_local, axes, plan=plan,
                                     mode=mode, gamma_t=gamma_t, impl=impl)
    if not isinstance(mdp, EllMDP):
        raise ValueError("comm overlap requires the ELL representation; "
                         "DenseMDP rows always reference global columns")
    f_lo, f_hi = plan
    n_loc = mdp.n_local
    pending = axes.gather_start(v_local, halo=halo)

    neg = mode == "maxreward"
    cost = -mdp.cost if neg else mdp.cost
    v_own = -v_local if neg else v_local
    gamma = fleet_gamma(mdp, gamma_t, v_local.dtype)
    rows = lambda t, lo, hi, d: t.narrow(t.dim() - d, lo, hi - lo) \
        .contiguous()
    part = lambda idx, lo, hi, v: ops.ell_backup(
        idx, rows(mdp.val, lo, hi, 3), rows(cost, lo, hi, 2), gamma, v,
        impl=impl)

    parts = []
    # interior rows: no data dependence on the in-flight window
    if f_lo + f_hi < n_loc:
        parts.append(part(mdp.own_idx, f_lo, n_loc - f_hi, v_own))
    # frontier rows: wait for the window, then finish the edges
    win = axes.gather_finish(pending)
    v_win = -win if neg else win
    if f_lo:
        parts.insert(0, part(rows(mdp.idx, 0, f_lo, 3), 0, f_lo, v_win))
    if f_hi:
        parts.append(part(rows(mdp.idx, n_loc - f_hi, n_loc, 3),
                          n_loc - f_hi, n_loc, v_win))
    vmin = torch.cat([p[0] for p in parts], dim=-1)
    amin = torch.cat([p[1] for p in parts], dim=-1)
    tv, pi = _finish_argmin(vmin, amin, mdp, axes, neg)
    return tv, pi, win


def _mf_backup_overlapped(mdp: MatrixFreeMDP, v_local: torch.Tensor,
                          axes: Axes, *, plan: tuple[int, int], mode: str,
                          gamma_t: torch.Tensor | None,
                          impl: str | None = None) \
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The interior/frontier split of :func:`backup_overlapped` for a
    matrix-free block: each part *rebuilds* its row range instead of
    slicing stored tables.  Interior rows read ``v_local`` through their
    global ids shifted to the block's own rows (clamped, as the stored
    ``own_idx`` is: zero-weight fill contributes exactly 0), frontier rows
    the arrived window, so the split is bitwise invisible here too."""
    f_lo, f_hi = plan
    n_loc = mdp.n_local
    pending = axes.gather_start(v_local, halo=mdp.halo)
    neg = mode == "maxreward"
    gamma = fleet_gamma(mdp, gamma_t, v_local.dtype)
    row_start = axes.state_index() * n_loc
    part = lambda lo, hi, idx_map, v: matrix_free.mf_backup(
        mdp.spec, row_start + lo, hi - lo, mdp.acts, gamma, v, mode=mode,
        idx_map=idx_map, impl=impl)

    parts = []
    # interior rows: no data dependence on the in-flight window
    if f_lo + f_hi < n_loc:
        own_map = lambda i: torch.clamp(i - row_start, 0, n_loc - 1).to(
            i.dtype)
        parts.append(part(f_lo, n_loc - f_hi, own_map, v_local))
    # frontier rows: wait for the window, then finish the edges
    win = axes.gather_finish(pending)
    win_map = _mf_window_map(mdp, axes)
    if f_lo:
        parts.insert(0, part(0, f_lo, win_map, win))
    if f_hi:
        parts.append(part(n_loc - f_hi, n_loc, win_map, win))
    vmin = torch.cat([p[0] for p in parts], dim=-1)
    amin = torch.cat([p[1] for p in parts], dim=-1)
    tv, pi = _finish_argmin(vmin, amin, mdp, axes, neg)
    return tv, pi, win


def residual_norm(mdp: MDP, v_local: torch.Tensor,
                  window: torch.Tensor, axes: Axes, *,
                  mode: str = "mincost",
                  gamma_t: torch.Tensor | None = None,
                  impl: str | None = None) -> torch.Tensor:
    """Sup-norm Bellman residual ``||T v - v||_inf`` (the optimality gap
    certificate: ``||v - v*||_inf <= residual / (1 - gamma)``); ``(B,)``
    per-lane residuals for a fleet."""
    tv, _ = backup(mdp, window, axes, mode=mode, gamma_t=gamma_t, impl=impl)
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
                gamma_t: torch.Tensor | None = None,
                gather_dtype: torch.dtype | None = None) -> PolicyRows:
    """Extract the ``P_pi`` rows for a (global-id) policy ``pi``
    (``(B, n)`` for a fleet, whose rows then carry a leading ``B``).

    With an action axis each action shard owns the rows whose greedy
    action falls in its slice: the others are masked to zero and the
    matvec's action-axis sum completes them (the 2-D layout).  Without
    one every row owns its action, and the all-ones mask is left out
    (multiplying by it is exact).  ``dtype`` is the value vector's: dense
    rows are cast once here to the product's dtype (exact), where the
    reference casts them in every matvec — at n = 16,384 a float64
    ``P_pi`` is 2.1 GB.  A ``gather_dtype`` narrows that product as the
    reference's dtype promotion does."""
    a_rel = pi - mdp.m_local * axes.action_index()
    a_sel = torch.clamp(a_rel, 0, mdp.m_local - 1).long()
    own = None if axes.action is None \
        else ((a_rel >= 0) & (a_rel < mdp.m_local))[..., None]
    mask = lambda t: t if own is None else t * own.to(t.dtype)
    gamma = fleet_gamma(mdp, gamma_t, dtype)
    if isinstance(mdp, MatrixFreeMDP):
        # rebuild the rows and select the greedy action's slots chunk by
        # chunk: the same O(n_local * nnz) rows the stored table's
        # selection gives, in the window's coordinates
        idx_pi, val_pi, g_pi = matrix_free.mf_policy_rows(
            mdp.spec, axes.state_index() * mdp.n_local, mdp.n_local,
            mdp.acts, a_sel, own, idx_map=_mf_window_map(mdp, axes))
        return PolicyRows(idx=idx_pi, val=val_pi, p=None, g=g_pi,
                          gamma=gamma)
    g_pi = mask(torch.gather(mdp.cost, -1, a_sel[..., None]))[..., 0]
    if isinstance(mdp, DenseMDP):
        rows = torch.arange(mdp.n_local, device=a_sel.device)
        if mdp.batch is None:
            p_pi = mdp.p[rows, a_sel]
        else:
            lanes = torch.arange(mdp.batch, device=a_sel.device)
            p_pi = mdp.p[lanes[:, None], rows[None, :], a_sel]
        wire = dtype if gather_dtype is None \
            else torch.promote_types(TABLE_DTYPE, gather_dtype)
        dt = torch.promote_types(p_pi.dtype, wire)
        return PolicyRows(idx=None, val=None, p=mask(p_pi).to(dt), g=g_pi,
                          gamma=gamma)
    k = mdp.nnz_per_row
    sel = a_sel[..., None, None].expand(*a_sel.shape, 1, k)
    lead = tuple(a_sel.shape[:-1])

    def take(t):
        # a shared idx is one table for every lane: gather from its view
        # broadcast over the lanes
        t = t.expand(*lead, *t.shape[-3:])
        return torch.gather(t, -2, sel)[..., 0, :].contiguous()

    return PolicyRows(idx=take(mdp.idx), val=mask(take(mdp.val)), p=None,
                      g=g_pi, gamma=gamma)


def _p_pi_matvec(rows: PolicyRows, x_eff: torch.Tensor, axes: Axes,
                 impl: str | None = None) -> torch.Tensor:
    """(P_pi @ x) on local rows, reduced over action shards.

    ``x_eff`` is the window the rows' ``idx`` (or columns) address.  Dense
    rows take a plain product (the reference's ``jnp.dot`` at
    ``Precision.HIGHEST``, outside any kernel; a batched product for a
    fleet), in the accumulation dtype and never in TF32."""
    if rows.p is None:
        return axes.psum_action(ops.ell_matvec(rows.idx, rows.val, x_eff,
                                               impl=impl))
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


def _window(x_local: torch.Tensor, axes: Axes, halo: int,
            gather_dtype) -> torch.Tensor:
    """The matvec's value window; a compressed gather is rounded through
    its wire dtype, then widened to float32 at least: the kernels take
    float32/float64 operands, and the reference's product with the
    float32 tables promotes to that dtype (the widening is exact)."""
    x_eff = gather_v(x_local, axes, halo=halo, dtype=gather_dtype)
    if gather_dtype is None:
        return x_eff
    return x_eff.to(torch.promote_types(TABLE_DTYPE, x_eff.dtype))


def t_pi(rows: PolicyRows, x_local: torch.Tensor, axes: Axes, *,
         halo: int = 0, gather_dtype=None,
         impl: str | None = None) -> torch.Tensor:
    """Policy-restricted Bellman operator ``T_pi x = g_pi + gamma P_pi x``."""
    y = _p_pi_matvec(rows, _window(x_local, axes, halo, gather_dtype), axes,
                     impl)
    return _fma(axes.psum_action(rows.g), y, rows.gamma)


def a_pi_matvec(rows: PolicyRows, x_local: torch.Tensor, axes: Axes, *,
                halo: int = 0, gather_dtype=None,
                impl: str | None = None) -> torch.Tensor:
    """Policy-evaluation system operator ``A_pi x = (I - gamma P_pi) x``.

    The matvec handed to the inner (Krylov) solvers; the value function of
    ``pi`` solves ``A_pi v = g_pi``.  XLA:CPU contracts the reference's
    ``x - gamma * y`` into one fused multiply-add, and so does this one.
    ``gather_dtype`` turns on the compressed (inexact) gather — safe here
    because the outer iPI loop's forcing term bounds the tolerable
    inner-system perturbation.
    """
    y = _p_pi_matvec(rows, _window(x_local, axes, halo, gather_dtype), axes,
                     impl)
    return _fma(x_local, y.to(x_local.dtype), -rows.gamma)


def b_pi(rows: PolicyRows, axes: Axes) -> torch.Tensor:
    """Right-hand side ``g_pi`` of the policy-evaluation system."""
    return axes.psum_action(rows.g)
