"""Partitioning of a global MDP over the ranks of a device mesh.

Counterpart of :mod:`repro.core.partition`.  madupite/PETSc row-partitions
states over MPI ranks (1-D).  The port has that layout, the reference's
beyond-paper 2-D (state x action) layout and its fleet-sharded layouts,
over a ``torch.distributed.device_mesh.DeviceMesh``:

* ``layout="1d"`` — states sharded over *all* mesh axes (paper-faithful);
* ``layout="2d"`` — states over all-but-last axis, actions over the last;
  the greedy min and the policy-evaluation matvec gain a reduction over
  the action axis (see :mod:`repro_torch.core.bellman`);
* ``layout="fleet"`` — the leading mesh axis shards a fleet's instance
  dim ``B``; states are sharded over the remaining axes within each fleet
  slice, so a rank holds ``B / fleet_size`` lanes of its state rows
  (``solve_many`` only);
* ``layout="fleet2d"`` — instances over the first axis, states over the
  middle axes, actions over the last.

Under ``1d`` / ``2d`` a fleet is replicated: every rank holds its rows of
all ``B`` lanes.

A matrix-free block (:class:`~repro_torch.core.mdp.MatrixFreeMDP`) has no
tables to cut: placing it is a zero tag of its padded local extent (the
row builder masks padding rows into the same absorbing self-loops), its
frontier margins and reach come from the declared ``band``, and it shards
states only.

Padding: states are padded with absorbing zero-cost self-loops (their value
is identically 0 and they are unreachable, so the solution and residuals on
real states are untouched); actions are padded with cost ``±BIG`` rows that
can never be greedy; a fleet-sharded fleet is padded to a multiple of the
fleet-axis size with zero-cost dummy instances whose optimal value is
identically 0 — they are done at k=0 and stay frozen under the solver's
active mask, so they cost one no-op lane (:func:`pad_fleet_dim`).

Each rank holds only its own block (:func:`shard_mdp`): the rows of its
state shard and the columns of its action shard (and, under the fleet
layouts, its lanes), on its own device.  An ELL block's successor ids are
rewritten once, at placement, into the coordinates of the value window its
backups read (the gathered vector, or the halo window), so no backup
shifts ``idx`` again.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.comm import Axes
from repro_torch.core.mdp import (MDP, DenseMDP, EllMDP, MatrixFreeMDP,
                                  gammas_of, stack_mdps)

_BIG_COST = 1e30

LAYOUTS = ("1d", "2d", "fleet", "fleet2d")
FLEET_LAYOUTS = ("fleet", "fleet2d")

# process groups spanning several dims of a mesh, built once per mesh
_GROUPS: dict = {}


def _check_layout(mesh, layout: str) -> tuple:
    # Raised (not assert'd): layout validation must survive `python -O`.
    names = tuple(mesh.mesh_dim_names)
    need = {"1d": 1, "2d": 2, "fleet": 2, "fleet2d": 3}.get(layout)
    if need is None:
        raise ValueError(f"unknown layout {layout!r}; pick one of {LAYOUTS}")
    if len(names) < need:
        hint = ("; see launch.mesh.make_fleet_mesh"
                if layout in FLEET_LAYOUTS else "")
        raise ValueError(f"layout {layout!r} needs >= {need} mesh axes, "
                         f"got {names}{hint}")
    return names


def layout_dims(mesh, layout: str) -> tuple[tuple, tuple]:
    """The mesh dimension names ``(state, action)`` that ``layout`` shards
    over (the reference's :func:`mesh_axes`, by name).  ``mesh`` needs only
    ``mesh_dim_names``."""
    names = _check_layout(mesh, layout)
    if layout == "1d":
        return names, ()
    if layout == "2d":
        return names[:-1], names[-1:]
    if layout == "fleet":
        return names[1:], ()
    return names[1:-1], names[-1:]


def fleet_dims(mesh, layout: str) -> tuple:
    """The mesh dimension name that shards the fleet's lanes under
    ``layout`` (the leading one of the fleet layouts), or ``()``."""
    names = _check_layout(mesh, layout)
    return names[:1] if layout in FLEET_LAYOUTS else ()


def _group(mesh, names: tuple):
    """One process group spanning the mesh dims ``names`` (``None`` for
    none): a dim's own group, the world's when ``names`` are every dim of
    a mesh over the whole world, else the mesh's groups along ``names``
    built on every rank in one order."""
    if not names:
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    import torch.distributed as dist
    all_dims = tuple(mesh.mesh_dim_names)
    if names == all_dims and mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    key = (id(mesh), names)
    if key not in _GROUPS:
        ids = mesh.mesh
        keep = [all_dims.index(n) for n in names]
        rest = [i for i in range(ids.dim()) if i not in keep]
        blocks = ids.permute(*rest, *keep).reshape(-1, math.prod(
            ids.shape[i] for i in keep))
        _GROUPS[key] = dist.new_subgroups_by_enumeration(blocks.tolist())[0]
    return _GROUPS[key]


def mesh_axes(mesh, layout: str) -> Axes:
    """The :class:`Axes` (process groups) of ``layout`` on ``mesh``."""
    s, a = layout_dims(mesh, layout)
    return Axes(state=_group(mesh, s), action=_group(mesh, a),
                fleet=_group(mesh, fleet_dims(mesh, layout)))


def _axis_size(mesh, names) -> int:
    dims = tuple(mesh.mesh_dim_names)
    return math.prod(mesh.shape[dims.index(n)] for n in names)


def padded_extents(mesh, layout: str, n: int, m: int) -> tuple[int, int]:
    """Global (state, action) extents after padding ``(n, m)`` up to the
    mesh's shard multiples under ``layout`` — the shapes a shard-locally
    materialized MDP must be built at."""
    s, a = layout_dims(mesh, layout)
    ns, ms = _axis_size(mesh, s), _axis_size(mesh, a)
    return -(-n // ns) * ns, -(-m // ms) * ms


def shard_block(index, shape) -> tuple[tuple[int, int], ...]:
    """Concrete per-dim ``(start, stop)`` ranges of one shard, from the
    slice tuple that names it in a global ``shape``."""
    out = []
    for sl, dim in zip(index, shape):
        lo, hi, step = sl.indices(dim)
        if step != 1:
            raise ValueError(f"shard_block expects contiguous shards, got "
                             f"step={step}")
        out.append((lo, hi))
    return tuple(out)


def pad_mdp(mdp: MDP, n_mult: int, m_mult: int, *,
            mode: str = "mincost") -> MDP:
    """Pad to state/action multiples, exact-solution preserving, on the
    tables' own device; an MDP that needs no padding is returned as it is.

    Padded actions carry cost ``+BIG`` under the argmin (``"mincost"``)
    backup and ``-BIG`` under the argmax (``"maxreward"``) one, and move to
    state 0 with probability 1, so they are never greedy.  Padded states
    are zero-cost absorbing self-loops (value identically 0) under every
    action.  ELL, dense and matrix-free containers, unbatched or a fleet
    (every lane padded alike; a shared ``idx`` stays shared): a
    matrix-free one pads its tag (its row builder makes the padding rows)
    and shards states only."""
    if isinstance(mdp, MatrixFreeMDP):
        return _pad_matrix_free(mdp, n_mult, m_mult)
    n, m = mdp.n_global, mdp.m_global
    return pad_to(mdp, -(-n // n_mult) * n_mult, -(-m // m_mult) * m_mult,
                  mode=mode)


def pad_to(mdp: MDP, n_to: int, m_to: int, *,
           mode: str = "mincost") -> MDP:
    """:func:`pad_mdp` to the extents ``(n_to, m_to)`` themselves."""
    big = _BIG_COST if mode == "mincost" else -_BIG_COST
    n, m = mdp.n_global, mdp.m_global
    n_pad, m_pad = n_to - n, m_to - m
    if not (n_pad or m_pad):
        return mdp
    cost = mdp.cost
    dev = cost.device
    lead = tuple(cost.shape[:-2])
    zeros = lambda shape, like: torch.zeros(shape, dtype=like.dtype,
                                            device=dev)
    if m_pad:
        cost = torch.cat([cost, torch.full(lead + (n, m_pad), big,
                                           dtype=cost.dtype, device=dev)],
                         -1)
    if n_pad:
        # zero cost on the absorbing self-loop -> v_pad == 0 exactly; big
        # cost on padded actions stays (still never greedy)
        pad_cost = zeros(lead + (n_pad, m_to), cost)
        pad_cost[..., m:] = big
        cost = torch.cat([cost, pad_cost], -2)
    pad_rows = torch.arange(n, n_to, device=dev)
    if isinstance(mdp, EllMDP):
        idx, val = mdp.idx, mdp.val
        k = idx.shape[-1]
        if m_pad:
            idx = torch.cat([idx, zeros(idx.shape[:-3] + (n, m_pad, k),
                                        idx)], -2)
            pv = zeros(val.shape[:-3] + (n, m_pad, k), val)
            pv[..., 0] = 1.0     # to state 0 (the row sums to 1)
            val = torch.cat([val, pv], -2)
        if n_pad:
            pad_idx = zeros(idx.shape[:-3] + (n_pad, m_to, k), idx)
            pad_idx[..., 0] = pad_rows.to(idx.dtype)[:, None]
            pad_val = zeros(val.shape[:-3] + (n_pad, m_to, k), val)
            pad_val[..., 0] = 1.0
            idx = torch.cat([idx, pad_idx], -3)
            val = torch.cat([val, pad_val], -3)
        return EllMDP(idx=idx, val=val, cost=cost, gamma=mdp.gamma,
                      n_global=n_to, m_global=m_to)
    p = mdp.p
    if m_pad:
        pp = zeros(lead + (n, m_pad, n), p)
        pp[..., 0] = 1.0
        p = torch.cat([p, pp], -2)
    if n_pad:
        p = torch.cat([p, zeros(lead + (n, m_to, n_pad), p)], -1)
        pad_p = zeros(lead + (n_pad, m_to, n_to), p)
        pad_p[..., torch.arange(n_pad, device=dev), :, pad_rows] = 1.0
        p = torch.cat([p, pad_p], -3)
    return DenseMDP(p=p, cost=cost, gamma=mdp.gamma, n_global=n_to,
                    m_global=m_to)


def _pad_matrix_free(mdp: MatrixFreeMDP, n_mult: int,
                     m_mult: int) -> MatrixFreeMDP:
    if m_mult > 1:
        raise ValueError(
            "matrix-free operators shard states only (every shard traces "
            "the full static action tuple); layout '2d' shards the action "
            "dim — use layout '1d'/'fleet', or materialize via "
            "-mdp_materialize device")
    n_to = -(-mdp.n_global // n_mult) * n_mult
    if n_to == mdp.n_global:
        return mdp
    return dataclasses.replace(
        mdp, tag=torch.zeros(mdp.tag.shape[:-1] + (n_to,), dtype=torch.int8,
                             device=mdp.device), n_global=n_to)


def fleet_padded_batch(b: int, fleet_size: int, pad: bool = True) -> int:
    """Fleet size after padding ``b`` up to a multiple of ``fleet_size``.

    Raises an actionable ``ValueError`` (before any device work) when
    ``b`` is incompatible and padding is off."""
    b_pad = -(-b // fleet_size) * fleet_size
    if b_pad != b and not pad:
        raise ValueError(
            f"fleet of B={b} instances does not divide over the "
            f"{fleet_size}-way fleet axis and fleet padding is disabled; "
            f"either pass pad_fleet=True (adds {b_pad - b} zero-cost dummy "
            f"instance(s), trimmed from the results), solve a B divisible "
            f"by {fleet_size}, or build the mesh with a fleet axis that "
            f"divides {b}")
    return b_pad


def _dummy(mdp: MDP, gamma: float) -> MDP:
    """A fleet-padding lane made from the unbatched ``mdp``: its (valid,
    row-stochastic) transitions with identically-zero costs, so its
    optimal value is exactly 0 and the solver's ``v0 = 0`` start is
    already done; a matrix-free lane instead re-solves ``mdp``'s rows (no
    stored cost to zero) and is trimmed like the others."""
    if isinstance(mdp, MatrixFreeMDP):
        return dataclasses.replace(mdp, gamma=gamma)
    return dataclasses.replace(mdp, cost=torch.zeros_like(mdp.cost),
                               gamma=gamma)


def fleet_lanes(mdps, lo: int, hi: int, *, pin: bool = False) -> MDP:
    """Lanes ``[lo, hi)`` of the fleet ``mdps`` (unbatched instances, or a
    batched container) padded with dummy lanes past its ``B``
    (:func:`pad_fleet_dim`'s), as one batched container with the fleet's
    state count: only these lanes are stacked, never the whole fleet.
    Per-instance gammas come along, the dummies' the last lane's.
    ``pin``: host tables are stacked straight into page-locked memory,
    the one host copy a rank makes before its copy to the card."""
    if isinstance(mdps, (EllMDP, DenseMDP, MatrixFreeMDP)):
        if mdps.batch is None:
            raise ValueError("fleet_lanes() takes a fleet")
        b, n_to = mdps.batch, mdps.n_global
        gammas = gammas_of(mdps)
        pick = lambda i: mdps.instance(i if i < b else 0)
    else:
        mdps = list(mdps)
        b, n_to = len(mdps), max(m.n_global for m in mdps)
        gammas = tuple(float(m.gamma) for m in mdps)
        pick = lambda i: mdps[i if i < b else 0]
    lanes = [pick(i) if i < b else _dummy(pick(0), gammas[-1])
             for i in range(lo, hi)]
    if isinstance(lanes[0], EllMDP):
        # every lane padded to the fleet's state count, as stack_mdps pads
        # them to the largest it is given
        lanes = [pad_to(m, n_to, m.m_global) for m in lanes]
    if pin and not isinstance(lanes[0], MatrixFreeMDP) \
            and lanes[0].device.type == "cpu":
        return _stack_pinned(lanes)
    return stack_mdps(lanes)


def _stack_pinned(lanes: list) -> MDP:
    """:func:`repro_torch.core.mdp.stack_mdps` of host lanes of one shape
    (a shared ``idx`` stays one table), written into page-locked
    memory."""
    def stack(ts):
        out = torch.empty((len(ts),) + tuple(ts[0].shape),
                          dtype=ts[0].dtype, pin_memory=True)
        return torch.stack(ts, out=out)

    gammas = tuple(float(m.gamma) for m in lanes)
    gamma = gammas[0] if len(set(gammas)) == 1 else gammas
    first = lanes[0]
    cost = stack([m.cost for m in lanes])
    if isinstance(first, DenseMDP):
        return DenseMDP(p=stack([m.p for m in lanes]), cost=cost,
                        gamma=gamma, n_global=first.n_global,
                        m_global=first.m_global)
    shared = all(torch.equal(m.idx, first.idx) for m in lanes[1:])
    idx = first.idx.contiguous().pin_memory() if shared \
        else stack([m.idx for m in lanes])
    return EllMDP(idx=idx, val=stack([m.val for m in lanes]), cost=cost,
                  gamma=gamma, n_global=first.n_global,
                  m_global=first.m_global)


def pad_fleet_dim(mdp: MDP, b_to: int) -> MDP:
    """Pad a batched fleet to ``b_to`` instances.

    Dummy instances reuse instance 0's (valid, row-stochastic) transitions
    with identically-zero costs, so their optimal value is exactly 0: at
    the solver's ``v0 = 0`` start their Bellman residual is 0 and the
    active mask freezes them at once — they never do real work and are
    trimmed from the results.  Their gamma is the last lane's.  A
    matrix-free fleet's dummies re-solve its (one, shared) row spec."""
    b = mdp.batch
    if b is None:
        raise ValueError("pad_fleet_dim() requires a batched MDP")
    if b_to == b:
        return mdp
    if b_to < b:
        raise ValueError(f"cannot pad fleet of {b} down to {b_to}")
    return fleet_lanes(mdp, 0, b_to)


@dataclasses.dataclass(frozen=True)
class FleetBlock:
    """This rank's part of a fleet placed under a fleet layout
    (:func:`shard_fleet`, :func:`repro_torch.api.mdp.place_function_fleet`):
    ``block`` holds lanes ``[lane0, lane0 + block.batch)`` of the padded
    fleet of ``batch`` lanes — the rows of its state shard and the actions
    of its action shard, on its device — and ``gammas`` the padded fleet's
    per-lane discounts.  :func:`repro_torch.core.driver.solve_many` takes
    it as it is (the reference's ``already_placed`` container)."""

    block: MDP
    batch: int
    lane0: int
    gammas: tuple
    layout: str

    @property
    def n_global(self) -> int:
        return self.block.n_global


def _eff_extents(idx: torch.Tensor, val: torch.Tensor, n: int):
    """Per-row ``(min, max)`` *nonzero-weight* ELL successor ids, reduced
    over (action, slot) — the effective column extents the communication
    planner reasons about.  Rows with no nonzero successors report the
    empty extents ``(n, -1)``."""
    nz = val != 0
    idx = idx.long()
    eff_max = torch.amax(torch.where(nz, idx, -1), dim=(-2, -1))
    eff_min = torch.amin(torch.where(nz, idx, n), dim=(-2, -1))
    return eff_min, eff_max


def _block_frontier(mdp: EllMDP, n_shards: int, axes: Axes):
    """``(reach, lo_bad, hi_bad)`` of the rows ``mdp`` holds (the whole
    MDP, or with ``axes`` this rank's block of global row ids ``start ..``,
    of every lane of a fleet), reduced over the ranks of ``axes``: how far
    any row's nonzero
    successors reach past its shard, and the last bad row of each shard's
    low half / the first of its high half."""
    n_local = mdp.n_global // n_shards
    dev = mdp.val.device
    eff_min, eff_max = _eff_extents(mdp.idx, mdp.val, mdp.n_global)
    g = axes.state_index() * mdp.n_local + torch.arange(mdp.n_local,
                                                        device=dev)
    i_loc = g % n_local
    start = g - i_loc
    reach = torch.maximum(torch.amax(start - eff_min),
                          torch.amax(eff_max - (start + n_local) + 1))
    bad = ~((eff_min >= start) & (eff_max < start + n_local))
    half = n_local // 2
    lo_bad = torch.amax(torch.where(bad & (i_loc < half), i_loc, -1))
    hi_bad = torch.amin(torch.where(bad & (i_loc >= half), i_loc, n_local))
    out = torch.stack([reach, lo_bad, -hi_bad])
    out = axes.pmax_fleet(axes.pmax_action(axes.pmax_state(out))).tolist()
    return out[0], out[1], -out[2]


def frontier_reach(mdp: MDP, n_shards: int, axes: Axes = Axes()) \
        -> int | None:
    """Smallest halo ``h`` such that every row's nonzero-weight successors
    fall inside the owning shard's ``[start - h, stop + h)`` window — the
    exchange width that makes the banded halo layout exact for this matrix
    at this shard count.  ``0`` means the partition is block-diagonal;
    ``None`` when the reach is undefined (dense representation, single
    shard, ragged partition).

    ``mdp`` is the whole MDP, or this rank's block with ``axes`` its
    placement (every rank then gets the global answer).  A matrix-free
    MDP has no table to measure: its reach is its declared ``band``
    (``None`` without one), valid at every shard boundary."""
    if isinstance(mdp, MatrixFreeMDP):
        if n_shards <= 1 or mdp.n_global % n_shards:
            return None
        return None if mdp.spec.band is None else int(mdp.spec.band)
    if not isinstance(mdp, EllMDP) or n_shards <= 1:
        return None
    if mdp.n_global % n_shards:
        return None
    reach, _, _ = _block_frontier(mdp, n_shards, axes)
    return max(int(reach), 0)


def overlap_margins(mdp: MDP, n_shards: int, axes: Axes = Axes()) \
        -> tuple[int, int] | None:
    """Frontier margins ``(f_lo, f_hi)`` for the communication-overlapped
    backup, or ``None`` when no contiguous interior core exists.

    A row is *interior* when every nonzero-weight ELL successor falls inside
    the owning shard's ``[start, stop)`` range — its backup can run against
    ``v_local`` before the window arrives.  The margins are the smallest
    ``(f_lo, f_hi)`` such that local rows ``[f_lo, n_local - f_hi)`` are
    interior on *every* shard.  ``mdp`` and ``axes`` as in
    :func:`frontier_reach`; call after padding.  A matrix-free MDP's
    margins come from its declared ``band``: rows at least ``band`` from
    both shard edges are interior — conservative against the measured
    margins of its table, and harmless, since the split is bitwise
    invisible for any valid margins."""
    if isinstance(mdp, MatrixFreeMDP):
        band = mdp.spec.band
        if band is None or n_shards <= 1 or mdp.n_global % n_shards:
            return None
        n_local = mdp.n_global // n_shards
        if 2 * int(band) >= n_local:
            return None
        return int(band), int(band)
    if not isinstance(mdp, EllMDP) or n_shards <= 1:
        return None
    if mdp.n_global % n_shards:
        return None
    n_local = mdp.n_global // n_shards
    _, lo_bad, hi_bad = _block_frontier(mdp, n_shards, axes)
    f_lo, f_hi = int(lo_bad) + 1, n_local - int(hi_bad)
    if f_lo + f_hi >= n_local:
        return None
    return f_lo, f_hi


def already_placed(mdp: MDP, mesh, layout: str,
                   device: torch.device) -> bool:
    """True when ``mdp`` is already this rank's block under ``layout`` on
    ``device``: its rows and actions are one shard's worth of its global
    extents and need no padding — an MDP materialized shard-locally, or a
    world of one, where the whole MDP is the one block.
    :func:`shard_mdp` then slices and copies nothing."""
    s, a = layout_dims(mesh, layout)
    ns, ms = _axis_size(mesh, s), _axis_size(mesh, a)
    return (mdp.n_global % ns == 0 and mdp.m_global % ms == 0
            and mdp.n_local * ns == mdp.n_global
            and mdp.m_local * ms == mdp.m_global and mdp.device == device)


def window_idx(idx: torch.Tensor, axes: Axes, n_local: int,
               halo: int) -> torch.Tensor:
    """Global successor ids -> the coordinates of the value window the
    backups read: unchanged for the gathered vector, shifted into the
    ``[start - halo, stop + halo)`` window (clamped: zero-weight ELL fill
    may name columns outside the band, and must read a defined value so
    ``0 * v[i]`` stays exactly 0) for the halo layout."""
    if not halo:
        return idx
    row_start = axes.state_index() * n_local
    return torch.clamp(idx - row_start + halo, 0,
                       n_local + 2 * halo - 1).to(idx.dtype)


def shard_mdp(mdp: MDP, mesh, layout: str = "1d", *,
              mode: str = "mincost", device: torch.device):
    """Pad and place this rank's block of a global MDP on ``device``.

    Returns ``(block, axes, n_orig)``: the rows of this rank's state shard
    and the actions of its action shard (the ``2d`` layout), contiguous on
    ``device``, successor ids still global (:func:`place_block` moves them
    into window coordinates once the solve's halo is known).  A fleet
    keeps all its lanes (the fleet layouts place one with
    :func:`shard_fleet`).  An MDP that is already this rank's block
    (:func:`already_placed`) is not copied."""
    axes = mesh_axes(mesh, layout)
    if axes.fleet is not None:
        raise ValueError(f"layout {layout!r} shards the fleet (batch) dim; "
                         f"place a fleet with shard_fleet() (solve_many "
                         f"does), or use layout '1d'/'2d'")
    if already_placed(mdp, mesh, layout, device):
        return mdp, axes, mdp.n_global
    return _place(mdp, axes, mode, device), axes, mdp.n_global


def _place(mdp: MDP, axes: Axes, mode: str, device: torch.device) -> MDP:
    """Pad ``mdp`` (one instance or lanes of a fleet) to the state and
    action shards of ``axes`` and cut this rank's rows and actions onto
    ``device``."""
    ns, ms = axes.state_size(), axes.action_size()
    padded = pad_mdp(mdp, ns, ms, mode=mode)
    n_loc, m_loc = padded.n_global // ns, padded.m_global // ms
    r, c = axes.state_index() * n_loc, axes.action_index() * m_loc

    def cut(t, d):
        # the state dim sits d dims from the end, the action dim after it
        t = t.narrow(t.dim() - d, r, n_loc).narrow(t.dim() - d + 1, c, m_loc)
        return t.contiguous().to(device)

    if isinstance(padded, MatrixFreeMDP):
        return dataclasses.replace(padded, tag=torch.zeros(
            padded.tag.shape[:-1] + (n_loc,), dtype=torch.int8,
            device=device))
    if isinstance(padded, EllMDP):
        return EllMDP(idx=cut(padded.idx, 3), val=cut(padded.val, 3),
                      cost=cut(padded.cost, 2), gamma=padded.gamma,
                      n_global=padded.n_global, m_global=padded.m_global)
    return DenseMDP(p=cut(padded.p, 3), cost=cut(padded.cost, 2),
                    gamma=padded.gamma, n_global=padded.n_global,
                    m_global=padded.m_global)


def shard_fleet(mdps, mesh, layout: str, *, mode: str = "mincost",
                device: torch.device, pad_fleet: bool = True) -> FleetBlock:
    """This rank's :class:`FleetBlock` of the fleet ``mdps`` (unbatched
    instances or a batched container) under a fleet layout: ``B`` padded
    to a multiple of the fleet-axis size (:func:`fleet_padded_batch`),
    only this rank's lanes stacked (:func:`fleet_lanes`), then padded and
    cut to its state and action shards."""
    axes = mesh_axes(mesh, layout)
    if axes.fleet is None:
        raise ValueError(f"shard_fleet serves the fleet layouts, got "
                         f"{layout!r}")
    batched = isinstance(mdps, (EllMDP, DenseMDP, MatrixFreeMDP))
    if not batched:
        mdps = list(mdps)
    if isinstance(mdps if batched else mdps[0], MatrixFreeMDP) \
            and axes.action_size() > 1:
        raise ValueError(
            f"matrix-free operators shard states only (every shard traces "
            f"the full static action tuple); layout {layout!r} shards the "
            f"action dim — use layout '1d'/'fleet', or materialize via "
            f"-mdp_materialize device")
    b = mdps.batch if batched else len(mdps)
    gammas = gammas_of(mdps) if batched else tuple(float(m.gamma)
                                                   for m in mdps)
    b_to = fleet_padded_batch(b, axes.fleet_size(), pad_fleet)
    b_loc = b_to // axes.fleet_size()
    lo = axes.fleet_index() * b_loc
    # one fleet shard of the whole fleet (a world of one): the container
    # itself, not a copy of its lanes
    local = mdps if batched and b_loc == b else fleet_lanes(
        mdps, lo, lo + b_loc, pin=torch.device(device).type == "cuda")
    return FleetBlock(block=_place(local, axes, mode, device), batch=b_to,
                      lane0=lo, gammas=gammas + (gammas[-1],) * (b_to - b),
                      layout=layout)


def place_block(block: MDP, axes: Axes, *, halo: int = 0,
                plan: tuple[int, int] | None = None) -> MDP:
    """``block`` with its ELL successor ids in window coordinates for
    ``halo`` and, for an overlap ``plan``, its interior rows' ids in its
    own coordinates (``own_idx``).  A matrix-free block records ``halo``:
    its backups map the rebuilt ids into the window."""
    if isinstance(block, MatrixFreeMDP):
        return dataclasses.replace(block, halo=halo)
    if not isinstance(block, EllMDP) or not (halo or plan):
        return block
    n_loc = block.n_local
    own = None
    if plan is not None:
        f_lo, f_hi = plan
        row_start = axes.state_index() * n_loc
        own = torch.clamp(block.idx.narrow(-3, f_lo, n_loc - f_lo - f_hi)
                          - row_start, 0, n_loc - 1).to(
                              block.idx.dtype).contiguous()
    return dataclasses.replace(
        block, idx=window_idx(block.idx, axes, n_loc, halo).contiguous(),
        own_idx=own)
