"""MDP containers: padded ELLPACK and dense tables as torch tensors.

Counterpart of :mod:`repro.core.mdp` (the unbatched :class:`EllMDP` and
:class:`DenseMDP`).  In an :class:`EllMDP` every (state, action) row keeps
exactly ``K`` (index, value) slots; padding slots carry ``val == 0`` and an
in-range index, so gathers stay in bounds and the arithmetic is exact.
Successor indices are global state ids.  A :class:`DenseMDP` stores the
full ``(n, m, n_cols)`` transition tensor.

Batched fleets
--------------
Both containers optionally carry a leading batch dimension ``B`` (a
*fleet* of same-shape instances solved in one lockstep loop —
:func:`repro_torch.core.driver.solve_many`).  :func:`stack_mdps` builds
the batched container from per-instance MDPs with the reference's rules:
heterogeneous ELL state counts are padded with absorbing zero-cost
states, one ``idx`` is stored unbatched when every instance has the same
sparsity pattern (a gamma sweep: *shared topology*), and ``gamma`` is a
float for a homogeneous fleet or a tuple of per-instance floats.
:func:`batch_parts` turns a per-instance gamma into the ``(B,)`` tensor
the kernels take; :func:`as_fleet` makes one instance the fleet of one,
as the solver loop runs it.

Matrix-free containers
----------------------
A :class:`MatrixFreeMDP` stores no table: it carries a function-backed
MDP's row spec (:class:`repro_torch.kernels.matrix_free.RowSpec`) and an
int8 placement tag of its local state extent, and the Bellman layer
rebuilds row chunks from the spec inside every backup.  A fleet of them
shares one spec (a gamma sweep): its tag gains the leading ``B``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.utils import trace

@dataclasses.dataclass(frozen=True)
class EllMDP:
    """Padded-ELL sparse MDP.

    idx:  (n, m, K) int32 — global successor ids (pad: 0)
    val:  (n, m, K) f32   — transition probabilities (pad: 0)
    cost: (n, m)    f32   — stage costs g(s, a)

    Batched (``B``-instance fleet): ``val`` / ``cost`` gain a leading
    batch dim; ``idx`` is either batched ``(B, n, m, K)`` or shared
    ``(n, m, K)`` (one topology for every instance); ``gamma`` is a float
    or a length-B tuple of per-instance floats.

    A rank's block of a sharded MDP (:func:`repro_torch.core.partition.
    shard_mdp`) holds its rows; after :func:`~repro_torch.core.partition.
    place_block` its ``idx`` is in the coordinates of the value window its
    backups read, and ``own_idx`` (``(n_int, m, K)``, or ``None``) holds
    the interior rows' successors in the block's own coordinates for the
    communication-overlapped backup.
    """

    idx: torch.Tensor
    val: torch.Tensor
    cost: torch.Tensor
    gamma: float | tuple
    n_global: int
    m_global: int
    own_idx: torch.Tensor | None = None

    @property
    def batch(self) -> int | None:
        """Fleet size ``B``, or ``None`` for an unbatched instance."""
        return self.val.shape[0] if self.val.dim() == 4 else None

    @property
    def shared_topology(self) -> bool:
        """Batched with one ``idx`` shared by every instance."""
        return self.batch is not None and self.idx.dim() == 3

    def instance(self, b: int) -> "EllMDP":
        """The unbatched instance ``b`` of a fleet (views of its tables)."""
        if self.batch is None:
            raise ValueError("instance() is only defined on a batched MDP")
        return EllMDP(idx=self.idx if self.shared_topology else self.idx[b],
                      val=self.val[b], cost=self.cost[b],
                      gamma=gammas_of(self)[b], n_global=self.n_global,
                      m_global=self.m_global)

    @property
    def n_local(self) -> int:
        return self.val.shape[-3]

    @property
    def m_local(self) -> int:
        return self.val.shape[-2]

    @property
    def nnz_per_row(self) -> int:
        return self.idx.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.val.device

    @classmethod
    def from_numpy(cls, idx, val, cost, gamma: float, n_global: int,
                   m_global: int, *, device: str | torch.device = "cpu") \
            -> "EllMDP":
        """Build from host arrays (e.g. ``np.asarray(jax_mdp.idx)``), cast
        to the reference's storage types (int32 / float32) and placed on
        ``device``."""
        dev = resolve_device(device)
        return cls(idx=_put(idx, np.int32, dev),
                   val=_put(val, np.float32, dev),
                   cost=_put(cost, np.float32, dev), gamma=float(gamma),
                   n_global=int(n_global), m_global=int(m_global))

    def to(self, device: str | torch.device) -> "EllMDP":
        """The same MDP with its tables on ``device`` (no copy if there)."""
        dev = resolve_device(device)
        if self.device == dev:
            return self
        own = None if self.own_idx is None else self.own_idx.to(dev)
        return dataclasses.replace(self, idx=self.idx.to(dev),
                                   val=self.val.to(dev),
                                   cost=self.cost.to(dev), own_idx=own)

    def validate(self) -> None:
        """Host-side sanity checks (probability rows, index ranges)."""
        idx = self.idx.cpu().numpy()
        val = self.val.cpu().numpy()
        if idx.shape[-3:] != val.shape[-3:] or val.ndim not in (3, 4) \
                or (idx.ndim == 4 and idx.shape[0] != val.shape[0]):
            raise ValueError(f"idx shape {idx.shape} != val shape "
                             f"{val.shape}")
        if tuple(self.cost.shape) != val.shape[:-1]:
            raise ValueError(f"cost shape {tuple(self.cost.shape)} != "
                             f"{val.shape[:-1]}")
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_global):
            raise ValueError(f"successor ids must lie in [0, "
                             f"{self.n_global}), got [{idx.min()}, "
                             f"{idx.max()}]")
        rowsum = val.sum(-1)
        if not np.allclose(rowsum, 1.0, rtol=0.0, atol=1e-5):
            bad = np.unravel_index(np.argmax(np.abs(rowsum - 1.0)),
                                   rowsum.shape)
            raise ValueError(f"transition row {tuple(int(i) for i in bad)} "
                             f"sums to {rowsum[bad]}, not 1")
        if not (val >= -1e-7).all():
            raise ValueError("transition probabilities must be >= 0")
        _check_gammas(self)

    def as_dense(self) -> "DenseMDP":
        """Materialize the dense tensor on the tables' device (small
        instances, oracles, and the dense path's tests).

        Duplicate successor ids of a row accumulate in the reference's
        order, ``k = 0 .. K-1`` from ``+0``: one ``index_put_`` per ``k``,
        within which no two writes share a ``(s, a)`` row, so the bits are
        the same on every device."""
        if self.batch is not None:
            raise ValueError("as_dense() is unbatched-only; use instance(b)")
        n, m, k = self.idx.shape
        dev = self.device
        p = torch.zeros((n, m, self.n_global), dtype=self.val.dtype,
                        device=dev)
        s = torch.arange(n, device=dev)[:, None]
        a = torch.arange(m, device=dev)[None, :]
        idx = self.idx.long()
        for j in range(k):
            p.index_put_((s, a, idx[..., j]), self.val[..., j],
                         accumulate=True)
        return DenseMDP(p=p, cost=self.cost, gamma=self.gamma,
                        n_global=self.n_global, m_global=self.m_global)


@dataclasses.dataclass(frozen=True)
class DenseMDP:
    """Dense MDP block.

    p:    (n, m, n_cols) f32 — transition probabilities P(s, a, s')
    cost: (n, m)         f32 — stage costs g(s, a)

    Batched fleet: leading ``B`` dim on both tensors; ``gamma`` as in
    :class:`EllMDP`.
    """

    p: torch.Tensor
    cost: torch.Tensor
    gamma: float | tuple
    n_global: int
    m_global: int

    @property
    def batch(self) -> int | None:
        return self.p.shape[0] if self.p.dim() == 4 else None

    @property
    def shared_topology(self) -> bool:
        return False

    def instance(self, b: int) -> "DenseMDP":
        if self.batch is None:
            raise ValueError("instance() is only defined on a batched MDP")
        return DenseMDP(p=self.p[b], cost=self.cost[b],
                        gamma=gammas_of(self)[b], n_global=self.n_global,
                        m_global=self.m_global)

    @property
    def n_local(self) -> int:
        return self.p.shape[-3]

    @property
    def m_local(self) -> int:
        return self.p.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.p.device

    @classmethod
    def from_numpy(cls, p, cost, gamma: float, n_global: int, m_global: int,
                   *, device: str | torch.device = "cpu") -> "DenseMDP":
        """Build from host arrays (e.g. ``np.asarray(jax_mdp.p)``), cast to
        the reference's storage type (float32) and placed on ``device``."""
        dev = resolve_device(device)
        return cls(p=_put(p, np.float32, dev),
                   cost=_put(cost, np.float32, dev), gamma=float(gamma),
                   n_global=int(n_global), m_global=int(m_global))

    def to(self, device: str | torch.device) -> "DenseMDP":
        """The same MDP with its tables on ``device`` (no copy if there)."""
        dev = resolve_device(device)
        if self.device == dev:
            return self
        return dataclasses.replace(self, p=self.p.to(dev),
                                   cost=self.cost.to(dev))

    def validate(self) -> None:
        """Sanity checks (probability rows, shapes), run by torch on the
        tables' own device: a table that fills the card is never copied to
        the host to be checked."""
        p = self.p
        if p.dim() not in (3, 4) \
                or tuple(self.cost.shape) != tuple(p.shape[:-1]):
            raise ValueError(f"p must be ([B,] n, m, n_cols) and cost "
                             f"([B,] n, m); got {tuple(p.shape)} and "
                             f"{tuple(self.cost.shape)}")
        if p.shape[-1] != self.n_global:
            raise ValueError(f"p has {p.shape[-1]} columns, not n_global = "
                             f"{self.n_global}")
        if p.numel():
            rowsum = p.sum(-1)
            err = torch.abs(rowsum - 1.0)
            if not float(err.max()) <= 1e-5:
                bad = np.unravel_index(int(torch.argmax(err)), err.shape)
                raise ValueError(f"transition row {tuple(int(i) for i in bad)}"
                                 f" sums to {float(rowsum[bad])}, not 1")
            if not float(p.min()) >= -1e-7:
                raise ValueError("transition probabilities must be >= 0")
        _check_gammas(self)


@dataclasses.dataclass(frozen=True)
class MatrixFreeMDP:
    """Matrix-free MDP block: no stored tables, rows are rebuilt on the fly.

    tag:  ([B,] n_local) int8 zeros — the block's placement: its local state
          extent, on the device it solves on
    spec: the row spec (:class:`repro_torch.kernels.matrix_free.RowSpec`)
          whose constructors the Bellman layer runs inside every backup and
          policy-row extraction, so a block holds ``O(n_local)`` memory
          instead of ``O(n_local * m * nnz)``
    halo: the value window the block's backups read — ``0`` for the
          gathered vector, else the ``[start - halo, stop + halo)`` halo
          window (:func:`repro_torch.core.partition.place_block` sets it,
          where it shifts an ELL block's ``idx``)

    A fleet's lanes share the one spec (identical constructors and shape:
    the gamma sweep); per-lane discounts ride in the ``gamma`` tuple as for
    the table containers.
    """

    tag: torch.Tensor
    gamma: float | tuple
    n_global: int
    m_global: int
    spec: object
    halo: int = 0

    @property
    def batch(self) -> int | None:
        return self.tag.shape[0] if self.tag.dim() == 2 else None

    @property
    def shared_topology(self) -> bool:
        return False

    @property
    def n_local(self) -> int:
        return self.tag.shape[-1]

    @property
    def m_local(self) -> int:
        # matrix-free blocks shard states only: every block covers all
        # actions
        return self.m_global

    @property
    def nnz_per_row(self) -> int:
        return self.spec.nnz

    @property
    def acts(self) -> tuple:
        """The global action ids every backup covers."""
        return tuple(range(self.m_global))

    @property
    def device(self) -> torch.device:
        return self.tag.device

    def instance(self, b: int) -> "MatrixFreeMDP":
        if self.batch is None:
            raise ValueError("instance() is only defined on a batched MDP")
        return dataclasses.replace(self, tag=self.tag[b],
                                   gamma=gammas_of(self)[b])

    def to(self, device: str | torch.device) -> "MatrixFreeMDP":
        """The same operator placed on ``device`` (its tag moves; the
        constructors run wherever the rows are)."""
        dev = resolve_device(device)
        if self.device == dev:
            return self
        return dataclasses.replace(self, tag=self.tag.to(dev))

    def validate(self) -> None:
        if self.tag.dtype != torch.int8:
            raise ValueError(f"tag must be int8, got {self.tag.dtype}")
        if self.n_global < self.spec.n:
            raise ValueError(f"n_global {self.n_global} < the spec's n "
                             f"{self.spec.n}")
        if self.m_global != self.spec.m:
            raise ValueError(f"m_global {self.m_global} != the spec's m "
                             f"{self.spec.m}")
        _check_gammas(self)


MDP = EllMDP | DenseMDP | MatrixFreeMDP


# --------------------------------------------------------------------------- #
# Fleet (batched multi-instance) construction                                 #
# --------------------------------------------------------------------------- #

def gammas_of(mdp: MDP) -> tuple:
    """Per-instance discount factors as a tuple (length B, or 1 unbatched)."""
    if isinstance(mdp.gamma, tuple):
        return mdp.gamma
    return (mdp.gamma,) * (mdp.batch or 1)


def stack_mdps(mdps) -> MDP:
    """Stack per-instance MDPs into one batched fleet container.

    All instances must share the container type, action count and (for
    ELL) nnz/row; heterogeneous ELL state counts are padded to the largest
    with absorbing zero-cost self-loops (trim results with the
    per-instance ``n_global`` you kept).  When every instance has the same
    sparsity pattern the single ``idx`` is stored unbatched.  A
    heterogeneous ``gamma`` is kept as a per-instance tuple.  The tables
    are stacked on the first instance's device.
    """
    mdps = list(mdps)
    if not mdps:
        raise ValueError("stack_mdps needs at least one MDP")
    first = mdps[0]
    kinds = (EllMDP, DenseMDP, MatrixFreeMDP)
    if any(not isinstance(m, kinds) for m in mdps):
        bad = sorted({type(m).__name__ for m in mdps
                      if not isinstance(m, kinds)})
        raise TypeError(f"stack_mdps takes EllMDP, DenseMDP or "
                        f"MatrixFreeMDP instances (the last: function-"
                        f"backed MDPs, ROADMAP queue 1 item 11), got {bad}")
    if any(type(m) is not type(first) for m in mdps):
        raise ValueError("stack_mdps: all instances must share one container "
                         f"type, got {sorted({type(m).__name__ for m in mdps})}")
    if any(m.batch is not None for m in mdps):
        raise ValueError("stack_mdps takes unbatched instances")
    if any(m.m_global != first.m_global for m in mdps):
        raise ValueError("stack_mdps: action counts differ "
                         f"({[m.m_global for m in mdps]}); pad actions first")
    gammas = tuple(float(m.gamma) for m in mdps)
    gamma = gammas[0] if len(set(gammas)) == 1 else gammas
    dev = first.device
    if isinstance(first, MatrixFreeMDP):
        # one spec for the fleet: lanes share the constructors and shape
        # (the gamma sweep), so each row chunk is rebuilt once for all
        if any(m.spec != first.spec or m.n_global != first.n_global
               for m in mdps):
            raise ValueError(
                "stack_mdps(MatrixFreeMDP): all lanes must share one row "
                "spec (identical P_fn/g_fn and n/m/nnz — gamma may "
                "differ); heterogeneous matrix-free fleets must be "
                "materialized (-mdp_materialize device) or solved "
                "separately")
        return MatrixFreeMDP(
            tag=torch.zeros((len(mdps), first.n_local), dtype=torch.int8,
                            device=dev),
            gamma=gamma, n_global=first.n_global, m_global=first.m_global,
            spec=first.spec)
    if isinstance(first, DenseMDP):
        if any(m.n_global != first.n_global for m in mdps):
            raise ValueError("stack_mdps(DenseMDP): state counts must match")
        return DenseMDP(p=torch.stack([m.p.to(dev) for m in mdps]),
                        cost=torch.stack([m.cost.to(dev) for m in mdps]),
                        gamma=gamma, n_global=first.n_global,
                        m_global=first.m_global)
    if any(m.nnz_per_row != first.nnz_per_row for m in mdps):
        raise ValueError("stack_mdps(EllMDP): nnz/row differ "
                         f"({[m.nnz_per_row for m in mdps]})")
    n_to = max(m.n_global for m in mdps)
    k, m_g = first.nnz_per_row, first.m_global
    idxs, vals, costs = [], [], []
    for m in mdps:
        hi, hv, hc = m.idx.to(dev), m.val.to(dev), m.cost.to(dev)
        if m.n_global < n_to:
            # absorbing zero-cost self-loops, the reference's state padding
            # (value identically 0, unreachable from real states)
            n_pad = n_to - m.n_global
            pad_idx = torch.zeros((n_pad, m_g, k), dtype=hi.dtype,
                                  device=dev)
            pad_idx[..., 0] = torch.arange(m.n_global, n_to, dtype=hi.dtype,
                                           device=dev)[:, None]
            pad_val = torch.zeros((n_pad, m_g, k), dtype=hv.dtype,
                                  device=dev)
            pad_val[..., 0] = 1.0
            hi = torch.cat([hi, pad_idx])
            hv = torch.cat([hv, pad_val])
            hc = torch.cat([hc, torch.zeros((n_pad, m_g), dtype=hc.dtype,
                                            device=dev)])
        idxs.append(hi)
        vals.append(hv)
        costs.append(hc)
    shared = True
    for i in idxs[1:]:
        with trace.reading("driver.stack"):
            shared = torch.equal(i, idxs[0])
        if not shared:
            break
    idx = idxs[0].contiguous() if shared else torch.stack(idxs)
    return EllMDP(idx=idx, val=torch.stack(vals), cost=torch.stack(costs),
                  gamma=gamma, n_global=n_to, m_global=m_g)


def as_fleet(mdp: MDP) -> MDP:
    """One instance as the fleet of one: views of its tables with a
    leading ``B = 1`` (an ELL ``idx`` stays unbatched, as a shared
    topology) and its float ``gamma``."""
    if mdp.batch is not None:
        raise ValueError("as_fleet() takes one MDP instance")
    if isinstance(mdp, DenseMDP):
        return dataclasses.replace(mdp, p=mdp.p[None], cost=mdp.cost[None])
    if isinstance(mdp, MatrixFreeMDP):
        return dataclasses.replace(mdp, tag=mdp.tag[None])
    return dataclasses.replace(mdp, val=mdp.val[None], cost=mdp.cost[None])


def batch_parts(mdp: MDP, dtype: torch.dtype) -> torch.Tensor | None:
    """The per-instance discounts of a batched MDP as the ``(B,)`` tensor
    the kernels take, in ``dtype`` (the solve's) on the tables' device, or
    ``None`` for a homogeneous fleet, which keeps the Python float and
    with it the unbatched arithmetic."""
    if mdp.batch is None:
        raise ValueError("batch_parts() requires a batched MDP")
    if not (isinstance(mdp.gamma, tuple) and len(set(mdp.gamma)) > 1):
        return None
    return torch.tensor(mdp.gamma, dtype=dtype, device=mdp.device)


def _put(x, dtype, dev: torch.device) -> torch.Tensor:
    """A private host copy of ``x`` as ``dtype`` (like ``jnp.asarray``),
    placed on ``dev``."""
    return torch.from_numpy(np.array(x, dtype=dtype, order="C",
                                     copy=True)).to(dev)


def _check_gammas(mdp: MDP) -> None:
    gammas = gammas_of(mdp)
    if mdp.batch is not None and len(gammas) != mdp.batch:
        raise ValueError(f"{len(gammas)} gammas for a fleet of {mdp.batch}")
    for gamma in gammas:
        if not 0.0 < gamma < 1.0:
            raise ValueError(f"gamma must lie in (0, 1), got {gamma}")

