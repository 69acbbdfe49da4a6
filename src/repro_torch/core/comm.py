"""Collective-axis abstraction on ``torch.distributed``.

Counterpart of :mod:`repro.core.comm`.  madupite distributes states across
MPI ranks and lets PETSc insert the communication (VecScatter for the
SpMV's value movement, MPI_Allreduce for Krylov dots).  The reference
expresses that with named mesh axes inside ``shard_map``; the port holds a
process group per axis instead:

* ``state`` — states are row-partitioned over the group's ranks; moving
  ``v`` is an all-gather (or a ring halo exchange for banded MDPs); norms
  and dots are SUM / MAX all-reduces;
* ``action`` — the optional 2-D layout: actions are column-partitioned and
  the greedy step finishes with MIN all-reduces.

An axis that is ``None`` degenerates every collective to the identity, so
the same solver code runs on one device (``Axes()``).  On the card the
groups run NCCL, on the host gloo; a failed collective raises, nothing
falls back.  Every host read that steers the solve loop is of an
all-reduced tensor, which has the same bits on every rank, so all ranks
take the same branch.

Vectors may carry a leading fleet axis (``(B, n_local)``, the solver's
fleet of one): the state collectives act on the last dimension.

* ``fleet`` — the fleet-sharded layouts: the leading instance dim of a
  :func:`repro_torch.core.driver.solve_many` fleet is partitioned over
  the group's ranks (each owns ``B / fleet_size`` lanes on top of its
  state slice).  Lanes are independent, so the solver body needs no fleet
  collective; the host loops gather each lane's flags over the group
  (:meth:`Axes.allgather_fleet`), so every fleet shard agrees on when a
  loop ends and the lead rank's monitor sees every lane.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

# all_gather_into_tensor's newer name (same arguments) where torch has it
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _gather_last(x: torch.Tensor, group, *, async_op: bool = False):
    """All-gather ``x`` (``(..., n)``) over ``group`` along its last dim:
    ``(buffer, work)``; the gathered ``(..., size * n)`` tensor is
    :func:`_gathered` of the buffer once ``work`` has finished."""
    x = x.contiguous()
    flat = torch.empty(_size(group) * x.numel(), dtype=x.dtype,
                       device=x.device)
    work = _all_gather(flat, x.reshape(-1), group=group, async_op=async_op)
    return flat.view(_size(group), *x.shape), work


def _gather_lanes(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather ``x`` (``(B_local, ...)``) over ``group`` along its first
    dim, in rank order: ``(size * B_local, ...)``.  A bool tensor moves as
    uint8 (gloo's all-gather takes no bool)."""
    if x.dtype == torch.bool:
        return _gather_lanes(x.to(torch.uint8), group).bool()
    buf, _ = _gather_last(x, group)
    return buf.reshape(-1, *x.shape[1:])


def _gathered(buf: torch.Tensor) -> torch.Tensor:
    """``(size, ..., n)`` gathered shards -> ``(..., size * n)``."""
    if buf.dim() == 2:
        return buf.reshape(-1)
    return buf.movedim(0, -2).reshape(*buf.shape[1:-1], -1)


def _ring(x: torch.Tensor, halo: int, group):
    """Post the ring exchange of ``x``'s ``halo`` boundary entries:
    ``(left, right, works)``.  ``left`` receives the left neighbour's tail,
    ``right`` the right neighbour's head (ends wrap, as the reference's
    ``ppermute`` ring does)."""
    n, me = _size(group), _rank(group)
    peer = lambda r: dist.get_global_rank(group, r % n)
    tail = x[..., -halo:].contiguous()
    head = x[..., :halo].contiguous()
    left = torch.empty_like(tail)
    right = torch.empty_like(head)
    ops = [dist.P2POp(dist.isend, tail, peer(me + 1), group),
           dist.P2POp(dist.irecv, left, peer(me - 1), group),
           dist.P2POp(dist.isend, head, peer(me - 1), group),
           dist.P2POp(dist.irecv, right, peer(me + 1), group)]
    return left, right, dist.batch_isend_irecv(ops)


@dataclasses.dataclass(frozen=True)
class Pending:
    """A value window in flight (:meth:`Axes.gather_start`): the request
    handles and what :meth:`Axes.gather_finish` assembles once they are
    done."""

    works: tuple
    assemble: Any


@dataclasses.dataclass(frozen=True)
class Axes:
    """The process groups the solver is sharded over (``None``: not
    sharded along that axis)."""

    state: Any = None
    action: Any = None
    fleet: Any = None

    # ---- state-axis collectives -------------------------------------------
    def allgather_state(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """Gather the value vector across state shards (PETSc VecScatter
        analogue).  ``dtype`` compresses the wire format (the inexact
        gather of the inner matvecs): ``x`` is cast before it moves."""
        if dtype is not None:
            x = x.to(dtype)
        if self.state is None:
            return x
        buf, _ = _gather_last(x, self.state)
        return _gathered(buf)

    def halo_exchange(self, x: torch.Tensor, halo: int,
                      dtype=None) -> torch.Tensor:
        """The local window ``[start - halo, stop + halo)``: ``halo``
        boundary entries from each ring neighbour instead of the whole
        vector (valid when the transition matrix is banded with bandwidth
        <= halo, checked when the MDP is placed; the wrapped ends are
        never referenced by such an MDP).  Volume: ``2 * halo`` entries
        against ``n_global``."""
        return self.gather_finish(self.gather_start(x, halo=halo,
                                                    dtype=dtype))

    # ---- split-phase window movement (communication/computation overlap) --
    def gather_start(self, x: torch.Tensor, *, halo: int = 0,
                     dtype=None) -> Pending:
        """Issue the value-window collective (all-gather, or the halo ring
        when ``halo > 0``) asynchronously and return it in flight — the
        MPI_Isend half of the split; compute issued before
        :meth:`gather_finish` that does not read the window overlaps it."""
        if dtype is not None:
            x = x.to(dtype)
        if halo == 0:
            if self.state is None:
                return Pending((), lambda: x)
            buf, work = _gather_last(x, self.state, async_op=True)
            return Pending((work,), lambda: _gathered(buf))
        if _size(self.state) == 1:
            # one shard: the ring's neighbours are the shard itself
            return Pending((), lambda: torch.cat(
                [x[..., -halo:], x, x[..., :halo]], dim=-1))
        left, right, works = _ring(x, halo, self.state)
        return Pending(tuple(works),
                       lambda: torch.cat([left, x, right], dim=-1))

    def gather_finish(self, pending: Pending) -> torch.Tensor:
        """Wait for the window of :meth:`gather_start` (MPI_Wait) and
        return it."""
        for work in pending.works:
            work.wait()
        return pending.assemble()

    def _all_reduce(self, x: torch.Tensor, group, op) -> torch.Tensor:
        if group is None:
            return x
        y = x.clone()
        dist.all_reduce(y, op=op, group=group)
        return y

    def psum_state(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, self.state, dist.ReduceOp.SUM)

    def pmax_state(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, self.state, dist.ReduceOp.MAX)

    def psum_ordered(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over state shards in rank order, whatever the
        collective's own reduction order: the partials are gathered and
        added left to right.  The deterministic dots' reduction: the bits
        depend on the number of state shards only."""
        if self.state is None:
            return x
        buf, _ = _gather_last(x.reshape(1, -1), self.state)
        acc = buf[0]
        for i in range(1, buf.shape[0]):
            acc = acc + buf[i]
        return acc.reshape(x.shape)

    def state_index(self) -> int:
        return _rank(self.state)

    def state_size(self) -> int:
        return _size(self.state)

    # ---- action-axis collectives ------------------------------------------
    def pmin_action(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, self.action, dist.ReduceOp.MIN)

    def pmax_action(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, self.action, dist.ReduceOp.MAX)

    def psum_action(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, self.action, dist.ReduceOp.SUM)

    def action_index(self) -> int:
        return _rank(self.action)

    def action_size(self) -> int:
        return _size(self.action)

    # ---- fleet-axis collectives ------------------------------------------
    def any_fleet(self, x: torch.Tensor) -> torch.Tensor:
        """Logical OR of a boolean across fleet shards (keeps the shared
        host loops in lockstep when lanes stop on some shards first)."""
        if self.fleet is None:
            return x
        return self._all_reduce(x.to(torch.int32), self.fleet,
                                dist.ReduceOp.MAX) > 0

    def fleet_index(self) -> int:
        return _rank(self.fleet)

    def fleet_size(self) -> int:
        return _size(self.fleet)

    def pmax_fleet(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, self.fleet, dist.ReduceOp.MAX)

    def allgather_fleet(self, x: torch.Tensor) -> torch.Tensor:
        """Gather per-lane rows (``(B_local, ...)``) across fleet shards
        into the fleet's ``(B, ...)``, lanes in order (the monitor's
        fleet-wide record, the driver's per-chunk flags, the results)."""
        if self.fleet is None:
            return x
        return _gather_lanes(x, self.fleet)

    # ---- derived linear-algebra helpers -----------------------------------
    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """<x, y> over state shards (MPI_Allreduce analogue)."""
        return self.psum_state(torch.dot(x, y))

    def norm2(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.clamp_min(self.dot(x, x), 0.0))

    def norm_inf(self, x: torch.Tensor) -> torch.Tensor:
        """``max |x|`` over the states: 0-d, or ``(B,)`` for a fleet's
        ``(B, n)`` (a max is exact in any order)."""
        return self.pmax_state(torch.amax(torch.abs(x), dim=-1))

    # ---- fleets: one value a lane of (B, n) vectors ------------------------
    def dot_lanes(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``(B,)``: ``<x[b], y[b]>`` over state shards, for every lane."""
        return self.psum_state(torch.sum(x * y, dim=-1))

    def norm2_lanes(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.clamp_min(self.dot_lanes(x, x), 0.0))
