"""Collective-axis abstraction, single-device subset.

Counterpart of :mod:`repro.core.comm`.  The solver code calls the same
collectives as the reference (``psum_state``, ``pmax_state``, ...); on one
device there is no axis to reduce over and each collective is the identity.  A later
slice puts ``torch.distributed`` behind the same interface.
"""

from __future__ import annotations

import torch


class Axes:
    """The mesh axes the solver is sharded over: none, on one device."""

    # ---- state-axis collectives -------------------------------------------
    def allgather_state(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def psum_state(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def pmax_state(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def state_index(self) -> int:
        return 0

    # ---- action-axis collectives ------------------------------------------
    def psum_action(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def action_index(self) -> int:
        return 0

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

