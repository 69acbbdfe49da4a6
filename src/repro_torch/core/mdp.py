"""MDP containers: padded ELLPACK and dense tables as torch tensors.

Counterpart of :mod:`repro.core.mdp` (the unbatched :class:`EllMDP` and
:class:`DenseMDP`).  In an :class:`EllMDP` every (state, action) row keeps
exactly ``K`` (index, value) slots; padding slots carry ``val == 0`` and an
in-range index, so gathers stay in bounds and the arithmetic is exact.
Successor indices are global state ids.  A :class:`DenseMDP` stores the
full ``(n, m, n_cols)`` transition tensor.

Batched and matrix-free containers are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EllMDP:
    """Padded-ELL sparse MDP.

    idx:  (n, m, K) int32 — global successor ids (pad: 0)
    val:  (n, m, K) f32   — transition probabilities (pad: 0)
    cost: (n, m)    f32   — stage costs g(s, a)
    """

    idx: torch.Tensor
    val: torch.Tensor
    cost: torch.Tensor
    gamma: float
    n_global: int
    m_global: int

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
        return dataclasses.replace(self, idx=self.idx.to(dev),
                                   val=self.val.to(dev),
                                   cost=self.cost.to(dev))

    def validate(self) -> None:
        """Host-side sanity checks (probability rows, index ranges)."""
        idx = self.idx.cpu().numpy()
        val = self.val.cpu().numpy()
        if idx.shape[-3:] != val.shape[-3:]:
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
        _check_gamma(self.gamma)

    def as_dense(self) -> "DenseMDP":
        """Materialize the dense tensor on the tables' device (small
        instances, oracles, and the dense path's tests).

        Duplicate successor ids of a row accumulate in the reference's
        order, ``k = 0 .. K-1`` from ``+0``: one ``index_put_`` per ``k``,
        within which no two writes share a ``(s, a)`` row, so the bits are
        the same on every device."""
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
    """

    p: torch.Tensor
    cost: torch.Tensor
    gamma: float
    n_global: int
    m_global: int

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
        if p.dim() != 3 or tuple(self.cost.shape) != tuple(p.shape[:2]):
            raise ValueError(f"p must be (n, m, n_cols) and cost (n, m); got "
                             f"{tuple(p.shape)} and {tuple(self.cost.shape)}")
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
        _check_gamma(self.gamma)


MDP = EllMDP | DenseMDP   # a materialized MDP block


def _put(x, dtype, dev: torch.device) -> torch.Tensor:
    """A private host copy of ``x`` as ``dtype`` (like ``jnp.asarray``),
    placed on ``dev``."""
    return torch.from_numpy(np.array(x, dtype=dtype, order="C",
                                     copy=True)).to(dev)


def _check_gamma(gamma: float) -> None:
    if not 0.0 < gamma < 1.0:
        raise ValueError(f"gamma must lie in (0, 1), got {gamma}")

