"""MDP container: padded ELLPACK tables as torch tensors.

Counterpart of :mod:`repro.core.mdp` (the unbatched :class:`EllMDP`).
Every (state, action) row keeps exactly ``K`` (index, value) slots;
padding slots carry ``val == 0`` and an in-range index, so gathers stay in
bounds and the arithmetic is exact.  Successor indices are global state
ids.

Dense, batched and matrix-free containers are not ported yet.
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

        def put(x, dtype):   # always a private copy, like jnp.asarray
            return torch.from_numpy(np.array(x, dtype=dtype, order="C",
                                             copy=True)).to(dev)

        return cls(idx=put(idx, np.int32), val=put(val, np.float32),
                   cost=put(cost, np.float32), gamma=float(gamma),
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
        if not 0.0 < self.gamma < 1.0:
            raise ValueError(f"gamma must lie in (0, 1), got {self.gamma}")

