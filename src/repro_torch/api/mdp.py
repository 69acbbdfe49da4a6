"""The user-facing MDP builder, materialized subset.

Counterpart of :class:`repro.api.MDP`: an MDP plus its solve semantics
(``mode="mincost"`` solves ``min_a``; ``"maxreward"`` reads ``cost`` as a
reward and solves ``max_a``).  Ported so far:

* :meth:`MDP.from_arrays` with ELL tables (``idx`` + ``val`` + ``cost``)
  or a dense transition tensor (``p`` + ``cost``);
* :meth:`MDP.from_generator` over the host generator families;
* :meth:`MDP.from_file` over the block-manifest format of
  :mod:`repro_torch.core.io` (either package's files).

Function-backed MDPs are not ported yet.  The tables are built on the
host; :meth:`MDP.build` returns them on a device, cached per device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import io as core_io
from repro_torch.core.generators import REGISTRY as GENERATORS
from repro_torch.core.ipi import MODES
from repro_torch.core.mdp import MDP as CoreMDP, DenseMDP, EllMDP
from repro_torch.device import resolve_device

__all__ = ["MDP"]


class MDP:
    """A built MDP plus its solve semantics (``mode``)."""

    def __init__(self, core: CoreMDP, *, mode: str = "mincost"):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; pick one of {MODES}")
        if not isinstance(core, (EllMDP, DenseMDP)):
            raise TypeError(f"MDP wraps an EllMDP or a DenseMDP, got "
                            f"{type(core).__name__}")
        self._core = core
        self.mode = mode
        self._device_cache: dict[torch.device, CoreMDP] = {}

    # ---- constructors ------------------------------------------------------
    @classmethod
    def from_arrays(cls, *, idx=None, val=None, cost=None, p=None,
                    gamma: float = 0.99, mode: str = "mincost",
                    validate: bool = True) -> "MDP":
        """ELL (``idx`` (n, m, K) + ``val`` (n, m, K) + ``cost`` (n, m))
        or dense (``p`` (n, m, n) + ``cost``), stored as the reference
        stores them (int32 ids, float32 values)."""
        if cost is None:
            raise ValueError("from_arrays requires cost (the stage "
                             "cost/reward table g(s, a))")
        if p is not None:
            if idx is not None or val is not None:
                raise ValueError("pass either dense p or ELL idx/val, "
                                 "not both")
            p = _host(p)
            core = DenseMDP.from_numpy(p, _host(cost), gamma,
                                       n_global=p.shape[0],
                                       m_global=p.shape[1], device="cpu")
        elif idx is None or val is None:
            raise ValueError("from_arrays requires idx+val (ELL) or p "
                             "(dense)")
        else:
            idx, val = _host(idx), _host(val)
            core = EllMDP.from_numpy(idx, val, _host(cost), gamma,
                                     n_global=idx.shape[0],
                                     m_global=idx.shape[1], device="cpu")
        if validate:
            core.validate()
        return cls(core, mode=mode)

    @classmethod
    def from_file(cls, path: str, *, mode: str | None = None,
                  rows: tuple[int, int] | None = None) -> "MDP":
        """Load the block-manifest format of :mod:`repro_torch.core.io`.
        The manifest's stored ``mode`` (if any) is used unless
        overridden."""
        if mode is None:
            mode = core_io.load_manifest(path).get("mode") or "mincost"
        return cls(core_io.load_mdp(path, rows=rows), mode=mode)

    @classmethod
    def from_generator(cls, name: str, *, mode: str = "mincost",
                       **kw) -> "MDP":
        """One of the built-in instance families
        (``garnet``/``maze2d``/``sis``/``chain_walk``)."""
        if name not in GENERATORS:
            raise ValueError(f"unknown generator {name!r}; pick one of "
                             f"{sorted(GENERATORS)}")
        return cls(GENERATORS[name](**kw), mode=mode)

    # ---- introspection -----------------------------------------------------
    @property
    def n(self) -> int:
        return self._core.n_global

    @property
    def m(self) -> int:
        return self._core.m_global

    @property
    def gamma(self) -> float:
        return self._core.gamma

    @property
    def core(self) -> CoreMDP:
        """The core container as built (host tables for the built-in
        constructors); :meth:`build` places it."""
        return self._core

    def __repr__(self) -> str:
        return (f"MDP({type(self._core).__name__}, n={self.n}, m={self.m}, "
                f"gamma={self.gamma}, mode={self.mode!r})")

    # ---- placement ---------------------------------------------------------
    def build(self, device: str | torch.device = "cuda") -> CoreMDP:
        """The core container with its tables on ``device`` (cached)."""
        dev = resolve_device(device)
        if dev not in self._device_cache:
            self._device_cache[dev] = self._core.to(dev)
        return self._device_cache[dev]

    def evict(self) -> None:
        """Drop the cached device copies (keeps the host tables)."""
        self._device_cache.clear()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
