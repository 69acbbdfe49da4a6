"""The session layer, single-device subset.

Counterpart of :mod:`repro.api.session`.  A :class:`Session` owns one
options database, places each solve on its ``-device`` (``cuda`` unless
the caller asks for ``cpu``), runs :func:`repro_torch.core.driver.solve`,
records per-solve statistics (:attr:`Session.stats`) and writes the
``-file_policy`` / ``-file_cost`` outputs.

    from repro_torch.api import MDP, madupite_session

    with madupite_session({"-method": "ipi_gmres", "-atol": 1e-8}) as s:
        result = s.solve(MDP.from_generator("garnet", n=10_000, m=16, k=8))

Meshes, fleets, monitors, ``-method auto`` and ``-file_stats`` are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import time
import weakref
from typing import Any, Mapping

import numpy as np

from repro_torch.api.mdp import MDP
from repro_torch.api.options import Options
from repro_torch.core import driver
from repro_torch.core.driver import SolveResult
from repro_torch.core.mdp import MDP as CoreMDP, DenseMDP, EllMDP
from repro_torch.device import resolve_device

__all__ = ["Session", "madupite_session"]


class Session:
    """A solve context: options database + device placement + outputs.

    ``options`` may be an :class:`Options` database, a plain mapping of
    option keys, or ``None`` (registry defaults + ``MADUPITE_OPTIONS``).
    The device named by ``-device`` is checked here, so asking for
    ``cuda`` without a GPU fails when the session opens.
    """

    def __init__(self, options: Options | Mapping[str, Any] | None = None):
        if isinstance(options, Options):
            self.options = options
        else:
            self.options = Options.from_sources(options)
        resolve_device(self.options.get("-device"))
        self._stats: list[dict] = []
        # builders this session placed: their device copies are dropped
        # on close
        self._solved: weakref.WeakSet = weakref.WeakSet()
        self._closed = False

    # ---- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Release the device copies of the MDPs this session placed."""
        if not self._closed:
            for mdp in list(self._solved):
                mdp.evict()
            self._solved = weakref.WeakSet()
            self._closed = True

    @property
    def stats(self) -> list[dict]:
        """Accumulated per-solve statistics."""
        return list(self._stats)

    # ---- solving -----------------------------------------------------------
    def solve(self, mdp: MDP | CoreMDP, **overrides) -> SolveResult:
        """Solve one MDP through the session's options and device.

        ``overrides`` are per-call option overrides (keys with or without
        the leading dash): ``s.solve(mdp, method="vi", atol=1e-6)``.
        """
        if self._closed:
            raise RuntimeError("this Session is closed; create a new one")
        opts = self.options.with_overrides(overrides) if overrides \
            else self.options
        mdp = self._wrap(mdp, opts)
        ipi = opts.to_ipi()
        if not opts.is_set("-mode") and ipi.mode != mdp.mode:
            ipi = dataclasses.replace(ipi, mode=mdp.mode)
        device = opts.get("-device")
        core = mdp.build(device)
        self._solved.add(mdp)
        t0 = time.time()
        r = driver.solve(core, ipi, chunk=opts.get("-chunk"),
                         verbose=opts.get("-verbose"), device=device)
        wall = time.time() - t0
        self._record(r, mdp, ipi, opts, device, wall)
        self._write_outputs(r, opts)
        return r

    # ---- internals ---------------------------------------------------------
    def _wrap(self, mdp: MDP | CoreMDP, opts: Options) -> MDP:
        if isinstance(mdp, MDP):
            return mdp
        if isinstance(mdp, (EllMDP, DenseMDP)):
            return MDP(mdp, mode=opts.get("-mode"))
        raise TypeError(f"solve wants a repro_torch.api.MDP (or a core "
                        f"EllMDP/DenseMDP), got {type(mdp).__name__}")

    def _record(self, r: SolveResult, mdp: MDP, ipi, opts: Options,
                device: str, wall: float) -> None:
        self._stats.append({
            "method": ipi.method,
            "mode": ipi.mode,
            "stop_criterion": ipi.stop_criterion,
            "device": device,
            "options": {k: v for k, v in
                        opts.as_dict(explicit_only=True).items()},
            "wall_s": round(wall, 6),
            "solves": [{
                "n": int(mdp.n), "m": int(mdp.m), "gamma": float(mdp.gamma),
                "converged": bool(r.converged),
                "diverged": bool(r.diverged),
                "outer_iterations": int(r.outer_iterations),
                "inner_iterations": int(r.inner_iterations),
                "residual": float(r.residual),
                "gap_bound": float(r.gap_bound),
            }],
        })

    def _write_outputs(self, r: SolveResult, opts: Options) -> None:
        for key, field in (("-file_policy", "policy"), ("-file_cost", "v")):
            path = opts.get(key)
            if not path:
                continue
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            np.save(path, np.asarray(getattr(r, field)))


def madupite_session(options: Options | Mapping[str, Any] | None = None) \
        -> Session:
    """Open a solve session (the ``madupite.initialize()`` analogue)::

        with madupite_session({"-method": "vi", "-device": "cpu"}) as s:
            r = s.solve(mdp)
    """
    return Session(options)
