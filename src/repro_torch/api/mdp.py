"""The user-facing MDP builder — madupite's ``MDP`` object.

Counterpart of :class:`repro.api.MDP`: an MDP plus its solve semantics
(``mode="mincost"`` solves ``min_a``; ``"maxreward"`` reads ``cost`` as a
reward and solves ``max_a``), built

* from arrays (:meth:`MDP.from_arrays`): ELL tables (``idx`` + ``val`` +
  ``cost``) or a dense transition tensor (``p`` + ``cost``);
* from files (:meth:`MDP.from_file`): the block-manifest format of
  :mod:`repro_torch.core.io` (either package's files), which
  :meth:`MDP.save` writes;
* from the built-in generator families (:meth:`MDP.from_generator`),
  optionally *deferred* (``deferred=True``: the torch constructors of
  :data:`repro_torch.core.generators.FN_REGISTRY`);
* from *callables* (:meth:`MDP.from_functions`): ``P_fn(s, a) ->
  (successor ids, probabilities)`` and ``g_fn(s, a) -> stage cost``
  (madupite's ``setTransitionProbabilitiesFunc`` / ``setStageCostFunc``),
  never held as one table on the host.

A function-backed MDP is materialized by one of three pipelines, picked
per build by :meth:`MDP.materialization`:

* **device**: the constructors are torch functions of an int32 row tensor
  (the action a Python int), run on the solve's device over row chunks
  (:func:`repro_torch.kernels.matrix_free.build_rows_block`), so the table
  is built where it is solved, and the validation counters are read back
  once;
* **host**: numpy callables (scalar or vectorized), evaluated on the host
  row block at a time, then moved to the device;
* **matrix_free**: the table is never built — the solve rebuilds row
  chunks from the constructors inside every Bellman backup
  (:class:`repro_torch.core.mdp.MatrixFreeMDP`), holding ``O(n)`` memory.

A ``device=True/False`` pin on :meth:`from_functions` wins, then the
session's ``-mdp_materialize`` option, then auto-detection: the
constructors are called on a small int32 tensor, and torch outputs select
the device pipeline, numpy or Python ones the host pipeline.  ``auto``
never selects matrix-free.  Nothing falls back: a constructor that fails
on the device raises.

Under a mesh (:meth:`MDP.place`) each rank builds only its own block of a
function-backed MDP, on its own device; under the fleet layouts
(:func:`place_function_fleet`) only its own instances' blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import io as core_io
from repro_torch.core import partition
from repro_torch.core.generators import FN_REGISTRY as FN_GENERATORS
from repro_torch.core.generators import REGISTRY as GENERATORS
from repro_torch.core.ipi import MODES
from repro_torch.core.mdp import MDP as CoreMDP, DenseMDP, EllMDP, \
    MatrixFreeMDP
from repro_torch.device import resolve_device
from repro_torch.kernels import matrix_free, ref

__all__ = ["MDP", "MATERIALIZE_MODES", "place_function_fleet"]

_BIG = 1e30

MATERIALIZE_MODES = ("auto", "host", "device", "matrix_free")

# rows of the sampled block a matrix-free build validates once (its
# backups rebuild rows where a bad constructor cannot raise)
_MF_CHECK_ROWS = 4096


@dataclasses.dataclass(frozen=True)
class _FunctionSpec:
    """Deferred MDP definition: callables and shape, materialized per
    build.  ``device`` pins the pipeline (``None``: resolved per build by
    the option, then auto-detection)."""

    p_fn: Callable
    g_fn: Callable
    n: int
    m: int
    nnz: int
    gamma: float
    vectorized: bool
    device: bool | None = None
    band: int | None = None     # declared |successor - row| bound, or None


def _device_block(spec: _FunctionSpec, row0: int, n_rows: int, acts: tuple,
                  mode: str, device: torch.device, axes=None,
                  counters: list | None = None) -> tuple:
    """The device pipeline: the ELL block of global rows ``[row0, row0 +
    n_rows)`` x ``acts``, built on ``device`` over row chunks of
    :func:`~repro_torch.kernels.matrix_free.chunk_rows` into preallocated
    tables.  The chunks' validation counters stay on the device and are
    read once (reduced over ``axes``' ranks first, so every rank of a
    sharded build raises together); they raise the host pipeline's
    errors.  With ``counters`` the block's counters are appended there
    instead, for the caller to check (:func:`_check_counters`)."""
    bad = torch.zeros((2,), dtype=torch.int64, device=device)

    def body(lo, hi):
        rows = row0 + torch.arange(lo, hi, dtype=torch.int32, device=device)
        idx, val, cost, b = matrix_free.build_rows_block(spec, rows, acts,
                                                         mode)
        bad.add_(b)
        return idx, val, cost

    out = ref._blocked_rows(body, n_rows,
                            matrix_free.chunk_rows(spec, len(acts)),
                            (0, 0, 0))
    if counters is not None:
        counters.append(bad)
    else:
        _check_counters(bad, spec.n, axes)
    return out


def _check_counters(bad: torch.Tensor, n: int, axes=None) -> None:
    """Raise the host pipeline's errors for the validation counters
    ``bad`` (``(2,)``: ids out of range, rows not summing to 1), reduced
    over ``axes``' ranks first so every rank raises together."""
    if axes is not None:
        bad = axes.pmax_fleet(axes.pmax_action(axes.pmax_state(bad)))
    n_ids, n_sum = bad.tolist()
    if n_ids:
        raise ValueError(f"P_fn produced successor ids outside "
                         f"[0, {n}) ({n_ids} offending entries)")
    if n_sum:
        raise ValueError(f"P_fn probability rows do not sum to ~1 "
                         f"({n_sum} offending (s, a) rows)")


class MDP:
    """A built (or deferred) MDP plus its solve semantics (``mode``).

    Hand it to :meth:`repro_torch.api.Session.solve`, or call
    :meth:`build` for the core container on a device.
    """

    def __init__(self, core: CoreMDP | None = None, *,
                 mode: str = "mincost", spec: _FunctionSpec | None = None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; pick one of {MODES}")
        if (core is None) == (spec is None):
            raise ValueError("MDP wants exactly one of a core container or "
                             "a function spec; use the from_* constructors")
        if core is not None and not isinstance(
                core, (EllMDP, DenseMDP, MatrixFreeMDP)):
            raise TypeError(f"MDP wraps an EllMDP, a DenseMDP or a "
                            f"MatrixFreeMDP, got {type(core).__name__}")
        self._core = core
        self._spec = spec
        self.mode = mode
        self._device_cache: dict = {}
        self._trace_ok: tuple | None = None   # lazily probed (ok, reason)

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
                       deferred: bool = False, **kw) -> "MDP":
        """One of the built-in instance families
        (``garnet``/``maze2d``/``sis``/``chain_walk``).

        ``deferred=True`` returns a *function-backed* MDP on the family's
        torch constructors (:data:`repro_torch.core.generators.
        FN_REGISTRY`): nothing is built until a solve places it, and then
        on the solve's device — or, matrix-free, never."""
        if deferred:
            if name not in FN_GENERATORS:
                raise ValueError(
                    f"unknown generator {name!r}; deferred families: "
                    f"{sorted(FN_GENERATORS)}")
            return cls.from_functions(**FN_GENERATORS[name](**kw),
                                      mode=mode, device=True)
        if name not in GENERATORS:
            raise ValueError(f"unknown generator {name!r}; pick one of "
                             f"{sorted(GENERATORS)}")
        return cls(GENERATORS[name](**kw), mode=mode)

    @classmethod
    def from_functions(cls, P_fn: Callable, g_fn: Callable, n: int, m: int,
                       *, nnz: int, gamma: float = 0.99,
                       mode: str = "mincost", vectorized: bool = False,
                       device: bool | None = None,
                       band: int | None = None) -> "MDP":
        """Define the MDP by callables; materialize lazily.

        ``P_fn(s, a) -> (ids, probs)`` gives state ``s``'s successors under
        action ``a`` (at most ``nnz`` of them, probabilities summing to 1);
        ``g_fn(s, a) -> float`` the stage cost (or reward, for
        ``mode="maxreward"``).  With ``vectorized=True`` they take a whole
        *array* of states at once — ``P_fn(rows, a) -> (ids (len(rows),
        nnz), probs (len(rows), nnz))``, ``g_fn(rows, a) -> (len(rows),)``.

        ``device`` picks the materialization pipeline:

        * ``True`` — torch constructors: ``rows`` is an int32 tensor on the
          solve's device (a 0-d one per state when not vectorized, under
          ``torch.func.vmap``) and they return torch tensors computed
          there, exactly ``nnz`` slots per row (zero-pad unused ones).
          They must take any int32 row id (shard padding rows ``>= n``,
          whose outputs are masked).
        * ``False`` — numpy callables, evaluated on the host.
        * ``None`` (default) — decided per build by the ``-mdp_materialize``
          option and auto-detection (torch outputs: device).

        ``band`` optionally declares the matrix bandwidth: every
        nonzero-weight successor satisfies ``|successor - row| <= band``.
        Matrix-free solves have no table to measure, so their banded halo
        exchange and overlapped interior/frontier split need it (``None``:
        rows reach globally; still solvable through the all-gather).

        Nothing is evaluated here.  A solve builds the table on its device
        (each rank its own block under a mesh), or under
        ``-mdp_materialize matrix_free`` never builds it and rebuilds row
        chunks inside every Bellman backup.
        """
        if n < 1 or m < 1 or nnz < 1:
            raise ValueError(f"from_functions needs n, m, nnz >= 1, got "
                             f"n={n} m={m} nnz={nnz}")
        if not 0.0 < gamma < 1.0:
            raise ValueError(f"gamma must lie in (0, 1), got {gamma}")
        if band is not None and band < 0:
            raise ValueError(f"band must be >= 0 (or None), got {band}")
        return cls(None, mode=mode,
                   spec=_FunctionSpec(P_fn, g_fn, int(n), int(m), int(nnz),
                                      float(gamma), bool(vectorized),
                                      None if device is None else
                                      bool(device),
                                      None if band is None else int(band)))

    # ---- introspection -----------------------------------------------------
    @property
    def n(self) -> int:
        """True (unpadded) global state count."""
        return self._spec.n if self._spec else self._core.n_global

    @property
    def m(self) -> int:
        return self._spec.m if self._spec else self._core.m_global

    @property
    def gamma(self) -> float:
        return self._spec.gamma if self._spec else self._core.gamma

    @property
    def deferred(self) -> bool:
        """True for a function-backed MDP (built per solve, or never)."""
        return self._spec is not None

    @property
    def core(self) -> CoreMDP:
        """The core container as built (host tables for the built-in
        constructors); :meth:`build` places it.  A function-backed MDP has
        none until :meth:`build`."""
        if self._core is None:
            raise ValueError("a function-backed MDP has no core container "
                             "until it is built; call build()")
        return self._core

    def __repr__(self) -> str:
        kind = "functions" if self.deferred else type(self._core).__name__
        return (f"MDP({kind}, n={self.n}, m={self.m}, "
                f"gamma={self.gamma}, mode={self.mode!r})")

    # ---- materialization pipeline selection --------------------------------
    def _device_traceable(self) -> tuple[bool, str | None]:
        """Probe (once) whether the constructors are torch functions: build
        one action's block of four rows on the host through the device
        pipeline's builder.  numpy or Python constructors fail here (their
        outputs are no tensors, or ``torch.func.vmap`` refuses their
        control flow) and select the host pipeline."""
        if self._trace_ok is None:
            try:
                matrix_free.build_rows_block(
                    self._spec, torch.arange(4, dtype=torch.int32), (0,),
                    "mincost")
                self._trace_ok = (True, None)
            except Exception as e:      # noqa: BLE001 — any failure: host
                self._trace_ok = (False, f"{type(e).__name__}: {e}")
        return self._trace_ok

    def materialization(self, option: str = "auto") -> str:
        """Resolve the pipeline for this MDP: ``"device"``, ``"host"`` or
        ``"matrix_free"``.

        Precedence: the ``device=`` pin given to :meth:`from_functions`,
        then ``option`` (the ``-mdp_materialize`` value), then
        auto-detection.  Raises when device (or matrix-free, which needs
        the same torch constructors) is *required* but the constructors
        are not torch functions.  ``"auto"`` never selects matrix-free:
        recompute-over-store is a memory/compute trade the user opts into.
        """
        if not self.deferred:
            raise ValueError("materialization() applies to function-backed "
                             "MDPs only")
        if option not in MATERIALIZE_MODES:
            raise ValueError(f"unknown materialization {option!r}; pick one "
                             f"of {MATERIALIZE_MODES}")
        pinned = self._spec.device
        if option == "matrix_free":
            if pinned is False:
                return "host"   # explicit host pin wins, like for "device"
            ok, why = self._device_traceable()
            if ok:
                return "matrix_free"
            raise ValueError(
                f"matrix-free solving reruns P_fn/g_fn inside every Bellman "
                f"backup, but the constructors are not torch functions "
                f"({why}); write them in torch over the int32 row tensor, "
                f"on its device, or drop to -mdp_materialize auto/host")
        if pinned is False or (pinned is None and option == "host"):
            return "host"
        ok, why = self._device_traceable()
        if ok:
            return "device"
        if pinned is True or option == "device":
            raise ValueError(
                f"device materialization was requested but the constructors "
                f"are not torch functions ({why}); write P_fn/g_fn in torch "
                f"over the int32 row tensor, on its device, or drop to "
                f"device=False / -mdp_materialize host")
        return "host"

    def _row_spec(self) -> matrix_free.RowSpec:
        """This MDP's row spec for the matrix-free operator (gamma-free: a
        sweep shares one spec)."""
        s = self._spec
        return matrix_free.RowSpec(s.p_fn, s.g_fn, s.n, s.m, s.nnz,
                                   s.vectorized, s.band)

    # ---- materialization ---------------------------------------------------
    def build(self, device: str | torch.device = "cuda", *,
              materialize: str = "auto") -> CoreMDP:
        """The core container on ``device`` (cached per device): the
        tables of an array-backed MDP moved there, or a function-backed
        MDP's table built there (``materialize`` as in
        :meth:`materialization`) — or, ``"matrix_free"``, its ``O(n)``
        operator container, after one sampled block of its rows is
        validated."""
        dev = resolve_device(device)
        if self._core is not None:
            if dev not in self._device_cache:
                self._device_cache[dev] = self._core.to(dev)
            return self._device_cache[dev]
        how = self.materialization(materialize)
        key = ("built", how, dev)
        if key not in self._device_cache:
            s = self._spec
            acts = tuple(range(s.m))
            if how == "matrix_free":
                # the operator reruns the constructors in every backup,
                # where a bad P_fn cannot raise: validate a sampled block
                # once, through the device pipeline's checked builder
                _device_block(s, 0, min(s.n, _MF_CHECK_ROWS), acts,
                              self.mode, dev)
                core = MatrixFreeMDP(
                    tag=torch.zeros((s.n,), dtype=torch.int8, device=dev),
                    gamma=s.gamma, n_global=s.n, m_global=s.m,
                    spec=self._row_spec())
            elif how == "device":
                idx, val, cost = _device_block(s, 0, s.n, acts, "mincost",
                                               dev)
                core = EllMDP(idx=idx, val=val, cost=cost, gamma=s.gamma,
                              n_global=s.n, m_global=s.m)
            else:
                idx, val, cost = self._block(np.arange(s.n), np.arange(s.m),
                                             n_pad_to=s.n, m_pad_to=s.m)
                core = EllMDP.from_numpy(idx, val, cost, s.gamma, s.n, s.m,
                                         device=dev)
            self._device_cache[key] = core
        return self._device_cache[key]

    # ---- persistence -------------------------------------------------------
    def save(self, path: str, n_blocks: int = 1, *,
             device: str | torch.device = "cuda") -> None:
        """Write the block-manifest format of :mod:`repro_torch.core.io`
        in ``n_blocks`` row blocks, with this MDP's ``mode``.

        An MDP that holds its core container (arrays, files, the built-in
        generators) writes that container as it is, wherever its tables
        lie, and builds nothing.  A function-backed MDP is built first, as
        :meth:`build` builds it on ``device`` (cached per device, so one
        already built there is not built again).  Only the ELL
        representation has a file format: a dense or matrix-free MDP
        raises ``ValueError``."""
        core = self._core if self._core is not None else self.build(device)
        if not isinstance(core, EllMDP):
            raise ValueError("save() supports the ELL representation only")
        core_io.save_mdp(path, core, n_blocks=n_blocks, mode=self.mode)

    def place(self, mesh, layout: str = "1d", *, mode: str | None = None,
              materialize: str = "auto",
              device: str | torch.device = "cuda") -> CoreMDP:
        """The core container for a solve on ``mesh`` under ``layout``.

        An array-backed MDP is returned as built (the driver pads it and
        cuts this rank's block).  A function-backed MDP is materialized
        *shard-locally*: this rank builds only its own padded block — by
        the device pipeline on ``device`` or the host callbacks, per
        :meth:`materialization` — which the driver's placement then takes
        as it is (:func:`repro_torch.core.partition.already_placed`).  A
        matrix-free MDP is its ``O(n)`` operator container, whose tag the
        driver places.  Without a mesh this is :meth:`build`.

        ``mode`` is the mode the *solve* runs under (default: this
        builder's): padded action columns carry a sign-dependent
        never-greedy cost, so the padding follows the solve.
        """
        if self._core is not None:
            return self._core
        if mesh is None:
            return self.build(device, materialize=materialize)
        how = self.materialization(materialize)
        if how == "matrix_free":
            return self.build(device, materialize=materialize)
        dev = resolve_device(device)
        key = (mesh, layout, mode or self.mode, how, dev)
        if key not in self._device_cache:
            self._device_cache[key] = self._place_sharded(
                mesh, layout, mode or self.mode, how == "device", dev)
        return self._device_cache[key]

    def evict(self, mesh=None, *, builders: bool = False) -> int:
        """Drop cached materializations — the blocks placed on ``mesh``, or
        every cached container when ``mesh`` is None — and return how many
        were dropped.  The session layer calls this on close, so a reused
        builder pins no device memory for a finished solve.

        ``builders`` is the reference's switch for dropping compiled block
        programs as well; the port compiles none (its constructors run
        eagerly), so it changes nothing here."""
        del builders
        if mesh is None:
            n = len(self._device_cache)
            self._device_cache.clear()
            return n
        dead = [k for k in self._device_cache
                if isinstance(k, tuple) and k[0] is mesh]
        for k in dead:
            del self._device_cache[k]
        return len(dead)

    def _place_sharded(self, mesh, layout: str, mode: str, device: bool,
                       dev: torch.device) -> EllMDP:
        """This rank's padded block under ``layout``: its state shard's
        rows and its action shard's actions, built on ``dev``."""
        axes = partition.mesh_axes(mesh, layout)
        s = self._spec
        n_to, m_to = partition.padded_extents(mesh, layout, s.n, s.m)
        n_loc = n_to // axes.state_size()
        m_loc = m_to // axes.action_size()
        lo, alo = axes.state_index() * n_loc, axes.action_index() * m_loc
        if device:
            idx, val, cost = _device_block(
                s, lo, n_loc, tuple(range(alo, alo + m_loc)), mode, dev,
                axes=axes)
        else:
            idx, val, cost = (torch.from_numpy(a).to(dev) for a in
                              self._block(np.arange(lo, lo + n_loc),
                                          np.arange(alo, alo + m_loc),
                                          n_pad_to=n_to, m_pad_to=m_to,
                                          mode=mode))
        return EllMDP(idx=idx, val=val, cost=cost, gamma=s.gamma,
                      n_global=n_to, m_global=m_to)

    def _block(self, rows: np.ndarray, acts: np.ndarray, *,
               n_pad_to: int, m_pad_to: int,
               mode: str | None = None) -> tuple:
        """One host-pipeline ELL block for global ``rows`` x ``acts``
        (padding included), as host arrays.

        Padding mirrors :func:`repro_torch.core.partition.pad_mdp`: padded
        states are zero-cost absorbing self-loops; padded actions are
        never-greedy under the solve ``mode`` (cost ``+BIG`` for mincost,
        ``-BIG`` for maxreward).
        """
        s = self._spec
        big = _BIG if (mode or self.mode) == "mincost" else -_BIG
        nr, na, K = len(rows), len(acts), s.nnz
        idx = np.zeros((nr, na, K), np.int32)
        val = np.zeros((nr, na, K), np.float32)
        cost = np.zeros((nr, na), np.float32)
        # pad defaults: absorbing self-loop on slot 0 (padded rows), and
        # never-greedy cost on padded action columns
        idx[..., 0] = rows[:, None].astype(np.int32)
        val[..., 0] = 1.0
        pad_a = acts >= s.m
        cost[:, pad_a] = big
        idx[:, pad_a, 0] = 0          # padded actions point at state 0
        real_r = rows < s.n
        if not real_r.any():
            return idx, val, cost
        rr = rows[real_r]
        for j, a in enumerate(acts):
            if a >= s.m:
                continue
            if s.vectorized:
                ids, probs = s.p_fn(rr, int(a))
                ids = np.asarray(ids)
                probs = np.asarray(probs)
                if ids.shape != (len(rr), K) or probs.shape != ids.shape:
                    raise ValueError(
                        f"vectorized P_fn must return (ids, probs) of "
                        f"shape ({len(rr)}, {K}), got {ids.shape} / "
                        f"{probs.shape}")
                rowsum = np.asarray(probs, np.float64).sum(-1)
                bad = np.nonzero(np.abs(rowsum - 1.0) > 1e-4)[0]
                if bad.size:
                    raise ValueError(
                        f"P_fn(s={int(rr[bad[0]])}, a={int(a)}) "
                        f"probabilities sum to {rowsum[bad[0]]:.6g}, "
                        f"expected ~1")
                idx[real_r, j, :] = ids
                val[real_r, j, :] = probs
                cost[real_r, j] = np.asarray(s.g_fn(rr, int(a)))
            else:
                for i, r in zip(np.nonzero(real_r)[0], rr):
                    ids, probs = s.p_fn(int(r), int(a))
                    ids = np.atleast_1d(np.asarray(ids))
                    probs = np.atleast_1d(np.asarray(probs))
                    if len(ids) > K:
                        raise ValueError(
                            f"P_fn({r}, {a}) returned {len(ids)} "
                            f"successors > nnz={K}")
                    if len(ids) != len(probs):
                        raise ValueError(
                            f"P_fn(s={int(r)}, a={int(a)}) returned "
                            f"{len(ids)} successor ids but {len(probs)} "
                            f"probabilities")
                    total = float(np.asarray(probs, np.float64).sum())
                    if abs(total - 1.0) > 1e-4:
                        raise ValueError(
                            f"P_fn(s={int(r)}, a={int(a)}) probabilities "
                            f"sum to {total:.6g}, expected ~1")
                    row_i = np.zeros(K, np.int32)
                    row_v = np.zeros(K, np.float32)
                    row_i[:len(ids)] = ids
                    row_v[:len(probs)] = probs
                    idx[i, j, :] = row_i
                    val[i, j, :] = row_v
                    cost[i, j] = float(s.g_fn(int(r), int(a)))
        # validate only the real (row, action) entries: padding self-loops
        # legitimately point at padded state ids >= s.n
        real = idx[real_r][:, acts < s.m]
        if real.size and ((real < 0).any() or (real >= s.n).any()):
            raise ValueError("P_fn produced successor ids outside "
                             f"[0, {s.n})")
        return idx, val, cost


# --------------------------------------------------------------------------- #
# Fleet-sharded materialization of function-backed fleets                      #
# --------------------------------------------------------------------------- #

def place_function_fleet(mdps: Sequence[MDP], mesh, layout: str,
                         mode: str = "mincost", *, pad_fleet: bool = True,
                         device: str | torch.device = "cuda") \
        -> partition.FleetBlock:
    """Build a fleet of function-backed MDPs straight into a fleet layout
    (``layout="fleet"`` / ``"fleet2d"``).

    Each rank owns ``(B_local, n_local, m_local)`` — a slice of
    *instances* on top of its state/action slice — and builds exactly that
    block from its own instances' torch constructors on ``device``
    (the device pipeline, one block a lane).  Neither the instance dim
    nor the state dim is ever built whole on one rank.

    Instances must share the action count and ``nnz``; heterogeneous
    state counts pad to the fleet maximum (absorbing zero-cost states, as
    :func:`repro_torch.core.mdp.stack_mdps` pads them).  ``B`` pads to the
    fleet-axis multiple with zero-cost dummy instances (``pad_fleet=False``
    raises instead).  The result is the rank's
    :class:`~repro_torch.core.partition.FleetBlock`, which
    :func:`repro_torch.core.driver.solve_many` takes as it is."""
    axes = partition.mesh_axes(mesh, layout)
    if axes.fleet is None:
        raise ValueError(f"place_function_fleet serves the fleet layouts, "
                         f"got {layout!r}; a single function-backed MDP "
                         f"places via MDP.place")
    mdps = list(mdps)
    specs = []
    for i, m_ in enumerate(mdps):
        if not isinstance(m_, MDP) or not m_.deferred:
            raise ValueError(f"place_function_fleet wants function-backed "
                             f"MDPs; instance {i} is "
                             f"{type(m_).__name__}")
        if m_.materialization("device") != "device":   # raises with reason
            raise ValueError(f"instance {i} cannot materialize on device")
        specs.append(m_._spec)
    K, m_acts = specs[0].nnz, specs[0].m
    if any(sp.nnz != K or sp.m != m_acts for sp in specs):
        raise ValueError(
            f"fleet instances must share the action count and nnz, got "
            f"m={sorted({sp.m for sp in specs})} "
            f"nnz={sorted({sp.nnz for sp in specs})}")
    dev = resolve_device(device)
    n_to, m_to = partition.padded_extents(mesh, layout,
                                          max(sp.n for sp in specs), m_acts)
    b = len(mdps)
    b_to = partition.fleet_padded_batch(b, axes.fleet_size(), pad_fleet)
    b_loc = b_to // axes.fleet_size()
    lo = axes.fleet_index() * b_loc
    n_loc, m_loc = n_to // axes.state_size(), m_to // axes.action_size()
    r0, a0 = axes.state_index() * n_loc, axes.action_index() * m_loc
    acts = tuple(range(a0, a0 + m_loc))
    counters: list = []
    per = []
    for bi in range(lo, lo + b_loc):
        if bi < b:
            per.append(_device_block(specs[bi], r0, n_loc, acts, mode, dev,
                                     counters=counters))
        else:
            # a zero-cost dummy instance (fleet padding): absorbing
            # self-loops, optimal value identically 0, done at k=0
            idx = torch.zeros((n_loc, m_loc, K), dtype=torch.int32,
                              device=dev)
            idx[..., 0] = torch.arange(r0, r0 + n_loc, dtype=torch.int32,
                                       device=dev)[:, None]
            val = torch.zeros((n_loc, m_loc, K), dtype=torch.float32,
                              device=dev)
            val[..., 0] = 1.0
            per.append((idx, val, torch.zeros((n_loc, m_loc),
                                              dtype=torch.float32,
                                              device=dev)))
    bad = torch.stack(counters).sum(0) if counters \
        else torch.zeros((2,), dtype=torch.int64, device=dev)
    _check_counters(bad, max(sp.n for sp in specs), axes)
    idx, val, cost = (torch.stack(t) for t in zip(*per))
    gammas = tuple(sp.gamma for sp in specs)
    gammas = gammas + (gammas[-1],) * (b_to - b)
    local = gammas[lo:lo + b_loc]
    block = EllMDP(idx=idx, val=val, cost=cost,
                   gamma=gammas[0] if len(set(gammas)) == 1 else local,
                   n_global=n_to, m_global=m_to)
    return partition.FleetBlock(block=block, batch=b_to, lane0=lo,
                                gammas=gammas, layout=layout)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
