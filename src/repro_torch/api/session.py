"""The session layer, single-device subset.

Counterpart of :mod:`repro.api.session`.  A :class:`Session` owns one
options database, places each solve on its ``-device`` (``cuda`` unless
the caller asks for ``cpu``), runs :func:`repro_torch.core.driver.solve`
(with ``-checkpoint_dir``, monitors and ad-hoc stop predicates) or, for a
fleet, :func:`repro_torch.core.driver.solve_many` once per pad-efficient
bucket (``-fleet_bucketing``, :mod:`repro_torch.api.fleet`), records
per-solve statistics (:attr:`Session.stats`) and writes the
``-file_stats`` / ``-file_policy`` / ``-file_cost`` outputs.

    from repro_torch.api import MDP, madupite_session

    with madupite_session({"-method": "ipi_gmres", "-atol": 1e-8}) as s:
        result = s.solve(MDP.from_generator("garnet", n=10_000, m=16, k=8))
        sweep = s.solve_fleet([MDP.from_generator("garnet", n=10_000, m=16,
                                                  k=8, gamma=g)
                               for g in (0.9, 0.99, 0.999)])

Under ``torch.distributed`` (``torchrun``, or
:func:`repro_torch.launch.mesh.init_distributed`) :meth:`Session.placement`
shards a single solve over the world (``-layout auto|1d|2d``) and a fleet
over a fleet layout (``auto`` picks ``fleet`` for ``B > 1``; ``-fleet``
sizes its fleet axis, ``-pad_fleet`` allows dummy lanes); every rank calls
``solve`` / ``solve_fleet`` with the same MDPs and gets the same results,
and only rank 0 writes the outputs.

Function-backed MDPs (:meth:`repro_torch.api.MDP.from_functions`,
``from_generator(..., deferred=True)``) are built per solve as
``-mdp_materialize`` says — on the session's device, each rank its own
block under a mesh — or solved matrix-free; a fleet of them that shares
one row spec rebuilds each chunk once for all its lanes.

``-method auto`` (a virtual method) probes the instance and picks the
method by the rule table of :mod:`repro_torch.adaptive`, once per problem
family ``(n, m, gamma, mode)`` — later solves of the family reuse the
choice (``_auto_cache``) — and ``-adapt_on_stagnation`` supervises any
solve with the hot-swap; a fleet resolves ``auto`` once per bucket.
Solves may come from several threads (the solve server's scheduler and
its clients): statistics and output files are written under one lock.

``-kernel_impl`` reaches every solve through its
:class:`~repro_torch.core.ipi.IPIOptions`; opening a session pushes
``-kernel_tune`` / ``-kernel_tune_cache`` into the process-wide launch
tuner (:mod:`repro_torch.kernels.tuning`), as the reference's does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import weakref
from typing import Any, Mapping, Sequence

import numpy as np
import torch.distributed as dist

from repro_torch.api.fleet import bucket_indices
from repro_torch.api.mdp import MDP, place_function_fleet
from repro_torch.api.options import Options
from repro_torch.core import driver, partition
from repro_torch.core import methods as _methods
from repro_torch.core.driver import SolveResult
from repro_torch.core.mdp import MDP as CoreMDP, DenseMDP, EllMDP, \
    MatrixFreeMDP, stack_mdps
from repro_torch.device import resolve_device
from repro_torch.kernels import tuning
from repro_torch.utils import trace
from repro_torch.utils.lru import LRUCache

__all__ = ["Session", "madupite_session"]

# capacity of the per-session device-fleet container cache: entries hold
# whole fleets of device tables, so the bound stays small
_FLEET_CACHE_CAPACITY = 8


class Session:
    """A solve context: options database + device placement + outputs.

    ``options`` may be an :class:`Options` database, a plain mapping of
    option keys, or ``None`` (registry defaults + ``MADUPITE_OPTIONS``).
    The device named by ``-device`` is checked here, so asking for
    ``cuda`` without a GPU fails when the session opens.  ``mesh`` (a
    ``torch.distributed`` device mesh) overrides the automatic placement
    of :meth:`placement`.
    """

    def __init__(self, options: Options | Mapping[str, Any] | None = None,
                 *, mesh=None):
        if isinstance(options, Options):
            self.options = options
        else:
            self.options = Options.from_sources(options)
        # the session's device, resolved (card index included) in the thread
        # that opens it and passed explicitly to every solve, whichever
        # thread runs it (the solve server's scheduler, say)
        self._device = resolve_device(self.options.get("-device"))
        self._mesh_override = mesh
        self._mesh_cache: dict = {}
        self._stats: list[dict] = []
        # per -file_stats path: (format, entries already on disk) — jsonl
        # appends only the entries written since the last solve
        self._stats_written: dict[str, tuple[str, int]] = {}
        # builders this session placed: their device copies are dropped
        # on close
        self._solved: weakref.WeakSet = weakref.WeakSet()
        # device-stacked fleet containers of function-backed buckets, keyed
        # by (device, mode, materialization, builder identities): a repeated
        # solve_fleet of the same builders skips the build and the stack.
        # Hit / miss / eviction counters land in the run stats.
        self._fleet_cache = LRUCache(_FLEET_CACHE_CAPACITY)
        # serializes stats recording and output-file writes: solves may run
        # from the solve server's scheduler thread and client threads
        self._io_lock = threading.RLock()
        # -method auto choices, keyed by the problem family (n, m, gamma,
        # mode): repeat solves of the family skip the probe
        self._auto_cache: dict = {}
        self._closed = False
        self._apply_kernel_options()

    def _apply_kernel_options(self) -> None:
        """Push the kernel-facing options into the process-wide launch
        tuner: on or off, and its cache file."""
        tuning.configure(
            enabled=self.options.get("-kernel_tune") != "off",
            cache_path=self.options.get("-kernel_tune_cache"))

    # ---- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Release the device copies of the MDPs this session placed —
        tables, blocks and matrix-free operator containers alike."""
        if not self._closed:
            for mdp in list(self._solved):
                mdp.evict()
            self._solved = weakref.WeakSet()
            self._fleet_cache.clear()
            self._closed = True

    @property
    def stats(self) -> list[dict]:
        """Accumulated per-solve statistics."""
        with self._io_lock:
            return list(self._stats)

    @property
    def cache_stats(self) -> dict:
        """Counters of the session-owned caches: the device-fleet container
        LRU (hits / misses / evictions) and, as in the reference, the
        compiled run-chunk programs — none here: the port's loops run
        eagerly and compile nothing."""
        return {"fleet": self._fleet_cache.stats(),
                "run_chunk_programs": 0}

    @property
    def device(self):
        """The torch device this session's solves run on."""
        return self._device

    def _device_of(self, opts: Options):
        """The device of a solve under ``opts``: the session's, unless a
        per-call override names another."""
        name = opts.get("-device")
        return self._device if name == self.options.get("-device") \
            else resolve_device(name)

    # ---- placement ---------------------------------------------------------
    def placement(self, opts: Options | None = None, *,
                  fleet_size: int | None = None):
        """``(mesh, layout)`` for a solve: auto-built unless overridden.

        Auto policy: no ``torch.distributed`` process group, or a world of
        one rank -> single-device (no mesh); otherwise a single solve gets
        the paper-faithful ``1d`` layout over every rank, and a fleet of
        ``fleet_size`` > 1 the ``fleet`` layout, its instance dim over a
        leading fleet axis whose size is the largest divisor of the world
        <= B.  ``-layout`` forces a layout: ``single`` no mesh, the others
        a mesh over the world (a world of one included; ``2d`` is ``(world
        // 2, 2)``, or ``(world, 1)`` for an odd world), which needs a
        process group; ``-fleet`` sets the fleet-axis size.  A mesh given
        to the session is used as it is (``auto``: ``fleet`` / ``fleet2d``
        when it has a ``fleet`` axis, else ``1d``).
        """
        opts = opts or self.options
        layout = opts.get("-layout")
        if layout == "single":
            return None, "1d"
        if self._mesh_override is not None:
            mesh = self._mesh_override
            if layout == "auto":
                names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
                layout = "1d" if "fleet" not in names else \
                    "fleet2d" if len(names) > 2 else "fleet"
            return mesh, layout
        up = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if up else 1
        if layout == "auto":
            if world == 1:
                return None, "1d"
            layout = "fleet" if (fleet_size or 0) > 1 else "1d"
        if not up:
            raise ValueError(
                f"-layout {layout} shards over the ranks of a "
                f"torch.distributed process group, and none is up: launch "
                f"under torchrun, or call repro_torch.launch.mesh."
                f"init_distributed() first (or use -layout single)")
        device = opts.get("-device")
        if layout in partition.FLEET_LAYOUTS:
            f = opts.get("-fleet")
            if f is None:
                f = _largest_divisor(world, at_most=max(fleet_size or 1, 1))
            key = (layout, f, device)
            if key not in self._mesh_cache:
                from repro_torch.launch.mesh import make_fleet_mesh
                self._mesh_cache[key] = make_fleet_mesh(f, layout=layout,
                                                        device=device)
            return self._mesh_cache[key], layout
        shape = (world // 2, 2) if layout == "2d" and world % 2 == 0 \
            else (world, 1)
        key = (layout, shape, device)
        if key not in self._mesh_cache:
            from repro_torch.launch.mesh import make_host_mesh
            self._mesh_cache[key] = make_host_mesh(shape, device=device)
        return self._mesh_cache[key], layout

    # ---- solving -----------------------------------------------------------
    def solve(self, mdp: MDP | CoreMDP, *, monitor=None, stop_criterion=None,
              **overrides) -> SolveResult:
        """Solve one MDP through the session's options and device.

        ``overrides`` are per-call option overrides (keys with or without
        the leading dash): ``s.solve(mdp, method="vi", atol=1e-6)``.

        ``monitor`` receives one record per outer iteration — a callable
        taking ``{"k", "res", "inner", "diverged", "elapsed"}`` dicts (or
        ``-monitor`` / ``monitor=True`` for PETSc-style printed lines;
        ``monitor=False`` turns a session-level ``-monitor`` off for this
        call).  While monitoring is on, the records and the dense
        convergence-history arrays also land in :attr:`stats` /
        ``-file_stats``.

        ``stop_criterion`` overrides ``-stop_criterion``: a registered
        name or a predicate ``fn(m: repro_torch.api.StopMetrics) -> bool``.

        While a ``torch.profiler`` session is active, or inside
        :func:`repro_torch.utils.trace.recording`, the call's run
        statistics also carry ``"trace"``: milliseconds by span of the
        solve path, total and self, the device time of the spans timed on
        the card, the device reads and the wait on them by site, and the
        kernel launches (:mod:`repro_torch.utils.trace`).
        """
        with trace.span("session.solve") as root:
            r, opts, entry = self._solve_one(mdp, monitor, stop_criterion,
                                             overrides)
        self._attach_trace(root, entry)
        self._write_outputs([r], opts)
        return r

    def _solve_one(self, mdp, monitor, stop_criterion, overrides):
        opts, mon_cb, mon_records = self._observe(overrides, monitor,
                                                  stop_criterion)
        mdp = self._wrap(mdp, opts)
        ipi = opts.to_ipi()
        if not opts.is_set("-mode") and ipi.mode != mdp.mode:
            ipi = dataclasses.replace(ipi, mode=mdp.mode)
        device = self._device_of(opts)
        mesh, layout = self.placement(opts)
        if mdp.deferred:
            # built where it is solved: this rank's block under a mesh, or
            # the matrix-free operator
            core = mdp.place(mesh, layout, mode=ipi.mode,
                             materialize=opts.get("-mdp_materialize"),
                             device=device)
        else:
            # a sharded solve places its blocks from the MDP where it was
            # built
            core = mdp.build(device if mesh is None else "cpu")
        self._solved.add(mdp)
        spec = _methods.get_method(ipi.method)
        t0 = time.time()
        report = None
        if spec.virtual or opts.get("-adapt_on_stagnation"):
            # virtual methods (-method auto) probe + select, then run
            # supervised; a fixed method under -adapt_on_stagnation skips
            # the probe but gets the same hot-swap safety net
            from repro_torch.adaptive import solve_adaptive
            key = choice = None
            if spec.virtual:
                key = (int(mdp.n), int(mdp.m), float(mdp.gamma), ipi.mode)
                choice = self._auto_cache.get(key)
            r, report = solve_adaptive(
                core, ipi, mesh=mesh, layout=layout,
                probe_iters=opts.get("-probe_iters"), choice=choice,
                checkpoint_dir=opts.get("-checkpoint_dir"),
                chunk=opts.get("-chunk"), verbose=opts.get("-verbose"),
                monitor=mon_cb, device=device)
            if key is not None and report.choice is not None:
                self._auto_cache[key] = report.choice
        else:
            r = driver.solve(core, ipi, mesh=mesh, layout=layout,
                             checkpoint_dir=opts.get("-checkpoint_dir"),
                             chunk=opts.get("-chunk"),
                             verbose=opts.get("-verbose"), monitor=mon_cb,
                             device=device)
        wall = time.time() - t0
        r = _trim(r, mdp.n)
        entry = self._record([r], [mdp], ipi, opts, wall, fleet=None,
                             monitor=mon_records, mesh=mesh, layout=layout,
                             adaptive=report)
        return r, opts, entry

    def solve_fleet(self, mdps: Sequence[MDP | CoreMDP], *, monitor=None,
                    stop_criterion=None, **overrides) -> list[SolveResult]:
        """Solve a fleet of MDPs in batched lockstep loops on the session's
        device.

        Ragged fleets (instances with very different state counts) are
        grouped into pad-efficient buckets (``-fleet_bucketing auto``), and
        each bucket runs one :func:`repro_torch.core.driver.solve_many`;
        results come back in input order.  All instances must share one
        ``mode``.  With more than one bucket, ``-checkpoint_dir`` gets a
        ``bucket{j}`` subdirectory a bucket and monitor records carry their
        ``bucket``.  ``monitor`` / ``stop_criterion`` / ``overrides`` as in
        :meth:`solve`.

        ``-method auto`` is resolved once per bucket: the bucket's largest
        instance is probed and the rule table's choice runs the whole
        bucket (no mid-solve hot-swap: it would split the batch); the
        choices land in the run statistics' ``fleet["auto"]``.  While
        recording (:meth:`solve`), the statistics carry ``"trace"``.
        """
        if not mdps:
            return []
        with trace.span("session.solve_fleet") as root:
            results, opts, entry = self._solve_fleet(mdps, monitor,
                                                     stop_criterion,
                                                     overrides)
        self._attach_trace(root, entry)
        self._write_outputs(results, opts)
        return results

    def _solve_fleet(self, mdps, monitor, stop_criterion, overrides):
        opts, mon_cb, mon_records = self._observe(overrides, monitor,
                                                  stop_criterion)
        wrapped = [self._wrap(m, opts) for m in mdps]
        modes = {m.mode for m in wrapped}
        if len(modes) > 1:
            raise ValueError(f"solve_fleet needs one shared mode, got "
                             f"{sorted(modes)}; solve mixed-mode instances "
                             f"separately")
        ipi = opts.to_ipi()
        mode = modes.pop()
        if not opts.is_set("-mode") and ipi.mode != mode:
            ipi = dataclasses.replace(ipi, mode=mode)
        device = self._device_of(opts)
        spec = _methods.get_method(ipi.method)
        buckets = bucket_indices([m.n for m in wrapped],
                                 policy=opts.get("-fleet_bucketing"))
        mat = opts.get("-mdp_materialize")
        ckpt = opts.get("-checkpoint_dir")
        results: list[SolveResult | None] = [None] * len(wrapped)
        auto_choices: list[dict] | None = [] if spec.virtual else None
        t0 = time.time()
        for j, bucket in enumerate(buckets):
            mesh, layout = self.placement(opts, fleet_size=len(bucket))
            bucket_ckpt = ckpt if ckpt is None or len(buckets) == 1 \
                else os.path.join(ckpt, f"bucket{j}")
            # tag records by bucket so interleaved per-bucket streams stay
            # attributable (each bucket restarts k at 0)
            bucket_cb = mon_cb if mon_cb is None or len(buckets) == 1 \
                else (lambda rec, _j=j: mon_cb({**rec, "bucket": _j}))
            bmdps = [wrapped[i] for i in bucket]
            bucket_ipi = ipi
            if spec.virtual:
                bucket_ipi, choice = self._resolve_auto(bmdps, ipi, opts)
                auto_choices.append(dict(
                    bucket=j, method=choice.method, pc_type=choice.pc_type,
                    stop_criterion=choice.stop_criterion,
                    reason=choice.reason))
            cores = self._fleet_cores(bmdps, ipi.mode, device, opts, mesh,
                                      layout)
            origin = None if isinstance(cores, list) else \
                (len(bmdps), max(m.n for m in bmdps))
            rs = driver.solve_many(
                cores, bucket_ipi, origin=origin,
                checkpoint_dir=bucket_ckpt, chunk=opts.get("-chunk"),
                verbose=opts.get("-verbose"), monitor=bucket_cb,
                device=device, mesh=mesh, layout=layout,
                pad_fleet=opts.get("-pad_fleet"))
            for i, r in zip(bucket, rs):
                results[i] = _trim(r, wrapped[i].n)
        wall = time.time() - t0
        fleet_info = dict(size=len(wrapped),
                          buckets=[sorted(b) for b in buckets])
        if auto_choices is not None:
            fleet_info["auto"] = auto_choices
        mesh, layout = self.placement(opts, fleet_size=len(wrapped))
        entry = self._record(results, wrapped, ipi, opts, wall,
                             fleet=fleet_info, monitor=mon_records,
                             mesh=mesh, layout=layout)
        return results, opts, entry

    # ---- internals ---------------------------------------------------------
    def _observe(self, overrides, monitor, stop_criterion):
        """Resolve the per-call observability arguments into the merged
        per-call options plus the monitor callback chain.

        Returns ``(opts, monitor_cb, records)``: ``records`` is the list
        the callback appends every record to (for :attr:`stats` /
        ``-file_stats``), or ``None`` when monitoring is off.  A callable
        ``stop_criterion`` is registered ad hoc (with span metrics on)."""
        if self._closed:
            raise RuntimeError("this Session is closed; create a new one")
        overrides = dict(overrides)
        if stop_criterion is not None:
            if callable(stop_criterion):
                stop_criterion = _methods.adhoc_stop_criterion(stop_criterion)
            overrides.setdefault("-stop_criterion", stop_criterion)
        if monitor is False:
            overrides.setdefault("-monitor", False)
        elif monitor is not None:
            overrides.setdefault("-monitor", True)
        opts = self.options.with_overrides(overrides) if overrides \
            else self.options
        if not opts.get("-monitor"):
            return opts, None, None
        records: list[dict] = []
        sink = monitor if callable(monitor) else _methods.print_monitor

        def mon_cb(rec):
            records.append(rec)
            sink(rec)

        return opts, mon_cb, records

    def _fleet_cores(self, bmdps: list[MDP], mode: str, device,
                     opts: Options, mesh=None, layout: str = "1d"):
        """What one bucket hands :func:`repro_torch.core.driver.solve_many`.

        A bucket of function-backed MDPs built on the device is one device
        container kept in the session's fleet LRU under its placement and
        its builders' identities, so solving the same builders again skips
        the build: under a fleet layout this rank's
        :class:`~repro_torch.core.partition.FleetBlock`
        (:func:`~repro_torch.api.mdp.place_function_fleet`, keyed by
        ``(mesh, layout, mode, pad_fleet, instances)`` as the reference
        keys it), on one device the stacked fleet (one shape only).  Under
        a mesh every rank takes a hit only when all do, so no rank skips
        the build's collectives.  Otherwise the per-instance cores as built
        — array-backed tables where they are (the driver stacks and places
        them), matrix-free operators sharing one row spec."""
        mat = opts.get("-mdp_materialize")
        for m in bmdps:
            if m.deferred:
                self._solved.add(m)
        on_device = all(m.deferred for m in bmdps) \
            and len({(m._spec.m, m._spec.nnz) for m in bmdps}) == 1 \
            and all(m.materialization(mat) == "device" for m in bmdps)
        fleet = mesh is not None and layout in partition.FLEET_LAYOUTS
        if fleet and on_device:
            pad = opts.get("-pad_fleet")
            key = (mesh, layout, mode, pad)
        elif mesh is None and on_device and len(bmdps) > 1 \
                and len({m.n for m in bmdps}) == 1:
            key = (device, mode, mat)
        else:
            return [m.build(device, materialize=mat) if m.deferred
                    else m.core for m in bmdps]
        # weakly keyed on the builders: an entry whose fleet the caller
        # dropped can never be asked for again, so purge it
        for k in self._fleet_cache.keys():
            if not all(r() is not None for r in k[-1]):
                self._fleet_cache.pop(k)
        key = key + (tuple(weakref.ref(m) for m in bmdps),)
        batched = self._fleet_cache.get(key)
        if mesh is not None:
            from repro_torch.launch.mesh import all_ranks
            if not all_ranks(batched is not None):
                batched = None
        if batched is None:
            if fleet:
                batched = place_function_fleet(bmdps, mesh, layout, mode,
                                               pad_fleet=pad, device=device)
            else:
                batched = stack_mdps([m.build(device, materialize=mat)
                                      for m in bmdps])
                for m in bmdps:
                    # the stacked copy is the one kept
                    m._device_cache.pop(("built", "device", device), None)
            self._fleet_cache.put(key, batched)
        return batched

    def _resolve_auto(self, bmdps: list[MDP], ipi, opts: Options):
        """Resolve a virtual method for one fleet bucket: probe the
        bucket's largest instance on the session's device, run the rule
        table, and return ``(concrete IPIOptions, MethodChoice)``.  Choices
        are cached per problem family (n, m, gamma, mode), so homogeneous
        fleets probe once."""
        from repro_torch.adaptive import probe, select_method
        rep = max(bmdps, key=lambda m: m.n)
        key = (int(rep.n), int(rep.m), float(rep.gamma), ipi.mode)
        choice = self._auto_cache.get(key)
        if choice is None:
            device = self._device_of(opts)
            core = rep.place(None, "1d", mode=ipi.mode,
                             materialize=opts.get("-mdp_materialize"),
                             device=device)
            profile, _ = probe(core, ipi,
                               probe_iters=opts.get("-probe_iters"),
                               device=device)
            choice = select_method(
                profile, deterministic_dots=ipi.deterministic_dots)
            self._auto_cache[key] = choice
        resolved = dataclasses.replace(
            ipi, method=choice.method,
            stop_criterion=choice.stop_criterion,
            pc_type=choice.pc_type if ipi.pc_type == "none"
            else ipi.pc_type)
        return resolved, choice

    def _wrap(self, mdp: MDP | CoreMDP, opts: Options) -> MDP:
        if isinstance(mdp, MDP):
            return mdp
        if isinstance(mdp, (EllMDP, DenseMDP, MatrixFreeMDP)):
            return MDP(mdp, mode=opts.get("-mode"))
        raise TypeError(f"solve wants a repro_torch.api.MDP (or a core "
                        f"EllMDP/DenseMDP/MatrixFreeMDP), got "
                        f"{type(mdp).__name__}")

    def _record(self, results, mdps, ipi, opts: Options, wall: float, *,
                fleet, monitor=None, mesh=None,
                layout: str = "1d", adaptive=None) -> dict:
        entry = {
            "method": ipi.method,
            "mode": ipi.mode,
            "stop_criterion": ipi.stop_criterion,
            # the reference's keys: "single" and no mesh on one device
            "layout": "single" if mesh is None else layout,
            "mesh": None if mesh is None else dict(zip(
                mesh.mesh_dim_names, (int(d) for d in mesh.shape))),
            "device": opts.get("-device"),
            "options": opts.as_dict(explicit_only=True),
            "wall_s": round(wall, 6),
            "fleet": fleet,
            "solves": [{
                "n": int(mdp.n), "m": int(mdp.m), "gamma": float(mdp.gamma),
                "converged": bool(r.converged),
                "diverged": bool(r.diverged),
                "outer_iterations": int(r.outer_iterations),
                "inner_iterations": int(r.inner_iterations),
                "residual": float(r.residual),
                "gap_bound": float(r.gap_bound),
            } for mdp, r in zip(mdps, results)],
        }
        if adaptive is not None:
            entry["adaptive"] = adaptive.as_dict()
        if fleet is not None:
            entry["fleet"] = dict(fleet, cache=self._fleet_cache.stats())
        if monitor is not None:
            # monitoring on: the records plus the dense convergence-history
            # arrays land in the run stats
            entry["monitor"] = sorted(
                monitor, key=lambda rec: (rec.get("bucket", 0), rec["k"]))
            for s, r in zip(entry["solves"], results):
                s["trace_residual"] = [float(x) for x in r.trace_residual]
                s["trace_inner"] = [int(x) for x in r.trace_inner]
        with self._io_lock:
            self._stats.append(entry)
        return entry

    def _attach_trace(self, root, entry: dict) -> None:
        """The call's spans, reads and launches into its run statistics,
        once its span (``root``; ``None`` when not recording) has
        closed."""
        call = None if root is None else trace.find(root.call)
        if call is not None:
            summary = call.summary()
            with self._io_lock:
                entry["trace"] = summary

    def _write_outputs(self, results, opts: Options) -> None:
        """``-file_stats``, then ``-file_policy`` / ``-file_cost``: one
        ``.npy`` for a single solve, one ``.npz`` of ``instance_{i}``
        arrays for a fleet, as the reference writes them.  Under
        ``torch.distributed`` only rank 0 writes (every rank holds the
        same results)."""
        if dist.is_available() and dist.is_initialized() \
                and dist.get_rank() != 0:
            return
        with self._io_lock:
            self._write_stats(opts)
            for key, field in (("-file_policy", "policy"),
                               ("-file_cost", "v")):
                path = opts.get(key)
                if not path:
                    continue
                _ensure_dir(path)
                arrays = [np.asarray(getattr(r, field)) for r in results]
                if len(arrays) == 1:
                    np.save(path, arrays[0])
                else:
                    np.savez(path, **{f"instance_{i}": a
                                      for i, a in enumerate(arrays)})

    def _write_stats(self, opts: Options) -> None:
        """Persist run statistics.  ``jsonl`` (default) appends only the
        entries written since the last solve; ``json`` rewrites one array.
        Switching the format on one path rewrites it whole (JSONL lines
        after a JSON array would corrupt both).  Callers hold
        ``self._io_lock``, so concurrent solves write each entry once and
        every line whole."""
        path = opts.get("-file_stats")
        if not path:
            return
        _ensure_dir(path)
        if opts.get("-file_stats_format") == "json":
            with open(path, "w") as f:
                json.dump(self._stats, f, indent=1)
            self._stats_written[path] = ("json", len(self._stats))
            return
        prev_fmt, start = self._stats_written.get(path, ("jsonl", 0))
        if prev_fmt != "jsonl":
            start = 0
        with open(path, "a" if start else "w") as f:
            for entry in self._stats[start:]:
                f.write(json.dumps(entry) + "\n")
        self._stats_written[path] = ("jsonl", len(self._stats))


def madupite_session(options: Options | Mapping[str, Any] | None = None) \
        -> Session:
    """Open a solve session (the ``madupite.initialize()`` analogue)::

        with madupite_session({"-method": "vi", "-device": "cpu"}) as s:
            r = s.solve(mdp)
    """
    return Session(options)


def _largest_divisor(n: int, *, at_most: int) -> int:
    for d in range(min(n, at_most), 0, -1):
        if n % d == 0:
            return d
    return 1


def _trim(r: SolveResult, n: int) -> SolveResult:
    """A result solved on a padded (shard-locally built) MDP, trimmed back
    to the true state count."""
    if len(r.v) <= n:
        return r
    return dataclasses.replace(r, v=r.v[:n], policy=r.policy[:n])


def _ensure_dir(path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
