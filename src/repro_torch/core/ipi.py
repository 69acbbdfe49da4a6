"""Inexact policy iteration (iPI) — the outer loop.

Counterpart of :mod:`repro.core.ipi`.  Every outer iteration does one
Bellman backup (greedy step + residual) and one inexact solve of ``(I -
gamma P_pi) v = g_pi`` warm-started at ``T v_k``; with 0 inner
iterations the update *is* ``T v_k``, so VI falls out as the degenerate
case.  A monotone safeguard falls back to the VI step whenever a Krylov
step fails to reduce the sup-norm Bellman residual.

The loop runs on a batched MDP (leading ``B``,
:func:`repro_torch.core.mdp.stack_mdps`; one instance is the fleet of one,
:func:`repro_torch.core.mdp.as_fleet`) with a batched
:class:`SolveState` — per-lane vectors, traces ``(B, ...)``, and host
arrays ``k`` / ``inner_total``.  The reference's vmapped ``lax.while_loop``
becomes one lockstep host loop in :func:`solve_chunk`: every step runs the
outer core on all lanes at once (one launch of each kernel for the
fleet), and an *active mask* (not done, no NaN, not diverged, ``k <
k_hi``) freezes the lanes that have stopped, so each lane's ``k``,
``inner_total`` and traces are what its independent solve gives.  All
active lanes share one outer index (every lane starts at 0 and advances
only while active), so each step writes one trace column.  One host read
per outer step carries every lane's flags and residual (a stream monitor
gets its record from it); the safeguard is a per-lane select behind one
more read.  ``n_true`` (per lane) keeps a ragged fleet's padding states
out of the span.  Under a fleet axis (the fleet layouts) the step's read
gathers every fleet shard's flags, so all shards agree on the step count:
one whose lanes have all stopped runs no-op steps until the fleet has.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bellman, methods
from repro_torch.core.comm import Axes
from repro_torch.core.solvers import PC_TYPES, build_precond, lanes
from repro_torch.core.mdp import MDP, batch_parts, gammas_of
from repro_torch.kernels import ops

MODES = ("mincost", "maxreward")
DTYPES = {"float32": torch.float32, "float64": torch.float64}

# the reference's forcing-tolerance floor, jnp.float32(1e-30)
_TOL_FLOOR = float(np.float32(1e-30))


def wire_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``gather_dtype`` name (``"bfloat16"``, ...)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"gather_dtype {name!r} is not a dtype: no torch "
                         f"dtype of that name")
    return dt


@dataclasses.dataclass(frozen=True)
class IPIOptions:
    """Solver options (the reference's, less its adaptive fields)."""

    method: str = "ipi_gmres"   # any name in the live method registry
    mode: str = "mincost"       # "mincost" (argmin backup) | "maxreward"
    atol: float = 1e-8          # stop when ||T v - v||_inf <= atol
    stop_criterion: str = "atol"  # atol | rtol | span
    rtol: float = 1e-4          # threshold for stop_criterion="rtol"
    max_outer: int = 500
    max_inner: int = 500        # inner-iteration cap per outer step
    forcing_eta: float = 0.05   # inner tol = eta * ||T v - v||_inf
    restart: int = 32           # GMRES restart length
    omega: float = 1.0          # Richardson damping
    mpi_sweeps: int = 50        # L for modified policy iteration
    anderson_window: int = 5    # AA depth for the anderson inner solver
    safeguard: bool = True      # monotone (VI-fallback) safeguard
    monitor: bool = False       # emit one record per outer iteration
    deterministic_dots: bool = False  # pin the Krylov accumulation orders
    impl: str | None = None     # kernel implementation (kernels/ops.py):
                                # auto | torch | blocked | cuda, or the
                                # reference's xla | pallas; None = auto
    dtype: str = "float32"      # value-vector dtype; "float64" == PETSc
    monitor_mode: str = "stream"  # "stream": a record from the host loop
                                # after each outer step; "chunk": the same
                                # records rebuilt from the traces after
                                # each chunk
    pc_type: str = "none"       # Krylov inner-solve preconditioner:
                                # none | jacobi | bjacobi
    pc_block: int = 32          # bjacobi tile size
    divtol: float = 1e4         # declare divergence when the residual
                                # exceeds divtol * (initial residual)
    halo: int = 0               # banded layout: exchange only +-halo
                                # boundary entries instead of gathering v
    gather_dtype: str | None = None  # compressed (inexact) gather for the
                                # INNER matvecs only; backups stay exact
    comm_overlap: str = "auto"  # overlap the backup's window movement with
                                # interior-row compute: "on" whenever an
                                # interior core exists, "auto" when it
                                # covers >= half the local rows, "off"
    async_sweeps: int = 1       # async_vi: local Bellman sweeps per value
                                # exchange (1 == synchronous vi)
    overlap_plan: tuple | None = None  # resolved (f_lo, f_hi) frontier
                                # margins (driver-set from
                                # partition.overlap_margins; not a user
                                # option)

    def __post_init__(self):
        # Raised (not assert'd): option validation must survive `python -O`.
        # Messages are the reference's.
        err = methods.check_method(self.method)
        if err:
            raise ValueError(err)
        err = methods.check_stop(self.stop_criterion)
        if err:
            raise ValueError(err)
        err = ops.check_impl(self.impl)
        if err:
            raise ValueError(err)
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; "
                             f"pick one of {MODES}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be 'float32' or 'float64' (PETSc "
                             f"default), got {self.dtype!r}")
        if not self.atol > 0:
            raise ValueError(f"atol must be > 0, got {self.atol}")
        if not 0.0 < self.rtol < 1.0:
            raise ValueError(f"rtol must lie in (0, 1), got {self.rtol}")
        if self.max_outer < 1:
            raise ValueError(f"max_outer must be >= 1, got {self.max_outer}")
        if self.max_inner < 0:
            raise ValueError(f"max_inner must be >= 0, got {self.max_inner}")
        if not 0.0 < self.forcing_eta < 1.0:
            raise ValueError(f"forcing_eta must lie in (0, 1) for iPI "
                             f"convergence, got {self.forcing_eta}")
        spec = methods.get_method(self.method)
        if self.deterministic_dots and spec.ksp is not None \
                and not methods.get_ksp(spec.ksp).deterministic:
            raise ValueError(
                f"deterministic_dots pins batch-invariant accumulation "
                f"orders, which ksp {spec.ksp!r} (method {self.method!r}) "
                f"does not implement — its dots would still re-associate "
                f"by lane count; use a deterministic ksp (e.g. "
                f"gmres/richardson/chebyshev) or drop the flag")
        if self.pc_type not in PC_TYPES:
            raise ValueError(f"pc_type must be 'none', 'jacobi' or "
                             f"'bjacobi', got {self.pc_type!r}")
        if self.pc_type != "none" and not spec.virtual:
            if spec.ksp is None:
                raise ValueError(
                    f"pc_type {self.pc_type!r} preconditions the Krylov "
                    f"inner solve, but method {self.method!r} has no inner "
                    f"KSP; pick an ipi_* method (or -method auto) or drop "
                    f"-pc_type")
            if not methods.get_ksp(spec.ksp).preconditioned:
                raise ValueError(
                    f"ksp {spec.ksp!r} (method {self.method!r}) does not "
                    f"accept a preconditioner; register it with "
                    f"preconditioned=True (and a `precond` keyword) or use "
                    f"gmres/bicgstab")
            if self.pc_type == "bjacobi" and self.deterministic_dots:
                raise ValueError(
                    "pc_type 'bjacobi' applies batched tile inverses whose "
                    "accumulation order is not lane-count-pinned; under "
                    "deterministic_dots use pc_type 'jacobi' (elementwise) "
                    "or drop the flag")
        if self.pc_block < 1:
            raise ValueError(f"pc_block must be >= 1, got {self.pc_block}")
        if not self.divtol > 1.0:
            raise ValueError(f"divtol must be > 1 (residual growth factor "
                             f"declaring divergence), got {self.divtol}")
        if self.restart < 1:
            raise ValueError(f"restart must be >= 1, got {self.restart}")
        if self.mpi_sweeps < 1:
            raise ValueError(f"mpi_sweeps must be >= 1, got {self.mpi_sweeps}")
        if self.anderson_window < 1:
            raise ValueError(f"anderson_window must be >= 1, "
                             f"got {self.anderson_window}")
        if not isinstance(self.halo, int) or self.halo < 0:
            raise ValueError(f"halo must be a non-negative int (0 disables "
                             f"the banded layout), got {self.halo!r}")
        if self.comm_overlap not in ("auto", "on", "off"):
            raise ValueError(f"comm_overlap must be 'auto', 'on' or 'off', "
                             f"got {self.comm_overlap!r}")
        if not isinstance(self.async_sweeps, int) or self.async_sweeps < 1:
            raise ValueError(f"async_sweeps must be an int >= 1 (1 == "
                             f"synchronous vi), got {self.async_sweeps!r}")
        if self.monitor_mode not in ("stream", "chunk"):
            raise ValueError(f"monitor_mode must be 'stream' or 'chunk', "
                             f"got {self.monitor_mode!r}")
        if self.overlap_plan is not None and (
                not isinstance(self.overlap_plan, tuple)
                or len(self.overlap_plan) != 2
                or not all(isinstance(x, int) and x >= 0
                           for x in self.overlap_plan)):
            raise ValueError(f"overlap_plan is driver-internal: None or a "
                             f"(f_lo, f_hi) tuple of ints >= 0, got "
                             f"{self.overlap_plan!r}")
        if self.gather_dtype is not None:
            gd = wire_dtype(self.gather_dtype)
            if not gd.is_floating_point:
                raise ValueError(f"gather_dtype must be a floating dtype "
                                 f"(wire format for v), got "
                                 f"{self.gather_dtype}")
            if gd.itemsize > DTYPES[self.dtype].itemsize:
                raise ValueError(
                    f"gather_dtype {self.gather_dtype} is wider than the "
                    f"value dtype {self.dtype}: the compressed gather would "
                    f"silently upcast the wire format; drop gather_dtype or "
                    f"widen dtype")

    @property
    def wire(self) -> torch.dtype | None:
        """The inner matvecs' gather dtype, or ``None``."""
        return None if self.gather_dtype is None \
            else wire_dtype(self.gather_dtype)


@dataclasses.dataclass(frozen=True)
class SolveState:
    """Solver state of a fleet of B lanes (one instance: B = 1).  ``k`` and
    ``inner_total`` are host int64 arrays ``(B,)`` (the host loop owns
    them); everything else lives on the solve device with a leading ``B``.
    The trace tensors keep the reference's fixed lengths and are written
    in place."""

    v: torch.Tensor            # (B, n) current value iterate
    tv: torch.Tensor           # (B, n) T v (one backup ahead)
    pi: torch.Tensor           # (B, n) int32 greedy policy (global ids)
    res: torch.Tensor          # (B,) ||T v - v||_inf
    k: np.ndarray              # (B,) outer iterations done
    inner_total: np.ndarray    # (B,) cumulative inner iterations
    trace_res: torch.Tensor    # (B, max_outer + 1) residual after k outers
    trace_inner: torch.Tensor  # (B, max_outer) int32 inner iters per outer
    res0: torch.Tensor         # (B,) residual at k=0 (rtol baseline)
    span: torch.Tensor         # (B,) sp(T v - v) (inf unless needs_span)
    done: torch.Tensor         # (B,) bool, stop criterion satisfied
    diverged: torch.Tensor     # (B,) bool (sticky): NaN or > divtol * res0
    n_true: torch.Tensor       # (B,) int32 unpadded state counts
    win: torch.Tensor | None = None  # (B, window) the last exchanged value
                               # window of an asynchronous method
                               # (invariant: win == gather_v(v) at outer
                               # steps); None for the synchronous ones.
                               # Checkpointed empty, restored as zeros —
                               # the k=0 iterate, a valid stale window


def _span_of(d: torch.Tensor, axes: Axes, opts: IPIOptions,
             n_true: torch.Tensor) -> torch.Tensor:
    """Span seminorms ``sp(d) = max(d) - min(d)`` of the lanes of ``(B,
    n)`` ``d`` — computed only when the stop criterion declared
    ``needs_span``, else a free ``+inf`` — over each lane's true states:
    rows ``>= n_true`` (a ragged fleet's padding) are masked out as the
    reference masks them, and so are mesh-pad rows (global ids
    ``>= n_true``); the extremes are reduced over the state shards."""
    if not methods.get_stop(opts.stop_criterion).needs_span:
        return torch.full(d.shape[:-1], float("inf"), dtype=d.dtype,
                          device=d.device)
    n_loc = d.shape[-1]
    rows = axes.state_index() * n_loc + torch.arange(n_loc, device=d.device)
    valid = rows[None, :] < n_true[:, None]
    ninf = torch.tensor(-float("inf"), dtype=d.dtype, device=d.device)
    ext = axes.pmax_state(torch.stack([
        torch.amax(torch.where(valid, d, ninf), dim=-1),
        torch.amax(torch.where(valid, -d, ninf), dim=-1)]))
    return ext[0] + ext[1]


def init_state(mdp: MDP, axes: Axes, opts: IPIOptions,
               v0: torch.Tensor | None = None, *,
               n_true=None) -> SolveState:
    """The k = 0 state of a batched MDP: one backup of ``v0`` (``(B,
    n_local)``, zeros if not given).  ``n_true`` holds the lanes' unpadded
    state counts (default: all ``n_global``)."""
    dt = DTYPES[opts.dtype]
    dev = mdp.device
    batch = mdp.batch
    v = torch.zeros((batch, mdp.n_local), dtype=dt, device=dev) \
        if v0 is None else torch.as_tensor(v0).to(device=dev, dtype=dt)
    gamma_t = batch_parts(mdp, dt)
    tv, pi, win = bellman.gather_backup(mdp, v, axes,
                                        plan=opts.overlap_plan,
                                        halo=opts.halo, mode=opts.mode,
                                        gamma_t=gamma_t, impl=opts.impl)
    tv = tv.to(dt)
    res = axes.norm_inf(tv - v)
    nt = torch.tensor([mdp.n_global] * batch if n_true is None
                      else list(n_true), dtype=torch.int32, device=dev)
    span = _span_of(tv - v, axes, opts, nt)
    done = methods.stop_done(
        opts, res=res, span=span, res0=res,
        k=torch.zeros((batch,), dtype=torch.int32, device=dev),
        gamma=mdp.gamma if gamma_t is None else gamma_t)
    trace_res = torch.full((batch, opts.max_outer + 1), float("nan"),
                           dtype=dt, device=dev)
    trace_res[:, 0] = res
    return SolveState(
        v=v, tv=tv, pi=pi, res=res, k=np.zeros(batch, np.int64),
        inner_total=np.zeros(batch, np.int64), trace_res=trace_res,
        trace_inner=torch.full((batch, opts.max_outer), -1,
                               dtype=torch.int32, device=dev),
        res0=res, span=span, done=done, diverged=torch.isnan(res),
        n_true=nt,
        win=win.to(dt) if methods.get_method(opts.method).outer else None)


def stop_flags(state: SolveState, axes: Axes = Axes()) -> tuple:
    """``(stop, res, diverged, k)`` of every lane in one device read: host
    arrays ``(B,)``.  Under a fleet axis they hold the lanes of every
    fleet shard, in order (one all-gather over the fleet group)."""
    stop = state.done | torch.isnan(state.res) | state.diverged
    flags = _read([stop, state.res, state.diverged], state.k, axes)
    return flags[0] != 0, flags[1], flags[2] != 0, \
        state.k if axes.fleet is None else flags[-1].astype(np.int64)


def _read(rows: list, k: np.ndarray, axes: Axes) -> np.ndarray:
    """Stack per-lane ``rows`` (``(B_local,)`` tensors) as float64 and read
    them to the host: ``(len(rows), B_local)``; under a fleet axis the host
    ``k`` joins them and the lanes of every fleet shard are gathered first:
    ``(len(rows) + 1, B)``."""
    dev = rows[0].device
    flags = torch.stack([r.to(torch.float64) for r in rows])
    if axes.fleet is not None:
        flags = torch.cat([flags, torch.from_numpy(k.astype(
            np.float64))[None].to(dev)])
        flags = axes.allgather_fleet(flags.T.contiguous()).T
    return flags.cpu().numpy()


def _outer_core(mdp: MDP, state: SolveState, opts: IPIOptions, axes: Axes,
                gamma_t, act: torch.Tensor | None, act_h: np.ndarray):
    """One outer iteration of every lane minus the k/trace bookkeeping.
    Lanes outside ``act`` (``None``: all lanes are active) are computed
    but not solved for, and their results are dropped by the caller.
    Methods with a custom ``outer`` (``async_vi``) replace the
    inner-solve/backup core.  Returns ``(v1, tv1, pi1, res1, span1,
    inner_iters (B,) int32, win1)``."""
    spec = methods.get_method(opts.method)
    if spec.outer is not None:
        v1, tv1, pi1, res1, inner, win1 = spec.outer(mdp, state, opts, axes,
                                                     gamma_t)
        span1 = _span_of(tv1 - v1, axes, opts, state.n_true)
        return v1, tv1, pi1, res1, span1, inner, win1
    dt = state.tv.dtype
    gammas = gammas_of(mdp)
    wire = opts.wire
    rows = bellman.policy_rows(mdp, state.pi, axes, dtype=dt,
                               gamma_t=gamma_t, gather_dtype=wire)
    b = bellman.b_pi(rows, axes).to(dt)
    mv = lambda r: (lambda x: bellman.a_pi_matvec(
        r, x, axes, halo=opts.halo, gather_dtype=wire, impl=opts.impl))
    matvec = mv(rows)
    tol = torch.maximum(opts.forcing_eta * state.res,
                        torch.tensor(_TOL_FLOOR, dtype=state.res.dtype,
                                     device=state.res.device))
    live = np.flatnonzero(act_h)
    lane_pcs = [None] * mdp.batch
    precond = None
    if opts.pc_type != "none" and spec.ksp is not None:
        # rebuilt every outer step, per lane with the lane's gamma, from
        # the policy rows the matvec holds
        row0 = bellman.window_offset(mdp, axes, opts.halo)
        for i in live:
            lane_pcs[i] = build_precond(
                rows.lane(i, gammas[i]), axes=axes, n_local=mdp.n_local,
                gamma=gammas[i], pc_type=opts.pc_type, block=opts.pc_block,
                dtype=dt, row0=row0)
        precond = lambda x: torch.stack(
            [x[i] if pc is None else pc(x[i])
             for i, pc in enumerate(lane_pcs)])

    def lane(i):
        return mv(rows.lane(i, gammas[i])), dict(gamma=gammas[i]), \
            lane_pcs[i]

    v1, inner = methods.inner_solve(
        opts, matvec, b, state.tv, tol, axes, live=act, live_lanes=live,
        lane=lane, precond=precond)

    def eval_at(v):
        # exact window; the overlap plan switches in the communication-
        # overlapped (result-identical) backup
        tv, pi, _ = bellman.gather_backup(mdp, v, axes,
                                          plan=opts.overlap_plan,
                                          halo=opts.halo, mode=opts.mode,
                                          gamma_t=gamma_t, impl=opts.impl)
        return v, tv, pi, axes.norm_inf(tv - v)

    cand = eval_at(v1)
    if opts.safeguard and spec.safeguarded and spec.ksp is not None:
        # Krylov-type steps are not contractions: a step that increases a
        # lane's Bellman residual is replaced by its VI step, computed
        # only when some active lane rejects.  The residuals are
        # all-reduced, so every rank takes the same branch
        reject = ~(cand[3] <= state.res)
        if act is not None:
            reject = reject & act
        reject_h = reject.cpu().numpy()
        if reject_h.all():
            cand = eval_at(state.tv)
        elif reject_h.any():
            fall = eval_at(state.tv)
            cand = tuple(torch.where(reject.view(-1, *[1] * (c.dim() - 1)),
                                     f, c) for c, f in zip(cand, fall))
    v1, tv1, pi1, res1 = cand
    span1 = _span_of(tv1 - v1, axes, opts, state.n_true)
    return v1, tv1, pi1, res1, span1, inner, state.win


def solve_chunk(mdp: MDP, state: SolveState, k_hi: int,
                opts: IPIOptions, axes: Axes,
                on_step=None) -> SolveState:
    """Run outer iterations until every lane has converged, hit a NaN
    residual, diverged or reached ``k == k_hi`` (module docstring): one
    device read of the lanes' flags and residuals per step.
    ``on_step(k, res, inner, diverged)``, if given, receives each step's
    record from that read (the stream monitor), one entry a lane.

    Under a fleet axis the read gathers the lanes of every fleet shard, so
    every shard runs the same steps: one whose lanes have all stopped runs
    no-op steps (its state frozen) until the whole fleet has, and the
    record covers the whole fleet."""
    dt = DTYPES[opts.dtype]
    dev = state.v.device
    gamma_t = batch_parts(mdp, dt)
    gamma = mdp.gamma if gamma_t is None else gamma_t
    lo = axes.fleet_index() * mdp.batch
    lanes_here = slice(lo, lo + mdp.batch)
    stop_g, _, _, k_g = stop_flags(state, axes)
    while True:
        act_g = ~stop_g & (k_g < k_hi)
        if not act_g.any():
            return state
        act_h = act_g[lanes_here]
        if not act_h.any():
            # this fleet shard's lanes have all stopped while others run:
            # a no-op step that joins the step's gather
            stop = state.done | torch.isnan(state.res) | state.diverged
            flags = _read([stop, state.res, state.diverged,
                           torch.zeros_like(state.res)], state.k, axes)
            stop_g, k_g = flags[0] != 0, flags[-1].astype(np.int64)
            if on_step is not None:
                on_step(int(k_g[act_g].max()), flags[1],
                        flags[3].astype(np.int64), flags[2] != 0)
            continue
        # with every lane active no lane is masked, and nothing is copied
        act = None if act_h.all() else lanes.to_device(act_h, dev)
        v1, tv1, pi1, res1, span1, inner, win1 = _outer_core(
            mdp, state, opts, axes, gamma_t, act, act_h)
        k1 = state.k + act_h
        done1 = methods.stop_done(
            opts, res=res1, span=span1, res0=state.res0,
            k=lanes.to_device(k1.astype(np.int32), dev), gamma=gamma)
        div = torch.isnan(res1) | (
            res1 > opts.divtol * torch.clamp_min(state.res0, 1e-30))
        sel = lambda new, old: lanes.keep(act, act is None, new, old)
        div1 = state.diverged | (div if act is None else act & div)
        # lockstep: every active lane writes outer index k_col; frozen
        # lanes keep their column
        k_col = int(k1[act_h].max())
        state.trace_res[:, k_col] = sel(res1.to(state.trace_res.dtype),
                                        state.trace_res[:, k_col])
        if act is not None:
            inner = torch.where(act, inner, 0)
        state.trace_inner[:, k_col - 1] = sel(
            inner, state.trace_inner[:, k_col - 1])
        res = sel(res1, state.res)
        done = sel(done1, state.done)
        stop = done | torch.isnan(res) | div1
        # the step's one read: every lane's flags, residual, inner count
        flags = _read([stop, res, div1, inner], k1, axes)
        stop_g = flags[0] != 0
        inner_g = flags[3].astype(np.int64)
        k_g = k1 if axes.fleet is None else flags[-1].astype(np.int64)
        state = SolveState(
            v=sel(v1, state.v), tv=sel(tv1, state.tv),
            pi=sel(pi1, state.pi), res=res, k=k1,
            inner_total=state.inner_total + inner_g[lanes_here],
            trace_res=state.trace_res, trace_inner=state.trace_inner,
            res0=state.res0, span=sel(span1, state.span), done=done,
            diverged=div1, n_true=state.n_true,
            win=None if win1 is None else sel(win1, state.win))
        if on_step is not None:
            on_step(k_col, flags[1], inner_g, flags[2] != 0)
