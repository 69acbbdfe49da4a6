"""Inexact policy iteration (iPI) — the outer loop, single device.

Counterpart of :mod:`repro.core.ipi` (the unbatched path).  Every outer
iteration does one Bellman backup (greedy step + residual) and one inexact
solve of ``(I - gamma P_pi) v = g_pi`` warm-started at ``T v_k``; with 0
inner iterations the update *is* ``T v_k``, so VI falls out as the
degenerate case.  A monotone safeguard falls back to the VI step whenever
a Krylov step fails to reduce the sup-norm Bellman residual.

The reference's ``lax.while_loop`` becomes a host loop in
:func:`solve_chunk` that reads ``done | isnan(res) | diverged`` with the
residual once per outer step; the safeguard's accept/reject decision is
one more read.  A stream monitor gets its record from that same read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bellman, methods
from repro_torch.core.comm import Axes
from repro_torch.core.solvers import PC_TYPES, build_precond
from repro_torch.core.mdp import MDP

MODES = ("mincost", "maxreward")
DTYPES = {"float32": torch.float32, "float64": torch.float64}

# the reference's forcing-tolerance floor, jnp.float32(1e-30)
_TOL_FLOOR = float(np.float32(1e-30))


@dataclasses.dataclass(frozen=True)
class IPIOptions:
    """Solver options (the reference's, less its kernel, layout and
    adaptive fields)."""

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

    def __post_init__(self):
        # Raised (not assert'd): option validation must survive `python -O`.
        # Messages are the reference's.
        err = methods.check_method(self.method)
        if err:
            raise ValueError(err)
        err = methods.check_stop(self.stop_criterion)
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
        if self.pc_type != "none":
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
        if self.monitor_mode not in ("stream", "chunk"):
            raise ValueError(f"monitor_mode must be 'stream' or 'chunk', "
                             f"got {self.monitor_mode!r}")


@dataclasses.dataclass(frozen=True)
class SolveState:
    """Solver state.  ``k`` and ``inner_total`` are host ints (the host
    loop owns them); everything else lives on the solve device.  The trace
    tensors keep the reference's fixed lengths and are written in place."""

    v: torch.Tensor            # (n,) current value iterate
    tv: torch.Tensor           # (n,) T v (one backup ahead)
    pi: torch.Tensor           # (n,) int32 greedy policy (global ids)
    res: torch.Tensor          # 0-d, ||T v - v||_inf
    k: int                     # outer iterations done
    inner_total: int           # cumulative inner iterations
    trace_res: torch.Tensor    # (max_outer + 1,) residual after k outers
    trace_inner: torch.Tensor  # (max_outer,) int32 inner iters per outer
    res0: torch.Tensor         # 0-d, residual at k=0 (rtol baseline)
    span: torch.Tensor         # 0-d, sp(T v - v) (inf unless needs_span)
    done: torch.Tensor         # 0-d bool, stop criterion satisfied
    diverged: torch.Tensor     # 0-d bool (sticky): NaN or > divtol * res0


def _span_of(d: torch.Tensor, opts: IPIOptions) -> torch.Tensor:
    """Span seminorm ``sp(d) = max(d) - min(d)`` — computed only when the
    stop criterion declared ``needs_span``, else a free ``+inf``.  (One
    device holds no mesh-pad rows, so every row is a true state.)"""
    if not methods.get_stop(opts.stop_criterion).needs_span:
        return torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    return torch.max(d) - torch.min(d)


def init_state(mdp: MDP, axes: Axes, opts: IPIOptions,
               v0: torch.Tensor | None = None) -> SolveState:
    dt = DTYPES[opts.dtype]
    dev = mdp.device
    v = torch.zeros((mdp.n_local,), dtype=dt, device=dev) if v0 is None \
        else torch.as_tensor(v0).to(device=dev, dtype=dt)
    tv, pi, _ = bellman.gather_backup(mdp, v, axes, mode=opts.mode)
    tv = tv.to(dt)
    res = axes.pmax_state(torch.max(torch.abs(tv - v)))
    span = _span_of(tv - v, opts)
    done = methods.stop_done(opts, res=res, span=span, res0=res, k=0,
                             gamma=mdp.gamma)
    trace_res = torch.full((opts.max_outer + 1,), float("nan"), dtype=dt,
                           device=dev)
    trace_res[0] = res
    return SolveState(
        v=v, tv=tv, pi=pi, res=res, k=0, inner_total=0,
        trace_res=trace_res,
        trace_inner=torch.full((opts.max_outer,), -1, dtype=torch.int32,
                               device=dev),
        res0=res, span=span, done=done, diverged=torch.isnan(res))


def _outer_core(mdp: MDP, state: SolveState, opts: IPIOptions,
                axes: Axes):
    """One outer iteration minus the k/trace bookkeeping.  Returns
    ``(v1, tv1, pi1, res1, span1, inner_iters)``."""
    spec = methods.get_method(opts.method)
    rows = bellman.policy_rows(mdp, state.pi, axes, dtype=state.tv.dtype)
    b = bellman.b_pi(rows, axes).to(state.tv.dtype)
    matvec = lambda x: bellman.a_pi_matvec(rows, x, axes)
    tol = torch.maximum(opts.forcing_eta * state.res,
                        torch.tensor(_TOL_FLOOR, dtype=state.res.dtype,
                                     device=state.res.device))
    precond = None
    if opts.pc_type != "none" and spec.ksp is not None:
        # rebuilt every outer step from the policy rows the matvec holds
        precond = build_precond(rows, axes=axes, n_local=mdp.n_local,
                                gamma=mdp.gamma, pc_type=opts.pc_type,
                                block=opts.pc_block, dtype=state.tv.dtype)
    v1, inner_iters, _ = methods.inner_solve(
        opts, matvec, b, state.tv, tol, axes,
        context=dict(gamma=mdp.gamma), precond=precond)

    def eval_at(v):
        tv, pi, _ = bellman.gather_backup(mdp, v, axes, mode=opts.mode)
        res = axes.pmax_state(torch.max(torch.abs(tv - v)))
        return v, tv, pi, res

    cand = eval_at(v1)
    if opts.safeguard and spec.safeguarded and spec.ksp is not None:
        # Krylov-type steps are not contractions; reject any step that
        # increases the Bellman residual and take the VI step instead.
        if not bool(cand[3] <= state.res):
            cand = eval_at(state.tv)
    v1, tv1, pi1, res1 = cand
    span1 = _span_of(tv1 - v1, opts)
    return v1, tv1, pi1, res1, span1, inner_iters


def outer_step(mdp: MDP, state: SolveState, opts: IPIOptions,
               axes: Axes) -> SolveState:
    """One outer iPI iteration (greedy policy is already in ``state``).
    Writes this step's entries of the trace tensors in place."""
    v1, tv1, pi1, res1, span1, inner_iters = _outer_core(mdp, state, opts,
                                                         axes)
    k1 = state.k + 1
    done = methods.stop_done(opts, res=res1, span=span1, res0=state.res0,
                             k=k1, gamma=mdp.gamma)
    div1 = state.diverged | torch.isnan(res1) | \
        (res1 > opts.divtol * torch.clamp_min(state.res0, 1e-30))
    state.trace_res[k1] = res1
    state.trace_inner[state.k] = inner_iters
    return SolveState(
        v=v1, tv=tv1, pi=pi1, res=res1, k=k1,
        inner_total=state.inner_total + inner_iters,
        trace_res=state.trace_res, trace_inner=state.trace_inner,
        res0=state.res0, span=span1, done=done, diverged=div1)


def stop_flags(state: SolveState) -> tuple[bool, float, bool]:
    """``(stop, res, diverged)`` of ``state`` in one device read."""
    stop = state.done | torch.isnan(state.res) | state.diverged
    flags = torch.stack([stop.to(torch.float64),
                         state.res.to(torch.float64),
                         state.diverged.to(torch.float64)]).tolist()
    return bool(flags[0]), flags[1], bool(flags[2])


def solve_chunk(mdp: MDP, state: SolveState, k_hi: int,
                opts: IPIOptions, axes: Axes,
                on_step=None) -> SolveState:
    """Run outer iterations until convergence, a NaN residual, divergence
    or ``k == k_hi``: one device read of the stop flags and the residual
    per step.  ``on_step(k, res, inner, diverged)``, if given, receives
    each step's record from that read (the stream monitor)."""
    stop, _, _ = stop_flags(state)
    while not stop and state.k < k_hi:
        inner0 = state.inner_total
        state = outer_step(mdp, state, opts, axes)
        stop, res, div = stop_flags(state)
        if on_step is not None:
            on_step(state.k, res, state.inner_total - inner0, div)
    return state
