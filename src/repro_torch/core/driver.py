"""Host driver: chunked, checkpointed single-device iPI solve.

Counterpart of :func:`repro.core.driver.solve` for one MDP on one device
(the reference's ``mesh=None`` path).  The outer loop runs in chunks of
``chunk`` iterations; between chunks the host persists the solver state
(``checkpoint_dir``) and reports progress, exactly as the reference bounds
its compiled loop.  :class:`SolveResult`, the span midpoint correction,
the checkpoint file format and the monitor records are the reference's,
so either package resumes the other's checkpoints.

Fleet solves — :func:`solve_many`
---------------------------------
``solve_many(mdps, opts)`` stacks B instances into one batched container
(:func:`repro_torch.core.mdp.stack_mdps`), runs one lockstep outer loop
for the whole fleet (one launch of each kernel for the fleet, through the
kernels' lane axis) and returns per-instance :class:`SolveResult`\\ s.
:func:`solve` runs the same loop on the fleet of one
(:func:`repro_torch.core.mdp.as_fleet`) and keeps the unbatched
checkpoint, monitor and result forms.
Converged lanes freeze under the active mask, so each result carries the
``k`` / ``inner_total`` / traces of its independent solve.  Ragged state
counts are padded and the results trimmed; per-lane gammas run as a
``(B,)`` discount tensor.  A fleet checkpoint holds the reference's
leaves with a leading ``B``, unpadded, so it too crosses between the
packages.

Sharded solves — ``solve(mdp, opts, mesh=, layout=)``
-----------------------------------------------------
With a ``torch.distributed`` device mesh (:mod:`repro_torch.launch.mesh`)
every rank pads the MDP to the mesh's multiples, keeps its own block on its
own device (:mod:`repro_torch.core.partition`, the ``1d`` or ``2d``
layout), resolves the halo and the communication-overlap plan, and runs
the same host loop; the collectives behind :class:`Axes` keep the ranks in
lockstep.  Every rank returns the global, unpadded :class:`SolveResult`.
Checkpoints stay mesh-agnostic: rank 0 writes the unpadded global state
and any world size (or one device) resumes it.  Monitors and progress
lines come from rank 0 only.

``solve_many(mdps, opts, mesh=, layout=)`` shards a fleet the same way:
replicated over ``1d`` / ``2d`` (every rank holds its rows of every
lane), or under ``fleet`` / ``fleet2d`` with its lanes over the mesh's
leading axis (``B`` padded with dummy lanes to a multiple of it).  The
fleet's flags are gathered over the fleet group once a step and once a
chunk, so every fleet shard runs the same steps; results and checkpoints
hold every true lane, unpadded, and a checkpoint resumes on any
fleet-axis size or none.

A ``supervisor`` (:mod:`repro_torch.adaptive`) may interrupt a single
solve between chunks; its state is then checkpointed for a resume under
another method.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.core import ipi, methods, partition
from repro_torch.core.comm import Axes
from repro_torch.core.ipi import IPIOptions, SolveState
from repro_torch.core.mdp import (MDP, DenseMDP, EllMDP, MatrixFreeMDP,
                                  as_fleet, gammas_of, stack_mdps)
from repro_torch.device import resolve_device
from repro_torch.utils import checkpoint as ckpt, trace

# the reference SolveState's leaves, in its field order: a checkpoint holds
# them as leaf_0 .. leaf_13
CKPT_FIELDS = ("v", "tv", "pi", "res", "k", "inner_total", "trace_res",
               "trace_inner", "res0", "span", "done", "diverged", "n_true",
               "win")
_CKPT_TREEDEF = f"SolveState({', '.join(CKPT_FIELDS)})"


@dataclasses.dataclass
class SolveResult:
    v: np.ndarray                  # (n,) optimal values
    policy: np.ndarray             # (n,) int32 greedy policy
    residual: float                # final ||T v - v||_inf
    gap_bound: float               # ||v - v*||_inf certificate: res/(1-gamma)
                                   # (span stopping: gamma*sp/(2*(1-gamma))
                                   # on the midpoint-corrected v)
    converged: bool
    outer_iterations: int
    inner_iterations: int
    trace_residual: np.ndarray     # (outer+1,)
    trace_inner: np.ndarray        # (outer,)
    diverged: bool = False         # residual went NaN or blew past
                                   # opts.divtol * res0
    span: float = float("inf")     # final sp(T v - v) (inf unless the stop
                                   # criterion declared needs_span)

    def summary(self) -> str:
        flag = " DIVERGED" if self.diverged else ""
        return (f"converged={self.converged} outer={self.outer_iterations} "
                f"inner={self.inner_iterations} residual={self.residual:.3e} "
                f"gap<= {self.gap_bound:.3e}{flag}")


def _result(state: SolveState, b: int, opts: IPIOptions, gamma: float,
            n_orig: int | None = None) -> SolveResult:
    """The result of lane ``b`` of ``state``, with padding states past
    ``n_orig`` trimmed."""
    read = lambda t: trace.to_host(t, "driver.results")
    k = int(state.k[b])
    res = float(read(state.res[b]))
    converged = bool(read(state.done[b]))
    v = read(state.v[b, :n_orig]).numpy()
    gap = res / (1.0 - gamma)
    if converged and opts.stop_criterion == "span" and gamma < 1.0:
        # Midpoint correction (Puterman §6.6): with d = T v - v,
        # T v + gamma/(1-gamma) * min(d) <= v* <= T v + gamma/(1-gamma) *
        # max(d), so the midpoint-shifted T v carries the certified bound
        # gamma * sp(d) / (2 * (1-gamma)).  A constant shift: the policy is
        # untouched.
        tv = read(state.tv[b, :n_orig]).numpy()
        d = tv - v
        scale = gamma / (1.0 - gamma)
        v = tv + scale * (float(d.max()) + float(d.min())) / 2.0
        gap = scale * float(read(state.span[b])) / 2.0
    return SolveResult(
        v=v,
        policy=read(state.pi[b, :n_orig]).numpy(),
        residual=res,
        gap_bound=gap,
        converged=converged,
        outer_iterations=k,
        inner_iterations=int(state.inner_total[b]),
        trace_residual=read(state.trace_res[b, :k + 1]).numpy(),
        trace_inner=read(state.trace_inner[b, :k]).numpy(),
        diverged=bool(read(state.diverged[b])),
        span=float(read(state.span[b])))


def _drain_monitor(emit, state: SolveState, done_prev: np.ndarray,
                   k_prev: np.ndarray) -> None:
    """``monitor_mode="chunk"``: rebuild this chunk's per-iteration
    records from the residual and inner traces — record for record (``k``
    / ``res`` / ``inner`` / ``diverged``) what ``"stream"`` emits
    (``elapsed`` is the drain time; the reference's reconstruction).
    ``done_prev`` / ``k_prev`` are the pre-chunk stop mask and outer
    counts."""
    act_prev = ~done_prev
    if not act_prev.any():
        return
    k = state.k
    tr = state.trace_res.cpu().numpy()
    ti = state.trace_inner.cpu().numpy()
    res_f = state.res.cpu().numpy()
    div_f = state.diverged.cpu().numpy()
    # lockstep: all active lanes share one outer index, so the stream's
    # per-step columns are exactly this range
    k_lo = int(k_prev[act_prev].max())
    k_hi = int(k[act_prev].max())
    for kk in range(k_lo + 1, k_hi + 1):
        col = tr[:, kk]
        # frozen lanes: the stream reports their current residual (lanes
        # frozen before the chunk override their old column; lanes frozen
        # in it have an unwritten, NaN column)
        col = np.where(~act_prev | np.isnan(col), res_f, col)
        inn = ti[:, kk - 1]
        inn = np.where(~act_prev | (inn < 0), 0, inn)
        # diverged flips exactly at the iteration the loop stopped on, so
        # only the final record can carry it, as in the stream
        div = div_f & (kk == k) if kk == k_hi else np.zeros_like(div_f)
        emit(kk, col, inn, div)


def _state_like(n: int, opts: IPIOptions,
                batch: int | None = None) -> list[tuple]:
    """``(shape, numpy dtype)`` of each checkpoint leaf of a solve of
    ``n`` states under ``opts`` (the reference's ``eval_shape`` of its
    initial state), with a leading ``batch`` for a fleet."""
    dt = np.dtype(opts.dtype)
    i32, b = np.dtype(np.int32), np.dtype(np.bool_)
    lead = () if batch is None else (batch,)
    return [(lead + shape, dtype) for shape, dtype in (
        ((n,), dt), ((n,), dt), ((n,), i32), ((), dt), ((), i32),
        ((), i32), ((opts.max_outer + 1,), dt), ((opts.max_outer,), i32),
        ((), dt), ((), dt), ((), b), ((), b), ((), i32), ((0,), dt))]


def _trim_ckpt_state(state: SolveState, n_orig: int,
                     b_orig: int) -> list[np.ndarray]:
    """The solver state in its checkpoint form: host arrays in the
    reference's leaf order, with ``k`` / ``inner_total`` as int32, the
    unpadded ``n_true`` and the (asynchronous methods') exchanged window
    empty, as the reference writes it — the true ``b_orig`` lanes and
    ``n_orig`` states (the reference's unpadded, mesh-agnostic form)."""
    lane = lambda a: np.asarray(a)[:b_orig]
    host = lambda t: lane(t.detach().cpu().numpy())
    v = host(state.v)[..., :n_orig]
    return [v, host(state.tv)[..., :n_orig], host(state.pi)[..., :n_orig],
            host(state.res), lane(state.k).astype(np.int32),
            lane(state.inner_total).astype(np.int32),
            host(state.trace_res), host(state.trace_inner), host(state.res0),
            host(state.span), host(state.done), host(state.diverged),
            host(state.n_true), np.zeros(v.shape[:-1] + (0,), v.dtype)]


def _pad_restored(leaves, like) -> list[np.ndarray]:
    """Zero-pad restored leaves to this solve's shapes (a checkpoint
    written under a smaller ``max_outer`` holds shorter traces) and cast
    them to its dtypes.  A leaf larger than this solve's raises."""
    out = []
    for a, (shape, dtype) in zip(leaves, like):
        a = np.asarray(a)
        if a.shape != shape:
            if len(a.shape) != len(shape) or \
                    any(s > t for s, t in zip(a.shape, shape)):
                raise ValueError(
                    f"checkpoint leaf of shape {a.shape} does not fit this "
                    f"solve's {tuple(shape)}: the checkpoint was written "
                    f"by a different problem or options (e.g. a larger "
                    f"max_outer, n, or fleet size); point checkpoint_dir "
                    f"at a fresh directory or re-run with the original "
                    f"settings")
            fill = True if a.dtype == np.bool_ else 0
            a = np.pad(a, [(0, t - s) for s, t in zip(a.shape, shape)],
                       constant_values=fill)
        out.append(a.astype(dtype))
    return out


def _state_from_leaves(leaves, dev: torch.device) -> SolveState:
    f = dict(zip(CKPT_FIELDS, leaves))
    put = lambda a: torch.from_numpy(np.array(a)).to(dev)
    count = lambda a: np.asarray(a, np.int64)
    return SolveState(
        v=put(f["v"]), tv=put(f["tv"]), pi=put(f["pi"]), res=put(f["res"]),
        k=count(f["k"]), inner_total=count(f["inner_total"]),
        trace_res=put(f["trace_res"]), trace_inner=put(f["trace_inner"]),
        res0=put(f["res0"]), span=put(f["span"]), done=put(f["done"]),
        diverged=put(f["diverged"]), n_true=put(f["n_true"]))


def _restore_or_init(init, like, dev: torch.device, checkpoint_dir,
                     verbose: bool, expect=None, single: bool = False,
                     rows: slice = slice(None),
                     lanes: slice = slice(None)) -> SolveState:
    """The state restored from ``checkpoint_dir``'s newest valid step, or
    ``init()``.  ``expect`` maps checkpoint-meta keys (``n``) to the
    values this solve requires — a mismatch means the directory holds
    another problem's checkpoint, which zero-padding would otherwise
    silently absorb.  ``single``: the checkpoint holds one instance's
    unbatched leaves, restored as the fleet of one.  ``rows`` / ``lanes``:
    the states and lanes this rank holds of the (zero-padded) global
    leaves; padded lanes restore done (a bool leaf pads with True), so
    they stay frozen."""
    if checkpoint_dir and ckpt.latest_step(checkpoint_dir) is not None:
        restored = ckpt.restore(checkpoint_dir, len(like))
        if restored is not None:
            leaves, _, meta = restored
            for key, want in (expect or {}).items():
                got = meta.get(key)
                if got is not None and got != want:
                    raise ValueError(
                        f"checkpoint in {checkpoint_dir!r} was written for "
                        f"{key}={got} but this solve has {key}={want}; "
                        f"refusing to resume from another problem's state")
            leaves = _pad_restored(leaves, like)
            if single:
                leaves = [a[None] for a in leaves]
            leaves = [a[lanes] for a in leaves]
            leaves[:3] = [a[..., rows] for a in leaves[:3]]
            state = _state_from_leaves(leaves, dev)
            if verbose:
                print(f"[driver] resumed at outer k={np.max(state.k)}")
            return state
    return init()


def _drive(dev_mdp: MDP, state: SolveState, opts: IPIOptions, axes: Axes,
           *, chunk: int, mid: int, emit, report, after_chunk,
           supervisor=None):
    """The host loop of :func:`solve` and :func:`solve_many`: chunks of at
    most ``chunk`` outer steps until every lane has stopped or reached
    ``opts.max_outer``.  ``emit(k, res, inner, diverged)`` sends a
    record (per-lane arrays) to monitor ``mid``; ``report(k, res, div,
    done)`` runs before every chunk and at the end, ``after_chunk(state)``
    after every chunk.  ``supervisor`` (one lane) is asked after every
    completed chunk, as :func:`solve` describes; a truthy answer stops the
    loop.  Under a fleet axis the flags cover every fleet shard's lanes
    (:func:`repro_torch.core.ipi.stop_flags`), so every rank takes the
    same branch, and the chunk monitor drains the whole fleet's traces.
    Returns the final state, its ``(stop, res, diverged)`` flags and
    whether the supervisor stopped it."""
    stream = emit if mid and opts.monitor_mode == "stream" else None
    stop, res, div, k = ipi.stop_flags(state, axes)
    if mid:   # the k=0 (or resume-point) record
        emit(k, res, np.zeros_like(k), np.zeros_like(stop))
    prev = None
    while True:
        done = stop | (k >= opts.max_outer)
        report(k, res, div, done)
        # converged, a NaN residual (inner-solver breakdown) or a diverged
        # flag: bail out, do not spin
        if done.all():
            return state, (stop, res, div), False
        # the control values this check already read: no extra sync
        if supervisor is not None and prev is not None and supervisor(dict(
                k=int(k[0]), res=float(res[0]), k_prev=prev[0],
                res_prev=prev[1], diverged=bool(div[0]))):
            return state, (stop, res, div), True
        prev = (int(k[0]), float(res[0]))
        k_hi = min(int(k[~done].min()) + chunk, opts.max_outer)
        state = ipi.solve_chunk(dev_mdp, state, k_hi, opts, axes,
                                on_step=stream)
        if opts.monitor and opts.monitor_mode == "chunk":
            # every fleet shard joins the traces' gather; the lead drains
            whole = state if axes.fleet is None \
                else _fleet_view(state, axes)
            if mid:
                _drain_monitor(emit, whole, done, k)
        after_chunk(state)
        stop, res, div, k = ipi.stop_flags(state, axes)


def _validate_banded(mdp: MDP, halo: int, axes: Axes,
                     n_shards: int | None) -> None:
    """The halo layout is only exact when every transition stays within
    +-halo of its source row (matrix bandwidth <= halo) and the halo fits
    in one shard.  ``mdp`` is the unpadded MDP, or this rank's block with
    ``axes`` its placement; ``n_shards`` the state-shard count of a mesh
    (``None`` on one device).  Raises ``ValueError`` (not assert: must
    survive -O).  A matrix-free MDP has no table to measure: its declared
    ``band`` is trusted, and required."""
    if isinstance(mdp, MatrixFreeMDP):
        if mdp.spec.band is None:
            raise ValueError(
                "halo>0 on a matrix-free operator needs a declared matrix "
                "bandwidth — there is no stored table to measure; pass "
                "band=... to from_functions() (max |successor - row| over "
                "all nonzero transitions) or drop to halo=0")
        band = int(mdp.spec.band)
    elif not isinstance(mdp, EllMDP):
        raise ValueError("halo>0 requires the ELL representation; DenseMDP "
                         "columns are global — drop halo or convert the MDP")
    else:
        rows = axes.state_index() * mdp.n_local + torch.arange(
            mdp.n_local, device=mdp.device)
        band = torch.amax(torch.abs(mdp.idx.long() - rows[:, None, None])) \
            if mdp.idx.numel() else torch.zeros((), dtype=torch.long,
                                                device=mdp.device)
        band = int(axes.pmax_action(axes.pmax_state(band)))
    if band > halo:
        raise ValueError(
            f"matrix bandwidth {band} exceeds halo {halo}: the banded "
            f"exchange would silently drop transitions; set halo >= {band} "
            f"or use the all-gather layout (halo=0)")
    if n_shards is not None:
        n_local = -(-mdp.n_global // n_shards)
        if halo > n_local:
            raise ValueError(
                f"halo {halo} exceeds the per-shard state count {n_local} "
                f"({n_shards} shards x {mdp.n_global} states): boundary "
                f"exchange would need >1 ring hop; use fewer shards or a "
                f"smaller halo")


def _resolve_overlap(opts: IPIOptions, block: MDP, axes: Axes,
                     sharded: bool) -> IPIOptions:
    """Resolve ``-comm_overlap auto|on|off`` into the interior/frontier
    plan ``opts.overlap_plan`` of this solve (the same on every rank).

    ``on`` overlaps whenever a contiguous interior core exists (banded /
    stencil instances); ``auto`` also requires the core to cover at least
    half the local rows.  Dense-random instances have no interior core and
    stay on the synchronous path.  When a plan exists and the user left
    ``-halo 0``, the planner also shrinks the collective: the solve runs on
    the halo layout at exactly the frontier reach
    (:func:`partition.frontier_reach`), a ``2 * reach`` ring exchange
    instead of the ``n_global`` all-gather (exact by construction)."""
    plan, halo = None, opts.halo
    if opts.comm_overlap != "off" and sharded:
        n_shards = axes.state_size()
        n_local = block.n_global // n_shards
        plan = partition.overlap_margins(block, n_shards, axes)
        if plan is not None and opts.comm_overlap == "auto":
            if n_local - plan[0] - plan[1] < n_local // 2:
                plan = None
        if plan is not None and opts.halo == 0:
            reach = partition.frontier_reach(block, n_shards, axes)
            # the ring exchange reaches one neighbour: the reach must fit
            # a shard (half — beyond that the window nears the gather)
            if reach is not None and reach <= n_local // 2:
                halo = max(int(reach), 1)
    if plan == opts.overlap_plan and halo == opts.halo:
        return opts
    return dataclasses.replace(opts, overlap_plan=plan, halo=halo)


def _with_window(state: SolveState, opts: IPIOptions,
                 n_win: int) -> SolveState:
    """A restored state of an asynchronous method gets its exchanged
    window back as zeros of length ``n_win`` — the k=0 iterate, a valid
    (stale) window — as the reference restores its empty leaf."""
    if methods.get_method(opts.method).outer is None \
            or state.win is not None:
        return state
    return dataclasses.replace(state, win=torch.zeros(
        (state.v.shape[0], n_win), dtype=state.v.dtype,
        device=state.v.device))


def _global_state(state: SolveState, axes: Axes) -> SolveState:
    """``state`` with its per-state vectors gathered over the state shards
    and, under a fleet axis, every field over the fleet shards (every
    other field is the same on every rank of a fleet slice)."""
    if axes.state is not None:
        state = dataclasses.replace(
            state, v=axes.allgather_state(state.v),
            tv=axes.allgather_state(state.tv),
            pi=axes.allgather_state(state.pi))
    if axes.fleet is None:
        return state
    return _fleet_view(state, axes, every=True)


def _fleet_view(state: SolveState, axes: Axes,
                every: bool = False) -> SolveState:
    """The per-lane fields of ``state`` gathered over the fleet shards:
    the residual, flags, counts and traces (a chunk monitor's drain), or
    ``every`` field.  The host counts travel as device tensors."""
    dev = state.res.device
    count = lambda a: axes.allgather_fleet(
        torch.from_numpy(np.asarray(a, np.int64)).to(dev)).cpu().numpy()
    lanes = axes.allgather_fleet
    kept = ("v", "tv", "pi", "res0", "span", "done", "n_true") if every \
        else ()
    return dataclasses.replace(
        state, res=lanes(state.res), k=count(state.k),
        inner_total=count(state.inner_total),
        trace_res=lanes(state.trace_res),
        trace_inner=lanes(state.trace_inner),
        diverged=lanes(state.diverged), win=None,
        **{f: lanes(getattr(state, f)) for f in kept})


def _mesh_device(mesh, device) -> torch.device:
    """This rank's device under ``mesh``: its card (the one the launcher
    set current) or the host, which ``device`` must name too."""
    want = resolve_device(device)
    if want.type != mesh.device_type:
        raise ValueError(f"device {str(device)!r} does not match the mesh's "
                         f"device type {mesh.device_type!r}")
    return want


def _reject_virtual(opts: IPIOptions) -> None:
    if methods.get_method(opts.method).virtual:
        raise ValueError(
            f"method {opts.method!r} is a virtual (meta) method — the "
            f"adaptive layer resolves it to a concrete solver first; use "
            f"repro_torch.api.Session.solve (which routes -method auto "
            f"automatically) or repro_torch.adaptive.solve_adaptive")


def solve(mdp: MDP, opts: IPIOptions = IPIOptions(), *, mesh=None,
          layout: str = "1d", v0=None,
          checkpoint_dir: str | None = None, chunk: int = 64,
          checkpoint_mode: str = "chunk", verbose: bool = False,
          monitor=None, supervisor=None,
          device: str | torch.device = "cuda") -> SolveResult:
    """Solve an MDP until ``opts.stop_criterion`` is satisfied (default:
    ``||T v - v||_inf <= opts.atol``) on ``device``.

    The MDP's tables move to ``device`` if they are elsewhere; ``device``
    defaults to ``"cuda"`` and raises when no GPU is visible.

    ``mesh`` (a ``torch.distributed`` device mesh, every rank calling with
    the same MDP and options) shards the solve under ``layout`` (``"1d"``
    or ``"2d"``, :mod:`repro_torch.core.partition`); ``device`` must then
    name the mesh's device type, and each rank works on its own card.
    Every rank returns the same global result.

    ``monitor`` (used when ``opts.monitor`` is set) is a callable receiving
    one dict per outer iteration — ``{"k", "res", "inner", "diverged",
    "elapsed"}``; without one, records print PETSc-style
    (:func:`repro_torch.core.methods.print_monitor`).  The first record is
    the k=0 (or resume-point) one.  Under a mesh only rank 0 emits them.

    ``supervisor`` is a between-chunks hook for the adaptive layer: a
    callable receiving ``{"k", "res", "k_prev", "res_prev", "diverged"}``
    once per completed chunk (the values the loop reads anyway); returning
    truthy interrupts the solve, and the current state is checkpointed
    when ``checkpoint_dir`` is set, so the caller can resume it under
    other options — the hot-swap path.  A diverged state stops the loop
    on its own.

    ``checkpoint_dir`` persists the state in the reference's format and
    resumes from its newest valid step.  ``checkpoint_mode="chunk"``
    (default) writes after every chunk; ``"interrupt"`` writes only when
    the solve is interrupted (supervisor trigger or divergence).
    """
    if not isinstance(mdp, (EllMDP, DenseMDP, MatrixFreeMDP)):
        raise TypeError(f"solve() takes an EllMDP, a DenseMDP or a "
                        f"MatrixFreeMDP, got {type(mdp).__name__}")
    if mdp.batch is not None:
        raise ValueError("solve() takes one MDP instance; for a batched "
                         "fleet use solve_many()")
    _reject_virtual(opts)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if checkpoint_mode not in ("chunk", "interrupt"):
        raise ValueError(f"checkpoint_mode={checkpoint_mode!r}: expected "
                         f"'chunk' or 'interrupt'")
    if layout in partition.FLEET_LAYOUTS:
        raise ValueError(f"layout={layout!r} shards the fleet (instance) "
                         "dim, which a single solve() does not have; use "
                         "solve_many() or layout='1d'/'2d'")
    n_orig = mdp.n_global
    with trace.span("driver.stack"):
        if mesh is None:
            dev = resolve_device(device)
            axes = Axes()
            block = mdp.to(dev)
            if opts.halo:
                _validate_banded(block, opts.halo, axes, None)
        else:
            dev = _mesh_device(mesh, device)
            placed = partition.already_placed(mdp, mesh, layout, dev)
            block, axes, _ = partition.shard_mdp(mdp, mesh, layout,
                                                 mode=opts.mode, device=dev)
            if opts.halo:
                _validate_banded(block if placed else mdp, opts.halo,
                                 axes if placed else Axes(),
                                 axes.state_size())
        opts = _resolve_overlap(opts, block, axes, mesh is not None)
        dev_mdp = as_fleet(partition.place_block(
            block, axes, halo=opts.halo, plan=opts.overlap_plan))
    lead = mesh is None or dist.get_rank() == 0
    n_pad, n_loc = block.n_global, block.n_local
    rows = slice(axes.state_index() * n_loc, (axes.state_index() + 1) * n_loc)
    if v0 is not None:
        v0 = torch.nn.functional.pad(torch.as_tensor(v0),
                                     (0, n_pad - n_orig))[rows][None]
    with trace.span("driver.init"):
        state = _restore_or_init(
            lambda: ipi.init_state(dev_mdp, axes, opts, v0,
                                   n_true=[n_orig]),
            _state_like(n_pad, opts), dev, checkpoint_dir, verbose and lead,
            expect=dict(n=n_orig), single=True, rows=rows)
        state = _with_window(state, opts,
                             n_loc + 2 * opts.halo if opts.halo else n_pad)
    save_each = bool(checkpoint_dir) and checkpoint_mode == "chunk"

    def save_state(state: SolveState) -> None:
        # every rank gathers; rank 0 writes; all wait for the file
        leaves = _trim_ckpt_state(_global_state(state, axes), n_orig, 1)
        if lead:
            ckpt.save(checkpoint_dir, int(state.k[0]),
                      [a[0] for a in leaves],
                      meta=dict(method=opts.method, n=n_orig),
                      treedef=_CKPT_TREEDEF)
        if mesh is not None:
            dist.barrier()

    def report(k, res, div, done) -> None:
        if verbose and lead:
            print(f"[driver] k={k[0]} residual={res[0]:.3e}"
                  + (" DIVERGED" if div[0] else ""))

    mid = 0
    if opts.monitor and lead:
        mid = methods.monitor_handle(monitor or methods.print_monitor)
    emit = lambda k, res, inner, div: methods.emit_host(
        mid, np.max(k), res[0], inner[0], div[0])
    try:
        with trace.span("driver.loop"):
            state, (_, res, div), stopped = _drive(
                dev_mdp, state, opts, axes, chunk=chunk, mid=mid, emit=emit,
                report=report,
                after_chunk=save_state if save_each else lambda state: None,
                supervisor=supervisor)
        # an interrupted solve is kept for its resume; a NaN-poisoned
        # state is not worth persisting
        if (stopped or (div[0] and not np.isnan(res[0]))) \
                and checkpoint_dir and not save_each:
            save_state(state)
    finally:
        if mid:
            methods.monitor_release(mid)
    with trace.span("driver.results"):
        return _result(_global_state(state, axes), 0, opts, mdp.gamma,
                       n_orig)


def solve_many(mdps, opts: IPIOptions = IPIOptions(), *, v0s=None,
               origin: tuple[int, int] | None = None,
               checkpoint_dir: str | None = None, chunk: int = 64,
               verbose: bool = False, monitor=None,
               device: str | torch.device = "cuda", mesh=None,
               layout: str = "1d", pad_fleet: bool = True) \
        -> list[SolveResult]:
    """Solve a fleet of MDPs in one lockstep batched loop on ``device``.

    ``mdps`` is a sequence of unbatched instances (stacked here, on the
    first instance's device, then moved to ``device``) or an
    already-batched container from :func:`repro_torch.core.mdp.stack_mdps`.
    Each instance is solved exactly as an individual :func:`solve` call
    would (per-instance counts and traces included: converged lanes freeze
    under the active mask), but every kernel runs once for the fleet.
    Returns one :class:`SolveResult` per instance, padding trimmed.

    ``mesh`` (a ``torch.distributed`` device mesh; every rank calls with
    the same fleet and options, and gets every lane's result) shards the
    fleet under ``layout``:

    * ``"1d"`` / ``"2d"`` — the instance dim is replicated: every rank
      holds its state (x action) slice of all ``B`` lanes;
    * ``"fleet"`` / ``"fleet2d"`` — the instance dim is sharded over the
      mesh's leading axis (:func:`repro_torch.launch.mesh.make_fleet_mesh`),
      states (and actions) over the rest within each fleet slice: a rank
      holds ``B / fleet_size`` lanes, stacked only from its own instances.
      ``B`` is padded to a multiple of the fleet-axis size with zero-cost
      dummy instances (trimmed from the results); ``pad_fleet=False``
      raises instead.  ``mdps`` may also be a placed
      :class:`repro_torch.core.partition.FleetBlock`
      (:func:`repro_torch.api.mdp.place_function_fleet`), taken as it is.

    ``v0s`` warm-starts: per-instance ``(n_i,)`` vectors (zero-padded to
    the fleet width) or a stacked ``(B, n)`` tensor.  ``origin=(B, n)``
    names the true fleet size and state count of a pre-batched container
    that carries padding, to trim results and checkpoints to.
    ``checkpoint_dir`` persists the fleet state after every chunk, in the
    reference's unpadded, unsharded format (meta ``batch`` and ``n``;
    under a mesh gathered over the fleet and state groups and written by
    rank 0), and resumes from its newest step on any mesh or none.
    ``monitor`` (with ``opts.monitor``) receives one fleet-wide record per
    outer step, one entry a lane (under a mesh, on rank 0).
    """
    _reject_virtual(opts)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if layout not in partition.LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; pick one of "
                         f"{partition.LAYOUTS}")
    if layout in partition.FLEET_LAYOUTS and mesh is None:
        raise ValueError(f"layout={layout!r} shards the fleet dim over a "
                         "mesh; pass mesh=... (see "
                         "repro_torch.launch.mesh.make_fleet_mesh)")
    fleet_block = isinstance(mdps, partition.FleetBlock)
    if fleet_block or isinstance(mdps, (EllMDP, DenseMDP, MatrixFreeMDP)):
        if not fleet_block and mdps.batch is None:
            raise ValueError("solve_many() wants a fleet; for a single "
                             "instance use solve()")
        b_all = mdps.batch
        b_true, n_true = origin or (b_all, mdps.n_global)
        if b_true > b_all or n_true > mdps.n_global:
            raise ValueError(f"origin={origin} exceeds the container's "
                             f"(B={b_all}, n={mdps.n_global})")
        n_origs = [n_true] * b_true
    else:
        if origin is not None:
            raise ValueError("origin= applies to a pre-batched container; "
                             "per-instance MDPs carry their own true n")
        mdps = list(mdps)
        n_origs = [m.n_global for m in mdps]
        b_true, n_true = len(mdps), max(n_origs)
    if fleet_block and (mesh is None or layout != mdps.layout):
        raise ValueError(f"a FleetBlock placed under layout "
                         f"{mdps.layout!r} solves on its mesh under that "
                         f"layout, not layout={layout!r}"
                         + ("" if mesh is not None else " without a mesh"))

    lead = mesh is None or dist.get_rank() == 0
    with trace.span("driver.stack"):
        if mesh is None:
            dev = resolve_device(device)
            axes = Axes()
            batched = mdps if not isinstance(mdps, list) \
                else stack_mdps(mdps)
            dev_mdp = batched.to(dev)
            gammas, lane0 = gammas_of(batched), 0
        else:
            dev = _mesh_device(mesh, device)
            axes = partition.mesh_axes(mesh, layout)
            if axes.fleet is not None:
                fb = mdps if fleet_block else partition.shard_fleet(
                    mdps, mesh, layout, mode=opts.mode, device=dev,
                    pad_fleet=pad_fleet)
                block, gammas, lane0 = fb.block, fb.gammas, fb.lane0
            else:
                batched = mdps if not isinstance(mdps, list) \
                    else stack_mdps(mdps)
                block, _, _ = partition.shard_mdp(batched, mesh, layout,
                                                  mode=opts.mode, device=dev)
                gammas, lane0 = gammas_of(batched), 0
            if opts.halo:
                _validate_banded(block, opts.halo, axes, axes.state_size())
            opts = _resolve_overlap(opts, block, axes, True)
            dev_mdp = partition.place_block(block, axes, halo=opts.halo,
                                            plan=opts.overlap_plan)
    # the padded fleet's lanes and states, and the ones this rank holds
    b_pad, n_pad = len(gammas), dev_mdp.n_global
    b_loc, n_loc = dev_mdp.batch, dev_mdp.n_local
    lanes = slice(lane0, lane0 + b_loc)
    rows = slice(axes.state_index() * n_loc, (axes.state_index() + 1) * n_loc)

    v0 = None
    if v0s is not None:
        if isinstance(v0s, (list, tuple)):
            v0 = torch.stack([torch.nn.functional.pad(
                torch.as_tensor(np.asarray(x)), (0, n_pad - len(x)))
                for x in v0s])
        else:
            v0 = torch.as_tensor(v0s)
        v0 = torch.nn.functional.pad(v0, (0, n_pad - v0.shape[-1], 0,
                                          b_pad - v0.shape[0]))
        v0 = v0[lanes, rows]
    # per-lane unpadded state counts (0 for dummy lanes and the lanes past
    # origin's B)
    nt = (list(n_origs) + [0] * (b_pad - len(n_origs)))[lanes]
    with trace.span("driver.init"):
        state = _restore_or_init(
            lambda: ipi.init_state(dev_mdp, axes, opts, v0, n_true=nt),
            _state_like(n_pad, opts, b_pad), dev, checkpoint_dir,
            verbose and lead, expect=dict(n=n_true, batch=b_true),
            rows=rows, lanes=lanes)
        state = _with_window(state, opts,
                             n_loc + 2 * opts.halo if opts.halo else n_pad)

    def report(k, res, div, done) -> None:
        if verbose and lead:
            print(f"[driver] fleet B={len(k)} active={int((~done).sum())} "
                  f"k_max={int(k.max())} res_max={float(res.max()):.3e}")

    def save_state(state: SolveState) -> None:
        if not checkpoint_dir:
            return
        # every rank gathers; rank 0 writes; all wait for the file
        whole = _global_state(state, axes)
        if lead:
            ckpt.save(checkpoint_dir, int(np.max(whole.k[:b_true])),
                      _trim_ckpt_state(whole, n_true, b_true),
                      meta=dict(method=opts.method, batch=b_true, n=n_true,
                                layout=layout),
                      treedef=_CKPT_TREEDEF)
        if mesh is not None:
            dist.barrier()

    mid = 0
    if opts.monitor and lead:
        mid = methods.monitor_handle(monitor or methods.print_monitor)
    emit = lambda k, res, inner, div: methods.emit_host(
        mid, k[:b_true] if np.ndim(k) else k, res[:b_true], inner[:b_true],
        div[:b_true])
    try:
        with trace.span("driver.loop"):
            state, _, _ = _drive(dev_mdp, state, opts, axes, chunk=chunk,
                                 mid=mid, emit=emit, report=report,
                                 after_chunk=save_state)
    finally:
        if mid:
            methods.monitor_release(mid)
    with trace.span("driver.results"):
        state = _global_state(state, axes)
        return [_result(state, b, opts, gammas[b], n_origs[b])
                for b in range(b_true)]
