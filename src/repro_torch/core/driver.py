"""Host driver: chunked, checkpointed single-device iPI solve.

Counterpart of :func:`repro.core.driver.solve` for one MDP on one device
(the reference's ``mesh=None`` path).  The outer loop runs in chunks of
``chunk`` iterations; between chunks the host persists the solver state
(``checkpoint_dir``) and reports progress, exactly as the reference bounds
its compiled loop.  :class:`SolveResult`, the span midpoint correction,
the checkpoint file format and the monitor records are the reference's,
so either package resumes the other's checkpoints.

The adaptive supervisor hook, fleets and meshes are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ipi, methods
from repro_torch.core.comm import Axes
from repro_torch.core.ipi import IPIOptions, SolveState
from repro_torch.core.mdp import MDP, DenseMDP, EllMDP
from repro_torch.device import resolve_device
from repro_torch.utils import checkpoint as ckpt

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


def _result(state: SolveState, opts: IPIOptions, gamma: float) \
        -> SolveResult:
    k = state.k
    res = float(state.res)
    converged = bool(state.done)
    v = state.v.cpu().numpy()
    gap = res / (1.0 - gamma)
    if converged and opts.stop_criterion == "span" and gamma < 1.0:
        # Midpoint correction (Puterman §6.6): with d = T v - v,
        # T v + gamma/(1-gamma) * min(d) <= v* <= T v + gamma/(1-gamma) *
        # max(d), so the midpoint-shifted T v carries the certified bound
        # gamma * sp(d) / (2 * (1-gamma)).  A constant shift: the policy is
        # untouched.
        tv = state.tv.cpu().numpy()
        d = tv - v
        scale = gamma / (1.0 - gamma)
        v = tv + scale * (float(d.max()) + float(d.min())) / 2.0
        gap = scale * float(state.span) / 2.0
    return SolveResult(
        v=v,
        policy=state.pi.cpu().numpy(),
        residual=res,
        gap_bound=gap,
        converged=converged,
        outer_iterations=k,
        inner_iterations=state.inner_total,
        trace_residual=state.trace_res[:k + 1].cpu().numpy(),
        trace_inner=state.trace_inner[:k].cpu().numpy(),
        diverged=bool(state.diverged),
        span=float(state.span))


def _drain_monitor(mid: int, state: SolveState, k_prev: int) -> None:
    """``monitor_mode="chunk"``: rebuild this chunk's per-iteration
    records from the residual and inner traces — record for record (``k``
    / ``res`` / ``inner`` / ``diverged``) what ``"stream"`` emits
    (``elapsed`` is the drain time).  ``k_prev`` is the pre-chunk outer
    count."""
    k = state.k
    tr = state.trace_res[:k + 1].cpu().numpy()
    ti = state.trace_inner[:k].cpu().numpy()
    div = bool(state.diverged)
    for kk in range(k_prev + 1, k + 1):
        # diverged flips exactly at the iteration the loop stopped on, so
        # only the final record can carry it, as in the stream
        methods.emit_host(mid, kk, float(tr[kk]), max(int(ti[kk - 1]), 0),
                          div and kk == k)


def _state_like(n: int, opts: IPIOptions) -> list[tuple]:
    """``(shape, numpy dtype)`` of each checkpoint leaf of a solve of
    ``n`` states under ``opts`` (the reference's ``eval_shape`` of its
    initial state)."""
    dt = np.dtype(opts.dtype)
    i32, b = np.dtype(np.int32), np.dtype(np.bool_)
    return [((n,), dt), ((n,), dt), ((n,), i32), ((), dt), ((), i32),
            ((), i32), ((opts.max_outer + 1,), dt), ((opts.max_outer,), i32),
            ((), dt), ((), dt), ((), b), ((), b), ((), i32), ((0,), dt)]


def _trim_ckpt_state(state: SolveState, n_orig: int) -> list[np.ndarray]:
    """The solver state in its checkpoint form: host arrays in the
    reference's leaf order, with ``k`` / ``inner_total`` as 0-d int32,
    ``n_true = n_orig`` and the (asynchronous methods') exchanged window
    empty, as the reference writes it.  One device pads nothing, so no
    leaf needs trimming."""
    host = lambda t: t.detach().cpu().numpy()
    v = host(state.v)
    return [v, host(state.tv), host(state.pi), host(state.res),
            np.int32(state.k), np.int32(state.inner_total),
            host(state.trace_res), host(state.trace_inner), host(state.res0),
            host(state.span), host(state.done), host(state.diverged),
            np.int32(n_orig), np.zeros((0,), v.dtype)]


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
    return SolveState(
        v=put(f["v"]), tv=put(f["tv"]), pi=put(f["pi"]), res=put(f["res"]),
        k=int(f["k"]), inner_total=int(f["inner_total"]),
        trace_res=put(f["trace_res"]), trace_inner=put(f["trace_inner"]),
        res0=put(f["res0"]), span=put(f["span"]), done=put(f["done"]),
        diverged=put(f["diverged"]))


def _restore_or_init(init, like, dev: torch.device, checkpoint_dir,
                     verbose: bool, expect=None) -> SolveState:
    """The state restored from ``checkpoint_dir``'s newest valid step, or
    ``init()``.  ``expect`` maps checkpoint-meta keys (``n``) to the
    values this solve requires — a mismatch means the directory holds
    another problem's checkpoint, which zero-padding would otherwise
    silently absorb."""
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
            state = _state_from_leaves(_pad_restored(leaves, like), dev)
            if verbose:
                print(f"[driver] resumed at outer k={state.k}")
            return state
    return init()


def solve(mdp: MDP, opts: IPIOptions = IPIOptions(), *, v0=None,
          checkpoint_dir: str | None = None, chunk: int = 64,
          checkpoint_mode: str = "chunk", verbose: bool = False,
          monitor=None, device: str | torch.device = "cuda") -> SolveResult:
    """Solve an MDP until ``opts.stop_criterion`` is satisfied (default:
    ``||T v - v||_inf <= opts.atol``) on ``device``.

    The MDP's tables move to ``device`` if they are elsewhere; ``device``
    defaults to ``"cuda"`` and raises when no GPU is visible.

    ``monitor`` (used when ``opts.monitor`` is set) is a callable receiving
    one dict per outer iteration — ``{"k", "res", "inner", "diverged",
    "elapsed"}``; without one, records print PETSc-style
    (:func:`repro_torch.core.methods.print_monitor`).  The first record is
    the k=0 (or resume-point) one.

    ``checkpoint_dir`` persists the state in the reference's format and
    resumes from its newest valid step.  ``checkpoint_mode="chunk"``
    (default) writes after every chunk; ``"interrupt"`` writes only when
    the solve stops early on divergence.
    """
    if not isinstance(mdp, (EllMDP, DenseMDP)):
        raise TypeError(f"solve() takes an EllMDP or a DenseMDP (batched "
                        f"and matrix-free MDPs are not yet ported), got "
                        f"{type(mdp).__name__}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if checkpoint_mode not in ("chunk", "interrupt"):
        raise ValueError(f"checkpoint_mode={checkpoint_mode!r}: expected "
                         f"'chunk' or 'interrupt'")
    dev = resolve_device(device)
    dev_mdp = mdp.to(dev)
    axes = Axes()
    n_orig = mdp.n_global
    state = _restore_or_init(
        lambda: ipi.init_state(dev_mdp, axes, opts, v0),
        _state_like(n_orig, opts), dev, checkpoint_dir, verbose,
        expect=dict(n=n_orig))
    save_each = bool(checkpoint_dir) and checkpoint_mode == "chunk"

    def save_state() -> None:
        ckpt.save(checkpoint_dir, state.k, _trim_ckpt_state(state, n_orig),
                  meta=dict(method=opts.method, n=n_orig),
                  treedef=_CKPT_TREEDEF)

    mid = 0
    if opts.monitor:
        mid = methods.monitor_handle(monitor or methods.print_monitor)
    stream = None
    if mid and opts.monitor_mode == "stream":
        stream = lambda k, res, inner, div: methods.emit_host(
            mid, k, res, inner, div)
    try:
        stop, res, div = ipi.stop_flags(state)
        if mid:   # the k=0 (or resume-point) record
            methods.emit_host(mid, state.k, res, 0)
        while True:
            k = state.k
            if verbose:
                print(f"[driver] k={k} residual={res:.3e}"
                      + (" DIVERGED" if div else ""))
            # converged, a NaN residual (inner-solver breakdown) or a
            # diverged flag: bail out, do not spin.
            if stop or k >= opts.max_outer:
                # a NaN-poisoned state is not worth persisting
                if div and not np.isnan(res) and checkpoint_dir \
                        and not save_each:
                    save_state()
                break
            state = ipi.solve_chunk(dev_mdp, state,
                                    min(k + chunk, opts.max_outer), opts,
                                    axes, on_step=stream)
            if mid and opts.monitor_mode == "chunk":
                _drain_monitor(mid, state, k)
            if save_each:
                save_state()
            stop, res, div = ipi.stop_flags(state)
    finally:
        if mid:
            methods.monitor_release(mid)
    return _result(state, opts, mdp.gamma)
