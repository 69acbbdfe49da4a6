"""Pluggable solution methods: inner KSPs, outer methods, stop criteria.

Counterpart of :mod:`repro.core.methods`, with the reference's names,
records and error messages.  Three live registries:

* **KSP registry** — inner linear solvers for ``(I - gamma P_pi) x =
  g_pi`` with the contract ``fn(matvec, b, x0, *, tol, maxiter, axes) ->
  (x, iters, resnorm)``, optionally also taking ``opts`` (the
  :class:`~repro_torch.core.ipi.IPIOptions`), ``context`` (per-solve
  values, ``{"gamma": ...}``) and ``precond`` (the ``-pc_type`` apply).
  Registering ``name`` also registers the outer method ``ipi_<name>``
  unless ``auto_method=False``.
* **Method registry** — which KSP runs the inexact policy-evaluation step
  and under which inner-stopping policy (``forcing`` / ``sweeps`` /
  ``tight`` / ``none``), and whether the monotone safeguard applies.
* **Stop-criterion registry** — outer stopping predicates over
  :class:`StopMetrics`: ``atol``, ``rtol``, ``span``, ``probe`` and user
  predicates.

A user's KSP or predicate runs eagerly on torch tensors on the solve
device; nothing is traced or compiled.  The port keeps no compiled
programs either, but the :func:`on_overwrite_clear` hook stays for
callers that cache something keyed by a registered name.

The monitor dispatch table also lives here: the solve's host loop emits
one record per outer iteration (:func:`emit_host`) to the monitor
registered under an integer id (:func:`monitor_handle`); a fleet's record
holds one entry a lane.

Fleets (:func:`inner_solve`; an unbatched solve is the fleet of one): a
KSP registered with a batched form (``KSPSpec.fleet``: Richardson, GMRES,
BiCGStab) solves all lanes in lockstep through the kernels' lane axis;
any other KSP (Chebyshev, Anderson, user KSPs) runs lane by lane, its
unbatched form on each live lane's own system — each lane's result is
its independent solve's.
"""

from __future__ import annotations

import dataclasses
import difflib
import inspect
import itertools
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.core.comm import Axes
from repro_torch.core.solvers import (anderson, async_vi_outer, bicgstab,
                                      bicgstab_fleet, chebyshev, gmres,
                                      gmres_fleet, richardson,
                                      richardson_fleet)

__all__ = [
    "KSPSpec", "MethodSpec", "StopMetrics", "StopSpec",
    "register_ksp", "register_method", "register_stop_criterion",
    "unregister_ksp", "unregister_method", "unregister_stop_criterion",
    "ksp_names", "method_names", "stop_names",
    "get_ksp", "get_method", "get_stop", "method_for_ksp",
    "check_ksp", "check_method", "check_stop",
    "inner_solve", "stop_done", "adhoc_stop_criterion",
    "suggest",
    "monitor_handle", "monitor_release", "emit_host", "print_monitor",
]

INNER_POLICIES = ("none", "forcing", "sweeps", "tight")


# --------------------------------------------------------------------------- #
# Registry records                                                            #
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class KSPSpec:
    """One registered inner linear solver."""

    name: str
    fn: Callable                 # normalized: fn(matvec, b, x0, tol, maxiter,
    #                              axes, opts, context, precond)
    #                              -> (x, iters, res)
    doc: str = ""
    deterministic: bool = False  # honors -deterministic_dots (fixed
    #                              accumulation orders)
    builtin: bool = False
    preconditioned: bool = False  # accepts a `precond` apply (-pc_type)
    fleet: Callable | None = None  # batched form over (B, n) systems:
    #                                fleet(matvec, b, x0, tol, maxiter,
    #                                axes, opts, precond, live)
    #                                -> (x, iters (B,), res (B,))

    def call(self, matvec, b, x0, *, tol, maxiter, axes, opts, context,
             precond=None):
        return self.fn(matvec, b, x0, tol, maxiter, axes, opts, context,
                       precond)


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One registered outer method: a KSP plus an inner-stopping policy."""

    name: str
    ksp: str | None              # KSP registry name; None -> no inner solve
    inner: str = "forcing"       # none | forcing (eta * res) | sweeps
    #                              (mpi_sweeps fixed) | tight (0.01 * atol)
    safeguarded: bool = True     # monotone VI-fallback applies (Krylov-type
    #                              steps are not contractions)
    doc: str = ""
    builtin: bool = False
    outer: Callable | None = None  # custom outer iteration replacing the
    #                                inner-solve/backup core (async_vi):
    #                                outer(mdp, state, opts, axes, gamma_t)
    #                                -> (v1, tv1, pi1, res1, inner, win1)
    virtual: bool = False        # meta-method (e.g. "auto"): validates in the
    #                              options layer but is resolved to a concrete
    #                              method by repro_torch.adaptive before any
    #                              solve loop runs; driver.solve rejects it


@dataclasses.dataclass(frozen=True)
class StopMetrics:
    """Per-outer-iteration quantities a stopping criterion may read (for a
    fleet, ``(B,)`` tensors: one value a lane)."""

    res: torch.Tensor       # ||T v - v||_inf (the Bellman residual)
    span: torch.Tensor      # sp(T v - v) = max - min (inf unless the
    #                         criterion declared needs_span)
    res0: torch.Tensor      # residual at k = 0 (rtol baseline)
    k: int | torch.Tensor   # outer iterations done
    gamma: float | torch.Tensor
    atol: float
    rtol: float


@dataclasses.dataclass(frozen=True)
class StopSpec:
    """One registered outer stopping criterion."""

    name: str
    fn: Callable[[StopMetrics], torch.Tensor]   # True -> converged (stop)
    needs_span: bool = False   # compute the span seminorm each iteration
    doc: str = ""
    builtin: bool = False


_KSPS: dict[str, KSPSpec] = {}
_METHODS: dict[str, MethodSpec] = {}
_STOPS: dict[str, StopSpec] = {}


# --------------------------------------------------------------------------- #
# Registration                                                                #
# --------------------------------------------------------------------------- #

def _normalize_ksp_fn(fn: Callable) -> Callable:
    """Adapt a user solver to the internal calling convention.

    ``fn(matvec, b, x0, *, tol, maxiter, axes)`` is the minimal contract;
    ``opts``, ``context`` and ``precond`` are forwarded only when the
    signature accepts them (or has ``**kwargs``).
    """
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):       # builtins / C callables: send all
        params = None
    var_kw = params is not None and any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())
    accepts = (lambda name: True) if (params is None or var_kw) else \
        (lambda name: name in params)

    def call(matvec, b, x0, tol, maxiter, axes, opts, context, precond=None):
        kw = dict(tol=tol, maxiter=maxiter, axes=axes)
        if accepts("opts"):
            kw["opts"] = opts
        if accepts("context"):
            kw["context"] = context
        if accepts("precond"):
            kw["precond"] = precond
        return fn(matvec, b, x0, **kw)

    return call


# Hooks run when a registered name is REPLACED (overwrite=True), for
# callers that cache anything keyed by a registered name.
_CACHE_CLEARERS: list[Callable[[], None]] = []


def on_overwrite_clear(fn: Callable[[], None]) -> None:
    _CACHE_CLEARERS.append(fn)


def _check_free(registry: Mapping[str, Any], kind: str, name: str,
                overwrite: bool) -> None:
    if not isinstance(name, str) or not name or not name.strip() == name:
        raise ValueError(f"{kind} names are non-empty strings, got {name!r}")
    prior = registry.get(name)
    if prior is not None and not overwrite:
        who = "builtin" if prior.builtin else "already-registered"
        raise ValueError(
            f"{kind} {name!r} is {who}; pass overwrite=True to replace it "
            f"(compiled solve caches are cleared automatically)")
    if prior is not None:
        for clear in _CACHE_CLEARERS:
            clear()


def register_ksp(name: str, fn: Callable | None = None, *, doc: str = "",
                 deterministic: bool = False, auto_method: bool = True,
                 preconditioned: bool = False,
                 overwrite: bool = False, _builtin: bool = False,
                 _fleet: Callable | None = None):
    """Register an inner linear solver (usable as a decorator).

    ``fn(matvec, b, x0, *, tol, maxiter, axes)`` returns ``(x, iters,
    resnorm)``.  With ``auto_method=True`` the outer method ``ipi_<name>``
    is also registered (forcing-term inner stopping, safeguarded).
    ``deterministic=True`` declares fixed accumulation orders (legal under
    ``-deterministic_dots``); ``preconditioned=True`` declares a
    ``precond`` keyword (an apply ``x -> M x``), so ``-pc_type`` applies.
    """
    if fn is None:
        return lambda f: register_ksp(name, f, doc=doc,
                                      deterministic=deterministic,
                                      auto_method=auto_method,
                                      preconditioned=preconditioned,
                                      overwrite=overwrite, _builtin=_builtin,
                                      _fleet=_fleet)
    _check_free(_KSPS, "ksp", name, overwrite)
    spec = KSPSpec(name=name, fn=_normalize_ksp_fn(fn),
                   doc=doc or (fn.__doc__ or "").strip().split("\n")[0],
                   deterministic=deterministic, builtin=_builtin,
                   preconditioned=preconditioned, fleet=_fleet)
    _KSPS[name] = spec
    if auto_method and f"ipi_{name}" not in _METHODS:
        register_method(f"ipi_{name}", ksp=name, inner="forcing",
                        safeguarded=True,
                        doc=f"iPI with {name} inner solves (auto-registered)",
                        _builtin=_builtin)
    return fn


def register_method(name: str, *, ksp: str | None, inner: str = "forcing",
                    safeguarded: bool = True, doc: str = "",
                    outer: Callable | None = None, virtual: bool = False,
                    overwrite: bool = False, _builtin: bool = False) \
        -> MethodSpec:
    """Register an outer method: which KSP runs the policy-evaluation step
    and under which inner-stopping policy (see :data:`INNER_POLICIES`) —
    or, with ``outer``, a full custom outer iteration (e.g. ``async_vi``)
    that replaces the inner-solve/backup core entirely.  ``virtual=True``
    marks a meta-method (like the builtin ``auto``) that never reaches a
    solve loop itself: the adaptive layer resolves it to a concrete
    method first."""
    _check_free(_METHODS, "method", name, overwrite)
    if inner not in INNER_POLICIES:
        raise ValueError(f"inner policy must be one of {INNER_POLICIES}, "
                         f"got {inner!r}")
    if ksp is not None and ksp not in _KSPS:
        raise ValueError(check_ksp(ksp))
    if outer is not None and ksp is not None:
        raise ValueError(f"method {name!r}: a custom outer iteration "
                         f"replaces the inner solve — pass ksp=None")
    if virtual and (ksp is not None or outer is not None):
        raise ValueError(f"method {name!r}: virtual methods carry no "
                         f"solver — pass ksp=None, outer=None")
    if (ksp is None) != (inner == "none"):
        raise ValueError(f"method {name!r}: ksp=None requires inner='none' "
                         f"(and vice versa), got ksp={ksp!r} inner={inner!r}")
    spec = MethodSpec(name=name, ksp=ksp, inner=inner,
                      safeguarded=safeguarded, doc=doc, builtin=_builtin,
                      outer=outer, virtual=virtual)
    _METHODS[name] = spec
    return spec


def register_stop_criterion(name: str, fn: Callable[[StopMetrics],
                                                    torch.Tensor]
                            | None = None, *, needs_span: bool = False,
                            doc: str = "", overwrite: bool = False,
                            _builtin: bool = False):
    """Register an outer stopping criterion (usable as a decorator).

    ``fn(metrics: StopMetrics) -> bool tensor`` returns True where the
    solve has converged.  NaN residuals never count as converged
    (enforced outside the predicate).
    """
    if fn is None:
        return lambda f: register_stop_criterion(
            name, f, needs_span=needs_span, doc=doc, overwrite=overwrite,
            _builtin=_builtin)
    _check_free(_STOPS, "stop criterion", name, overwrite)
    _STOPS[name] = StopSpec(name=name, fn=fn, needs_span=needs_span,
                            doc=doc or (fn.__doc__ or "").strip()
                            .split("\n")[0], builtin=_builtin)
    return fn


def _unregister(registry: dict, kind: str, name: str) -> None:
    spec = registry.get(name)
    if spec is None:
        return
    if spec.builtin:
        raise ValueError(f"refusing to unregister builtin {kind} {name!r}")
    del registry[name]


def unregister_ksp(name: str) -> None:
    """Remove a user-registered KSP (and its auto-method, if still its)."""
    _unregister(_KSPS, "ksp", name)
    auto = _METHODS.get(f"ipi_{name}")
    if auto is not None and not auto.builtin and auto.ksp == name:
        del _METHODS[f"ipi_{name}"]


def unregister_method(name: str) -> None:
    _unregister(_METHODS, "method", name)


def unregister_stop_criterion(name: str) -> None:
    _unregister(_STOPS, "stop criterion", name)


# --------------------------------------------------------------------------- #
# Lookup / validation                                                         #
# --------------------------------------------------------------------------- #

def ksp_names(*, builtin_only: bool = False) -> tuple[str, ...]:
    return tuple(n for n, s in _KSPS.items()
                 if s.builtin or not builtin_only)


def method_names(*, builtin_only: bool = False) -> tuple[str, ...]:
    return tuple(n for n, s in _METHODS.items()
                 if s.builtin or not builtin_only)


def stop_names(*, builtin_only: bool = False) -> tuple[str, ...]:
    return tuple(n for n, s in _STOPS.items()
                 if s.builtin or not builtin_only)


def suggest(name, candidates) -> str:
    """Shared '; did you mean ...?' hint (difflib over the live candidate
    names), or '' when nothing is close."""
    close = difflib.get_close_matches(str(name),
                                      [str(c) for c in candidates], n=3)
    return f"; did you mean {' / '.join(repr(c) for c in close)}?" \
        if close else ""


def _unknown(kind: str, name, names, register_hint: str) -> str:
    return (f"unknown {kind} {name!r}{suggest(name, names)} (registered: "
            f"{', '.join(sorted(names))}; extend with "
            f"repro_torch.api.{register_hint})")


def check_ksp(name) -> str | None:
    """None if registered, else an actionable error message with
    close-spelling suggestions drawn from the live registry."""
    if name in _KSPS:
        return None
    return _unknown("ksp", name, list(_KSPS), "register_ksp")


def check_method(name) -> str | None:
    if name in _METHODS:
        return None
    return _unknown("method", name, list(_METHODS), "register_method")


def check_stop(name) -> str | None:
    if name in _STOPS:
        return None
    return _unknown("stop criterion", name, list(_STOPS),
                    "register_stop_criterion")


def get_ksp(name: str) -> KSPSpec:
    err = check_ksp(name)
    if err:
        raise ValueError(err)
    return _KSPS[name]


def get_method(name: str) -> MethodSpec:
    err = check_method(name)
    if err:
        raise ValueError(err)
    return _METHODS[name]


def get_stop(name: str) -> StopSpec:
    err = check_stop(name)
    if err:
        raise ValueError(err)
    return _STOPS[name]


def method_for_ksp(ksp: str) -> str:
    """The ``-ksp_type`` sugar: the outer method a bare KSP choice picks
    (``none`` -> ``vi``, else ``ipi_<ksp>``)."""
    if ksp == "none":
        return "vi"
    err = check_ksp(ksp)
    if err:
        raise ValueError(err)
    name = f"ipi_{ksp}"
    if name not in _METHODS:     # registered with auto_method=False
        raise ValueError(
            f"ksp {ksp!r} has no ipi_{ksp} method registered; register one "
            f"with repro_torch.api.register_method(ksp={ksp!r}, ...) or "
            f"select a -method directly")
    return name


# --------------------------------------------------------------------------- #
# Dispatch: the inner solve and the outer stopping decision                   #
# --------------------------------------------------------------------------- #

def _inner_bounds(opts, spec: MethodSpec, forcing_tol, dev):
    """``(tol, maxiter)`` of the method's inner policy; tolerances keep the
    reference's dtypes (a float32 ``0`` for sweeps, ``float32(atol) *
    0.01`` for tight)."""
    if spec.inner == "sweeps":
        return (torch.zeros((), dtype=torch.float32, device=dev),
                max(opts.mpi_sweeps - 1, 0))
    if spec.inner == "tight":
        return (torch.tensor(np.float32(opts.atol), device=dev) * 0.01,
                opts.max_inner)
    return forcing_tol, opts.max_inner


def inner_solve(opts, matvec, b, x0, forcing_tol, axes: Axes, *,
                live: torch.Tensor, live_lanes, lane, precond=None):
    """Run ``opts.method``'s inner policy-evaluation solve on a fleet of
    ``(B, n)`` systems (an unbatched solve is the fleet of one).

    ``forcing_tol`` is the iPI forcing term ``eta * ||T v - v||_inf``
    (``(B,)``, already floored); the method's inner policy decides whether
    it, a fixed sweep count, or a tight absolute tolerance bounds the KSP.
    Tolerances keep the reference's dtypes (a float32 ``0`` for sweeps,
    ``float32(atol) * 0.01`` for tight).  Lanes outside ``live`` (the
    frozen ones) are not solved and report 0 iterations.  A KSP with a
    batched form runs it on the batched ``matvec`` / ``precond``; any other
    KSP runs lane by lane over ``live_lanes`` (host indices), on ``lane(b)
    -> (matvec_b, context_b, precond_b)``, the lane's own unbatched system.
    ``precond`` reaches only KSPs that declared ``preconditioned=True``.
    Returns ``(x (B, n), iters (B,) int32 on the solve device)``.
    """
    spec = get_method(opts.method)
    dev = x0.device
    lanes = x0.shape[0]
    if spec.ksp is None:
        return x0, torch.zeros((lanes,), dtype=torch.int32, device=dev)
    ksp = get_ksp(spec.ksp)
    tol, maxiter = _inner_bounds(opts, spec, forcing_tol, dev)
    if ksp.fleet is not None:
        x, iters, _ = ksp.fleet(matvec, b, x0, tol, maxiter, axes, opts,
                                precond if ksp.preconditioned else None,
                                live)
        return x, iters
    x = x0.clone()
    iters = [0] * lanes
    for i in live_lanes:
        mv, context, pc = lane(i)
        x[i], it, _ = ksp.call(
            mv, b[i], x0[i], tol=tol[i] if tol.dim() else tol,
            maxiter=maxiter, axes=axes, opts=opts, context=context,
            precond=pc if ksp.preconditioned else None)
        iters[i] = int(it)
    return x, torch.tensor(iters, dtype=torch.int32, device=dev)


def stop_done(opts, *, res, span, res0, k, gamma) -> torch.Tensor:
    """Evaluate ``opts.stop_criterion`` -> bool "converged" (0-d, or
    elementwise over a fleet's lanes).  NaN residuals never converge."""
    spec = get_stop(opts.stop_criterion)
    m = StopMetrics(res=res, span=span, res0=res0, k=k, gamma=gamma,
                    atol=opts.atol, rtol=opts.rtol)
    return torch.as_tensor(spec.fn(m), device=res.device) & ~torch.isnan(res)


_ADHOC_STOPS: dict[int, str] = {}
_ADHOC_SEQ = itertools.count()

_ADHOC_LIMIT = 64


def adhoc_stop_criterion(fn: Callable[[StopMetrics], torch.Tensor], *,
                         needs_span: bool = True) -> str:
    """Register (once) an anonymous user predicate and return its registry
    name — how ``Session.solve(stop_criterion=callable)`` threads a
    predicate through the string-keyed options.

    The same callable maps to the same name.  Names are monotonic and
    never recycled onto different code; the table is bounded (the oldest
    entries beyond ``_ADHOC_LIMIT`` are evicted).  ``needs_span`` defaults
    to True so a predicate reading ``m.span`` sees real values."""
    key = id(fn)
    name = _ADHOC_STOPS.get(key)
    if name is not None and _STOPS.get(name) is not None \
            and _STOPS[name].fn is fn:
        return name
    while len(_ADHOC_STOPS) >= _ADHOC_LIMIT:
        old_key, old_name = next(iter(_ADHOC_STOPS.items()))
        del _ADHOC_STOPS[old_key]
        _STOPS.pop(old_name, None)
    name = f"custom_{next(_ADHOC_SEQ)}"
    register_stop_criterion(name, fn, needs_span=needs_span,
                            doc="ad-hoc user predicate")
    _ADHOC_STOPS[key] = name
    return name


# --------------------------------------------------------------------------- #
# Monitor dispatch                                                            #
# --------------------------------------------------------------------------- #

_MONITORS: dict[int, tuple[Callable, float]] = {}
_MONITOR_SEQ = itertools.count(1)        # 0 is reserved: "no monitor"


def monitor_handle(fn: Callable[[dict], None]) -> int:
    """Activate a monitor callable; returns the integer id records are
    emitted to (:func:`emit_host`)."""
    mid = next(_MONITOR_SEQ)
    _MONITORS[mid] = (fn, time.perf_counter())
    return mid


def monitor_release(mid: int) -> None:
    _MONITORS.pop(mid, None)


def _record(mid_entry, k, res, inner, diverged=False) -> dict:
    _, t0 = mid_entry
    res = np.asarray(res)
    if res.ndim:                           # a fleet: one entry a lane
        div = np.broadcast_to(np.asarray(diverged), res.shape)
        return dict(k=int(np.max(k)), res=[float(x) for x in res],
                    inner=[int(x) for x in np.asarray(inner)],
                    diverged=[bool(x) for x in div],
                    elapsed=time.perf_counter() - t0)
    return dict(k=int(k), res=float(res), inner=int(inner),
                diverged=bool(diverged), elapsed=time.perf_counter() - t0)


def emit_host(mid: int, k, res, inner, diverged=False) -> None:
    """Emit one record to monitor ``mid`` from the host loop; an exception
    in the monitor is printed and the record dropped, never raised into
    the solve."""
    try:
        entry = _MONITORS.get(int(mid))
        if entry is None:
            return
        entry[0](_record(entry, k, res, inner, diverged))
    except Exception as e:  # noqa: BLE001 — a monitor bug must not kill
        print(f"[monitor] callback error (record dropped): "  # the solve
              f"{type(e).__name__}: {e}")


def print_monitor(rec: dict) -> None:
    """The default ``-monitor`` sink (PETSc ``-ksp_monitor`` style lines)."""
    if isinstance(rec["res"], list):
        res = rec["res"]
        div = rec.get("diverged") or []
        flag = f" DIVERGED={sum(bool(d) for d in div)}" if any(div) else ""
        print(f"[monitor] k={rec['k']} res_max={max(res):.6e} "
              f"inner={sum(rec['inner'])} B={len(res)} "
              f"elapsed={rec['elapsed']:.3f}s{flag}", flush=True)
    else:
        flag = " DIVERGED" if rec.get("diverged") else ""
        print(f"[monitor] k={rec['k']} res={rec['res']:.6e} "
              f"inner={rec['inner']} elapsed={rec['elapsed']:.3f}s{flag}",
              flush=True)


# --------------------------------------------------------------------------- #
# Builtins                                                                    #
# --------------------------------------------------------------------------- #

register_ksp(
    "richardson",
    lambda mv, b, x0, *, tol, maxiter, axes, opts=None:
        richardson(mv, b, x0, tol=tol, maxiter=maxiter, axes=axes,
                   omega=opts.omega if opts is not None else 1.0),
    doc="(damped) Richardson iteration == repeated T_pi sweeps",
    deterministic=True, auto_method=False, _builtin=True,
    _fleet=lambda mv, b, x0, tol, maxiter, axes, opts, precond, live:
        richardson_fleet(mv, b, x0, tol=tol, maxiter=maxiter, axes=axes,
                         omega=opts.omega, live=live))

register_ksp(
    "gmres",
    lambda mv, b, x0, *, tol, maxiter, axes, opts=None, precond=None:
        gmres(mv, b, x0, tol=tol, maxiter=maxiter, axes=axes,
              restart=opts.restart if opts is not None else 32,
              deterministic=bool(opts.deterministic_dots) if opts is not None
              else False, precond=precond),
    doc="restarted GMRES (CGS2 + Givens) — the iGMRES-PI inner solver",
    deterministic=True, auto_method=False, preconditioned=True,
    _builtin=True,
    _fleet=lambda mv, b, x0, tol, maxiter, axes, opts, precond, live:
        gmres_fleet(mv, b, x0, tol=tol, maxiter=maxiter, axes=axes,
                    restart=opts.restart,
                    deterministic=bool(opts.deterministic_dots),
                    precond=precond, live=live))

register_ksp(
    "bicgstab",
    lambda mv, b, x0, *, tol, maxiter, axes, precond=None:
        bicgstab(mv, b, x0, tol=tol, maxiter=maxiter, axes=axes,
                 precond=precond),
    doc="BiCGStab — O(1)-memory Krylov alternative",
    deterministic=False, auto_method=False, preconditioned=True,
    _builtin=True,
    _fleet=lambda mv, b, x0, tol, maxiter, axes, opts, precond, live:
        bicgstab_fleet(mv, b, x0, tol=tol, maxiter=maxiter, axes=axes,
                       precond=precond, live=live))

register_ksp(
    "chebyshev",
    lambda mv, b, x0, *, tol, maxiter, axes, context=None:
        chebyshev(mv, b, x0, tol=tol, maxiter=maxiter, axes=axes,
                  lo=1.0 - (context or {}).get("gamma", 0.999),
                  hi=1.0 + (context or {}).get("gamma", 0.999)),
    doc="Chebyshev semi-iteration on [1-gamma, 1+gamma] — no inner products",
    deterministic=True, auto_method=False, _builtin=True)

register_ksp(
    "anderson",
    lambda mv, b, x0, *, tol, maxiter, axes, opts=None:
        anderson(mv, b, x0, tol=tol, maxiter=maxiter, axes=axes,
                 window=opts.anderson_window if opts is not None else 5,
                 mixing=opts.omega if opts is not None else 1.0,
                 deterministic=bool(opts.deterministic_dots)
                 if opts is not None else False),
    doc="Anderson-accelerated VI (windowed residual extrapolation)",
    deterministic=True, auto_method=False, _builtin=True)

register_method("vi", ksp=None, inner="none", safeguarded=False,
                doc="value iteration (0 inner sweeps)", _builtin=True)
register_method("mpi", ksp="richardson", inner="sweeps", safeguarded=False,
                doc="modified policy iteration (mpi_sweeps fixed sweeps)",
                _builtin=True)
register_method("ipi_richardson", ksp="richardson", inner="forcing",
                safeguarded=False,
                doc="iPI + Richardson to the forcing tolerance",
                _builtin=True)
register_method("ipi_gmres", ksp="gmres", inner="forcing", safeguarded=True,
                doc="iPI + restarted GMRES (the paper's iGMRES-PI)",
                _builtin=True)
register_method("ipi_bicgstab", ksp="bicgstab", inner="forcing",
                safeguarded=True, doc="iPI + BiCGStab", _builtin=True)
register_method("pi", ksp="gmres", inner="tight", safeguarded=True,
                doc="(near-)exact policy iteration (GMRES at 0.01 * atol)",
                _builtin=True)
register_method("ipi_chebyshev", ksp="chebyshev", inner="forcing",
                safeguarded=True,
                doc="iPI + Chebyshev semi-iteration (collective-free inner)",
                _builtin=True)
register_method("ipi_anderson", ksp="anderson", inner="forcing",
                safeguarded=True, doc="iPI + Anderson-accelerated VI",
                _builtin=True)
register_method("async_vi", ksp=None, inner="none", safeguarded=False,
                outer=async_vi_outer,
                doc="asynchronous VI: async_sweeps stale local sweeps per "
                    "value exchange (span-certified)",
                _builtin=True)
register_method("auto", ksp=None, inner="none", safeguarded=False,
                virtual=True,
                doc="adaptive: probe the instance, then pick method / stop "
                    "criterion / preconditioner (repro.adaptive)",
                _builtin=True)


@register_stop_criterion("atol", _builtin=True)
def _stop_atol(m: StopMetrics):
    """sup-norm residual: ||T v - v||_inf <= atol."""
    return m.res <= m.atol


@register_stop_criterion("rtol", _builtin=True)
def _stop_rtol(m: StopMetrics):
    """relative residual: ||T v - v||_inf <= rtol * (initial residual)."""
    return m.res <= m.rtol * m.res0


@register_stop_criterion("probe", needs_span=True, _builtin=True)
def _stop_probe(m: StopMetrics):
    """adaptive probe phase: never stop early — fixed-length residual traces.

    Running exactly the probe's outer count keeps traces comparable across
    instances; span is recorded so a probe can read the span-vs-residual
    ratio."""
    return m.res <= 0.0


@register_stop_criterion("span", needs_span=True, _builtin=True)
def _stop_span(m: StopMetrics):
    """span seminorm: sp(T v - v) = max - min <= atol.

    Once the Bellman residual vector is nearly constant the greedy policy
    has stabilized: after the midpoint correction the value error is
    bounded by gamma * sp / (2 * (1 - gamma)), so span stopping certifies
    VI in far fewer outer iterations than ``atol`` at matched certificate
    scale."""
    return m.span <= m.atol
