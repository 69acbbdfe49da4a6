"""Solution methods: inner KSPs, outer methods and stopping criteria.

Counterpart of :mod:`repro.core.methods`, builtin subset.  The reference
keeps live registries users extend (``register_ksp`` & co.); this slice
ports the builtin entries the main path uses, with the reference's names,
records and error messages:

* KSPs ``richardson`` and ``gmres``;
* methods ``vi``, ``mpi``, ``ipi_richardson``, ``ipi_gmres``, ``pi``;
* stop criteria ``atol``, ``rtol``, ``span``;
* :func:`inner_solve` and :func:`stop_done`.

User registration, monitors and the other KSPs wait for later slices.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Callable

import numpy as np
import torch

from repro_torch.core.comm import Axes
from repro_torch.core.solvers import gmres, richardson

@dataclasses.dataclass(frozen=True)
class KSPSpec:
    """One inner linear solver: ``fn(matvec, b, x0, *, tol, maxiter, axes,
    opts) -> (x, iters, res)``."""

    name: str
    fn: Callable
    doc: str = ""


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One outer method: a KSP plus an inner-stopping policy."""

    name: str
    ksp: str | None              # None -> no inner solve
    inner: str = "forcing"       # none | forcing (eta * res) | sweeps
    #                              (mpi_sweeps fixed) | tight (0.01 * atol)
    safeguarded: bool = True     # monotone VI-fallback applies
    doc: str = ""


@dataclasses.dataclass(frozen=True)
class StopMetrics:
    """Per-outer-iteration quantities a stopping criterion may read."""

    res: torch.Tensor       # ||T v - v||_inf
    span: torch.Tensor      # sp(T v - v) (inf unless needs_span)
    res0: torch.Tensor      # residual at k = 0 (rtol baseline)
    k: int                  # outer iterations done
    gamma: float
    atol: float
    rtol: float


@dataclasses.dataclass(frozen=True)
class StopSpec:
    """One outer stopping criterion."""

    name: str
    fn: Callable[[StopMetrics], torch.Tensor]   # True -> converged
    needs_span: bool = False
    doc: str = ""


_KSPS: dict[str, KSPSpec] = {}
_METHODS: dict[str, MethodSpec] = {}
_STOPS: dict[str, StopSpec] = {}


def _add(registry: dict, spec) -> None:
    registry[spec.name] = spec


# --------------------------------------------------------------------------- #
# Lookup / validation                                                         #
# --------------------------------------------------------------------------- #

def ksp_names() -> tuple[str, ...]:
    return tuple(_KSPS)


def method_names() -> tuple[str, ...]:
    return tuple(_METHODS)


def stop_names() -> tuple[str, ...]:
    return tuple(_STOPS)


def suggest(name, candidates) -> str:
    """Shared '; did you mean ...?' hint, or '' when nothing is close."""
    close = difflib.get_close_matches(str(name),
                                      [str(c) for c in candidates], n=3)
    return f"; did you mean {' / '.join(repr(c) for c in close)}?" \
        if close else ""


def _unknown(kind: str, name, names) -> str:
    return (f"unknown {kind} {name!r}{suggest(name, names)} (registered: "
            f"{', '.join(sorted(names))})")


def check_ksp(name) -> str | None:
    """None if known, else an actionable error message."""
    return None if name in _KSPS else _unknown("ksp", name, list(_KSPS))


def check_method(name) -> str | None:
    return None if name in _METHODS else _unknown("method", name,
                                                  list(_METHODS))


def check_stop(name) -> str | None:
    return None if name in _STOPS else _unknown("stop criterion", name,
                                                list(_STOPS))


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
    """The ``-ksp_type`` sugar: ``none`` -> ``vi``, else ``ipi_<ksp>``."""
    if ksp == "none":
        return "vi"
    err = check_ksp(ksp)
    if err:
        raise ValueError(err)
    return f"ipi_{ksp}"


# --------------------------------------------------------------------------- #
# Dispatch: the inner solve and the outer stopping decision                   #
# --------------------------------------------------------------------------- #

def inner_solve(opts, matvec, b, x0, forcing_tol, axes: Axes):
    """Run ``opts.method``'s inner policy-evaluation solve.

    Returns ``(x, iters, resnorm)``.  ``forcing_tol`` is the iPI forcing
    term ``eta * ||T v - v||_inf`` (already floored); the method's inner
    policy decides whether it, a fixed sweep count, or a tight absolute
    tolerance bounds the KSP.  Tolerances keep the reference's dtypes
    (a float32 ``0`` for sweeps, ``float32(atol) * 0.01`` for tight).
    """
    spec = get_method(opts.method)
    if spec.ksp is None:
        return x0, 0, torch.tensor(float("inf"), dtype=torch.float32)
    ksp = get_ksp(spec.ksp)
    dev = x0.device
    if spec.inner == "sweeps":
        tol = torch.tensor(0.0, dtype=torch.float32, device=dev)
        maxiter = max(opts.mpi_sweeps - 1, 0)
    elif spec.inner == "tight":
        tol = torch.tensor(np.float32(opts.atol), device=dev) * 0.01
        maxiter = opts.max_inner
    else:
        tol, maxiter = forcing_tol, opts.max_inner
    return ksp.fn(matvec, b, x0, tol=tol, maxiter=maxiter, axes=axes,
                  opts=opts)


def stop_done(opts, *, res, span, res0, k, gamma) -> torch.Tensor:
    """Evaluate ``opts.stop_criterion`` -> 0-d bool "converged".  NaN
    residuals never converge."""
    spec = get_stop(opts.stop_criterion)
    m = StopMetrics(res=res, span=span, res0=res0, k=k, gamma=gamma,
                    atol=opts.atol, rtol=opts.rtol)
    return torch.as_tensor(spec.fn(m)) & ~torch.isnan(res)


# --------------------------------------------------------------------------- #
# Builtins                                                                    #
# --------------------------------------------------------------------------- #

_add(_KSPS, KSPSpec(
    "richardson",
    lambda mv, b, x0, *, tol, maxiter, axes, opts:
        richardson(mv, b, x0, tol=tol, maxiter=maxiter, axes=axes,
                   omega=opts.omega),
    doc="(damped) Richardson iteration == repeated T_pi sweeps"))
_add(_KSPS, KSPSpec(
    "gmres",
    lambda mv, b, x0, *, tol, maxiter, axes, opts:
        gmres(mv, b, x0, tol=tol, maxiter=maxiter, axes=axes,
              restart=opts.restart),
    doc="restarted GMRES (CGS2 + Givens) — the iGMRES-PI inner solver"))

_add(_METHODS, MethodSpec("vi", ksp=None, inner="none", safeguarded=False,
                          doc="value iteration (0 inner sweeps)"))
_add(_METHODS, MethodSpec(
    "mpi", ksp="richardson", inner="sweeps", safeguarded=False,
    doc="modified policy iteration (mpi_sweeps fixed sweeps)"))
_add(_METHODS, MethodSpec(
    "ipi_richardson", ksp="richardson", inner="forcing", safeguarded=False,
    doc="iPI + Richardson to the forcing tolerance"))
_add(_METHODS, MethodSpec(
    "ipi_gmres", ksp="gmres", inner="forcing", safeguarded=True,
    doc="iPI + restarted GMRES (the paper's iGMRES-PI)"))
_add(_METHODS, MethodSpec(
    "pi", ksp="gmres", inner="tight", safeguarded=True,
    doc="(near-)exact policy iteration (GMRES at 0.01 * atol)"))

_add(_STOPS, StopSpec("atol", lambda m: m.res <= m.atol,
                      doc="sup-norm residual: ||T v - v||_inf <= atol"))
_add(_STOPS, StopSpec("rtol", lambda m: m.res <= m.rtol * m.res0,
                      doc="relative residual: ||T v - v||_inf <= rtol * "
                          "(initial residual)"))
_add(_STOPS, StopSpec("span", lambda m: m.span <= m.atol, needs_span=True,
                      doc="span seminorm: sp(T v - v) = max - min <= atol"))

__all__ = ["KSPSpec", "MethodSpec", "StopMetrics", "StopSpec",
           "ksp_names", "method_names", "stop_names", "get_ksp",
           "get_method", "get_stop", "check_ksp", "check_method",
           "check_stop", "method_for_ksp", "inner_solve", "stop_done",
           "suggest"]
