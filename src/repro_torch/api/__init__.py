"""repro_torch.api — the user surface of the torch port (madupite-style).

* :class:`MDP` — ELL problems from arrays, files, the built-in
  generators or callables (``from_functions``: built on the device, on
  the host, or never — matrix-free), tagged ``mode="mincost"`` or
  ``"maxreward"``;
* :class:`Options` — the PETSc-style options database (the ported keys
  plus ``-device``), rendered by :func:`option_table`;
* :class:`Session` / :func:`madupite_session` — one options view, device
  placement, checkpoints, monitors, run statistics and outputs;
* the **method registries** — :func:`register_ksp` /
  :func:`register_method` / :func:`register_stop_criterion` plug user
  inner solvers, outer methods and stopping criteria into the solve,
  selectable from options everywhere (``-ksp_type`` / ``-method`` /
  ``-stop_criterion``).

    from repro_torch.api import MDP, madupite_session

    mdp = MDP.from_generator("garnet", n=10_000, m=16, k=8, gamma=0.99)
    with madupite_session({"-method": "ipi_gmres", "-atol": 1e-8}) as s:
        result = s.solve(mdp)          # on the GPU; "-device": "cpu" for host

Module-level :func:`solve` / :func:`solve_fleet` are one-shot
conveniences over a shared default session.
"""

from __future__ import annotations

from repro_torch.api.fleet import bucket_indices
from repro_torch.api.mdp import MDP, place_function_fleet
from repro_torch.api.methods import (StopMetrics, ksp_names, ksp_table,
                                     method_names, method_table,
                                     register_ksp, register_method,
                                     register_stop_criterion, stop_names,
                                     stop_table, unregister_ksp,
                                     unregister_method,
                                     unregister_stop_criterion)
from repro_torch.api.options import (OPTION_SPECS, Options, OptionTypeError,
                                     UnknownOptionError, option_table)
from repro_torch.api.session import Session, madupite_session

__all__ = ["MDP", "Options", "OptionTypeError", "OPTION_SPECS", "Session",
           "StopMetrics", "UnknownOptionError", "bucket_indices",
           "ksp_names", "ksp_table", "madupite_session", "method_names",
           "method_table", "option_table", "place_function_fleet",
           "register_ksp", "register_method", "register_stop_criterion",
           "solve", "solve_fleet", "stop_names", "stop_table",
           "unregister_ksp", "unregister_method",
           "unregister_stop_criterion"]

_default_session: Session | None = None


def _default() -> Session:
    global _default_session
    if _default_session is None or _default_session._closed:
        _default_session = Session()
    return _default_session


def solve(mdp, options=None, **overrides):
    """One-shot :meth:`Session.solve`: on a throwaway session when
    ``options`` is given, else on a shared default session (registry
    defaults and ``MADUPITE_OPTIONS``; ``-device cuda`` unless set)."""
    if options is not None:
        with Session(options) as s:
            return s.solve(mdp, **overrides)
    return _default().solve(mdp, **overrides)


def solve_fleet(mdps, options=None, **overrides):
    """One-shot :meth:`Session.solve_fleet`, on a throwaway session or the
    shared default one as :func:`solve` picks."""
    if options is not None:
        with Session(options) as s:
            return s.solve_fleet(mdps, **overrides)
    return _default().solve_fleet(mdps, **overrides)
