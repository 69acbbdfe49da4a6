"""The pluggable solution-method surface (madupite / PETSc-KSP style).

Counterpart of :mod:`repro.api.methods`: the user-facing face of the live
registries in :mod:`repro_torch.core.methods`.  Register an inner linear
solver, an outer method or a stopping criterion once, and it is selectable
everywhere options are read — Python (``Options`` / ``Session``), the
``MADUPITE_OPTIONS`` environment variable and the CLI's ``--option k=v``:

    from repro_torch.api import MDP, madupite_session, register_ksp

    def my_solver(matvec, b, x0, *, tol, maxiter, axes):
        ...torch ops on the solve device...
        return x, iters, resnorm

    register_ksp("mysolver", my_solver)       # also registers ipi_mysolver

    with madupite_session({"-ksp_type": "mysolver"}) as s:
        r = s.solve(MDP.from_generator("garnet", n=10_000, m=16, k=8))

Contracts
---------
* **KSP** — ``fn(matvec, b, x0, *, tol, maxiter, axes) -> (x, iters,
  resnorm)`` over torch tensors on the solve device; optionally accepts
  ``opts`` (the :class:`repro_torch.core.ipi.IPIOptions`), ``context``
  (``{"gamma": ...}``) and ``precond`` (with ``preconditioned=True``).
* **Method** — a KSP name plus an inner-stopping policy: ``forcing``
  (iPI forcing term), ``sweeps`` (fixed ``mpi_sweeps``), ``tight``
  (``0.01 * atol``), ``none`` (pure VI).
* **Stop criterion** — ``fn(m: StopMetrics) -> bool`` (True where
  converged).  ``Session.solve(stop_criterion=callable)`` registers
  anonymous predicates automatically.

The tables (:func:`method_table`, :func:`ksp_table`, :func:`stop_table`,
:func:`repro_torch.api.option_table`) render the registries for the docs.
"""

from __future__ import annotations

from repro_torch.core.methods import (
    KSPSpec, MethodSpec, StopMetrics, StopSpec,
    check_ksp, check_method, check_stop,
    get_ksp, get_method, get_stop,
    ksp_names, method_names, method_for_ksp, print_monitor,
    register_ksp, register_method, register_stop_criterion, stop_names,
    unregister_ksp, unregister_method, unregister_stop_criterion,
)

__all__ = [
    "KSPSpec", "MethodSpec", "StopMetrics", "StopSpec",
    "check_ksp", "check_method", "check_stop",
    "get_ksp", "get_method", "get_stop",
    "ksp_names", "ksp_table", "method_for_ksp", "method_names",
    "method_table", "print_monitor",
    "register_ksp", "register_method", "register_stop_criterion",
    "stop_names", "stop_table",
    "unregister_ksp", "unregister_method", "unregister_stop_criterion",
]

_INNER_DOC = {
    "none": "—",
    "forcing": "forcing: `eta * res`",
    "sweeps": "fixed: `mpi_sweeps`",
    "tight": "tight: `0.01 * atol`",
}


def method_table(*, builtin_only: bool = True) -> str:
    """The method registry as a markdown table (``builtin_only`` keeps
    runtime registrations out of the docs)."""
    lines = ["| method | inner solver (ksp) | inner stop | safeguard "
             "| description |",
             "|--------|--------------------|------------|-----------"
             "|-------------|"]
    for name in method_names(builtin_only=builtin_only):
        s = get_method(name)
        ksp = "—" if s.ksp is None else f"`{s.ksp}`"
        guard = "yes" if (s.safeguarded and s.ksp is not None) else "—"
        lines.append(f"| `{s.name}` | {ksp} | {_INNER_DOC[s.inner]} | "
                     f"{guard} | {s.doc.replace('|', chr(92) + '|')} |")
    return "\n".join(lines)


def ksp_table(*, builtin_only: bool = True) -> str:
    """The inner-solver (KSP) registry as a markdown table."""
    lines = ["| ksp | deterministic_dots | precond | description |",
             "|-----|--------------------|---------|-------------|"]
    for name in ksp_names(builtin_only=builtin_only):
        s = get_ksp(name)
        det = "yes" if s.deterministic else "—"
        pc = "yes" if s.preconditioned else "—"
        lines.append(f"| `{s.name}` | {det} | {pc} | "
                     f"{s.doc.replace('|', chr(92) + '|')} |")
    return "\n".join(lines)


def stop_table(*, builtin_only: bool = True) -> str:
    """The stopping-criterion registry as a markdown table."""
    lines = ["| criterion | description |",
             "|-----------|-------------|"]
    for name in stop_names(builtin_only=builtin_only):
        s = get_stop(name)
        lines.append(f"| `{s.name}` | {s.doc.replace('|', chr(92) + '|')} |")
    return "\n".join(lines)
