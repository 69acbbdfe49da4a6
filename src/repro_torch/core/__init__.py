"""Solver core of the torch port (:mod:`repro.core`'s solve engine: one
device, fleets on one device, or one MDP sharded over a
``torch.distributed`` world; tables stored or, matrix-free, rebuilt from
row constructors in every backup).

The supported user surface is :mod:`repro_torch.api` (MDP builders, the
options database, sessions)::

    from repro_torch.api import MDP, madupite_session
    mdp = MDP.from_generator("garnet", n=10_000, m=16, k=8, gamma=0.99)
    with madupite_session({"-method": "ipi_gmres", "-atol": 1e-8}) as s:
        result = s.solve(mdp)

As in the reference's package, ``repro_torch.core.solve`` /
``repro_torch.core.solve_many`` remain as deprecated aliases of the
engine entry points (:mod:`repro_torch.core.driver`): they work
unchanged but emit a ``DeprecationWarning`` pointing at the new API.
Fleets of generated instances come from
:func:`repro_torch.core.generators.generate_many`.
"""

import functools
import warnings

from repro_torch.core.comm import Axes
from repro_torch.core.driver import SolveResult
from repro_torch.core.driver import solve as _driver_solve
from repro_torch.core.driver import solve_many as _driver_solve_many
from repro_torch.core.ipi import IPIOptions, METHODS, MODES, SolveState
from repro_torch.core.mdp import DenseMDP, EllMDP, stack_mdps
from repro_torch.core import bellman, generators, methods, partition

__all__ = ["Axes", "DenseMDP", "EllMDP", "IPIOptions", "METHODS", "MODES",
           "SolveResult", "SolveState", "bellman", "generators", "methods",
           "partition", "solve", "solve_many", "stack_mdps"]


def _deprecated_shim(fn, name):
    @functools.wraps(fn)
    def shim(*args, **kwargs):
        warnings.warn(
            f"repro_torch.core.{name} is deprecated as a user entry point; "
            f"use repro_torch.api (MDP builders + madupite_session / "
            f"Session.{'solve_fleet' if name == 'solve_many' else 'solve'}"
            f"), which owns mesh/layout placement and the options database. "
            f"Internal callers should import repro_torch.core.driver.{name}.",
            DeprecationWarning, stacklevel=2)
        return fn(*args, **kwargs)
    return shim


solve = _deprecated_shim(_driver_solve, "solve")
solve_many = _deprecated_shim(_driver_solve_many, "solve_many")
