"""Solver core of the torch port (:mod:`repro.core`'s solve engine: one
device, fleets on one device, or one MDP sharded over a
``torch.distributed`` world; tables stored or, matrix-free, rebuilt from
row constructors in every backup).

As in the reference's package, the engine entry points :func:`solve` and
:func:`solve_many` and the fleet container builder :func:`stack_mdps` are
exported here; fleets of generated instances come from
:func:`repro_torch.core.generators.generate_many`.  The user surface is
:mod:`repro_torch.api`.
"""

from repro_torch.core.driver import SolveResult, solve, solve_many
from repro_torch.core.ipi import IPIOptions, SolveState
from repro_torch.core.mdp import DenseMDP, EllMDP, stack_mdps

__all__ = ["DenseMDP", "EllMDP", "IPIOptions", "SolveResult", "SolveState",
           "solve", "solve_many", "stack_mdps"]
