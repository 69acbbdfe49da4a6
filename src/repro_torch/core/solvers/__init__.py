"""Inner linear solvers for the policy-evaluation system, their
preconditioners, the asynchronous-VI outer iteration, and the dense direct
oracle."""

from repro_torch.core.solvers.anderson import anderson
from repro_torch.core.solvers.async_vi import async_vi_outer
from repro_torch.core.solvers.bicgstab import bicgstab, bicgstab_fleet
from repro_torch.core.solvers.chebyshev import chebyshev
from repro_torch.core.solvers.direct import dense_policy_value
from repro_torch.core.solvers.gmres import gmres, gmres_fleet
from repro_torch.core.solvers.precond import PC_TYPES, build_precond
from repro_torch.core.solvers.richardson import richardson, richardson_fleet

__all__ = ["PC_TYPES", "anderson", "async_vi_outer", "bicgstab", "bicgstab_fleet",
           "build_precond", "chebyshev", "dense_policy_value", "gmres",
           "gmres_fleet", "richardson", "richardson_fleet"]
