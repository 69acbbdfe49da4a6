"""Inner linear solvers for the policy-evaluation system (single device),
and the dense direct oracle."""

from repro_torch.core.solvers.direct import dense_policy_value
from repro_torch.core.solvers.gmres import gmres
from repro_torch.core.solvers.richardson import richardson

__all__ = ["dense_policy_value", "gmres", "richardson"]
