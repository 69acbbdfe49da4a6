"""Inner linear solvers for the policy-evaluation system (single device)."""

from repro_torch.core.solvers.gmres import gmres
from repro_torch.core.solvers.richardson import richardson

__all__ = ["gmres", "richardson"]
