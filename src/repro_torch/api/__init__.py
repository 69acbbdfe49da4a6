"""repro_torch.api — the user surface of the torch port (madupite-style).

* :class:`MDP` — ELL problems from arrays or the built-in generators,
  tagged ``mode="mincost"`` or ``"maxreward"``;
* :class:`Options` — the PETSc-style options database (the ported keys
  plus ``-device``);
* :class:`Session` / :func:`madupite_session` — one options view, device
  placement, run statistics and outputs.

    from repro_torch.api import MDP, madupite_session

    mdp = MDP.from_generator("garnet", n=10_000, m=16, k=8, gamma=0.99)
    with madupite_session({"-method": "ipi_gmres", "-atol": 1e-8}) as s:
        result = s.solve(mdp)          # on the GPU; "-device": "cpu" for host
"""

from __future__ import annotations

from repro_torch.api.mdp import MDP
from repro_torch.api.options import (OPTION_SPECS, Options, OptionTypeError,
                                     UnknownOptionError)
from repro_torch.api.session import Session, madupite_session

__all__ = ["MDP", "Options", "OptionTypeError", "OPTION_SPECS", "Session",
           "UnknownOptionError", "madupite_session"]
