"""Mid-solve supervisor: detect stagnation / divergence between chunks.

Counterpart of :mod:`repro.adaptive.supervisor` (the same triggers).

The driver calls the supervisor once per completed run chunk with the
control tuple it already fetched (``{"k", "res", "k_prev", "res_prev",
"diverged"}``) — zero extra device syncs.  The supervisor computes the
observed per-iteration residual decay rate over the chunk and compares it
to the instance's discount: a healthy Krylov/MPI solve decays *much* faster
than gamma per outer iteration, while a safeguard-crawling one (Chebyshev
on a mis-bracketed spectrum, GMRES stalling at a restart) degenerates to
exactly the VI rate — paying full inner-solve cost for plain-backup
progress.  That is the hot-swap trigger: the solve is interrupted (its
state is already checkpointed) and resumed under the next method in the
escalation chain (:func:`repro_torch.adaptive.rules.escalate`).

This generalizes the Chebyshev ``divtol`` bail-out template: divergence
(residual past ``-divtol`` x initial, or NaN) interrupts the solve loop
on its own via the sticky ``SolveState.diverged`` flag; stagnation — the
subtler failure — is caught here.
"""

from __future__ import annotations

import numpy as np

__all__ = ["StagnationSupervisor"]

_TINY = 1e-30


class StagnationSupervisor:
    """Between-chunks callable for ``driver.solve(supervisor=...)``.

    Triggers (returns True, interrupting the solve) when the observed
    per-iteration residual decay rate over the last chunk is no better than
    ``gamma ** margin`` — i.e. the method is making at best VI-rate
    progress while paying its full inner-solve cost.  ``margin`` > 1 sets
    the threshold slightly *below* gamma so a crawl at exactly the VI rate
    is caught (default 1.1: for gamma=0.999 the threshold is ~0.9989).

    ``patience`` is how many CONSECUTIVE crawling chunks it takes to
    declare stagnation (healthy chunks reset the streak).  f32 sup-norm
    residuals are quantized, so a converging solve routinely shows single
    chunks with decay rate exactly 1.0 — the residual sits on one f32
    value for a chunk, then drops (measured on the gamma=0.9999 chain:
    isolated flat chunks amid a healthy 0.995/iter decay).  A genuine
    stall (GMRES pinned at a restart, a mis-bracketed Chebyshev) crawls
    for *every* subsequent chunk, so patience > 1 costs only
    ``(patience - 1) * chunk`` extra iterations before the hot-swap.

    Solves already within ``4 * atol`` of the target never trigger —
    rounding-plateau noise near convergence is not stagnation.
    """

    def __init__(self, gamma: float, *, atol: float = 0.0,
                 margin: float = 1.1, patience: int = 2):
        self.threshold = float(min(max(gamma, 0.0), 1.0 - 1e-9)) ** margin
        self.atol = float(atol)
        self.patience = max(int(patience), 1)
        self.triggered = False
        self.reason = ""
        self.rate = None          # last observed per-iteration decay rate
        self._streak = 0          # consecutive crawling chunks so far

    def __call__(self, info: dict) -> bool:
        if info.get("diverged"):
            self.triggered = True
            self.reason = "diverged (residual past -divtol x initial)"
            return True
        dk = int(info["k"]) - int(info["k_prev"])
        res, res_prev = float(info["res"]), float(info["res_prev"])
        if dk <= 0 or not np.isfinite(res) or not np.isfinite(res_prev):
            return False
        if res <= max(self.atol * 4.0, 0.0):
            return False          # converging plateau, not stagnation
        self.rate = (res / max(res_prev, _TINY)) ** (1.0 / dk)
        if self.rate >= self.threshold:
            self._streak += 1
            if self._streak >= self.patience:
                self.triggered = True
                self.reason = (f"stagnation: residual decay "
                               f"{self.rate:.6f}/iter >= threshold "
                               f"{self.threshold:.6f} over {self._streak} "
                               f"consecutive chunks")
                return True
        else:
            self._streak = 0
        return False
