"""Probe phase: a few plain VI backups that profile an MDP instance.

Counterpart of :mod:`repro.adaptive.probe`.  ``-method auto`` must not
guess from static metadata alone — two MDPs with the same ``(n, m,
gamma)`` can have very different effective contraction (a dense-random
garnet mixes in a handful of sweeps; a 5000-state chain at the same gamma
takes tens of thousands).  The probe runs a handful of VI iterations
under the never-stopping ``"probe"`` stop criterion (fixed-length
residual trace, span recorded) and distills the trace into a
:class:`ProblemProfile`:

* **contraction** — geometric mean of consecutive residual ratios over the
  tail of the probe trace: the *observed* per-iteration decay rate.
* **span_ratio** — ``sp(T v - v) / ||T v - v||_inf`` at the probe end: a
  near-zero ratio means the residual is almost a constant vector — the
  long-mixing regime where span stopping certifies far earlier than atol.
* **converged** — the probe alone already met ``opts.atol``.

The residual trace is the solve's own (float64 when the solve is), read
once on the host at the probe's end.  The probe value vector is returned
so the main solve warm-starts from it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import driver as _driver
from repro_torch.core.ipi import IPIOptions

__all__ = ["ProblemProfile", "estimate_contraction", "probe"]

_TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class ProblemProfile:
    """What the probe learned about one MDP instance."""

    n: int                   # global state count
    gamma: float             # declared discount
    iters: int               # probe outer iterations actually run
    res0: float              # residual at k = 0
    res: float               # residual at probe end
    contraction: float       # observed per-iteration residual decay rate
    span_ratio: float        # sp(T v - v) / ||T v - v||_inf at probe end
    converged: bool          # probe already satisfied opts.atol

    def summary(self) -> str:
        return (f"n={self.n} gamma={self.gamma} probe_iters={self.iters} "
                f"contraction={self.contraction:.6f} "
                f"span_ratio={self.span_ratio:.3e} res={self.res:.3e}"
                + (" CONVERGED" if self.converged else ""))


def estimate_contraction(trace: np.ndarray) -> float:
    """Geometric mean of consecutive residual ratios over the tail half of
    the trace (the head is polluted by the v0 transient).  Returns 0.0 for
    traces too short (or too converged) to measure."""
    tr = np.asarray(trace, dtype=float)
    tr = tr[np.isfinite(tr)]
    if tr.size < 2:
        return 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = tr[1:] / np.maximum(tr[:-1], _TINY)
    ratios = ratios[np.isfinite(ratios) & (ratios > 0)]
    if ratios.size == 0:
        return 0.0
    tail = ratios[ratios.size // 2:]
    return float(np.exp(np.mean(np.log(np.maximum(tail, _TINY)))))


def probe(mdp, opts: IPIOptions, *, probe_iters: int = 8, mesh=None,
          layout: str = "1d", v0=None, device="cuda"):
    """Run the probe and return ``(profile, v_probe)``.

    ``v_probe`` is the value iterate at probe end (true-``n`` length, a
    host array) — pass it as the main solve's ``v0`` so the probe work is
    reused.  The probe always runs plain VI (no inner solves, no
    preconditioner): ``probe_iters`` Bellman backups, one ``ell_backup``
    (or ``dense_backup``) launch each, in one chunk.
    """
    k = max(int(probe_iters), 2)
    popts = dataclasses.replace(
        opts, method="vi", stop_criterion="probe",
        max_outer=min(k, opts.max_outer), pc_type="none", monitor=False)
    r = _driver.solve(mdp, popts, mesh=mesh, layout=layout, v0=v0,
                      chunk=popts.max_outer, device=device)
    res = float(r.residual)
    res0 = float(r.trace_residual[0]) if len(r.trace_residual) else res
    span = float(r.span)
    span_ratio = span / max(res, _TINY) if np.isfinite(span) else 1.0
    profile = ProblemProfile(
        n=int(mdp.n_global), gamma=float(mdp.gamma),
        iters=int(r.outer_iterations), res0=res0, res=res,
        contraction=estimate_contraction(r.trace_residual),
        span_ratio=span_ratio,
        converged=bool(np.isfinite(res) and res <= opts.atol))
    return profile, r.v
