"""Adaptive solver driver: ``-method auto`` made first-class.

Counterpart of :mod:`repro.adaptive`, with the same rules, thresholds,
triggers and escalation chain:

* :mod:`repro_torch.adaptive.probe` — a handful of plain VI backups
  distill an instance into a :class:`~repro_torch.adaptive.probe.
  ProblemProfile` (observed contraction, span-vs-norm ratio, probe
  residuals);
* :mod:`repro_torch.adaptive.rules` — an explainable ordered rule table
  maps the profile to a (method, stop criterion, preconditioner) choice,
  plus the stagnation escalation chain;
* :mod:`repro_torch.adaptive.supervisor` — between-chunks
  stagnation/divergence detection;
* :mod:`repro_torch.adaptive.driver` — :func:`solve_adaptive`, which runs
  probe -> select -> supervised solve and hot-swaps mid-solve by resuming
  the current solver state (through a checkpoint) under the next method.

The user surface is ``-method auto`` (plus ``-probe_iters``,
``-adapt_on_stagnation``, ``-pc_type``) through
:class:`repro_torch.api.Session` and ``--method auto`` of
:mod:`repro_torch.launch.solve`.
"""

from repro_torch.adaptive.driver import AdaptiveReport, solve_adaptive
from repro_torch.adaptive.probe import ProblemProfile, \
    estimate_contraction, probe
from repro_torch.adaptive.rules import MethodChoice, escalate, explain, \
    select_method
from repro_torch.adaptive.supervisor import StagnationSupervisor

__all__ = [
    "AdaptiveReport", "MethodChoice", "ProblemProfile",
    "StagnationSupervisor", "escalate", "estimate_contraction", "explain",
    "probe", "select_method", "solve_adaptive",
]
