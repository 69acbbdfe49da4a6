"""Adaptive solve driver: probe -> select -> supervised solve -> hot-swap.

Counterpart of :mod:`repro.adaptive.driver`.  ``solve_adaptive`` is what
``-method auto`` resolves to (and what ``-adapt_on_stagnation`` wraps
around a fixed method): it owns the checkpoint directory the hot-swap
resumes through, so a swap continues from the CURRENT solver state —
iterate, iteration count, residual traces — rather than restarting from
scratch.  Checkpoints carry no method (the driver checks only the
problem's ``n``), which is what makes a cross-method resume work; they
are the reference's format, so the files cross between the packages.

The flow:

1. **probe** (virtual methods only): a few plain VI backups distill a
   :class:`~repro_torch.adaptive.probe.ProblemProfile`; the probe
   iterate warm-starts the main solve.
2. **select**: the rule table picks (method, stop criterion,
   preconditioner) — or the caller's fixed method is kept, supervised.
3. **supervised solve**: :func:`repro_torch.core.driver.solve` runs with
   a :class:`~repro_torch.adaptive.supervisor.StagnationSupervisor`
   (unless the current method is terminal in the escalation chain).
4. **hot-swap**: on stagnation or divergence the solve is interrupted,
   the checkpoint is re-armed (sticky ``diverged`` flag cleared, ``res0``
   reset so ``-divtol`` measures from the resume point; a NaN-poisoned
   state is discarded instead — resuming NaNs is worse than restarting),
   and the loop re-enters under the escalated method.  At most
   ``max_swaps`` escalations; the chain ends at VI, which cannot
   stagnate.

Under a mesh every rank runs this loop with the same decisions (the
supervisor reads all-reduced residuals); rank 0 owns the private
checkpoint directory and the re-arm, and hands their outcome to the
other ranks.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch.distributed as dist

from repro_torch.adaptive import rules as _rules
from repro_torch.adaptive.probe import probe as _probe, ProblemProfile
from repro_torch.adaptive.rules import MethodChoice
from repro_torch.adaptive.supervisor import StagnationSupervisor
from repro_torch.core import driver as _driver
from repro_torch.core import ipi as _ipi
from repro_torch.core import methods as _methods
from repro_torch.utils import checkpoint as _ckpt

__all__ = ["AdaptiveReport", "solve_adaptive"]

_FIELD = {name: i for i, name in enumerate(_driver.CKPT_FIELDS)}


@dataclasses.dataclass
class AdaptiveReport:
    """What the adaptive layer decided and why (lands in session stats)."""

    profile: ProblemProfile | None      # None when -method was concrete
    choice: MethodChoice | None         # initial selection (virtual only)
    methods: list                       # concrete methods actually run
    swaps: list                         # one dict per hot-swap event
    probe_iters: int = 0

    def as_dict(self) -> dict:
        return dict(
            profile=dataclasses.asdict(self.profile)
            if self.profile is not None else None,
            choice=dataclasses.asdict(self.choice)
            if self.choice is not None else None,
            methods=list(self.methods), swaps=list(self.swaps),
            probe_iters=int(self.probe_iters))


def _rearm_checkpoint(ckpt_dir: str) -> bool:
    """Prepare the newest checkpoint for a cross-method resume: clear the
    sticky ``diverged`` flag and reset ``res0`` to the current residual so
    the divergence guard re-arms relative to the resume point (``res0``
    kept in float32, as the reference writes it).  A NaN-poisoned state
    is discarded (checkpoint files removed) so the next method restarts
    clean.  Returns True when a resumable state remains."""
    if _ckpt.latest_step(ckpt_dir) is None:
        return False
    restored = _ckpt.restore(ckpt_dir, len(_driver.CKPT_FIELDS))
    if restored is None:
        return False
    leaves, step, meta = restored
    leaves = [np.asarray(a) for a in leaves]
    res, v = leaves[_FIELD["res"]], leaves[_FIELD["v"]]
    if np.isnan(res).any() or np.isnan(v).any():
        for f in os.listdir(ckpt_dir):
            if f.startswith("step_"):
                os.unlink(os.path.join(ckpt_dir, f))
        return False
    leaves[_FIELD["diverged"]] = np.zeros_like(leaves[_FIELD["diverged"]],
                                               dtype=bool)
    leaves[_FIELD["res0"]] = np.maximum(
        np.asarray(leaves[_FIELD["res0"]], dtype=np.float32),
        res.astype(np.float32))
    _ckpt.save(ckpt_dir, step, leaves, meta=meta,
               treedef=_driver._CKPT_TREEDEF)
    return True


def _on_lead(sharded: bool, fn):
    """``fn()`` on rank 0 of a sharded solve, its result handed to every
    rank (all wait for it); on one device simply ``fn()``."""
    if not sharded:
        return fn()
    box = [fn() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def solve_adaptive(mdp, opts: _ipi.IPIOptions, *, mesh=None,
                   layout: str = "1d", v0=None, probe_iters: int = 8,
                   choice: MethodChoice | None = None,
                   supervise: bool = True, max_swaps: int = 3,
                   checkpoint_dir: str | None = None, chunk: int = 64,
                   verbose: bool = False, monitor=None, device="cuda"):
    """Adaptively solve one (core) MDP; returns ``(result, report)``.

    ``opts.method`` may be virtual (``"auto"`` — probed and resolved here)
    or concrete (kept, but supervised for stagnation when ``supervise``).
    ``choice`` short-circuits the probe with a previously-selected
    :class:`MethodChoice` (the session's per-family cache).
    ``checkpoint_dir`` doubles as the hot-swap resume channel; when unset a
    private temporary directory is used and removed afterwards.
    ``device`` is the solve's device (:func:`repro_torch.core.driver.
    solve`'s ``device``).
    """
    report = AdaptiveReport(profile=None, choice=None, methods=[], swaps=[])
    spec = _methods.get_method(opts.method)
    sharded = mesh is not None
    lead = not sharded or dist.get_rank() == 0
    say = print if verbose and lead else (lambda *a, **k: None)
    cur = opts
    if spec.virtual:
        if choice is None:
            report.profile, v_probe = _probe(
                mdp, opts, probe_iters=probe_iters, mesh=mesh,
                layout=layout, v0=v0, device=device)
            report.probe_iters = report.profile.iters
            choice = _rules.select_method(
                report.profile,
                deterministic_dots=opts.deterministic_dots)
            v0 = v_probe
            say("[adaptive] " + _rules.explain(
                report.profile, deterministic_dots=opts.deterministic_dots))
        report.choice = choice
        cur = dataclasses.replace(
            opts, method=choice.method,
            stop_criterion=choice.stop_criterion,
            pc_type=choice.pc_type if opts.pc_type == "none"
            else opts.pc_type)
        say(f"[adaptive] selected {choice.summary()}")

    own_ckpt = checkpoint_dir is None
    ckpt_dir = checkpoint_dir
    gamma = float(mdp.gamma)
    try:
        swaps = 0
        while True:
            nxt = _rules.escalate(
                cur.method, deterministic_dots=cur.deterministic_dots)
            sup = None
            if supervise and nxt is not None and swaps < max_swaps:
                sup = StagnationSupervisor(gamma, atol=cur.atol)
            if sup is not None and ckpt_dir is None:
                # the private checkpoint stream only carries the state
                # across a hot-swap; with checkpoint_mode "interrupt" it is
                # written once — at the trigger — so supervised solves pay
                # no per-chunk save.  A caller's checkpoint_dir keeps the
                # per-chunk fault-tolerance contract.
                ckpt_dir = _on_lead(sharded, lambda: tempfile.mkdtemp(
                    prefix="madupite_adapt_"))
            report.methods.append(cur.method)
            result = _driver.solve(
                mdp, cur, mesh=mesh, layout=layout, v0=v0,
                checkpoint_dir=ckpt_dir, chunk=chunk,
                checkpoint_mode="interrupt" if own_ckpt else "chunk",
                verbose=verbose, monitor=monitor, supervisor=sup,
                device=device)
            v0 = None                     # later rounds resume via ckpt
            interrupted = bool(result.diverged) or \
                (sup is not None and sup.triggered)
            if result.converged or not interrupted or nxt is None \
                    or swaps >= max_swaps \
                    or result.outer_iterations >= cur.max_outer:
                break
            reason = ("diverged" if result.diverged
                      else (sup.reason if sup is not None else "supervisor"))
            resumable = _on_lead(sharded,
                                 lambda: _rearm_checkpoint(ckpt_dir))
            report.swaps.append(dict(
                k=int(result.outer_iterations),
                residual=float(result.residual),
                from_method=cur.method, to_method=nxt.method,
                pc_type=nxt.pc_type, reason=reason,
                resumed=bool(resumable)))
            say(f"[adaptive] hot-swap at k={result.outer_iterations}: "
                f"{cur.method} -> {nxt.method} (pc={nxt.pc_type}) — "
                f"{reason}" + ("" if resumable
                               else " [state discarded: NaN]"))
            cur = dataclasses.replace(
                cur, method=nxt.method, pc_type=nxt.pc_type)
            swaps += 1
    finally:
        if own_ckpt and ckpt_dir is not None and lead:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return result, report
