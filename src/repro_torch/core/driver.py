"""Host driver: chunked single-device iPI solve.

Counterpart of :func:`repro.core.driver.solve` for one MDP on one device
(the reference's ``mesh=None`` path).  The outer loop runs in chunks of
``chunk`` iterations between progress reports, exactly as the reference
bounds its compiled loop; :class:`SolveResult` and the span midpoint
correction are the reference's.

Checkpointing, monitors, supervisors, fleets and meshes are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ipi
from repro_torch.core.comm import Axes
from repro_torch.core.ipi import IPIOptions, SolveState
from repro_torch.core.mdp import MDP, DenseMDP, EllMDP
from repro_torch.device import resolve_device


@dataclasses.dataclass
class SolveResult:
    v: np.ndarray                  # (n,) optimal values
    policy: np.ndarray             # (n,) int32 greedy policy
    residual: float                # final ||T v - v||_inf
    gap_bound: float               # ||v - v*||_inf certificate: res/(1-gamma)
                                   # (span stopping: gamma*sp/(2*(1-gamma))
                                   # on the midpoint-corrected v)
    converged: bool
    outer_iterations: int
    inner_iterations: int
    trace_residual: np.ndarray     # (outer+1,)
    trace_inner: np.ndarray        # (outer,)
    diverged: bool = False         # residual went NaN or blew past
                                   # opts.divtol * res0
    span: float = float("inf")     # final sp(T v - v) (inf unless the stop
                                   # criterion declared needs_span)

    def summary(self) -> str:
        flag = " DIVERGED" if self.diverged else ""
        return (f"converged={self.converged} outer={self.outer_iterations} "
                f"inner={self.inner_iterations} residual={self.residual:.3e} "
                f"gap<= {self.gap_bound:.3e}{flag}")


def _result(state: SolveState, opts: IPIOptions, gamma: float) \
        -> SolveResult:
    k = state.k
    res = float(state.res)
    converged = bool(state.done)
    v = state.v.cpu().numpy()
    gap = res / (1.0 - gamma)
    if converged and opts.stop_criterion == "span" and gamma < 1.0:
        # Midpoint correction (Puterman §6.6): with d = T v - v,
        # T v + gamma/(1-gamma) * min(d) <= v* <= T v + gamma/(1-gamma) *
        # max(d), so the midpoint-shifted T v carries the certified bound
        # gamma * sp(d) / (2 * (1-gamma)).  A constant shift: the policy is
        # untouched.
        tv = state.tv.cpu().numpy()
        d = tv - v
        scale = gamma / (1.0 - gamma)
        v = tv + scale * (float(d.max()) + float(d.min())) / 2.0
        gap = scale * float(state.span) / 2.0
    return SolveResult(
        v=v,
        policy=state.pi.cpu().numpy(),
        residual=res,
        gap_bound=gap,
        converged=converged,
        outer_iterations=k,
        inner_iterations=state.inner_total,
        trace_residual=state.trace_res[:k + 1].cpu().numpy(),
        trace_inner=state.trace_inner[:k].cpu().numpy(),
        diverged=bool(state.diverged),
        span=float(state.span))


def solve(mdp: MDP, opts: IPIOptions = IPIOptions(), *, v0=None,
          chunk: int = 64, verbose: bool = False,
          device: str | torch.device = "cuda") -> SolveResult:
    """Solve an MDP until ``opts.stop_criterion`` is satisfied (default:
    ``||T v - v||_inf <= opts.atol``) on ``device``.

    The MDP's tables move to ``device`` if they are elsewhere; ``device``
    defaults to ``"cuda"`` and raises when no GPU is visible.
    """
    if not isinstance(mdp, (EllMDP, DenseMDP)):
        raise TypeError(f"solve() takes an EllMDP or a DenseMDP (batched "
                        f"and matrix-free MDPs are not yet ported), got "
                        f"{type(mdp).__name__}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dev_mdp = mdp.to(resolve_device(device))
    axes = Axes()
    state = ipi.init_state(dev_mdp, axes, opts, v0)
    while True:
        k = state.k
        res, done, div = (state.res.item(), bool(state.done),
                          bool(state.diverged))
        if verbose:
            print(f"[driver] k={k} residual={res:.3e}"
                  + (" DIVERGED" if div else ""))
        # NaN residual (inner-solver breakdown) or a diverged flag: bail
        # out, do not spin.
        if done or k >= opts.max_outer or np.isnan(res) or div:
            break
        state = ipi.solve_chunk(dev_mdp, state, min(k + chunk,
                                                    opts.max_outer),
                                opts, axes)
    return _result(state, opts, mdp.gamma)
