"""Policy engine: an explainable rule table from profile to method choice.

Counterpart of :mod:`repro.adaptive.rules`: the same rules, thresholds
and reasons, so both packages choose the same method for the same
profile.  The thresholds were measured on the JAX package's CPU bench
suite (ROADMAP queue 1 item 12: retune them only from ledger numbers).

The selector is deliberately NOT a learned model: it is an ordered list of
``(name, predicate, choose)`` rules over the :class:`ProblemProfile`, each
carrying a human-readable reason, so ``explain(profile)`` can print exactly
why a method was (or was not) picked — the PETSc ``-ksp_view`` ethos applied
to method selection.

The table encodes what the benchmark suite shows (``bench_solvers`` /
``bench_conditioning``):

* fast-contracting instances (dense-random garnets, modest gamma) are VI's
  home turf — inner solves cannot beat a plain backup sweep;
* moderately slow instances favor ``mpi`` (a fixed block of Richardson
  sweeps per outer amortizes the backup's argmin);
* long-mixing instances whose residual is nearly a constant vector
  (``span_ratio`` tiny) certify via the span criterion many times earlier
  than any sup-norm method;
* genuinely ill-conditioned instances (chains / SIS at gamma -> 1, the
  GMRES outliers) need a Krylov inner solver, and a Jacobi / block-Jacobi
  preconditioner to tame the restart stalls.

:func:`escalate` is the mid-solve hot-swap chain: when the supervisor
declares stagnation or divergence, the solve resumes under the next method
in a fixed robustness ordering, terminating at VI — the unconditional
contraction that cannot stagnate.
"""

from __future__ import annotations

import dataclasses

from repro_torch.adaptive.probe import ProblemProfile

__all__ = ["MethodChoice", "RULES", "select_method", "explain", "escalate"]


@dataclasses.dataclass(frozen=True)
class MethodChoice:
    """A concrete (method, stop criterion, preconditioner) selection."""

    method: str
    stop_criterion: str = "atol"
    pc_type: str = "none"
    reason: str = ""

    def summary(self) -> str:
        pc = f" pc={self.pc_type}" if self.pc_type != "none" else ""
        return (f"{self.method} (stop={self.stop_criterion}{pc}) "
                f"— {self.reason}")


# Observed-contraction thresholds.  c <= FAST: VI reaches atol in a few
# dozen backups — inner solves cannot pay for themselves.  The cutoff is
# measured, not guessed: on the garnet family VI wins at observed c=0.76
# (1.8ms vs mpi 2.6ms) but loses from c=0.85 up (4.1ms vs 2.2ms, and 2.9x
# at c=0.89) — the crossover sits between, so FAST = 0.8.
# FAST < c <= MODERATE: fixed Richardson blocks (mpi) amortize the argmin.
# Above MODERATE the sup-norm horizon 1/(1-c) exceeds ~300 iterations and
# Krylov (or span certification) is required.
FAST_CONTRACTION = 0.8
MODERATE_CONTRACTION = 0.997
# span/res below this means the residual is a near-constant vector: the
# midpoint-corrected span certificate converges at the mixing rate, far
# faster than the sup-norm decay.
SPAN_FLAT = 0.05
# Below this state count even ill-conditioned instances go to mpi: a
# Richardson sweep propagates information one transition per application,
# so on small instances the fixed sweep blocks cross the state space many
# times over and beat Krylov wall-clock (bench_adaptive: mpi 0.32s vs
# gmres+jacobi 2.7s on chain n=750 at gamma=0.9999 — reversed at n=5000,
# where mpi stalls at the f32 residual floor and only gmres+jacobi
# converges).  The stagnation supervisor remains the safety net when the
# small-n bet goes wrong.
KRYLOV_MIN_N = 2048


def _krylov(profile: ProblemProfile, deterministic_dots: bool, reason: str) \
        -> MethodChoice:
    # GMRES + Jacobi is the measured hard-regime winner (chain n=5k at
    # gamma=0.9999: 65 outers / 4.3s vs >=3000 outers / 119s plain GMRES and
    # 1149 outers / 72s bicgstab+bjacobi): the elementwise scaling is nearly
    # free yet breaks the GMRES(restart) stall on advection-like chains.
    # bjacobi is stronger per-iteration at small n but its block applies
    # aggravate restart stagnation at scale, so it stays opt-in (-pc_type).
    # Jacobi is also order-free, so the same choice is legal under
    # -deterministic_dots.
    del deterministic_dots
    return MethodChoice("ipi_gmres", "atol", "jacobi", reason)


RULES = (
    ("probe-converged",
     lambda p: p.converged,
     lambda p, det: MethodChoice(
         "vi", "atol", "none",
         "probe already reached atol — one VI sweep re-certifies")),
    ("fast-contraction",
     lambda p: p.contraction <= FAST_CONTRACTION,
     lambda p, det: MethodChoice(
         "vi", "atol", "none",
         f"observed contraction {p.contraction:.4f} <= "
         f"{FAST_CONTRACTION}: plain backups win, inner solves can't pay")),
    ("moderate-contraction",
     lambda p: p.contraction <= MODERATE_CONTRACTION,
     lambda p, det: MethodChoice(
         "mpi", "atol", "none",
         f"observed contraction {p.contraction:.4f} <= "
         f"{MODERATE_CONTRACTION}: fixed Richardson blocks amortize the "
         f"backup argmin")),
    ("long-mixing-flat-span",
     lambda p: p.span_ratio <= SPAN_FLAT,
     lambda p, det: MethodChoice(
         "vi", "span", "none",
         f"span/res {p.span_ratio:.3e} <= {SPAN_FLAT}: residual is a "
         f"near-constant vector — span certifies at the mixing rate")),
    ("ill-conditioned-small",
     lambda p: p.n < KRYLOV_MIN_N,
     lambda p, det: MethodChoice(
         "mpi", "atol", "none",
         f"slow contraction {p.contraction:.4f} but only {p.n} states "
         f"(< {KRYLOV_MIN_N}): Richardson sweep blocks cross the state "
         f"space many times over — cheaper than Krylov at this size")),
    ("ill-conditioned",
     lambda p: True,
     lambda p, det: _krylov(
         p, det,
         f"observed contraction {p.contraction:.4f} with span/res "
         f"{p.span_ratio:.2f}: sup-norm horizon ~"
         f"{int(1.0 / max(1.0 - p.contraction, 1e-6))} iterations — "
         f"preconditioned Krylov inner solves required")),
)


def select_method(profile: ProblemProfile, *,
                  deterministic_dots: bool = False) -> MethodChoice:
    """First matching rule wins (the last rule always matches)."""
    for name, pred, choose in RULES:
        if pred(profile):
            choice = choose(profile, deterministic_dots)
            return dataclasses.replace(
                choice, reason=f"[{name}] {choice.reason}")
    raise AssertionError("unreachable: the fallback rule always matches")


def explain(profile: ProblemProfile, *,
            deterministic_dots: bool = False) -> str:
    """Every rule's verdict for this profile, first match marked — the
    ``-verbose`` / report rendering of the selection."""
    lines = [profile.summary()]
    matched = False
    for name, pred, choose in RULES:
        hit = pred(profile)
        mark = "->" if hit and not matched else ("  " if not hit else " +")
        if hit and not matched:
            matched = True
            lines.append(f"{mark} {name}: "
                         f"{choose(profile, deterministic_dots).summary()}")
        else:
            lines.append(f"{mark} {name}: "
                         f"{'matches (shadowed)' if hit else 'no match'}")
    return "\n".join(lines)


# Hot-swap escalation: a stagnating or diverging method hands its CURRENT
# SolveState to the next entry.  Ordered by escalation strength: cheap
# Richardson blocks first (also where out-of-chain methods like a
# diverging chebyshev land), then the Krylov combos — GMRES+Jacobi is the
# measured strongest stall-breaker (see _krylov), bicgstab the
# independent second opinion — and VI terminal (every ipi_* step is
# safeguarded to never lose to a VI sweep, and a gamma-contraction cannot
# stagnate, so the chain always ends at something that converges).
_CHAIN = ("mpi", "ipi_gmres", "ipi_bicgstab", "vi")
_CHAIN_DET = ("mpi", "ipi_gmres", "vi")


def escalate(method: str, *, deterministic_dots: bool = False) \
        -> MethodChoice | None:
    """The next method in the stagnation escalation chain after ``method``
    (``None`` when ``method`` is terminal).  Methods outside the chain
    (chebyshev, anderson, user-registered) escalate to the chain head."""
    chain = _CHAIN_DET if deterministic_dots else _CHAIN
    try:
        i = chain.index(method)
    except ValueError:
        i = -1
    if i + 1 >= len(chain):
        return None
    nxt = chain[i + 1] if i >= 0 else chain[0]
    pc = "none"
    if nxt in ("ipi_bicgstab", "ipi_gmres"):
        # jacobi (elementwise) is cheap, deterministic-dots safe, and never
        # hurts a diagonally-dominant system (I - gamma P_pi always is)
        pc = "jacobi"
    return MethodChoice(
        nxt, "atol", pc,
        f"escalated from stagnating/diverging {method!r}")
