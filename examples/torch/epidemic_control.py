"""Epidemic (SIS) intervention policy on the port — the paper's
application-domain demo, on the card.

madupite's motivating applications include epidemiology (Steimle & Denton
2017), and its signature construction mode is *MDPs defined by callables*:
the transition law and stage cost below are functions of (state, action).

We model an SIS process with 6 intervention levels trading infection load
against intervention cost, solve it with iPI-BiCGStab through the session
layer, and read out the certified optimal intervention thresholds.

The constructors are torch functions of an int32 row tensor, so
``MDP.from_functions`` takes the *device* pipeline: the session builds the
ELL tables on the solve device, a chunk of rows at a time, with no host
arrays in the loop.  Written in numpy they would run through the host
pipeline instead, just slower at scale.

    PYTHONPATH=src python examples/torch/epidemic_control.py
    PYTHONPATH=src python examples/torch/epidemic_control.py --device cpu \\
        --pop 100

Runs on the GPU unless given ``--device cpu``; ``--pop`` is the population
(500 by default: states 0 .. pop).
"""
import argparse
import hashlib

import numpy as np
import torch

from repro_torch.api import MDP, madupite_session
from repro_torch.kernels import ops

N_ACT = 6

# SIS birth-death chain: state i = #infected in [0, POP].  Infections up
# w.p. beta_a * i * (POP - i) / POP^2, recoveries down w.p. mu * i / POP;
# state 0 (eradicated) is absorbing.  Stronger actions cut the spread rate
# but cost more.
BETA = np.linspace(0.9, 0.05, N_ACT)
ACT_COST = np.linspace(0.0, 0.15, N_ACT)
MU = 0.3


def constructors(pop: int):
    """``(P_fn, g_fn)`` of the SIS model on ``pop + 1`` states: vectorized
    torch functions of a row tensor and a static action."""

    def transitions(rows, a: int):
        """Successor ids and probabilities for states ``rows`` under
        intervention level ``a`` (ELL rows: [up, down, stay])."""
        i = rows.to(torch.float32)
        up = torch.clamp(float(BETA[a]) * i * (pop - i) / pop**2, 0, 0.49)
        down = torch.clamp(MU * i / pop, 0, 0.49)
        up = torch.where(rows == 0, 0.0, up)        # eradicated: absorbing
        down = torch.where(rows == 0, 0.0, down)
        ids = torch.stack([torch.clamp(rows + 1, 0, pop),
                           torch.clamp(rows - 1, 0, pop), rows], dim=-1)
        probs = torch.stack([up, down, 1.0 - up - down], dim=-1)
        return ids.to(torch.int32), probs.to(torch.float32)

    def stage_cost(rows, a: int):
        """Infection load + intervention cost (zero load once
        eradicated), summed in float64 and rounded once to the table's
        float32."""
        load = torch.where(rows == 0, 0.0, 2.0 * rows.double() / pop)
        return (load + float(ACT_COST[a])).to(torch.float32)

    return transitions, stage_cost


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--pop", type=int, default=500,
                    help="population: +-1 birth-death dynamics must "
                         "traverse the states within the 1/(1-gamma) "
                         "horizon for control to matter")
    args = ap.parse_args(argv)
    pop = args.pop

    transitions, stage_cost = constructors(pop)
    mdp = MDP.from_functions(transitions, stage_cost, n=pop + 1, m=N_ACT,
                             nnz=3, gamma=0.999, vectorized=True)
    print(f"SIS MDP: {mdp.n:,} states x {mdp.m} interventions (defined by "
          f"callables, built by the {mdp.materialization()} pipeline)")

    ops.reset_launch_counts()
    with madupite_session({"-method": "ipi_bicgstab", "-atol": 1e-8,
                           "-dtype": "float64",
                           "-device": args.device}) as s:
        r = s.solve(mdp)
    print(r.summary())
    assert r.converged

    # where does the optimal policy escalate interventions?
    pol = r.policy
    changes = np.where(np.diff(pol) != 0)[0]
    print("\ninfection level -> optimal intervention level")
    lo = 0
    for c in list(changes[:12]) + [pop]:
        print(f"  {lo:6d} .. {c:6d} infected : level {pol[lo]}")
        lo = c + 1
        if lo > pop:
            break
    print(f"policy digest: "
          f"{hashlib.sha1(np.asarray(pol, np.int32).tobytes()).hexdigest()[:16]}")
    print(f"\ncertified: ||v - v*||_inf <= {r.gap_bound:.2e}")
    if args.device == "cuda":
        print("kernel launches:", " ".join(
            f"{k}={v}" for k, v in ops.launch_counts().items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
