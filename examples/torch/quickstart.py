"""Quickstart on the port's user API: builders, options database, session
layer — on the card.

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu --n 2000

Runs on the GPU unless given ``--device cpu``; ``--n`` sizes the garnet
(10,000 states by default).  The session reads ``MADUPITE_OPTIONS`` too,
so ``MADUPITE_OPTIONS="-kernel_tune_cache tune.json"`` points the kernels'
launch tuner at a file of your own.
"""
import argparse
import hashlib
import json
import os
import shutil
import tempfile

import numpy as np

from repro_torch.api import MDP, madupite_session
from repro_torch.kernels import ops


def digest(policy) -> str:
    """A short fingerprint of a policy, to compare runs by."""
    return hashlib.sha1(np.asarray(policy, np.int32).tobytes()).hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n", type=int, default=10_000,
                    help="garnet states (the reference example's 10,000)")
    args = ap.parse_args(argv)

    # A random MDP (GARNET family), 16 actions, 8 successors, discount 0.99.
    mdp = MDP.from_generator("garnet", n=args.n, m=16, k=8, gamma=0.99,
                             seed=0)
    tmp = tempfile.mkdtemp(prefix="quickstart_")
    stats_path = os.path.join(tmp, "stats.jsonl")
    ops.reset_launch_counts()
    try:
        # One options database drives the solver, the device and the outputs.
        with madupite_session({"-atol": 1e-8, "-dtype": "float64",
                               "-file_stats": stats_path,
                               "-device": args.device}) as s:
            # Value iteration (the mdpsolver/pymdptoolbox baseline)...
            r_vi = s.solve(mdp, method="vi", max_outer=10_000)
            print("VI        :", r_vi.summary())
            # ...vs inexact policy iteration with a GMRES inner solver.
            r_ipi = s.solve(mdp, method="ipi_gmres")
            print("iPI-GMRES :", r_ipi.summary())

        assert np.abs(r_vi.v - r_ipi.v).max() < 1e-5
        print(f"\nSame certified solution; iPI used "
              f"{r_ipi.outer_iterations} outer iterations vs VI's "
              f"{r_vi.outer_iterations}.")
        print("optimal value of state 0:", r_ipi.v[0], "| action:",
              r_ipi.policy[0])
        print("policy digest:", digest(r_ipi.policy))

        # The run statistics were also written via -file_stats (one JSONL
        # line per solve).
        entries = [json.loads(line) for line in open(stats_path)]
        assert [e["method"] for e in entries] == ["vi", "ipi_gmres"]
        assert all(e["solves"][0]["converged"] for e in entries)
        print(f"\nstats JSONL: {len(entries)} solves recorded, device="
              f"{args.device}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # maxreward mode: read cost as reward, solve max_a (r + gamma P v).  It
    # is exactly the negation of the mincost solve on negated costs.
    reward = MDP.from_generator("garnet", n=min(2_000, args.n), m=8, k=6,
                                gamma=0.99, seed=1, mode="maxreward")
    with madupite_session({"-atol": 1e-8, "-dtype": "float64",
                           "-device": args.device}) as s:
        r_max = s.solve(reward, method="vi", max_outer=10_000)
    print("\nmaxreward :", r_max.summary())
    print("best reward-to-go of state 0:", r_max.v[0])
    print("maxreward policy digest:", digest(r_max.policy))
    if args.device == "cuda":
        print("kernel launches:", " ".join(
            f"{k}={v}" for k, v in ops.launch_counts().items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
