"""The pluggable method surface on the port: register a KSP, monitor a
solve, stop on the span seminorm — on the card.

    PYTHONPATH=src python examples/torch/custom_solver.py
    PYTHONPATH=src python examples/torch/custom_solver.py --device cpu \\
        --n 1000 --chain 200 --chain-gamma 0.99

Runs on the GPU unless given ``--device cpu``; ``--n`` sizes the garnet
(5,000 states by default), ``--chain`` the chain walk (400) and
``--chain-gamma`` its discount (0.999).  A
user-registered inner solver is a plain function of torch tensors on the
solve device, and runs under whatever placement the session picks.
"""
import argparse
import hashlib

import numpy as np

from repro_torch.api import (MDP, madupite_session, register_ksp,
                             unregister_ksp)
from repro_torch.core.solvers import richardson
from repro_torch.kernels import ops


def digest(policy) -> str:
    """A short fingerprint of a policy, to compare runs by."""
    return hashlib.sha1(np.asarray(policy, np.int32).tobytes()).hexdigest()[:16]


# --- 1. a user inner solver: damped Richardson, registered as a KSP --------
# Contract: torch ops on the solve device, distributed reductions via
# `axes`, returns (x, iters, resnorm).  One call makes it selectable from
# Python, MADUPITE_OPTIONS and the CLI (as -ksp_type damped / -method
# ipi_damped).

def damped(matvec, b, x0, *, tol, maxiter, axes):
    return richardson(matvec, b, x0, tol=tol, maxiter=maxiter, axes=axes,
                      omega=0.9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n", type=int, default=5_000, help="garnet states")
    ap.add_argument("--chain", type=int, default=400,
                    help="chain_walk states")
    ap.add_argument("--chain-gamma", type=float, default=0.999,
                    help="chain_walk discount")
    args = ap.parse_args(argv)
    base = {"-dtype": "float64", "-device": args.device}
    ops.reset_launch_counts()

    register_ksp("damped", damped)
    try:
        mdp = MDP.from_generator("garnet", n=args.n, m=8, k=6, gamma=0.99,
                                 seed=0)
        with madupite_session({**base, "-atol": 1e-8}) as s:
            r_user = s.solve(mdp, ksp_type="damped")
            r_ref = s.solve(mdp, method="ipi_gmres")
    finally:
        # unregistered again, so that main() can run twice in one process
        unregister_ksp("damped")
    assert r_user.converged
    np.testing.assert_allclose(r_user.v, r_ref.v, atol=1e-6)
    print(f"user ksp 'damped':  {r_user.summary()}")
    print(f"reference (gmres):  {r_ref.summary()}")
    print(f"policy digest: {digest(r_user.policy)} (damped) "
          f"{digest(r_ref.policy)} (gmres)\n")

    # --- 2. monitor + span stopping on a long-mixing chain -----------------
    # A monitor receives one record per outer iteration; -stop_criterion
    # span certifies VI once the residual vector is nearly constant — far
    # earlier than the sup-norm decay.
    chain = MDP.from_generator("chain_walk", n=args.chain,
                               gamma=args.chain_gamma)
    records = []
    with madupite_session({**base, "-atol": 1e-8,
                           "-max_outer": 100_000}) as s:
        r_span = s.solve(chain, method="vi", stop_criterion="span",
                         monitor=records.append)
        r_atol = s.solve(chain, method="vi")
    assert len(records) == r_span.outer_iterations + 1   # k=0 .. k_final
    assert r_span.outer_iterations < r_atol.outer_iterations
    assert np.array_equal(r_span.policy, r_atol.policy)
    print(f"chain_walk VI, span stop: {r_span.outer_iterations} outers "
          f"(vs {r_atol.outer_iterations} with atol — "
          f"{r_atol.outer_iterations / r_span.outer_iterations:.0f}x fewer, "
          f"same policy)")
    print(f"monitored {len(records)} records; last: k={records[-1]['k']} "
          f"res={records[-1]['res']:.2e} "
          f"elapsed={records[-1]['elapsed']:.3f}s\n")

    # --- 3. a custom stopping criterion as a predicate ----------------------
    # Stop when the certified optimality gap res/(1-gamma) drops below 1e-4.
    with madupite_session(base) as s:
        r_gap = s.solve(mdp, method="ipi_gmres",
                        stop_criterion=lambda m: m.res / (1 - m.gamma)
                        <= 1e-4)
    assert r_gap.converged and r_gap.gap_bound <= 1e-4
    print(f"custom gap criterion: {r_gap.summary()}")
    if args.device == "cuda":
        print("kernel launches:", " ".join(
            f"{k}={v}" for k, v in ops.launch_counts().items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
