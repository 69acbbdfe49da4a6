"""The paper's headline claim as a runnable comparison on the port: as
gamma -> 1, Krylov-accelerated inexact policy iteration decouples from the
1/(1-gamma) iteration blow-up that hits value iteration.

    PYTHONPATH=src python examples/torch/ipi_vs_vi.py
    PYTHONPATH=src python examples/torch/ipi_vs_vi.py --device cpu \\
        --n 200 --gammas 0.9 0.99

Runs on the GPU unless given ``--device cpu``; ``--n`` sizes the chain
walk (1,000 states) and ``--gammas`` lists the discounts (0.9 ... 0.9999).
"""
import argparse

from repro_torch.core import IPIOptions, generators
from repro_torch.core.driver import solve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n", type=int, default=1000, help="chain_walk states")
    ap.add_argument("--gammas", type=float, nargs="+",
                    default=[0.9, 0.99, 0.999, 0.9999])
    args = ap.parse_args(argv)

    print(f"{'gamma':>8} | {'VI iters':>9} | {'iPI outer':>9} | "
          f"{'iPI inner':>9}")
    print("-" * 46)
    for gamma in args.gammas:
        mdp = generators.chain_walk(n=args.n, gamma=gamma)
        r_vi = solve(mdp, IPIOptions(method="vi", atol=1e-8,
                                     dtype="float64", max_outer=1_000_000),
                     chunk=8192, device=args.device)
        r_ip = solve(mdp, IPIOptions(method="ipi_gmres", atol=1e-8,
                                     max_inner=3000, dtype="float64"),
                     device=args.device)
        print(f"{gamma:>8} | {r_vi.outer_iterations:>9} | "
              f"{r_ip.outer_iterations:>9} | {r_ip.inner_iterations:>9}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
