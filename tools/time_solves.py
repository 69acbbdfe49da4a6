"""Time single-instance solves of the PyTorch port on one card.

    PYTHONPATH=src python3 tools/time_solves.py [--repeats 5]

Builds chip_smoke.py's ELL garnet (n = 10^6, m = 16, k = 8, gamma = 0.99,
seed 0) on the card and times ``driver.solve`` on it, warm, for ipi_gmres
and ipi_bicgstab in float64 to 1e-8, mpi in float32 to 1e-4 and 200
outer steps of vi in float32: each solve's wall between device syncs, with
its outer / inner counts and kernel launches.  The package comes from
``PYTHONPATH``, so two source trees are compared by running the script
once for each, in turns (old, new, new, old), in one call on the card.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

CASES = (("ipi_gmres", "float64", 1e-8, 2000),
         ("ipi_bicgstab", "float64", 1e-8, 2000),
         ("mpi", "float32", 1e-4, 2000),
         ("vi", "float32", 1e-12, 200))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_solves: no CUDA device")
    import repro_torch
    from repro_torch.core import driver, generators
    from repro_torch.core.ipi import IPIOptions
    from repro_torch.kernels import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    mdp = generators.garnet(n=1_000_000, m=16, k=8, gamma=0.99,
                            seed=0).to("cuda")
    rows = []
    for method, dtype, atol, max_outer in CASES:
        opts = IPIOptions(method=method, dtype=dtype, atol=atol,
                          max_outer=max_outer)
        driver.solve(mdp, opts, device="cuda")     # warm: builds, caches
        walls = []
        for _ in range(args.repeats):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = driver.solve(mdp, opts, device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rows.append(dict(method=method, dtype=dtype, atol=atol,
                         outer=r.outer_iterations, inner=r.inner_iterations,
                         launches=ops.launch_counts(),
                         wall_ms=[w * 1e3 for w in walls],
                         median_ms=float(np.median(walls)) * 1e3,
                         min_ms=min(walls) * 1e3))
    print(json.dumps(dict(package=repro_torch.__file__, solves=rows)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
