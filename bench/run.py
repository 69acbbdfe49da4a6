"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the profile's ``breakdown``.  The
last line on standard output is the JSON result; the last lines on
standard error are the numbers the correctness check compared, each
beside its limit.  Without a CUDA device, or with fewer than the cell
asks for, it exits with 2 and prints no result: it never falls back to
the CPU.  ``--dtype float32`` runs the program's float32 value path, the
control of the correctness check (``bench/README.md``), and
``--option KEY=VALUE`` adds a solver option to it; the benchmark's own
runs pass neither.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    p.add_argument("--dtype", choices=("float32", "float64"))
    p.add_argument("--option", action="append", default=[],
                   metavar="KEY=VALUE")
    return p.parse_args(argv)


def options(pairs) -> dict:
    out = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        try:
            out[key] = json.loads(value)
        except ValueError:
            out[key] = value
    return out


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["USE_FLAX"] = "0"
    # one process with one CPU thread: the solve's host work is launches
    # and reads, and idle intra-op threads only add jitter to its pacing
    os.environ["OMP_NUM_THREADS"] = "1"
    # any kernel cache a library keeps goes to a fixed place in the
    # checkout (the port's own kernels build into build/kernels/)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "bench" / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "bench" / ".cache"
                                             / "torch_extensions")
    import torch

    torch.set_num_threads(1)
    from bench import manifest as mf
    from bench.harness import forbidden_modules, run_cell

    spec = mf.cell(mf.load(), args.workload)
    if not torch.cuda.is_available():
        print("bench: no CUDA device is visible; the benchmark measures the "
              "program on an NVIDIA GPU and never falls back to the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"bench: cell {args.workload} needs {spec['chips']} CUDA "
              f"devices, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   dtype=args.dtype, extra_options=options(args.option),
                   t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}: the program or the harness "
              f"imports JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
