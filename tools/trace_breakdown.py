"""Where a benchmark cell's device idle falls in the program, and what
recording the program's spans costs.

    PYTHONPATH=src python3 tools/trace_breakdown.py \\
        --workload garnet1e6.gmres.fleet8 --seed 12345 [--seconds 51] \\
        [--cost] [--out breakdown.json]

Runs the cell traced once through the benchmark's harness
(``bench/harness.py``: its traced calls under a profile of the device
alone) and labels every stretch of device idle in them by the innermost
span of ``repro_torch.utils.trace`` open on the host at the stretch's
middle (``between calls`` outside every call's span: the benchmark's cost
draws), from the profile's device records and the spans, which share the
host clock.  The idle before the first and after the last device record
of the window is ``window edges``.  With ``--cost`` it also runs the
cell's untraced window twice in turns, recording off and on (inside
``trace.recording()``), and reports both ``solve_s``.  Prints one JSON
line: the card and its power limit, the labelled idle seconds beside the
window's, each traced call's reads by site and milliseconds by span, and
the two ``solve_s``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def innermost(calls, t_ns: int) -> str:
    """The innermost span open at ``t_ns`` in ``calls``."""
    for c in calls:
        root = c.root
        if not root.start_ns <= t_ns <= root.end_ns:
            continue
        best = root
        for s in c.spans:
            if s.start_ns <= t_ns <= s.end_ns and \
                    s.start_ns >= best.start_ns and s.end_ns <= best.end_ns:
                best = s
        return best.name
    return "between calls"


def idle_by_span(prof, calls) -> dict:
    """Idle seconds between the profile's device records, by the innermost
    span open at each gap's middle."""
    from bench.devtrace import _records
    merged, _, _ = _records(prof)
    out: dict[str, float] = defaultdict(float)
    for (_, lo), (hi, _) in zip(merged, merged[1:]):
        if hi > lo:
            out[innermost(calls, (lo + hi) // 2)] += (hi - lo) / 1e9
    edges = (merged[0][0], merged[-1][1]) if merged else (0, 0)
    return dict(out), edges


def traced(cell: str, seed: int, **run) -> dict:
    from bench import devtrace
    from bench.harness import run_cell
    from repro_torch.utils import trace

    seen = {}
    summarize = devtrace.summarize

    def keep(prof, window_s):
        calls = [c for c in trace.calls()
                 if c.root.name.startswith("session.")]
        seen["idle"], seen["edges"] = idle_by_span(prof, calls)
        seen["calls"] = [c.summary() for c in calls]
        return summarize(prof, window_s)

    trace.clear()
    devtrace.summarize = keep
    try:
        out = run_cell(cell, seed, 1.0, True, **run)
    finally:
        devtrace.summarize = summarize
    window, busy = out["device"]["window_s"], out["device"]["busy_s"]
    labelled = sum(seen["idle"].values())
    seen["idle"]["window edges"] = max(window - busy - labelled, 0.0)
    return {"correct": out["correct"], "window_s": window, "busy_s": busy,
            "idle_s": window - busy, "labelled_idle_s": labelled,
            "records_span_s": (seen["edges"][1] - seen["edges"][0]) / 1e9,
            "idle_by_span": dict(sorted(seen["idle"].items(),
                                        key=lambda kv: -kv[1])),
            "calls": seen["calls"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()}}


def cost(cell: str, seed: int, seconds: float, **run) -> dict:
    from bench.harness import run_cell
    from repro_torch.utils import trace

    runs = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        if mode == "on":
            with trace.recording():
                out = run_cell(cell, seed, seconds, False, **run)
        else:
            out = run_cell(cell, seed, seconds, False, **run)
        assert out["correct"], out["checks"]
        runs[mode].append(out["metrics"]["solve_s"]["value"])
        trace.clear()
    return runs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--cost", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    result = {"card": card.strip(), "workload": args.workload,
              "seed": args.seed, "traced": traced(args.workload, args.seed)}
    if args.cost:
        result["solve_s"] = cost(args.workload, args.seed, args.seconds)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
