"""One run of one cell: set-up, the measured window, the check, the line.

:func:`run_cell` does everything but the look for a card, which
``bench/run.py`` does first, so that tests can drive a whole run on the
CPU at a small size.  The steps:

1. Set-up (``setup_s``, from the process's start): import the program,
   make every lane's instance on the device (the configuration's inputs
   module, ``bench/inputs/<inputs>.py``), open a
   ``repro_torch.api.Session`` (its launch tuner's cache at a fixed path
   under ``bench/.cache/``), and make one warm call of the cell's own
   shape, which on a checkout's first run builds the kernels into
   ``build/kernels/`` and tunes their launch shapes.
2. The window.  Untraced: whole calls back to back, each making the next
   problem of the traffic's pool in the seed's order (costs drawn afresh
   on the device), until ``--seconds`` have passed; the window runs from
   the first call's start to the last call's end.  Traced: the traffic's
   ``traced_calls`` whole calls under ``torch.profiler`` recording the
   device alone, then one more call with host records for the
   ``breakdown``'s idle gaps.
3. The peak device memory is read, the session closed and its memory
   freed.  The plain reference (``bench/reference/<reference>.py``) then
   recomputes, from the inputs made again, every answer of the window,
   and each number it returns is held, at its worst, to its limit in the
   configuration's ``limits``.
4. The metrics the manifest lists for the cell are read by their readers
   (``bench/metrics/<name>.py``) from the run's record.

The harness knows the program's entries and its results' fields, and
nothing of an MDP's kind: it hands the inputs module's objects to the
program and to the reference as they are.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import sys
import time

import torch

from bench import manifest as mf
from bench.generator import WARM_CALL, Traffic

CACHE_DIR = mf.BENCH / ".cache"
TUNE_CACHE = CACHE_DIR / "autotune.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class LaneRecord:
    outer: int
    inner: int
    trace_inner: list
    converged: bool


@dataclasses.dataclass
class CallRecord:
    index: int
    draw: int                     # the problem of the pool it made
    t0: float
    t1: float
    lanes: list                   # LaneRecord, one an instance asked for


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (``bench/metrics/*.py``)."""

    cfg: dict
    traffic: Traffic
    options: dict                 # the session's options as passed
    setup_s: float
    window_s: float
    calls: list                   # CallRecord
    peak_window_bytes: int | None
    trace: object | None          # devtrace.TraceSummary of a traced run

    @property
    def method(self) -> str:
        return self.options["-method"]

    @property
    def dtype(self) -> str:
        return self.options["-dtype"]

    @property
    def lanes(self) -> list:
        return [lane for c in self.calls for lane in c.lanes]

    @property
    def certified(self) -> int:
        return sum(lane.converged for lane in self.lanes)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _span(tracing: bool, name: str):
    if not tracing:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def session_options(cfg: dict, traffic: Traffic, dev: torch.device,
                    dtype: str | None, extra: dict | None) -> dict:
    opts = {**cfg["options"], **traffic.options, "-device": dev.type,
            "-kernel_tune_cache": str(TUNE_CACHE)}
    if dtype is not None:
        opts["-dtype"] = dtype
    opts.update(extra or {})
    return opts


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", dtype: str | None = None,
             extra_options: dict | None = None, t_start: float | None = None,
             config_overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> dict:
    """Run one cell once and return the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = mf.load()
    spec = mf.cell(man, cell_name)
    cfg = {**mf.config(man, spec["config"]), **(config_overrides or {})}
    traffic = Traffic.from_dict({**mf.traffic(spec["traffic"]),
                                 **(traffic_overrides or {})})
    inputs = mf.module("inputs", cfg["inputs"])
    reference = mf.module("reference", cfg["reference"])
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    opts = session_options(cfg, traffic, dev, dtype, extra_options)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)

    from repro_torch.api import Session
    from repro_torch.kernels import ops

    lanes = range(traffic.batch)
    instances = [inputs.instance(cfg, b, dev) for b in lanes]
    session = Session(opts)

    def one_call(i: int, tracing: bool) -> CallRecord:
        draw = traffic.problem(seed, i)
        t0 = time.perf_counter()
        with _span(tracing, "bench.cost_draw"):
            mdps = [inputs.program_mdp(cfg, inputs.problem(cfg, inst, b,
                                                           draw, dev))
                    for b, inst in zip(lanes, instances)]
        with _span(tracing, "bench.solve_call"):
            if traffic.entry == "solve":
                results = [session.solve(mdps[0])]
            else:
                results = session.solve_fleet(mdps)
        t1 = time.perf_counter()
        del mdps
        records = []
        for b in lanes:
            r = results[b] if b < len(results) else None
            if r is None:
                records.append(LaneRecord(0, 0, [], False))
                answers[(i, b)] = None
                continue
            records.append(LaneRecord(
                outer=int(r.outer_iterations), inner=int(r.inner_iterations),
                trace_inner=[int(x) for x in r.trace_inner],
                converged=bool(r.converged)))
            answers[(i, b)] = (r.v, r.policy)
        return CallRecord(index=i, draw=draw, t0=t0, t1=t1, lanes=records)

    answers: dict = {}
    one_call(WARM_CALL, False)
    _sync(dev)
    answers.clear()
    setup_s = time.perf_counter() - t_start
    peak_setup = None
    if dev.type == "cuda":
        peak_setup = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    calls: list[CallRecord] = []
    extra: list[CallRecord] = []      # answered, checked, in no metric
    summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from bench.devtrace import idle_by_host, summarize
        ops.reset_launch_counts()
        on_card = [ProfilerActivity.CUDA] if dev.type == "cuda" else []
        with profile(activities=on_card or [ProfilerActivity.CPU]) as prof:
            tw0 = time.perf_counter()
            for i in range(traffic.traced_calls):
                calls.append(one_call(i, False))
            _sync(dev)
            window_s = time.perf_counter() - tw0
        summary = summarize(prof, window_s)
        print(f"[bench] traced {len(calls)} whole calls in "
              f"{window_s:.6f} s; kernel launches "
              f"{json.dumps(ops.launch_counts())}", file=sys.stderr)
        # one more call with host records, for the idle gaps' labels
        with profile(activities=[ProfilerActivity.CPU] + on_card) as prof:
            extra.append(one_call(traffic.traced_calls, True))
            _sync(dev)
        summary.idle_by_host = idle_by_host(prof)
        del prof
    else:
        tw0 = time.perf_counter()
        i = 0
        while True:
            calls.append(one_call(i, False))
            i += 1
            if calls[-1].t1 - tw0 >= seconds:
                break
        window_s = calls[-1].t1 - tw0
    print("[bench] calls (seconds, outer, inner of each instance) "
          + json.dumps([[c.t1 - c.t0, [lane.outer for lane in c.lanes],
                         [lane.inner for lane in c.lanes]] for c in calls]),
          file=sys.stderr)
    peak_window = None
    if dev.type == "cuda":
        peak_window = torch.cuda.max_memory_allocated(dev)
    session.close()
    del session, instances
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = RunRecord(cfg=cfg, traffic=traffic, options=opts, setup_s=setup_s,
                    window_s=window_s, calls=calls,
                    peak_window_bytes=peak_window, trace=summary)
    checks, failed = check_answers(cfg, answers, calls + extra, inputs,
                                   reference, dev)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for metric in mf.metrics_of(man, cell_name, kind):
        value = mf.reader(metric["name"])(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    correct = bool(answers) and all(c["value"] <= c["limit"]
                                    for c in checks.values())
    peaks = [p for p in (peak_setup, peak_window) if p is not None]
    out = {"correct": correct, "attempted": len(answers), "failed": failed,
           "metrics": metrics, "device": device_info(dev, peaks)}
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = {"device_ops": summary.top_ops(),
                            "idle_gaps": summary.top_idle()}
        tuned = json.loads(TUNE_CACHE.read_text()) if TUNE_CACHE.exists() \
            else {}
        choices = {k: v.get("choice")
                   for k, v in tuned.get("entries", {}).items()}
        print("[bench] tuner choices " + json.dumps(choices),
              file=sys.stderr)
    out["checks"] = checks
    return out


def check_answers(cfg, answers: dict, calls: list, inputs, reference,
                  dev) -> tuple:
    """Hold every answer of the window to the plain reference.  Returns
    the checks (each number beside its limit) and the count of instances
    that failed: missing, not converged, or out of a limit."""
    limits = cfg["limits"]
    draws = {c.index: c.draw for c in calls}
    missing = [key for key, a in answers.items() if a is None]
    unconverged = sum(not lane.converged for c in calls for lane in c.lanes)
    keys = sorted(key for key, a in answers.items() if a is not None)
    worst = dict.fromkeys(limits, 0.0)
    bad = set(missing)
    for b in sorted({b for _, b in keys}):
        inst = inputs.instance(cfg, b, dev)
        for draw in sorted({draws[i] for i, lane in keys if lane == b}):
            data = inputs.problem(cfg, inst, b, draw, dev)
            for i in (i for i, lane in keys
                      if lane == b and draws[i] == draw):
                got = reference.check(data, *answers[(i, b)])
                for name, value in got.items():
                    worst[name] = _worse(worst[name], value)
                    if not value <= limits[name]:
                        bad.add((i, b))
            del data
        del inst
    for c in calls:
        for b, lane in enumerate(c.lanes):
            if not lane.converged:
                bad.add((c.index, b))
    checks = {f"{name}_max": {"value": worst[name], "limit": limits[name]}
              for name in limits}
    checks.update({
        "unconverged": {"value": unconverged, "limit": 0},
        "missing": {"value": len(missing), "limit": 0},
        "none_checked": {"value": int(not keys), "limit": 0},
    })
    return checks, len(bad)


def _worse(a: float, b: float) -> float:
    """The worse of two readings; NaN is the worst."""
    if math.isnan(a) or (not math.isnan(b) and b <= a):
        return a
    return b


def device_info(dev: torch.device, peaks: list) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": max(peaks)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
