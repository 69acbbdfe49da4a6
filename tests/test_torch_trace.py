"""Spans and reads of the solve path (``repro_torch.utils.trace``) on the
CPU: recording off keeps nothing and changes no bit, spans nest by call,
the clock is the profiler's, and every device read is counted by site as
the code makes them."""

import math
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.api import Session
from repro_torch.core import generators
from repro_torch.utils import trace

RESTART = 8
OPTIONS = {"-device": "cpu", "-dtype": "float64", "-atol": 1e-8,
           "-restart": RESTART, "-kernel_tune": "off"}


def _fleet(count: int, n: int = 200):
    return [generators.garnet(n=n, m=5, k=4, gamma=0.95, seed=40 + i)
            for i in range(count)]


def _solve(session: Session, kind: str, mdps):
    if kind == "single":
        return [session.solve(mdps[0])]
    return session.solve_fleet(mdps)


@pytest.fixture(autouse=True)
def _fresh_records():
    trace.clear()
    yield
    trace.clear()


@pytest.mark.parametrize("method,kind,count", [
    ("ipi_gmres", "fleet", 3), ("ipi_gmres", "single", 1),
    ("mpi", "fleet", 3)])
def test_recording_off_keeps_nothing_and_changes_no_bit(method, kind,
                                                         count):
    mdps = _fleet(count)
    session = Session({**OPTIONS, "-method": method})
    off = _solve(session, kind, mdps)
    assert not trace.enabled() and trace.calls() == []
    with trace.recording():
        on = _solve(session, kind, mdps)
    assert len(trace.calls()) == 1
    for a, b in zip(off, on):
        for field in ("v", "policy", "trace_residual", "trace_inner"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field
        for field in ("residual", "gap_bound", "converged",
                      "outer_iterations", "inner_iterations", "span"):
            assert getattr(a, field) == getattr(b, field), field


def test_off_hands_back_one_shared_context_and_plain_reads():
    t = torch.arange(4)
    assert trace.span("a") is trace.span("b", device=t.device)
    with trace.span("a") as sp:
        assert sp is None
    assert torch.equal(trace.to_host(t, "site"), t)
    assert trace.calls() == []


# where each span of a GMRES fleet solve opens
PARENTS = {
    "driver.stack": {"session.solve_fleet"},
    "driver.init": {"session.solve_fleet"},
    "driver.loop": {"session.solve_fleet"},
    "driver.results": {"session.solve_fleet"},
    "ipi.step": {"driver.loop"},
    "ipi.backup": {"driver.init", "ipi.step"},
    "ipi.inner": {"ipi.step"},
    "gmres.cycle": {"ipi.inner"},
    "gmres.orthogonalize": {"gmres.cycle"},
    "gmres.givens": {"gmres.cycle"},
    "read.driver.stack": {"driver.stack"},
    "read.driver.results": {"driver.results"},
    "read.ipi.flags": {"driver.loop", "ipi.step"},
    "read.ipi.safeguard": {"ipi.step"},
    "read.lanes.start": {"ipi.inner"},
    "read.gmres.cycle": {"ipi.inner"},
}


def test_spans_nest_by_call_with_one_id_a_session_call():
    session = Session({**OPTIONS, "-method": "ipi_gmres"})
    mdps = _fleet(3)
    with trace.recording():
        session.solve_fleet(mdps)
        session.solve(mdps[0])
    fleet, single = trace.calls()
    assert fleet.id != single.id
    assert fleet.root.name == "session.solve_fleet" and \
        single.root.name == "session.solve"
    assert fleet.root.parent is None
    names = {s.name for s in fleet.spans}
    assert names == set(PARENTS) | {"session.solve_fleet"}
    for s in fleet.spans[1:]:
        assert s.call == fleet.id
        assert s.parent.name in PARENTS[s.name], (s.name, s.parent.name)
        assert s.parent.start_ns <= s.start_ns <= s.end_ns \
            <= s.parent.end_ns
    assert all(s.call == single.id for s in single.spans)
    assert "read.gmres.go" in {s.name for s in single.spans}


def test_self_time_is_duration_less_the_children():
    with trace.recording():
        with trace.span("outer"):
            time.sleep(0.002)
            with trace.span("a"):
                time.sleep(0.003)
                with trace.span("leaf"):
                    time.sleep(0.001)
            with trace.span("a"):
                time.sleep(0.001)
    call, = trace.calls()
    by = {}
    for s in call.spans:
        by.setdefault(s.name, []).append(s)
    outer, = by["outer"]
    summary = call.summary()
    kids = sum(s.duration_ns for s in by["a"])
    assert summary["self_ms"]["outer"] == pytest.approx(
        (outer.duration_ns - kids) / 1e6, abs=1e-6)
    a_self = sum(s.duration_ns for s in by["a"]) - by["leaf"][0].duration_ns
    assert summary["self_ms"]["a"] == pytest.approx(a_self / 1e6, abs=1e-6)
    assert summary["self_ms"]["leaf"] == summary["total_ms"]["leaf"]
    assert summary["total_ms"]["outer"] == pytest.approx(
        outer.duration_ns / 1e6, abs=1e-6)
    assert summary["device_ms"] == {} and summary["reads"] == {}


def test_spans_share_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer") as sp:
            with record_function("inner.region"):
                torch.ones(64).sum()
    rec, = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "inner.region"]
    assert sp.start_ns <= rec.start_ns()
    assert rec.start_ns() + rec.duration_ns() <= sp.end_ns


def test_recording_follows_the_profiler():
    assert not trace.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.enabled()
        with trace.span("x") as sp:
            assert isinstance(sp, trace.Span)
    assert not trace.enabled()
    with trace.span("y") as sp:
        assert sp is None
    assert [c.root.name for c in trace.calls()] == ["x"]


def test_each_thread_keeps_its_own_bounded_ring():
    seen = {}

    def worker():
        with trace.span("in.thread"):
            pass
        seen["names"] = [c.root.name for c in trace.calls()]

    with trace.recording():
        for _ in range(trace.RING + 5):
            with trace.span("main"):
                pass
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen["names"] == ["in.thread"]
    mine = trace.calls()
    assert len(mine) == trace.RING and {c.root.name for c in mine} == {"main"}


def _cycles(steps: int, restart: int) -> int:
    return math.ceil(steps / restart)


def _expected_reads(method: str, results, fleet_of: int) -> dict:
    """Reads by site, derived from the code and the results' counts: the
    driver reads the flags once before the loop, once at a chunk's start,
    once a step and once after the chunk; each step reads the safeguard
    (GMRES), its KSP's start (batched bodies) or first test (one lane),
    once a restart cycle (GMRES) or a sweep (Richardson); each lane's
    result is read field by field; stacking lanes with their own tables
    stops at the first that differs."""
    steps = max(r.outer_iterations for r in results)
    per_step = [[int(r.trace_inner[k]) for r in results
                 if k < r.outer_iterations] for k in range(steps)]
    want = {"ipi.flags": steps + 3, "driver.results": 8 * len(results)}
    if fleet_of > 1:
        want["driver.stack"] = 1
    if method == "ipi_gmres":
        want["ipi.safeguard"] = steps
        want["gmres.cycle"] = sum(max(_cycles(j, RESTART) for j in step)
                                  for step in per_step)
        want["lanes.start" if fleet_of > 1 else "gmres.go"] = steps
    else:
        want["lanes.start"] = steps
        want["richardson.sweep"] = sum(max(step) for step in per_step)
    return want


@pytest.mark.parametrize("method,kind,count", [
    ("ipi_gmres", "fleet", 3), ("ipi_gmres", "fleet", 1),
    ("ipi_gmres", "single", 1), ("mpi", "fleet", 3), ("mpi", "single", 1)])
def test_reads_counted_by_site_as_the_code_makes_them(method, kind, count):
    session = Session({**OPTIONS, "-method": method})
    with trace.recording():
        results = _solve(session, kind, _fleet(count))
    call, = trace.calls()
    got = call.summary()["reads"]
    assert got == _expected_reads(method, results, count)
    assert sum(got.values()) == sum(s.name.startswith("read.")
                                    for s in call.spans)
    assert session.stats[-1]["trace"]["reads"] == got


def test_run_stats_carry_trace_only_while_recording(tmp_path):
    path = tmp_path / "stats.jsonl"
    session = Session({**OPTIONS, "-method": "ipi_gmres",
                       "-file_stats": str(path)})
    mdps = _fleet(2)
    session.solve_fleet(mdps)
    with trace.recording():
        session.solve_fleet(mdps)
    session.solve(mdps[0])
    plain, traced, after = session.stats
    assert "trace" not in plain and "trace" not in after
    assert set(traced) == set(plain) | {"trace"}
    t = traced["trace"]
    assert set(t) == {"total_ms", "self_ms", "device_ms", "reads",
                      "read_wait_ms", "launches"}
    assert t["total_ms"]["session.solve_fleet"] >= \
        t["total_ms"]["driver.loop"] > 0
    assert set(t["read_wait_ms"]) == set(t["reads"])
    lines = path.read_text().splitlines()
    assert len(lines) == 3 and '"trace"' in lines[1] \
        and '"trace"' not in lines[0] + lines[2]
    assert np.isfinite(t["self_ms"]["session.solve_fleet"])
