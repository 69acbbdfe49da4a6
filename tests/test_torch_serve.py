"""The solve server of the torch port against the JAX reference's, on the
CPU, and the session's LRU caches.

Arrival order is made deterministic for both servers: each wave of
requests is submitted while the test holds the request queue's lock (the
scheduler cannot look at the queue in between), with
``-serve_batch_window 0``, so the scheduler groups exactly that wave.
Both servers then see the same stream, and must give:

* the same dispatches, bucket shapes (padded state count, fleet slot),
  padded lanes, batch sizes and program-cache counters (hits, misses,
  evictions, per-slot dispatch counts) — exactly;
* per-request results within ``tests/test_torch_fleet.py``'s tolerances
  (float64: policy and outer / inner counts exact, values within 1e-9);
* the same admission, drain and close errors (reason and message, the
  package names aside);
* monitor streams attributed per request (the lane's own residuals).

Also: ``LRUCache`` and ``ProgramCache`` counters over one sequence of
operations, ``slot_size``'s grids, the session's device-fleet cache on a
repeated function-backed fleet, concurrent ``-file_stats`` appends, and
the serve CLI with ``--device cpu``.  No test asserts a wall-clock bound.
"""

import gc
import json
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.api import MDP as JMDP, Options as JOptions
from repro.serve import ProgramCache as JProgramCache
from repro.serve import Server as JServer
from repro.serve import percentile as jpercentile
from repro.serve import program_key as jprogram_key
from repro.serve import slot_size as jslot_size
from repro.utils.lru import LRUCache as JLRU
from repro_torch import api as tapi
from repro_torch.launch import serve as tserve_cli
from repro_torch.serve import (AdmissionError, ProgramCache, Server,
                               percentile, program_key, slot_size)
from repro_torch.utils.lru import LRUCache

jax.config.update("jax_enable_x64", True)

BASE = {"-method": "vi", "-atol": 1e-8, "-dtype": "float64",
        "-serve_batch_window": 0.0}
JBASE = {"-layout": "single", "-kernel_impl": "xla", "-kernel_tune": "off"}
TBASE = {"-device": "cpu"}
TIMEOUT = 600          # seconds a result may take (a hang guard, not a bound)


def _mdps(spec, api):
    """Build one request's MDP from a spec with either package's API."""
    kind, kw = spec
    if kind == "dense":
        ell = api.MDP.from_generator("garnet", **kw)
        core = ell.core if hasattr(ell, "core") and not callable(ell.core) \
            else ell._core
        return api.MDP(core.as_dense())
    if kind == "deferred":
        return api.MDP.from_generator("garnet", deferred=True, **kw)
    return api.MDP.from_generator(kind, **kw)


class _JAPI:
    MDP = JMDP


def _garnet(n, seed, gamma=0.9):
    return ("garnet", dict(n=n, m=3, k=4, gamma=gamma, seed=seed))


def _run_waves(server_cls, options, waves):
    """Each wave: ``[(spec, overrides, monitor)]`` submitted under the
    queue's lock, then waited for.  Returns (results, streams, stats)."""
    api = tapi if server_cls is Server else _JAPI
    results, streams = [], []
    with server_cls(options) as srv:
        for wave in waves:
            built = [(_mdps(spec, api), ov, mon) for spec, ov, mon in wave]
            with srv._queue.cv:
                reqs = [srv.submit(m, monitor=mon, **ov)
                        for m, ov, mon in built]
            for r in reqs:
                streams.append(list(srv.stream(r)) if r.monitor else None)
                results.append(r.result(timeout=TIMEOUT))
        st = srv.stats()
    return results, streams, st


def _held(t, j, v_rtol=1e-9):
    np.testing.assert_array_equal(t.policy, np.asarray(j.policy))
    assert (t.outer_iterations, t.inner_iterations, t.converged) == \
        (j.outer_iterations, j.inner_iterations, j.converged)
    scale = float(np.abs(np.asarray(j.v)).max())
    assert float(np.abs(t.v - np.asarray(j.v)).max()) <= v_rtol * scale


_STAT_KEYS = ("submitted", "completed", "failed", "rejected", "dispatches",
              "dispatched_requests", "padded_lanes", "batch")


def _same_counters(tst, jst):
    for key in _STAT_KEYS:
        assert tst[key] == jst[key], key
    tpc, jpc = tst["program_cache"], jst["program_cache"]
    assert tpc == jpc


SCENARIOS = {
    # compatible arrivals coalesce; 48 and 64 share one bucket (25% pad)
    "coalesce": (BASE, [[(_garnet(n, i), {}, False) for i, n in
                         enumerate([48, 64, 48, 64, 48, 48, 64, 48])]]),
    # 48 vs 96: past the pad-waste rule, two buckets of one group
    "two_buckets": (BASE, [[(_garnet(n, 10 + i), {}, False) for i, n in
                            enumerate([48, 96, 48, 96, 48, 96])]]),
    # two waves of 5 pad to the mid2 slot of 6: the second wave hits
    "slot_padding": (BASE, [[(_garnet(48, 20 + i), {}, False)
                             for i in range(5)],
                            [(_garnet(48, 30 + i), {}, False)
                             for i in range(5)]]),
    # overrides split signatures; the max_batch cap splits a group
    "overrides": ({**BASE, "-serve_max_batch": 3},
                  [[(_garnet(48, 40 + i), {"atol": a}, False)
                    for i, a in enumerate([1e-6, 1e-6, 1e-8, 1e-8, 1e-6,
                                           1e-6, 1e-6])]]),
    # a one-slot program cache: alternating shapes evict each other
    "eviction": ({**BASE, "-serve_program_cache": 1},
                 [[(_garnet(48, 50), {}, False)],
                  [(_garnet(96, 51), {}, False)],
                  [(_garnet(48, 52), {}, False)]]),
    # -method auto, resolved per bucket; pow2 slots
    "auto": ({**BASE, "-method": "auto", "-serve_slot_policy": "pow2",
              "-atol": 1e-6},
             [[(_garnet(48, 60 + i, gamma=0.95), {}, False)
               for i in range(3)]
              + [(("chain_walk", dict(n=120, gamma=0.99)), {}, False)]]),
    # dense requests batch by n; deferred ones solved matrix-free (their
    # own signature); exact slots
    "dense_and_matrix_free": (
        {**BASE, "-serve_slot_policy": "exact"},
        [[(("dense", dict(n=32, m=3, k=4, gamma=0.9, seed=70 + i)), {},
           False) for i in range(3)]
         # a matrix-free gamma sweep: one row spec, so one bucket
         + [(("deferred", dict(n=40, m=3, k=4, gamma=g, seed=80)),
             {"mdp_materialize": "matrix_free"}, False)
            for g in (0.5, 0.6)]]),
    # monitor streams, one per request
    "monitor": (BASE, [[(_garnet(48, 90 + i), {}, True)
                        for i in range(4)]]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_server_matches_reference(name):
    opts, waves = SCENARIOS[name]
    jres, jstreams, jst = _run_waves(JServer, {**opts, **JBASE}, waves)
    tres, tstreams, tst = _run_waves(Server, {**opts, **TBASE}, waves)
    _same_counters(tst, jst)
    assert tst["completed"] == sum(len(w) for w in waves)
    for t, j in zip(tres, jres):
        _held(t, j)
    for ts, js, r in zip(tstreams, jstreams, tres):
        if js is None:
            assert ts is None
            continue
        # every record carries its own request id and its lane's residual
        # trajectory, one record per outer step (k = 0 included); the
        # stream spans the whole bucket's run
        assert [rec["k"] for rec in ts] == [rec["k"] for rec in js]
        assert len({rec["request"] for rec in ts}) == 1
        res = np.array([rec["res"] for rec in ts])
        k = min(len(res), len(r.trace_residual))
        assert np.array_equal(res[:k], r.trace_residual[:k])
        np.testing.assert_allclose(res, [rec["res"] for rec in js],
                                   rtol=1e-9, atol=0)


def test_dispatch_log_and_request_placement():
    opts, waves = SCENARIOS["two_buckets"]
    with Server({**opts, **TBASE}) as srv:
        built = [_mdps(spec, tapi) for spec, _, _ in waves[0]]
        with srv._queue.cv:
            reqs = [srv.submit(m) for m in built]
        for r in reqs:
            r.result(timeout=TIMEOUT)
        log = srv.dispatch_log()
        st = srv.stats()
    assert [d["dispatch"] for d in log] == list(range(st["dispatches"]))
    assert sorted(i for d in log for i in d["requests"]) == \
        sorted(r.id for r in reqs)
    for r in reqs:
        d = log[r.dispatch]
        assert r.id in d["requests"]
        assert d["n_pad"] >= r.mdp.n and d["slot"] >= len(d["requests"])
        assert d["launches"] is None        # the CPU counts no launches
    assert {(d["n_pad"], d["slot"]) for d in log} == {
        (s["n_pad"], s["fleet_slot"]) for s in st["program_cache"]["slots"]}


def test_matrix_free_requests_rebuild_on_the_scheduler_thread():
    """A matrix-free request is rebuilt on the scheduler thread, whose
    rebuilds see their own chunk memo (a context variable): its result is
    bit for bit a solve of the same MDP in this thread, while this thread
    rebuilds the same constructors concurrently."""
    from repro_torch.kernels import matrix_free
    kw = dict(n=300, m=3, k=4, gamma=0.9, seed=5)
    opts = {**BASE, **TBASE, "-atol": 1e-6}
    with Server(opts) as srv:
        req = srv.submit(tapi.MDP.from_generator("garnet", deferred=True,
                                                 **kw),
                         mdp_materialize="matrix_free")
        # this thread's own matrix-free solves while the scheduler works
        with tapi.Session({**opts, "-mdp_materialize": "matrix_free"}) as s:
            here = [s.solve(tapi.MDP.from_generator("garnet", deferred=True,
                                                    **kw))
                    for _ in range(2)]
        served = req.result(timeout=TIMEOUT)
    assert matrix_free.chunk_memo(torch.zeros(1, dtype=torch.int32)) is None
    for r in here:
        assert np.array_equal(served.v.view(np.uint64), r.v.view(np.uint64))
        assert np.array_equal(served.policy, r.policy)
        assert (served.outer_iterations, served.inner_iterations) == \
            (r.outer_iterations, r.inner_iterations)


# --------------------------------------------------------------------------- #
# admission, drain, close                                                     #
# --------------------------------------------------------------------------- #

def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, getattr(e, "reason", None), str(e)
    return None


def _same_error(t, j):
    assert t is not None and j is not None
    assert t[:2] == j[:2]
    assert t[2] == j[2].replace("repro.api.MDP", "repro_torch.api.MDP")


def test_admission_too_large_matches_reference():
    for server_cls, api, extra in ((Server, tapi, TBASE),
                                   (JServer, _JAPI, JBASE)):
        with server_cls({**BASE, **extra, "-serve_max_states": 50}) as srv:
            srv.submit(_mdps(_garnet(48, 0), api)).result(timeout=TIMEOUT)
            big = _err(lambda: srv.submit(_mdps(_garnet(64, 1), api)))
            # a matrix-free request is charged its O(n) operator bytes
            # against the table bytes of 50 states: up to 101 states here
            mf_ok = srv.submit(_mdps(("deferred", dict(
                n=100, m=3, k=4, gamma=0.5, seed=2)), api),
                mdp_materialize="matrix_free")
            mf_ok.result(timeout=TIMEOUT)
            mf_big = _err(lambda: srv.submit(_mdps(("deferred", dict(
                n=100_000, m=3, k=4, gamma=0.9, seed=3)), api),
                mdp_materialize="matrix_free"))
            st = srv.stats()
        if server_cls is Server:
            t = (big, mf_big, st)
        else:
            j = (big, mf_big, st)
    _same_error(t[0], j[0])
    _same_error(t[1], j[1])
    assert t[0][1] == t[1][1] == "too_large"
    assert t[2]["rejected"] == j[2]["rejected"] == {"too_large": 2}
    assert t[2]["completed"] == j[2]["completed"] == 2


def test_admission_queue_full_draining_and_closed_match_reference():
    out = {}
    for server_cls, api, extra in ((Server, tapi, TBASE),
                                   (JServer, _JAPI, JBASE)):
        srv = server_cls({**BASE, **extra, "-serve_max_queue": 2,
                          "-serve_batch_window": 600.0})
        try:
            r1 = srv.submit(_mdps(_garnet(48, 50), api))
            r2 = srv.submit(_mdps(_garnet(48, 51), api))
            full = _err(lambda: srv.submit(_mdps(_garnet(48, 52), api)))
            assert srv.drain(timeout=TIMEOUT)     # cuts the window short
            assert r1.done and r2.done
            draining = _err(lambda: srv.submit(_mdps(_garnet(48, 53),
                                                     api)))
            st = srv.stats()
        finally:
            srv.close()
        closed = _err(lambda: srv.submit(_mdps(_garnet(48, 54), api)))
        out[server_cls] = (full, draining, closed, st,
                           r1.result(timeout=1), r2.result(timeout=1))
    t, j = out[Server], out[JServer]
    for a, b in zip(t[:3], j[:3]):
        _same_error(a, b)
    assert [e[1] for e in t[:3]] == ["queue_full", "draining", "closed"]
    _same_counters(t[3], j[3])
    assert t[3]["queue_depth"] == 0 and t[3]["in_flight"] == 0
    assert t[3]["draining"] and j[3]["draining"]
    _held(t[4], j[4])
    _held(t[5], j[5])


def test_close_fails_undispatched_requests_and_junk_submits():
    srv = Server({**BASE, **TBASE, "-serve_batch_window": 600.0})
    mdps = [_mdps(_garnet(48, 100 + i), tapi) for i in range(3)]
    with srv._queue.cv:
        reqs = [srv.submit(m) for m in mdps]
    with pytest.raises(ValueError, match="one MDP per request"):
        from repro_torch.core import generators, stack_mdps
        srv.submit(tapi.MDP(stack_mdps([generators.garnet(
            n=32, m=3, k=4, seed=s) for s in range(2)])))
    with pytest.raises(TypeError, match="repro_torch.api.MDP"):
        srv.submit("not an mdp")
    with pytest.raises(ValueError, match="monitor=True"):
        next(iter(srv.stream(reqs[0])))
    with pytest.raises(KeyError, match="unknown"):
        srv.result(10 ** 9)
    srv.close(timeout=0.0)                  # the window never closes
    for r in reqs:
        with pytest.raises(AdmissionError) as e:
            r.result(timeout=TIMEOUT)
        assert e.value.reason == "closed"
    assert srv.stats()["failed"] == 3


def test_server_over_a_mesh_is_not_ported():
    """A Server over a mesh (a world of one gloo rank in this process, a
    fleet mesh given to its session) solves its buckets under the fleet
    layout, each request bit for bit its solo solve; the multi-rank server
    runs in tests/test_torch_fleet_sharded.py."""
    import torch.distributed as dist
    from repro_torch.core import driver as tdriver
    from repro_torch.core.ipi import IPIOptions as TOpts
    from repro_torch.launch import mesh as lm
    lm.init_distributed("cpu", store=dist.HashStore(), rank=0,
                        world_size=1)
    try:
        mesh = lm.make_fleet_mesh(1, device="cpu")
        mdps = [_mdps(_garnet(n, i), tapi) for i, n in
                enumerate((60, 80, 60))]
        with tapi.Session({**TBASE, **BASE}, mesh=mesh) as s:
            assert s.placement(fleet_size=3) == (mesh, "fleet")
            with Server(session=s) as srv:
                reqs = [srv.submit(m) for m in mdps]
                got = [r.result(timeout=TIMEOUT) for r in reqs]
            assert s.stats[-1]["layout"] == "fleet"
        for m, r in zip(mdps, got):
            solo = tdriver.solve(m.core, TOpts(method="vi", atol=1e-8,
                                               dtype="float64"),
                                 device="cpu")
            assert np.array_equal(r.v.view(np.uint64), solo.v.view(np.uint64))
            assert r.outer_iterations == solo.outer_iterations
    finally:
        lm.shutdown()
    with pytest.raises(ValueError, match="OR an existing session"):
        Server(BASE, session=tapi.Session(TBASE))


def test_serve_options_match_reference():
    from repro.api.options import OPTION_SPECS as JSPECS
    keys = [k for k in JSPECS if k.startswith("-serve_")]
    assert keys == [k for k in tapi.OPTION_SPECS if k.startswith("-serve_")]
    for key in keys:
        ts, js = tapi.OPTION_SPECS[key], JSPECS[key]
        assert (ts.type, ts.default, ts.choices, ts.nullable) == \
            (js.type, js.default, js.choices, js.nullable), key
    for key, bad in (("-serve_batch_window", -1.0), ("-serve_max_queue", 0),
                     ("-serve_max_states", 0), ("-serve_deadline_ms", 0.0),
                     ("-serve_slot_policy", "fib")):
        with pytest.raises(tapi.OptionTypeError) as te:
            tapi.Options({key: bad})
        with pytest.raises(Exception) as je:
            JOptions({key: bad})
        assert str(te.value) == str(je.value), key


def test_deadline_cuts_the_window_without_a_wall_bound():
    """``-serve_deadline_ms`` dispatches a lone request before its 3600 s
    window could close: the request completes and is its own dispatch
    (without the deadline it would wait out the window)."""
    with Server({**BASE, **TBASE, "-serve_batch_window": 3600.0,
                 "-serve_deadline_ms": 50.0}) as srv:
        r = srv.submit(_mdps(_garnet(48, 110), tapi))
        assert r.result(timeout=TIMEOUT).converged
        assert srv.stats()["dispatches"] == 1
        assert r.dispatched - r.submitted < 3600.0


# --------------------------------------------------------------------------- #
# caches and counters                                                         #
# --------------------------------------------------------------------------- #

def _lru_ops(lru):
    out = [lru.get("a"), lru.put("a", 1), lru.put("b", 2), lru.get("a"),
           lru.put("c", 3), lru.get("b"), lru.peek("a"), lru.put("a", 9),
           lru.get("c"), lru.pop("c"), lru.put("d", 4), lru.put("e", 5),
           "a" in lru, len(lru), lru.keys(), lru.values(), lru.items(),
           list(lru)]
    lru.clear()
    return out + [len(lru), lru.stats()]


def test_lru_counters_match_reference():
    assert _lru_ops(LRUCache(2)) == _lru_ops(JLRU(2))
    st = LRUCache(2)
    _lru_ops(st)
    assert st.stats() == {"size": 0, "capacity": 2, "hits": 2,
                          "misses": 2, "evictions": 2, "hit_rate": 0.5}
    for cls in (LRUCache, JLRU):
        with pytest.raises(ValueError, match="capacity must be >= 1"):
            cls(0)


def test_program_cache_and_slot_grid_match_reference():
    sig = (("-atol", 1e-6),), "mincost", "ell", 3, 4
    keys = [(sig, 48, 6), (sig, 96, 2), (sig, 48, 6), (sig, 64, 6),
            (sig, 96, 2), (sig, 48, 6), (sig, 48, 4)]
    t, j = ProgramCache(2), JProgramCache(2)
    assert [t.touch(program_key(*k)) for k in keys] == \
        [j.touch(jprogram_key(*k)) for k in keys]
    assert t.stats() == j.stats()
    for policy in ("mid2", "pow2", "exact"):
        for cap in (1, 4, 6, 32, 64):
            assert [slot_size(n, policy, cap) for n in range(1, 70)] == \
                [jslot_size(n, policy, cap) for n in range(1, 70)]
    assert [slot_size(n, "mid2", 64) for n in
            (1, 2, 3, 4, 5, 6, 7, 12, 13, 24, 25)] == \
        [1, 2, 3, 4, 6, 6, 8, 12, 16, 24, 32]
    xs = [0.3, 0.1, 0.7, 0.2, 0.9, 0.4]
    for q in (0, 10, 50, 95, 100):
        assert percentile(xs, q) == jpercentile(xs, q)


def test_session_fleet_cache_counts_a_repeated_function_backed_fleet():
    mdps = [tapi.MDP.from_generator("garnet", deferred=True, n=60, m=3, k=4,
                                    gamma=0.9, seed=s) for s in range(3)]
    with tapi.Session({**BASE, **TBASE,
                       "-mdp_materialize": "device"}) as s:
        cs = s.cache_stats
        assert set(cs) == {"fleet", "run_chunk_programs"}
        assert cs["run_chunk_programs"] == 0
        r1 = s.solve_fleet(mdps)
        c1 = dict(s.cache_stats["fleet"])
        r2 = s.solve_fleet(mdps)
        c2 = dict(s.cache_stats["fleet"])
        assert s.stats[-1]["fleet"]["cache"] == c2
        # solved one by one: the same results (no cache entry)
        solo = [s.solve(m) for m in mdps]
    assert (c1["misses"], c1["hits"], c1["size"]) == (1, 0, 1)
    assert (c2["misses"], c2["hits"], c2["size"]) == (1, 1, 1)
    for a, b, c in zip(r1, r2, solo):
        assert np.array_equal(a.v, b.v) and np.array_equal(a.v, c.v)
        assert a.outer_iterations == c.outer_iterations
    with tapi.Session({**BASE, **TBASE}) as s:
        s.solve_fleet(mdps)
        assert s.cache_stats["fleet"]["misses"] == 1
    # the entry dies with its builders
    with tapi.Session({**BASE, **TBASE,
                       "-mdp_materialize": "device"}) as s:
        s.solve_fleet(mdps[:2])
        s.solve_fleet(mdps[1:])
        assert s.cache_stats["fleet"]["size"] == 2
        del mdps[0]
        gc.collect()
        s.solve_fleet(mdps)
        cs = s.cache_stats["fleet"]
        assert (cs["size"], cs["hits"], cs["misses"]) == (1, 1, 2)


def test_concurrent_jsonl_stats_stay_valid(tmp_path):
    """More solving threads than cores on one session, the interpreter
    switching threads as often as it can: every solve's entry lands once,
    in the stats and as one whole line of the jsonl file."""
    path = tmp_path / "stats.jsonl"
    mdps = [_mdps(_garnet(32, 120 + i), tapi) for i in range(16)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tapi.Session({**BASE, **TBASE, "-file_stats": str(path),
                           "-file_stats_format": "jsonl"}) as sess:
            threads = [threading.Thread(target=sess.solve, args=(m,))
                       for m in mdps]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            assert len(sess.stats) == len(mdps)
    finally:
        sys.setswitchinterval(switch)
    lines = path.read_text().strip().splitlines()
    assert len(lines) == len(mdps)         # one line per solve, none torn
    assert all(json.loads(ln)["solves"][0]["converged"] for ln in lines)
    assert sorted(json.loads(ln)["solves"][0]["n"] for ln in lines) == \
        [32] * len(mdps)


def test_program_cache_and_telemetry_counters_under_threads():
    """Many threads touching one program cache and one telemetry, switching
    as often as the interpreter allows: no count is lost."""
    from repro_torch.serve import Telemetry
    cache, tel = ProgramCache(4), Telemetry()
    keys = [program_key(("s",), n, 1) for n in range(6)]
    n_threads, n_each = 32, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(n_each):
                cache.touch(keys[(i + j) % len(keys)])
                tel.on_submit()
                tel.on_dispatch(1, 0)
                tel.on_complete(0.001)
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    st, snap = cache.stats(), tel.snapshot()
    total = n_threads * n_each
    assert st["hits"] + st["misses"] == total
    assert st["misses"] - st["evictions"] == st["size"] == 4
    assert sum(s["dispatches"] for s in st["slots"]) <= total
    assert (snap["submitted"], snap["dispatches"], snap["completed"]) == \
        (total, total, total)


# --------------------------------------------------------------------------- #
# the serve CLI                                                               #
# --------------------------------------------------------------------------- #

def test_serve_cli_on_cpu(capsys):
    rc = tserve_cli.main(["--requests", "6", "--n-choices", "48,96",
                          "--m", "3", "--k", "4", "--gamma", "0.9",
                          "--rate", "0", "--clients", "2", "--prebuild",
                          "--device", "cpu", "--option", "method=auto",
                          "--option", "serve_max_batch=4",
                          "--option", "atol=1e-6"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[serve] completed=6/6" in out and "device=cpu" in out
    assert out.count("[serve] request ") == 6
    assert "[serve] latency p50=" in out and "program_cache" in out
    assert "[serve] dispatch 0: n_pad=" in out


def test_serve_cli_workload_file_with_dense_and_deferred(tmp_path, capsys):
    lines = [dict(instance="garnet", n=40, m=3, k=4, gamma=0.9, seed=1,
                  monitor=True),
             dict(instance="garnet", n=32, m=3, k=4, gamma=0.9, seed=2,
                  dense=True),
             dict(instance="garnet", n=50, m=3, k=4, gamma=0.9, seed=3,
                  deferred=True,
                  overrides={"-mdp_materialize": "matrix_free"}),
             dict(instance="chain_walk", n=64, gamma=0.9,
                  overrides={"-atol": 1e-6})]
    path = tmp_path / "reqs.jsonl"
    path.write_text("# a comment\n" + "\n".join(json.dumps(x)
                                                 for x in lines) + "\n")
    rc = tserve_cli.main(["--workload", str(path), "--device", "cpu",
                          "--rate", "100", "--window", "0.01"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[serve] completed=4/4" in out
    assert "records=" not in out or "FAILED" not in out
