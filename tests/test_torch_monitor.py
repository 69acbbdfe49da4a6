"""The torch port's monitors and run statistics against the JAX package's.

* The monitor records of one solve match the reference's record for
  record: ``k``, ``inner`` and ``diverged`` exactly, ``res`` within
  ``(1 + gamma)`` times the solve's value tolerance (``res = ||T v -
  v||_inf`` moves by at most that much when ``v`` does).
* In the port, ``-monitor_mode stream`` and ``chunk`` give identical
  records (all but ``elapsed``), whatever the chunk size.
* ``print_monitor`` prints the reference's line format.
* ``-file_stats`` in both formats holds the reference's keys (the port's
  entries add ``device``).
"""

import json

import jax
import numpy as np
import pytest

from repro.api import MDP as JMDP
from repro.api import Session as JSession
from repro.core import driver as jdriver
from repro.core import generators as jgen
from repro.core import methods as jmethods
from repro.core.ipi import IPIOptions as JOpts
from repro_torch.api import MDP, madupite_session
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core import methods as tmethods
from repro_torch.core.ipi import IPIOptions as TOpts

jax.config.update("jax_enable_x64", True)

GARNET = dict(n=97, m=5, k=3, gamma=0.95, seed=1)
KEYS = {"k", "res", "inner", "diverged", "elapsed"}


def _records(solve):
    recs = []
    r = solve(recs.append)
    return r, recs


@pytest.mark.parametrize("method,dtype", [("ipi_gmres", "float64"),
                                          ("vi", "float64"),
                                          ("ipi_bicgstab", "float64"),
                                          ("mpi", "float32")])
def test_records_match_reference(method, dtype):
    common = dict(method=method, dtype=dtype, monitor=True,
                  atol=1e-8 if dtype == "float64" else 1e-4)
    rj, jrecs = _records(lambda cb: jdriver.solve(
        jgen.garnet(**GARNET), JOpts(impl="xla", **common), monitor=cb,
        chunk=7))
    rt, trecs = _records(lambda cb: tdriver.solve(
        tgen.garnet(**GARNET), TOpts(**common), monitor=cb, chunk=7,
        device="cpu"))
    assert len(trecs) == len(jrecs) == rj.outer_iterations + 1
    scale = float(np.abs(rj.v).max())
    tol = (1 + GARNET["gamma"]) * (max(1e-9 * scale, rj.gap_bound)
                                   if dtype == "float64" else 1e-4 * scale)
    for j, t in zip(jrecs, trecs):
        assert set(t) == set(j) == KEYS
        assert (t["k"], t["inner"], t["diverged"]) == \
            (j["k"], j["inner"], j["diverged"])
        assert abs(t["res"] - j["res"]) <= tol, (t, j)
    assert [r["k"] for r in trecs] == list(range(rt.outer_iterations + 1))
    assert [r["inner"] for r in trecs[1:]] == list(rt.trace_inner)


@pytest.mark.parametrize("chunk", [1, 3, 64])
@pytest.mark.parametrize("method", ["ipi_gmres", "ipi_anderson", "vi"])
def test_stream_and_chunk_records_are_identical(method, chunk):
    def run(mode):
        opts = TOpts(method=method, dtype="float64", monitor=True,
                     monitor_mode=mode)
        return _records(lambda cb: tdriver.solve(
            tgen.chain_walk(n=60, gamma=0.95), opts, monitor=cb,
            chunk=chunk, device="cpu"))

    (rs, stream), (rc, chunked) = run("stream"), run("chunk")
    drop = lambda recs: [{k: v for k, v in r.items() if k != "elapsed"}
                         for r in recs]
    assert drop(stream) == drop(chunked)
    assert len(stream) == rs.outer_iterations + 1
    np.testing.assert_array_equal(rs.v, rc.v)


def test_diverged_flag_reaches_the_last_record():
    """A solve whose residual blows past ``divtol`` stops with the flag on
    its last record only, in both modes (a user KSP that overshoots)."""
    def overshoot(matvec, b, x0, *, tol, maxiter, axes):
        x = x0 + 50.0 * (b - matvec(x0))
        return x, 1, axes.norm_inf(b - matvec(x))

    tmethods.register_ksp("overshoot", overshoot, auto_method=False)
    tmethods.register_method("ipi_overshoot", ksp="overshoot",
                             inner="forcing", safeguarded=False)
    try:
        recs = {}
        for mode in ("stream", "chunk"):
            opts = TOpts(method="ipi_overshoot", dtype="float64",
                         monitor=True, monitor_mode=mode, divtol=10.0)
            r, recs[mode] = _records(lambda cb: tdriver.solve(
                tgen.garnet(**GARNET), opts, monitor=cb, device="cpu"))
            assert r.diverged and not r.converged
        for mode, rs in recs.items():
            assert [x["diverged"] for x in rs] == \
                [False] * (len(rs) - 1) + [True], mode
    finally:
        tmethods.unregister_method("ipi_overshoot")
        tmethods.unregister_ksp("overshoot")


def test_a_failing_monitor_does_not_stop_the_solve(capsys):
    def broken(rec):
        raise RuntimeError("sink is down")

    r = tdriver.solve(tgen.garnet(**GARNET),
                      TOpts(method="vi", monitor=True, atol=1e-6),
                      monitor=broken, device="cpu")
    assert r.converged
    assert "[monitor] callback error (record dropped): RuntimeError" in \
        capsys.readouterr().out


@pytest.mark.parametrize("rec", [
    dict(k=3, res=1.25e-7, inner=12, diverged=False, elapsed=0.5),
    dict(k=4, res=float("nan"), inner=0, diverged=True, elapsed=12.0),
    dict(k=5, res=[1e-3, 2e-3], inner=[3, 4], diverged=[False, True],
         elapsed=0.25)])
def test_print_monitor_lines_match_reference(rec, capsys):
    jmethods.print_monitor(rec)
    want = capsys.readouterr().out
    tmethods.print_monitor(rec)
    assert capsys.readouterr().out == want
    assert want.startswith("[monitor] k=")


def test_session_monitor_lands_in_stats(capsys):
    seen = []
    with madupite_session({"-device": "cpu", "-method": "ipi_gmres",
                           "-dtype": "float64"}) as s:
        r = s.solve(MDP.from_generator("garnet", **GARNET),
                    monitor=seen.append)
        s.solve(MDP.from_generator("garnet", **GARNET), monitor=False)
        printed = s.solve(MDP.from_generator("garnet", **GARNET),
                          monitor=True)
        stats = s.stats
    assert [x["k"] for x in seen] == list(range(r.outer_iterations + 1))
    assert stats[0]["monitor"] == seen
    assert stats[0]["solves"][0]["trace_inner"] == list(r.trace_inner)
    assert "monitor" not in stats[1]
    out = capsys.readouterr().out
    assert out.count("[monitor] k=") == printed.outer_iterations + 1


@pytest.mark.parametrize("fmt", ["json", "jsonl"])
def test_file_stats_hold_the_reference_keys(fmt, tmp_path):
    common = {"-method": "ipi_gmres", "-dtype": "float64", "-atol": 1e-8,
              "-monitor": True, "-file_stats_format": fmt}
    entries = {}
    for pkg in ("jax", "torch"):
        path = tmp_path / f"{pkg}.{fmt}"
        if pkg == "jax":
            s = JSession({**common, "-layout": "single", "-kernel_impl":
                          "xla", "-kernel_tune": "off",
                          "-file_stats": str(path)})
            make = lambda: JMDP.from_generator("garnet", **GARNET)
        else:
            s = madupite_session({**common, "-device": "cpu",
                                  "-file_stats": str(path)})
            make = lambda: MDP.from_generator("garnet", **GARNET)
        with s:
            s.solve(make(), monitor=lambda rec: None)
            s.solve(make(), method="vi", monitor=False)
        text = path.read_text()
        entries[pkg] = json.loads(text) if fmt == "json" else \
            [json.loads(line) for line in text.splitlines()]
    j, t = entries["jax"], entries["torch"]
    assert len(j) == len(t) == 2
    for je, te in zip(j, t):
        assert set(te) - set(je) == {"device"} and set(je) <= set(te)
        assert set(te["solves"][0]) == set(je["solves"][0])
        assert te["layout"] == je["layout"] == "single"
        assert (te["method"], te["stop_criterion"]) == \
            (je["method"], je["stop_criterion"])
        for key in ("outer_iterations", "inner_iterations", "converged"):
            assert te["solves"][0][key] == je["solves"][0][key]
    assert [set(r) for r in t[0]["monitor"]] == \
        [set(r) for r in j[0]["monitor"]]
    assert [r["k"] for r in t[0]["monitor"]] == \
        [r["k"] for r in j[0]["monitor"]]
