"""The adaptive driver of the torch port (``-method auto``, the stagnation
supervisor, the hot-swap) against the JAX reference, on the CPU.

* The probe: profiles of garnet, chain_walk, maze2d and sis (and a
  slow chain that needs Krylov), float64 and float32 — ``n``, ``gamma``,
  ``iters`` and ``converged`` exact, ``res0`` / ``res`` /
  ``contraction`` / ``span_ratio`` within a relative 1e-9 (float64; both
  packages run the same backups in the same order, so the residual traces
  agree to rounding) or 1e-5 (float32), the probe iterate within 1e-12
  (1e-5) of ``|v|_inf``; each profile lies farther than that tolerance
  from every rule threshold, so the choice must match exactly.
* The rule table (the reference's ``test_rule_table_selections`` cases,
  parametrized), ``explain`` and ``escalate``: equal, field for field.
* The supervisor: the same trigger sequence, rates and reasons on the
  same chunk traces (synthetic ones and a solve's own residual trace).
* ``solve_adaptive``: the choice, methods and counts of an auto solve;
  the hot-swap of the reference's chain_walk(400) Chebyshev case — the
  swap sequence (``from_method`` -> ``to_method``, pc, reason, resumed),
  convergence and the certificate held, not the outer step of the swap.
* The checkpoint re-arm on reference checkpoints: the same files (a
  NaN-poisoned state discarded by both).
* ``Session``: the ``adaptive`` stats entry and the per-family choice
  cache; ``solve_fleet``'s per-bucket choices; ``-adapt_on_stagnation``;
  the CLI's ``--method auto``.
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest

from repro.adaptive import (ProblemProfile as JProfile,
                            StagnationSupervisor as JSup,
                            escalate as jescalate, explain as jexplain,
                            probe as jprobe, select_method as jselect,
                            solve_adaptive as jsolve_adaptive)
from repro.adaptive.driver import _rearm_checkpoint as j_rearm
from repro.adaptive.probe import estimate_contraction as j_estimate
from repro.adaptive.rules import RULES as J_RULES
from repro.api import MDP as JMDP, Session as JSession
from repro.core import generators as jgen
from repro.core.driver import solve as jsolve
from repro.core.ipi import IPIOptions as JOpts, SolveState as JState
from repro.utils import checkpoint as jckpt
from repro_torch import api as tapi
from repro_torch.adaptive import (ProblemProfile, StagnationSupervisor,
                                  escalate, explain, probe, select_method,
                                  solve_adaptive)
from repro_torch.adaptive import rules as trules
from repro_torch.adaptive.driver import _rearm_checkpoint
from repro_torch.adaptive.probe import estimate_contraction
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core.ipi import IPIOptions as TOpts
from repro_torch.launch import solve as tcli
from repro_torch.utils import checkpoint as tckpt

jax.config.update("jax_enable_x64", True)

# relative tolerance of a probe profile's float fields, by dtype
PROFILE_RTOL = {"float64": 1e-9, "float32": 1e-5}
THRESHOLDS = {"contraction": (trules.FAST_CONTRACTION,
                              trules.MODERATE_CONTRACTION),
              "span_ratio": (trules.SPAN_FLAT,)}

FAMILIES = {
    "garnet": ("garnet", dict(n=300, m=6, k=4, gamma=0.99, seed=2)),
    "garnet_fast": ("garnet", dict(n=200, m=5, k=3, gamma=0.5, seed=1)),
    "chain_walk": ("chain_walk", dict(n=400, gamma=0.99)),
    "maze2d": ("maze2d", dict(size=16, gamma=0.99, seed=0)),
    "sis": ("sis", dict(pop=150, n_actions=4, gamma=0.99, seed=0)),
    "chain_slow": ("chain_walk", dict(n=3000, gamma=0.9999)),
}
# what the rule table picks for each, fixed (chip_smoke's phase 3s holds
# the garnet family's choice at n = 10^6 to this one)
CHOICE = {"garnet": "mpi", "garnet_fast": "vi", "chain_walk": "mpi",
          "maze2d": "mpi", "sis": "mpi", "chain_slow": "ipi_gmres"}


def _pair(name):
    fam, kw = FAMILIES[name]
    return getattr(jgen, fam)(**kw), getattr(tgen, fam)(**kw)


def _jopts(**kw):
    return JOpts(impl="xla", **kw)


def _fields(x):
    return dataclasses.asdict(x)


# --------------------------------------------------------------------------- #
# probe                                                                       #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_probe_profile_matches_reference(name, dtype):
    jm, tm = _pair(name)
    jp, jv = jprobe(jm, _jopts(method="auto", atol=1e-8, dtype=dtype))
    tp, tv = probe(tm, TOpts(method="auto", atol=1e-8, dtype=dtype),
                   device="cpu")
    rtol = PROFILE_RTOL[dtype]
    assert (tp.n, tp.gamma, tp.iters, tp.converged) == \
        (jp.n, jp.gamma, jp.iters, jp.converged)
    for f in ("res0", "res", "contraction", "span_ratio"):
        np.testing.assert_allclose(getattr(tp, f), getattr(jp, f),
                                   rtol=rtol, atol=0, err_msg=f)
    jv = np.asarray(jv)
    assert tv.shape == jv.shape
    assert np.abs(tv - jv).max() <= rtol * 100 * np.abs(jv).max()
    # the profile is not within the tolerance of a threshold: the choice
    # is decided, and must be the same
    for f, ths in THRESHOLDS.items():
        for th in ths:
            assert abs(getattr(tp, f) - th) > rtol * th, (f, th)
    assert _fields(select_method(tp)) == _fields(jselect(jp))
    assert select_method(tp).method == CHOICE[name]
    assert tp.summary() == jp.summary()


def test_probe_converged_flag_and_iters_cap():
    jm, tm = _pair("garnet")
    jp, _ = jprobe(jm, _jopts(method="vi", atol=10.0), probe_iters=4)
    tp, _ = probe(tm, TOpts(method="vi", atol=10.0), probe_iters=4,
                  device="cpu")
    assert tp.converged and jp.converged and tp.iters == jp.iters == 4
    assert select_method(tp).method == "vi"
    # the probe never runs past the solve's own max_outer, and at least 2
    jp, _ = jprobe(jm, _jopts(method="vi", max_outer=3), probe_iters=1)
    tp, _ = probe(tm, TOpts(method="vi", max_outer=3), probe_iters=1,
                  device="cpu")
    assert tp.iters == jp.iters == 2


@pytest.mark.parametrize("trace", [
    [], [1.0], [1.0, np.nan, np.inf], list(0.5 ** np.arange(10)),
    [1.0, 0.9, 0.0, 0.0], [3.0, 2.0, 1.9, 1.85, 1.84, 1.839],
    [1.0, 2.0, 4.0, 8.0]])
def test_estimate_contraction_matches_reference(trace):
    tr = np.asarray(trace, dtype=float)
    assert estimate_contraction(tr) == j_estimate(tr)


# --------------------------------------------------------------------------- #
# rule table, explain, escalation chain                                       #
# --------------------------------------------------------------------------- #

def _prof(cls, **kw):
    d = dict(n=100_000, gamma=0.9999, iters=8, res0=1.0, res=0.5,
             contraction=0.9999, span_ratio=0.5, converged=False)
    d.update(kw)
    return cls(**d)


# the reference's test_rule_table_selections cases: (profile fields,
# deterministic_dots, the method / stop / pc it expects)
RULE_CASES = [
    (dict(converged=True), False, ("vi", "atol", "none")),
    (dict(contraction=0.75), False, ("vi", "atol", "none")),
    (dict(contraction=0.85), False, ("mpi", "atol", "none")),
    (dict(contraction=0.99), False, ("mpi", "atol", "none")),
    (dict(span_ratio=0.01), False, ("vi", "span", "none")),
    (dict(n=1_000), False, ("mpi", "atol", "none")),
    (dict(), False, ("ipi_gmres", "atol", "jacobi")),
    (dict(), True, ("ipi_gmres", "atol", "jacobi")),
    # on the thresholds themselves: the first rule with <= matches
    (dict(contraction=0.8), False, ("vi", "atol", "none")),
    (dict(contraction=0.997), False, ("mpi", "atol", "none")),
    (dict(span_ratio=0.05), False, ("vi", "span", "none")),
    (dict(n=2048), False, ("ipi_gmres", "atol", "jacobi")),
]


@pytest.mark.parametrize("fields,det,want", RULE_CASES,
                         ids=[f"{i}" for i in range(len(RULE_CASES))])
def test_rule_table_selections(fields, det, want):
    t = select_method(_prof(ProblemProfile, **fields), deterministic_dots=det)
    j = jselect(_prof(JProfile, **fields), deterministic_dots=det)
    assert _fields(t) == _fields(j)
    assert (t.method, t.stop_criterion, t.pc_type) == want
    assert t.summary() == j.summary()
    assert explain(_prof(ProblemProfile, **fields), deterministic_dots=det) \
        == jexplain(_prof(JProfile, **fields), deterministic_dots=det)


def test_rule_names_and_thresholds_are_the_reference_s():
    assert [r[0] for r in trules.RULES] == [r[0] for r in J_RULES]
    from repro.adaptive import rules as jrules
    for name in ("FAST_CONTRACTION", "MODERATE_CONTRACTION", "SPAN_FLAT",
                 "KRYLOV_MIN_N"):
        assert getattr(trules, name) == getattr(jrules, name), name


@pytest.mark.parametrize("det", [False, True])
@pytest.mark.parametrize("method", ["mpi", "ipi_gmres", "ipi_bicgstab",
                                    "vi", "ipi_chebyshev", "ipi_anderson",
                                    "ipi_richardson", "pi", "async_vi",
                                    "user_method"])
def test_escalation_chain_matches_reference(method, det):
    t, j = escalate(method, deterministic_dots=det), \
        jescalate(method, deterministic_dots=det)
    assert (t is None) == (j is None)
    if t is not None:
        assert _fields(t) == _fields(j)


# --------------------------------------------------------------------------- #
# supervisor                                                                  #
# --------------------------------------------------------------------------- #

def _info(res, res_prev, k=64, kp=0, div=False):
    return dict(k=k, res=res, k_prev=kp, res_prev=res_prev, diverged=div)


SUP_TRACES = {
    "consecutive_crawl": (dict(gamma=0.99, atol=1e-6, patience=2),
                          [_info(1.0, 1.0), _info(1.0, 1.0)]),
    "healthy_reset": (dict(gamma=0.99, patience=2),
                      [_info(1.0, 1.0), _info(0.1, 1.0), _info(1.0, 1.0),
                       _info(0.5, 0.5)]),
    "diverged": (dict(gamma=0.99, patience=5),
                 [_info(1.0, 1.0, div=True)]),
    "atol_guard": (dict(gamma=0.99, atol=1.0, patience=1),
                   [_info(2.0, 2.0), _info(5.0, 5.0)]),
    "nan_and_no_step": (dict(gamma=0.9, patience=1),
                        [_info(np.nan, 1.0), _info(1.0, 1.0, k=3, kp=3),
                         _info(0.9, 1.0, k=1, kp=0)]),
    "gamma_one": (dict(gamma=1.0, margin=1.0, patience=1),
                  [_info(0.999999, 1.0, k=1, kp=0)]),
}


@pytest.mark.parametrize("name", list(SUP_TRACES))
def test_supervisor_trigger_sequence_matches_reference(name):
    kw, infos = SUP_TRACES[name]
    gamma = kw.pop("gamma")
    t, j = StagnationSupervisor(gamma, **kw), JSup(gamma, **kw)
    kw["gamma"] = gamma
    for info in infos:
        assert t(dict(info)) == j(dict(info)), info
        assert (t.triggered, t.reason, t.rate, t.threshold) == \
            (j.triggered, j.reason, j.rate, j.threshold)


def test_supervisor_on_a_solve_trace():
    """A real residual trace (vi on the chain, f64) cut into chunks of 8
    outer steps: the same decisions, chunk by chunk."""
    _, tm = _pair("chain_walk")
    r = tdriver.solve(tm, TOpts(method="vi", atol=1e-8, dtype="float64",
                                max_outer=200), device="cpu")
    tr = r.trace_residual
    t, j = StagnationSupervisor(0.99, atol=1e-8), JSup(0.99, atol=1e-8)
    fired = []
    for k in range(8, len(tr), 8):
        info = _info(float(tr[k]), float(tr[k - 8]), k=k, kp=k - 8)
        a, b = t(dict(info)), j(dict(info))
        assert a == b and t.rate == j.rate
        fired.append(a)
    # plain VI crawls at exactly gamma: the supervisor fires
    assert any(fired)


# --------------------------------------------------------------------------- #
# the driver hook                                                             #
# --------------------------------------------------------------------------- #

def test_driver_rejects_virtual_method():
    _, tm = _pair("chain_walk")
    for fn in (lambda: tdriver.solve(tm, TOpts(method="auto"),
                                     device="cpu"),
               lambda: tdriver.solve_many([tm, tm], TOpts(method="auto"),
                                          device="cpu")):
        with pytest.raises(ValueError, match="virtual") as e:
            fn()
        with pytest.raises(ValueError) as je:
            jsolve(_pair("chain_walk")[0], _jopts(method="auto"))
        assert str(e.value) == str(je.value).replace(
            "repro.", "repro_torch.")


def test_supervisor_interrupt_checkpoints_and_resumes_bitwise(tmp_path):
    """A supervisor that fires after the first chunk stops the solve; in
    ``interrupt`` mode the state is written then, and the resumed solve
    ends bit for bit where the uninterrupted one does."""
    _, tm = _pair("garnet")
    opts = TOpts(method="mpi", atol=1e-9, dtype="float64")
    calls = []

    def sup(info):
        calls.append(dict(info))
        return True

    d = str(tmp_path / "ck")
    r1 = tdriver.solve(tm, opts, chunk=3, checkpoint_dir=d,
                       checkpoint_mode="interrupt", supervisor=sup,
                       device="cpu")
    assert not r1.converged and r1.outer_iterations == 3
    assert calls == [dict(k=3, res=float(r1.residual), k_prev=0,
                          res_prev=float(r1.trace_residual[0]),
                          diverged=False)]
    assert tckpt.latest_step(d) == 3
    r2 = tdriver.solve(tm, opts, chunk=3, checkpoint_dir=d, device="cpu")
    full = tdriver.solve(tm, opts, chunk=3, device="cpu")
    assert r2.converged
    assert np.array_equal(r2.v.view(np.uint64), full.v.view(np.uint64))
    assert (r2.outer_iterations, r2.inner_iterations) == \
        (full.outer_iterations, full.inner_iterations)


# --------------------------------------------------------------------------- #
# solve_adaptive                                                              #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["garnet", "garnet_fast"])
def test_solve_adaptive_auto_matches_reference(name):
    jm, tm = _pair(name)
    common = dict(method="auto", atol=1e-8, dtype="float64",
                  max_outer=5000)
    jr, jrep = jsolve_adaptive(jm, _jopts(**common))
    tr, trep = solve_adaptive(tm, TOpts(**common), device="cpu")
    assert _fields(trep.choice) == _fields(jrep.choice)
    assert trep.methods == jrep.methods and trep.swaps == jrep.swaps
    assert trep.probe_iters == jrep.probe_iters
    assert tr.converged and jr.converged
    np.testing.assert_array_equal(tr.policy, np.asarray(jr.policy))
    assert (tr.outer_iterations, tr.inner_iterations) == \
        (jr.outer_iterations, jr.inner_iterations)
    np.testing.assert_allclose(tr.v, np.asarray(jr.v), rtol=0,
                               atol=1e-10 * np.abs(tr.v).max())


def _cheby(**kw):
    # the reference's case: safeguard off, so the mis-bracketed Chebyshev
    # iteration truly diverges past -divtol
    d = dict(method="ipi_chebyshev", atol=1e-3, max_outer=3000,
             max_inner=64, divtol=10.0, safeguard=False)
    d.update(kw)
    return d


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hot_swap_sequence_resume_and_certificate(dtype):
    jm, tm = _pair("chain_walk")
    jr, jrep = jsolve_adaptive(jm, _jopts(**_cheby(dtype=dtype)))
    tr, trep = solve_adaptive(tm, TOpts(**_cheby(dtype=dtype)),
                              device="cpu")
    key = lambda sw: (sw["from_method"], sw["to_method"], sw["pc_type"],
                      sw["reason"], sw["resumed"])
    assert [key(s) for s in trep.swaps] == [key(s) for s in jrep.swaps]
    assert trep.methods == jrep.methods
    assert trep.methods[0] == "ipi_chebyshev" and len(trep.methods) >= 2
    assert trep.swaps[0]["resumed"]
    assert tr.converged and not tr.diverged
    ref = tdriver.solve(tm, TOpts(method="vi", atol=1e-3, max_outer=20_000,
                                  dtype=dtype), device="cpu")
    assert np.abs(tr.v - ref.v).max() <= tr.gap_bound + ref.gap_bound
    assert np.mean(tr.policy == ref.policy) >= 0.95
    # the resume continued the state, not a fresh solve: the outer count
    # carries on past the swap
    assert tr.outer_iterations > trep.swaps[0]["k"]


def test_fixed_method_is_supervised_without_probe():
    jm, tm = _pair("garnet")
    common = dict(method="mpi", atol=1e-8, dtype="float64")
    jr, jrep = jsolve_adaptive(jm, _jopts(**common))
    tr, trep = solve_adaptive(tm, TOpts(**common), device="cpu")
    assert trep.profile is None and trep.choice is None
    assert trep.as_dict() == jrep.as_dict()
    assert (tr.outer_iterations, tr.inner_iterations) == \
        (jr.outer_iterations, jr.inner_iterations)


# --------------------------------------------------------------------------- #
# checkpoint re-arm                                                           #
# --------------------------------------------------------------------------- #

def _jstate(nan=False, res=0.5, res0=0.1, dtype=np.float32):
    v = np.full(8, np.nan if nan else 1.0, dtype)
    return JState(
        v=v, tv=v.copy(), pi=np.zeros(8, np.int32), res=dtype(res),
        k=np.int32(10), inner_total=np.int32(3),
        trace_res=np.zeros(4, dtype), trace_inner=np.zeros(4, np.int32),
        res0=dtype(res0), span=dtype(0.0), done=np.bool_(False),
        diverged=np.bool_(True), n_true=np.int32(8),
        win=np.zeros(0, dtype))


@pytest.mark.parametrize("case", ["f32", "f64", "res0_above", "nan_v",
                                  "nan_res"])
def test_rearm_matches_reference(tmp_path, case):
    kw = {"f32": {}, "f64": dict(dtype=np.float64, res=0.123456789012345),
          "res0_above": dict(res=0.5, res0=2.0), "nan_v": dict(nan=True),
          "nan_res": dict(res=np.nan)}[case]
    src = str(tmp_path / "src")
    jckpt.save(src, 10, _jstate(**kw), meta={"n": 8})
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(src, jdir)
    shutil.copytree(src, tdir)
    assert _rearm_checkpoint(tdir) == j_rearm(jdir)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    if case.startswith("nan"):
        assert tckpt.latest_step(tdir) is None
        return
    jl, js, jmeta = tckpt.restore(jdir, 14)
    tl, ts, tmeta = tckpt.restore(tdir, 14)
    assert (ts, tmeta) == (js, jmeta) == (10, {"n": 8})
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    assert not tl[11] and tl[8] == np.float32(max(kw.get("res0", 0.1),
                                                  kw.get("res", 0.5)))
    # the re-armed file resumes in the reference too
    tree, step, _ = jckpt.restore(tdir, _jstate(**kw))
    assert step == 10 and not bool(np.asarray(tree.diverged))


def test_rearm_missing_directory():
    assert _rearm_checkpoint("/nonexistent/madupite/ck") is False


# --------------------------------------------------------------------------- #
# Session, fleets, CLI                                                        #
# --------------------------------------------------------------------------- #

COMMON = {"-atol": 1e-3, "-max_outer": 2000}


def test_session_auto_records_choice_and_caches_probe():
    kw = dict(n=256, gamma=0.99)
    with JSession({**COMMON, "-layout": "single", "-kernel_impl": "xla",
                   "-kernel_tune": "off"}) as js:
        jr1 = js.solve(JMDP.from_generator("chain_walk", **kw),
                       method="auto")
        ja = js.stats[-1]["adaptive"]
    with tapi.Session({**COMMON, "-device": "cpu"}) as s:
        m = tapi.MDP.from_generator("chain_walk", **kw)
        r1 = s.solve(m, method="auto")
        a1 = s.stats[-1]["adaptive"]
        assert r1.converged and s.stats[-1]["solves"][0]["diverged"] is False
        assert a1["choice"] == ja["choice"]
        assert a1["methods"] == ja["methods"] and a1["swaps"] == ja["swaps"]
        assert a1["probe_iters"] == ja["probe_iters"] == 8
        assert a1["profile"]["contraction"] == pytest.approx(
            ja["profile"]["contraction"], rel=1e-5)
        np.testing.assert_array_equal(r1.policy, np.asarray(jr1.policy))
        assert r1.outer_iterations == jr1.outer_iterations
        # the same (n, m, gamma, mode) family: the cached choice, no probe
        r2 = s.solve(m, method="auto")
        a2 = s.stats[-1]["adaptive"]
        assert a2["profile"] is None and a2["probe_iters"] == 0
        assert a2["choice"] == a1["choice"]
        assert np.array_equal(r1.policy, r2.policy)
        assert list(s._auto_cache) == [(256, m.m, 0.99, "mincost")]


def test_session_fleet_auto_resolves_per_bucket():
    ns = (128, 128, 400, 400)
    jmdps = [JMDP.from_generator("chain_walk", n=n, gamma=0.95) for n in ns]
    tmdps = [tapi.MDP.from_generator("chain_walk", n=n, gamma=0.95)
             for n in ns]
    with JSession({"-atol": 1e-4, "-max_outer": 2000, "-layout": "single",
                   "-kernel_impl": "xla", "-kernel_tune": "off"}) as js:
        jrs = js.solve_fleet(jmdps, method="auto")
        jauto = js.stats[-1]["fleet"]["auto"]
    with tapi.Session({"-atol": 1e-4, "-max_outer": 2000,
                       "-device": "cpu"}) as s:
        trs = s.solve_fleet(tmdps, method="auto")
        entry = s.stats[-1]
    assert len(entry["fleet"]["buckets"]) == 2
    assert entry["fleet"]["auto"] == jauto
    assert all(a["method"] != "auto" for a in jauto)
    assert entry["fleet"]["cache"]["misses"] == 0      # no cached path
    for t, j in zip(trs, jrs):
        assert t.converged
        np.testing.assert_array_equal(t.policy, np.asarray(j.policy))
        assert t.outer_iterations == j.outer_iterations


def test_session_adapt_on_stagnation_hot_swaps():
    opts = {"-method": "ipi_chebyshev", "-atol": 1e-3, "-max_outer": 3000,
            "-max_inner": 64, "-divtol": 10.0, "-safeguard": False,
            "-adapt_on_stagnation": True}
    with JSession({**opts, "-layout": "single", "-kernel_impl": "xla",
                   "-kernel_tune": "off"}) as js:
        js.solve(JMDP.from_generator("chain_walk", n=400, gamma=0.99))
        ja = js.stats[-1]["adaptive"]
    with tapi.Session({**opts, "-device": "cpu"}) as s:
        r = s.solve(tapi.MDP.from_generator("chain_walk", n=400,
                                            gamma=0.99))
        a = s.stats[-1]["adaptive"]
    assert r.converged
    assert a["profile"] is None and a["choice"] is None
    assert a["methods"] == ja["methods"]
    assert [(w["from_method"], w["to_method"], w["reason"])
            for w in a["swaps"]] == [(w["from_method"], w["to_method"],
                                      w["reason"]) for w in ja["swaps"]]


def test_adaptive_options_match_reference():
    from repro.api import Options as JOptions
    for key, good, bad in (("-probe_iters", 3, 0),
                           ("-adapt_on_stagnation", "true", "maybe")):
        assert tapi.Options({key: good}).get(key) == \
            JOptions({key: good}).get(key)
        assert tapi.OPTION_SPECS[key].default == \
            __import__("repro.api.options", fromlist=["x"]) \
            .OPTION_SPECS[key].default
        with pytest.raises(tapi.OptionTypeError):
            tapi.Options({key: bad})
    assert tapi.Options({"-method": "auto"}).to_ipi().method == "auto"
    # a preconditioner may ride on auto (the choice keeps it)
    assert TOpts(method="auto", pc_type="jacobi").pc_type == "jacobi"


def test_cli_method_auto_on_cpu(capsys):
    rc = tcli.main(["--instance", "garnet", "--n", "300", "--m", "6",
                    "--k", "4", "--seed", "2", "--method", "auto",
                    "--atol", "1e-8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[solve] probe: 8 iterations, contraction=0.947189" in out
    assert "[solve] auto-selected mpi (stop=atol pc=none): " \
        "[moderate-contraction]" in out
    assert "[solve] methods run: mpi" in out and "converged=True" in out


def test_cli_adapt_on_stagnation_on_cpu(capsys):
    rc = tcli.main(["--instance", "chain_walk", "--n", "400",
                    "--method", "ipi_chebyshev", "--atol", "1e-3",
                    "--dtype", "float32", "--device", "cpu",
                    "--option", "adapt_on_stagnation=true",
                    "--option", "safeguard=false", "--option", "divtol=10",
                    "--option", "max_inner=64"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[solve] hot-swap at k=" in out and "ipi_chebyshev -> mpi" in out
    assert "[solve] methods run: ipi_chebyshev -> mpi" in out
