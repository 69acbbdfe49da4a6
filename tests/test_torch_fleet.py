"""Fleet solves of the torch port against the JAX reference and against
the port's own unbatched solves, on the CPU.

* ``solve_many`` against the reference's ``solve_many`` (``impl="xla"``):
  B = 4 garnets ``n=120, m=6, k=4``, gamma 0.95, float64, for ``vi``,
  ``mpi``, ``ipi_gmres`` and ``ipi_bicgstab``: policies, per-lane outer /
  inner counts and ``trace_inner`` exact, values within 1e-9,
  ``trace_residual`` within atol 1e-12 / rtol 1e-4 (the reference's own
  fleet-vs-single tolerance: Krylov dots sum in another order).  The
  lanes' counts differ, so the freeze is exercised.
* A gamma sweep on one seed (shared topology): policies and counts exact,
  values within 1e-7; a ragged fleet (n = 90 and 120) padded and trimmed.
* Lanes of ``vi`` / ``mpi`` (and of the lane-by-lane KSPs) are bit for bit
  the port's unbatched solves; Krylov lanes agree to rounding.
* Warm starts, guards, checkpoints (resume bit for bit; a reference fleet
  checkpoint resumes in the port), monitors, ``Session.solve_fleet``
  bucketing and outputs, and the CLI's ``--batch`` / ``--sweep-gamma``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import Session as JSession
from repro.api.fleet import bucket_indices as j_bucket_indices
from repro.core import driver as jdriver
from repro.core import generators as jgen
from repro.core.ipi import IPIOptions as JOpts
from repro_torch import api as tapi
from repro_torch.api.fleet import bucket_indices
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core import methods as tmethods
from repro_torch.core.driver import solve as tsolve
from repro_torch.core.driver import solve_many as tsolve_many
from repro_torch.core import stack_mdps
from repro_torch.core.ipi import IPIOptions as TOpts
from repro_torch.launch import solve as tcli

jax.config.update("jax_enable_x64", True)

SEEDS = (0, 1, 2, 3)


def _fleet(seeds=SEEDS, gamma=0.95, n=120, m=6, k=4):
    kws = [dict(n=n, m=m, k=k, gamma=gamma, seed=s) for s in seeds]
    return ([jgen.garnet(**kw) for kw in kws],
            [tgen.garnet(**kw) for kw in kws])


def _opts(method, dtype="float64", **kw):
    common = dict(method=method, atol=1e-9 if dtype == "float64" else 1e-4,
                  dtype=dtype, max_outer=20000, **kw)
    return JOpts(impl="xla", **common), TOpts(**common)


def _bits(x):
    return np.atleast_1d(np.asarray(x)).view(np.uint8)


def _assert_reference_parity(jrs, trs, v_atol=1e-9, traces=True):
    assert len(jrs) == len(trs)
    for b, (j, t) in enumerate(zip(jrs, trs)):
        assert j.converged and t.converged, (b, t.summary())
        np.testing.assert_array_equal(t.policy, j.policy,
                                      err_msg=f"lane {b} policy")
        np.testing.assert_allclose(t.v, j.v, atol=v_atol, rtol=0,
                                   err_msg=f"lane {b} values")
        assert (t.outer_iterations, t.inner_iterations) == \
            (j.outer_iterations, j.inner_iterations), b
        if traces:
            np.testing.assert_array_equal(t.trace_inner, j.trace_inner)
            np.testing.assert_allclose(t.trace_residual, j.trace_residual,
                                       atol=1e-12, rtol=1e-4)


def _assert_bitwise(singles, fleet):
    for s, f in zip(singles, fleet):
        assert f.v.dtype == s.v.dtype
        np.testing.assert_array_equal(_bits(f.v), _bits(s.v))
        np.testing.assert_array_equal(f.policy, s.policy)
        assert (f.outer_iterations, f.inner_iterations) == \
            (s.outer_iterations, s.inner_iterations)
        np.testing.assert_array_equal(_bits(f.trace_residual),
                                      _bits(s.trace_residual))
        np.testing.assert_array_equal(f.trace_inner, s.trace_inner)


@pytest.mark.parametrize("method", ["vi", "mpi", "ipi_gmres", "ipi_bicgstab"])
def test_solve_many_matches_reference_solve_many(method):
    jm, tm = _fleet()
    jo, to = _opts(method)
    jrs = jdriver.solve_many(jm, jo)
    trs = tsolve_many(tm, to, device="cpu")
    _assert_reference_parity(jrs, trs)
    counts = {(r.outer_iterations, r.inner_iterations) for r in trs}
    assert len(counts) > 1          # lanes stop at different steps


def test_gamma_sweep_matches_reference():
    gammas = [0.9, 0.95, 0.99]
    jm = [jgen.garnet(n=100, m=5, k=4, gamma=g, seed=1) for g in gammas]
    tm = [tgen.garnet(n=100, m=5, k=4, gamma=g, seed=1) for g in gammas]
    st = stack_mdps(tm)
    assert st.shared_topology and st.gamma == tuple(gammas)
    jo, to = _opts("ipi_gmres")
    jrs = jdriver.solve_many(jm, jo)
    trs = tsolve_many(st, to, device="cpu")
    _assert_reference_parity(jrs, trs, v_atol=1e-7, traces=False)
    singles = [tsolve(m, to, device="cpu") for m in tm]
    _assert_reference_parity(singles, trs, v_atol=1e-7, traces=False)


@pytest.mark.parametrize("method", ["mpi", "ipi_gmres"])
def test_ragged_fleet_is_padded_and_trimmed(method):
    kws = [dict(n=90, m=4, k=3, gamma=0.95, seed=0),
           dict(n=120, m=4, k=3, gamma=0.95, seed=1)]
    jo, to = _opts(method)
    jrs = jdriver.solve_many([jgen.garnet(**kw) for kw in kws], jo)
    trs = tsolve_many([tgen.garnet(**kw) for kw in kws], to, device="cpu")
    assert [len(r.v) for r in trs] == [90, 120]
    assert [len(r.policy) for r in trs] == [90, 120]
    _assert_reference_parity(jrs, trs)


@pytest.mark.parametrize("mode", ["mincost", "maxreward"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method", ["vi", "mpi"])
def test_fleet_lanes_are_the_unbatched_solves_bit_for_bit(method, dtype,
                                                          mode):
    _, tm = _fleet(seeds=(4, 5, 6), n=70)
    _, to = _opts(method, dtype, mode=mode)
    singles = [tsolve(m, to, device="cpu") for m in tm]
    _assert_bitwise(singles, tsolve_many(tm, to, device="cpu"))


def test_gamma_sweep_lanes_are_the_unbatched_solves_bit_for_bit():
    tm = [tgen.garnet(n=70, m=4, k=3, gamma=g, seed=2)
          for g in (0.9, 0.95, 0.99)]
    _, to = _opts("mpi", "float32")
    singles = [tsolve(m, to, device="cpu") for m in tm]
    _assert_bitwise(singles, tsolve_many(tm, to, device="cpu"))


@pytest.mark.parametrize("variant", ["deterministic_dots", "pc_jacobi",
                                     "bicgstab_jacobi", "pc_bjacobi",
                                     "span"])
def test_fleet_krylov_variants_match_unbatched_solves(variant):
    """The batched GMRES / BiCGStab paths under their options: the same
    counts and policies as the unbatched solves, values to rounding."""
    method, extra = {
        "deterministic_dots": ("ipi_gmres", dict(deterministic_dots=True)),
        "pc_jacobi": ("ipi_gmres", dict(pc_type="jacobi")),
        "bicgstab_jacobi": ("ipi_bicgstab", dict(pc_type="jacobi")),
        "pc_bjacobi": ("ipi_gmres", dict(pc_type="bjacobi", pc_block=16)),
        "span": ("vi", dict(stop_criterion="span")),
    }[variant]
    _, tm = _fleet(seeds=(7, 8, 9), n=80)
    _, to = _opts(method, **extra)
    singles = [tsolve(m, to, device="cpu") for m in tm]
    fleet = tsolve_many(tm, to, device="cpu")
    _assert_reference_parity(singles, fleet, v_atol=1e-12)


def test_ragged_span_fleet_masks_its_padding():
    """The span criterion over a ragged fleet reads only each lane's true
    states, as the reference's per-lane ``n_true`` does."""
    kws = [dict(n=50, m=4, k=3, gamma=0.95, seed=0),
           dict(n=80, m=4, k=3, gamma=0.95, seed=1)]
    jo, to = _opts("vi", stop_criterion="span")
    jrs = jdriver.solve_many([jgen.garnet(**kw) for kw in kws], jo)
    trs = tsolve_many([tgen.garnet(**kw) for kw in kws], to, device="cpu")
    _assert_reference_parity(jrs, trs)
    singles = [tsolve(tgen.garnet(**kw), to, device="cpu") for kw in kws]
    _assert_bitwise(singles, trs)


def test_dense_fleet_matches_reference():
    kws = [dict(n=60, m=4, k=3, gamma=0.95, seed=s) for s in (0, 1)]
    jo, to = _opts("ipi_gmres")
    jrs = jdriver.solve_many([jgen.garnet(**kw).as_dense() for kw in kws],
                             jo)
    tm = [tgen.garnet(**kw).as_dense() for kw in kws]
    trs = tsolve_many(tm, to, device="cpu")
    _assert_reference_parity(jrs, trs, traces=False)
    # vi touches only the dense backup: bit for bit.  mpi's policy matvec
    # is a library product, torch.bmm for a fleet and torch.mv alone,
    # whose sums may round differently: counts exact, values to rounding
    _, to = _opts("vi")
    _assert_bitwise([tsolve(m, to, device="cpu") for m in tm],
                    tsolve_many(tm, to, device="cpu"))
    _, to = _opts("mpi")
    _assert_reference_parity([tsolve(m, to, device="cpu") for m in tm],
                             tsolve_many(tm, to, device="cpu"),
                             v_atol=1e-12)


def test_warm_start_and_guards():
    jm, tm = _fleet(seeds=(0, 1))
    _, to = _opts("ipi_gmres")
    singles = [tsolve(m, to, device="cpu") for m in tm]
    fleet = tsolve_many(tm, to, v0s=[s.v for s in singles], device="cpu")
    assert all(r.outer_iterations <= 1 and r.converged for r in fleet)
    stacked = tsolve_many(tm, to, device="cpu",
                          v0s=torch.from_numpy(np.stack([s.v
                                                         for s in singles])))
    assert [r.outer_iterations for r in stacked] == \
        [r.outer_iterations for r in fleet]
    with pytest.raises(ValueError, match="solve_many"):
        tsolve(stack_mdps(tm), to, device="cpu")
    with pytest.raises(ValueError, match="solve"):
        tsolve_many(tm[0], to, device="cpu")
    with pytest.raises(ValueError, match="origin"):
        tsolve_many(tm, to, origin=(2, 120), device="cpu")
    # the fleet layouts need a mesh; pad_fleet only acts on one
    with pytest.raises(ValueError, match="mesh"):
        tsolve_many(tm, to, device="cpu", layout="fleet")
    with pytest.raises(ValueError, match="unknown layout"):
        tsolve_many(tm, to, device="cpu", layout="3d")
    plain = tsolve_many(tm, to, device="cpu")
    unpadded = tsolve_many(tm, to, device="cpu", pad_fleet=False)
    for a, b in zip(unpadded, plain):
        np.testing.assert_array_equal(_bits(a.v), _bits(b.v))


def test_pre_batched_container_with_origin_is_trimmed():
    _, tm = _fleet(seeds=(0, 1, 2))
    _, to = _opts("mpi")
    full = tsolve_many(tm, to, device="cpu")
    trimmed = tsolve_many(stack_mdps(tm), to, origin=(2, 100), device="cpu")
    assert len(trimmed) == 2 and all(len(r.v) == 100 for r in trimmed)
    for f, t in zip(full, trimmed):
        np.testing.assert_array_equal(_bits(t.v), _bits(f.v[:100]))


@pytest.fixture
def user_ksp():
    def two_sweeps(matvec, b, x0, *, tol, maxiter, axes):
        """Two Richardson sweeps a call, whatever the tolerance."""
        x = x0
        for _ in range(2):
            x = x + (b - matvec(x))
        return x, 2, torch.zeros((), dtype=x.dtype)

    tmethods.register_ksp("fleet_two_sweeps", two_sweeps)
    yield "ipi_fleet_two_sweeps"
    tmethods.unregister_ksp("fleet_two_sweeps")


@pytest.mark.parametrize("which", ["ipi_chebyshev", "ipi_anderson", "user"])
def test_ksps_without_a_batched_form_run_lane_by_lane(which, user_ksp):
    """A KSP with no batched form solves each live lane's own system with
    its unbatched form: every lane is its independent solve, bit for bit
    (gammas differ per lane, so each lane's Chebyshev interval is its
    own)."""
    method = user_ksp if which == "user" else which
    tm = [tgen.garnet(n=60, m=4, k=3, gamma=g, seed=3)
          for g in (0.9, 0.95, 0.97)]
    to = TOpts(method=method, atol=1e-6, dtype="float64", max_outer=20000)
    singles = [tsolve(m, to, device="cpu") for m in tm]
    _assert_bitwise(singles, tsolve_many(tm, to, device="cpu"))


# --------------------------------------------------------------------------- #
# Checkpoints and monitors                                                    #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("method", ["vi", "ipi_gmres"])
def test_fleet_resume_is_bit_for_bit(method, tmp_path):
    _, tm = _fleet(seeds=(0, 1, 2))
    _, to = _opts(method)
    whole = tsolve_many(tm, to, device="cpu")
    first = tsolve_many(tm, TOpts(**{**to.__dict__, "max_outer": 3}),
                        checkpoint_dir=str(tmp_path), device="cpu")
    assert all(r.outer_iterations == 3 and not r.converged for r in first)
    resumed = tsolve_many(tm, to, checkpoint_dir=str(tmp_path),
                          device="cpu")
    _assert_bitwise(whole, resumed)
    with pytest.raises(ValueError, match="batch=3"):
        tsolve_many(tm[:2], to, checkpoint_dir=str(tmp_path), device="cpu")


def test_reference_fleet_checkpoint_resumes_in_the_port(tmp_path):
    jm, tm = _fleet(seeds=(0, 1, 2))
    jo, to = _opts("mpi")
    jdriver.solve_many(jm, JOpts(**{**jo.__dict__, "max_outer": 3}),
                       checkpoint_dir=str(tmp_path))
    resumed = tsolve_many(tm, to, checkpoint_dir=str(tmp_path),
                          device="cpu")
    _assert_reference_parity(jdriver.solve_many(jm, jo), resumed)
    # and a port fleet checkpoint resumes in the reference
    port_dir = str(tmp_path / "port")
    tsolve_many(tm, TOpts(**{**to.__dict__, "max_outer": 3}),
                checkpoint_dir=port_dir, device="cpu")
    _assert_reference_parity(
        tsolve_many(tm, to, device="cpu"),
        jdriver.solve_many(jm, jo, checkpoint_dir=port_dir))


def test_fleet_monitor_records_match_reference():
    """One fleet-wide record per outer step (k=0 first), stream and chunk
    alike, record for record the reference's."""
    jm, tm = _fleet(seeds=(0, 1, 2))
    jo, to = _opts("ipi_gmres", monitor=True)
    want = []
    jdriver.solve_many(jm, jo, monitor=want.append)
    for mode in ("stream", "chunk"):
        got = []
        tsolve_many(tm, TOpts(**{**to.__dict__, "monitor_mode": mode}),
                    monitor=got.append, chunk=4, device="cpu")
        assert [r["k"] for r in got] == [r["k"] for r in want]
        for g, w in zip(got, want):
            assert g["inner"] == w["inner"] and g["diverged"] == w["diverged"]
            np.testing.assert_allclose(g["res"], w["res"], rtol=1e-4,
                                       atol=1e-12)


# --------------------------------------------------------------------------- #
# Session and CLI                                                             #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("ns", [[40, 44, 200, 210, 43], [100] * 4,
                                [10, 1000, 11, 990, 500], [7]])
def test_bucketing_matches_the_reference(ns):
    for policy in ("auto", "off"):
        assert bucket_indices(ns, policy=policy) == \
            j_bucket_indices(ns, policy=policy)
    with pytest.raises(ValueError, match="bucketing policy"):
        bucket_indices(ns, policy="never")


def test_session_solve_fleet_buckets_and_outputs(tmp_path):
    kws = [dict(n=n, m=4, k=3, gamma=0.95, seed=s)
           for s, n in enumerate((40, 200, 44, 210))]
    common = {"-method": "ipi_gmres", "-dtype": "float64", "-atol": 1e-9,
              "-monitor": True}
    ck, pol, cost = tmp_path / "ck", tmp_path / "pi.npz", tmp_path / "v.npz"
    records = []
    with tapi.madupite_session({**common, "-device": "cpu",
                                "-checkpoint_dir": str(ck),
                                "-file_policy": str(pol),
                                "-file_cost": str(cost)}) as s:
        trs = s.solve_fleet([tapi.MDP.from_generator("garnet", **kw)
                             for kw in kws], monitor=records.append)
        stats = s.stats[-1]
    with JSession({**common, "-layout": "single", "-kernel_impl": "xla"}) \
            as js:
        jrs = js.solve_fleet([jgen.garnet(**kw) for kw in kws],
                             monitor=lambda rec: None)
        jstats = js.stats[-1]
    _assert_reference_parity(jrs, trs)
    assert stats["fleet"]["size"] == jstats["fleet"]["size"] == 4
    assert stats["fleet"]["buckets"] == jstats["fleet"]["buckets"] \
        == [[0, 2], [1, 3]]
    assert sorted(os.listdir(ck)) == ["bucket0", "bucket1"]
    assert {r["bucket"] for r in records} == {0, 1}
    assert [(r["bucket"], r["k"]) for r in stats["monitor"]] == \
        [(r["bucket"], r["k"]) for r in jstats["monitor"]]
    assert [x["outer_iterations"] for x in stats["solves"]] == \
        [x["outer_iterations"] for x in jstats["solves"]]
    with np.load(pol) as zp, np.load(cost) as zv:
        for i, r in enumerate(trs):
            np.testing.assert_array_equal(zp[f"instance_{i}"], r.policy)
            np.testing.assert_array_equal(zv[f"instance_{i}"], r.v)


def test_session_solve_fleet_guards():
    with tapi.madupite_session({"-device": "cpu"}) as s:
        assert s.solve_fleet([]) == []
        mdps = [tapi.MDP.from_generator("garnet", n=20, m=3, k=2, seed=i,
                                        mode=mode)
                for i, mode in enumerate(("mincost", "maxreward"))]
        with pytest.raises(ValueError, match="one shared mode"):
            s.solve_fleet(mdps)
        # -method auto resolves per bucket (ROADMAP queue 1 item 12)
        assert s.solve_fleet(mdps[:1], method="auto",
                             atol=1e-4)[0].converged
        assert s.stats[-1]["fleet"]["auto"][0]["method"] != "auto"
    # the fleet-mesh keys are ported, with the reference's types and rules
    opts = tapi.Options({"-fleet": 2, "-pad_fleet": False,
                         "-layout": "fleet2d"})
    assert (opts.get("-fleet"), opts.get("-pad_fleet"),
            opts.get("-layout")) == (2, False, "fleet2d")
    assert tapi.Options().get("-fleet") is None
    with pytest.raises(tapi.OptionTypeError, match="must be > 0"):
        tapi.Options({"-fleet": 0})
    with pytest.raises(tapi.OptionTypeError):
        tapi.Options({"-layout": "fleet3d"})


def test_cli_gamma_sweep_on_cpu(capsys):
    rc = tcli.main(["--instance", "garnet", "--n", "150", "--m", "4",
                    "--k", "3", "--batch", "3", "--sweep-gamma", "0.9",
                    "0.99", "--device", "cpu", "--method", "ipi_gmres"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[solve] fleet B=3" in out and "device=cpu" in out
    assert out.count("converged=True") == 3
    assert "gammas=[0.9, 0.968377, 0.99]" in out
    assert "s/instance amortized" in out and "kernel launches" not in out


def test_cli_seed_ensemble_matches_reference_cli(capsys):
    from repro.launch import solve as jcli
    argv = ["--instance", "maze2d", "--size", "7", "--batch", "2",
            "--method", "mpi", "--atol", "1e-9"]
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert jcli.main([*argv, "--single-device"]) == 0
    jout = capsys.readouterr().out
    summary = lambda out: [line.split("residual")[0] for line in
                           out.splitlines() if line.startswith("[solve] [")]
    assert summary(tout) == summary(jout) and len(summary(tout)) == 2


@pytest.mark.parametrize("flags, msg", [
    (["--sweep-gamma", "0.9", "0.99"], "needs --batch"),
    (["--batch", "3", "--load", "x"], "does not combine with --load")])
def test_cli_fleet_guards(flags, msg):
    with pytest.raises(SystemExit, match=msg):
        tcli.main(["--device", "cpu", *flags])


def test_fleet_stats_are_json(tmp_path):
    path = tmp_path / "stats.jsonl"
    with tapi.madupite_session({"-device": "cpu", "-method": "vi",
                                "-atol": 1e-6,
                                "-file_stats": str(path)}) as s:
        s.solve_fleet([tgen.garnet(n=30, m=3, k=2, seed=i)
                       for i in range(2)])
    entry = json.loads(path.read_text().splitlines()[-1])
    # the session's device-fleet LRU counters ride along, as in the
    # reference's entry (an array-backed fleet takes no cache entry)
    assert entry["fleet"] == {"size": 2, "buckets": [[0, 1]],
                              "cache": {"size": 0, "capacity": 8, "hits": 0,
                                        "misses": 0, "evictions": 0,
                                        "hit_rate": 0.0}}
    assert len(entry["solves"]) == 2
