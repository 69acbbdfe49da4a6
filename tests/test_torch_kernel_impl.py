"""``-kernel_impl`` on the CPU: the implementations give the same solves,
``blocked`` tunes its rows a chunk, and the names, aliases and refusals
are the table of :mod:`repro_torch.kernels.ops`.

* ``auto`` (the plain versions on the CPU), ``torch`` / ``xla`` (the
  plain versions) and ``blocked`` (the plain blocked versions, bit for bit
  the plain ones) give bit-identical solves: an ELL solve, a dense one, a
  fleet and a matrix-free solve.
* The port's solve under ``torch`` and ``blocked`` holds against the
  reference's ``IPIOptions(impl="xla")`` and ``impl="blocked")`` solves to
  ``tests/test_torch_solve.py``'s rules: ``vi`` bit for bit, ``mpi`` with
  exact policy and counts and values within ``max(1e-9 |v|_inf, gap
  bound)``.
* ``cuda`` / ``pallas`` on CPU tensors raise, ``pallas_interpret`` raises
  (the port has no interpreter), and so does ``-xla_flag_bundle``.

Every test runs with the port's tuner (and the reference's) pointed at a
file of its own under ``tmp_path``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.core import driver as jdriver
from repro.core import generators as jgen
from repro.core.ipi import IPIOptions as JOpts
from repro.kernels import tuning as jtuning
from repro_torch.api import MDP, Options, Session, UnknownOptionError
from repro_torch.api.options import OptionTypeError
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core.ipi import IPIOptions as TOpts
from repro_torch.kernels import ops, ref, tuning

from test_torch_solve import assert_close

jax.config.update("jax_enable_x64", True)

IMPLS = ["auto", "torch", "xla", "blocked"]


@pytest.fixture(autouse=True)
def _isolated_tuners(tmp_path):
    """The port's tuner and the reference's, each on its own file under
    ``tmp_path``; the process-wide state restored afterwards."""
    prev = (tuning.enabled(), tuning.cache_path())
    jprev = (jtuning.enabled(), jtuning.cache_path())
    tuning.reset(cache_path=str(tmp_path / "autotune.json"))
    jtuning.reset(cache_path=str(tmp_path / "reference_autotune.json"))
    jtuning.configure(enabled=False)
    yield
    tuning.reset(cache_path=prev[1])
    tuning.configure(enabled=prev[0])
    jtuning.reset(cache_path=jprev[1])
    jtuning.configure(enabled=jprev[0])


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).view(np.uint8)


def _same(a, b) -> None:
    assert np.array_equal(_bits(a.v), _bits(b.v))
    assert np.array_equal(a.policy, b.policy)
    assert (a.outer_iterations, a.inner_iterations) == \
        (b.outer_iterations, b.inner_iterations)
    assert np.array_equal(a.trace_residual, b.trace_residual,
                          equal_nan=True)


GARNET = dict(n=97, m=5, k=3, gamma=0.95, seed=1)
OPTS = dict(atol=1e-8, dtype="float64", max_outer=2000)


@pytest.mark.parametrize("method", ["vi", "mpi", "ipi_gmres"])
def test_impls_give_the_same_ell_solve(method):
    mdp = tgen.garnet(**GARNET)
    runs = [tdriver.solve(mdp, TOpts(method=method, impl=impl, **OPTS),
                          device="cpu") for impl in IMPLS]
    for r in runs[1:]:
        _same(runs[0], r)


@pytest.mark.parametrize("method", ["mpi", "ipi_gmres"])
def test_impls_give_the_same_dense_solve(method):
    mdp = tgen.garnet(n=40, m=4, k=3, gamma=0.95, seed=2).as_dense()
    runs = [tdriver.solve(mdp, TOpts(method=method, impl=impl, **OPTS),
                          device="cpu") for impl in IMPLS]
    for r in runs[1:]:
        _same(runs[0], r)


def test_impls_give_the_same_fleet():
    mdps = [tgen.garnet(**{**GARNET, "seed": s}) for s in range(3)]
    runs = [tdriver.solve_many(mdps, TOpts(method="ipi_gmres", impl=impl,
                                           **OPTS), device="cpu")
            for impl in IMPLS]
    for lanes in runs[1:]:
        for a, b in zip(runs[0], lanes):
            _same(a, b)


def test_impls_give_the_same_matrix_free_solve():
    mdp = MDP.from_generator("garnet", deferred=True, **GARNET)
    core = mdp.build("cpu", materialize="matrix_free")
    runs = [tdriver.solve(core, TOpts(method="mpi", impl=impl, **OPTS),
                          device="cpu") for impl in IMPLS]
    for r in runs[1:]:
        _same(runs[0], r)


def test_blocked_tunes_rows_a_chunk(monkeypatch):
    """``blocked`` times :data:`ops.BLOCK_ROWS_CANDIDATES` once a shape
    passes ``MIN_TUNE_ELEMS`` and persists the winner; the solve keeps its
    bits.  The threshold and the candidates are lowered so that a CPU test
    can reach them at n = 2000 (at the real threshold, 2^21 slots, the
    plain versions' bench would take minutes here)."""
    monkeypatch.setattr(tuning, "MIN_TUNE_ELEMS", 1000)
    monkeypatch.setattr(ops, "BLOCK_ROWS_CANDIDATES", (250, 500, 1000))
    mdp = tgen.garnet(n=2000, m=4, k=3, gamma=0.95, seed=3)
    base = tdriver.solve(mdp, TOpts(method="mpi", impl="torch", **OPTS),
                         device="cpu")
    got = tdriver.solve(mdp, TOpts(method="mpi", impl="blocked", **OPTS),
                        device="cpu")
    _same(base, got)
    entries = json.load(open(tuning.cache_path()))["entries"]
    assert set(entries) == {
        "ell_backup_blocked|torch-cpu|n2048|m4|k3|float64",
        "ell_matvec_blocked|torch-cpu|n2048|m1|k3|float64"}
    # the candidates, and the default (all 2000 rows) among them
    for entry in entries.values():
        assert set(entry["timings_s"]) == {"250", "500", "1000", "2000"}
        assert entry["choice"] in (250, 500, 1000, 2000)
    # explicit keyword > cache > default
    idx, val, cost = mdp.idx, mdp.val, mdp.cost
    v = torch.rand(2000, dtype=torch.float64)
    want = ref.ell_backup(idx, val, cost, 0.95, v)
    for bn in (None, 7):
        out = ops.ell_backup(idx, val, cost, 0.95, v, impl="blocked",
                             block_rows=bn)
        assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_blocked_below_the_threshold_times_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(tuning, "measure", lambda fn: calls.append(fn))
    assert ops.backup_block_rows(1000, 4, 4, 1000, torch.float64) == 1000
    assert ops.matvec_block_rows(200_000, 8, 200_000,
                                 torch.float64) == 125_000
    assert not calls


@pytest.mark.parametrize("family", ["garnet", "maze2d"])
@pytest.mark.parametrize("jimpl, timpl", [("xla", "torch"),
                                          ("blocked", "blocked")])
@pytest.mark.parametrize("method", ["vi", "mpi"])
def test_port_impls_hold_against_the_reference(method, jimpl, timpl,
                                               family):
    kw = dict(GARNET) if family == "garnet" else dict(size=9, gamma=0.99)
    common = dict(method=method, **OPTS)
    rj = jdriver.solve(jgen.REGISTRY[family](**kw),
                       JOpts(impl=jimpl, **common))
    rt = tdriver.solve(tgen.REGISTRY[family](**kw),
                       TOpts(impl=timpl, **common), device="cpu")
    assert rj.converged and rt.converged
    np.testing.assert_array_equal(rt.policy, rj.policy)
    assert (rt.outer_iterations, rt.inner_iterations) == \
        (rj.outer_iterations, rj.inner_iterations)
    if method == "vi":
        np.testing.assert_array_equal(_bits(rt.v), _bits(rj.v))
    else:
        assert_close(rj, rt, "float64")


def test_names_and_aliases():
    dev = torch.device("cpu")
    assert [ops.resolve(i, dev) for i in
            (None, "auto", "torch", "xla", "blocked")] == \
        ["torch", "torch", "torch", "torch", "blocked"]
    assert ops.resolve("cuda", torch.device("cuda")) == "cuda"
    assert ops.resolve("pallas", torch.device("cuda")) == "cuda"
    assert ops.resolve("auto", torch.device("cuda")) == "cuda"
    assert ops.resolve("xla", torch.device("cuda")) == "torch"
    assert Options({"-impl": "pallas"}).get("-kernel_impl") == "pallas"
    assert Options({"-impl": "xla"}).to_ipi().impl == "xla"
    assert Options().to_ipi().impl is None
    assert Options({"-kernel_impl": "none"}).get("-kernel_impl") is None
    assert TOpts(impl="blocked").impl == "blocked"


@pytest.mark.parametrize("impl", ["cuda", "pallas"])
def test_cuda_on_cpu_tensors_raises(impl):
    mdp = tgen.garnet(**GARNET)
    v = torch.zeros(GARNET["n"], dtype=torch.float64)
    with pytest.raises(ValueError, match="take CUDA tensors"):
        ops.ell_backup(mdp.idx, mdp.val, mdp.cost, 0.9, v, impl=impl)
    with pytest.raises(ValueError, match="take CUDA tensors"):
        ops.ell_matvec(mdp.idx[:, 0], mdp.val[:, 0], v, impl=impl)
    with pytest.raises(ValueError, match="take CUDA tensors"):
        tdriver.solve(mdp, TOpts(method="vi", impl=impl), device="cpu")
    with pytest.raises(ValueError, match="take CUDA tensors"):
        with Session({"-device": "cpu", "-kernel_impl": impl}) as s:
            s.solve(MDP.from_generator("garnet", **GARNET))


def test_pallas_interpret_raises_everywhere():
    with pytest.raises(ValueError, match="no interpreter"):
        TOpts(impl="pallas_interpret")
    with pytest.raises(OptionTypeError, match="no interpreter"):
        Options({"-kernel_impl": "pallas_interpret"})
    with pytest.raises(ValueError, match="no interpreter"):
        ops.resolve("pallas_interpret", torch.device("cpu"))
    with pytest.raises(ValueError, match="no interpreter"):
        ops.resolve("pallas_interpret", torch.device("cuda"))
    with pytest.raises(OptionTypeError, match="must be one of"):
        Options({"-kernel_impl": "triton"})


def test_xla_flag_bundle_is_refused_with_its_reason():
    with pytest.raises(UnknownOptionError, match="no counterpart in the "
                                                 "port"):
        Options({"-xla_flag_bundle": "cpu-host"})
    with pytest.raises(UnknownOptionError, match="XLA"):
        Options.from_sources(env={"MADUPITE_OPTIONS":
                                  "-xla_flag_bundle cpu-host"})


def test_session_configures_the_tuner_and_the_solves(tmp_path):
    path = str(tmp_path / "elsewhere.json")
    with Session({"-device": "cpu", "-kernel_tune": "off",
                  "-kernel_tune_cache": path, "-kernel_impl": "blocked",
                  "-method": "vi", "-dtype": "float64"}) as s:
        assert (tuning.enabled(), tuning.cache_path()) == (False, path)
        r = s.solve(MDP.from_generator("garnet", **GARNET))
    base = tdriver.solve(tgen.garnet(**GARNET),
                         TOpts(method="vi", dtype="float64"), device="cpu")
    _same(base, r)
    with Session({"-device": "cpu"}):
        assert tuning.enabled() is True


def test_cli_takes_the_kernel_options(tmp_path, capsys):
    from repro_torch.launch import solve as cli

    path = str(tmp_path / "cli.json")
    rc = cli.main(["--instance", "garnet", "--n", "97", "--m", "5", "--k",
                   "3", "--device", "cpu", "--method", "mpi", "--option",
                   "kernel_impl=blocked", "--option",
                   f"kernel_tune_cache={path}"])
    assert rc == 0
    assert tuning.cache_path() == path
    assert "converged=True" in capsys.readouterr().out
    with pytest.raises(ValueError, match="take CUDA tensors"):
        cli.main(["--instance", "garnet", "--n", "97", "--device", "cpu",
                  "--option", "kernel_impl=cuda"])
