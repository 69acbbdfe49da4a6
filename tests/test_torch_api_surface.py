"""The rest of the reference's public surface in the torch port, each name
held against the JAX package on the same input, on the CPU.

* ``MDP.save``: each package's files read by the other's ``load_mdp`` and
  ``MDP.from_file``, bit for bit (garnet in both modes, 1 and 3 blocks, a
  function-backed garnet); a dense MDP raises ``ValueError`` on both
  sides.
* ``Options.from_ipi`` / ``unset``: ``tests/test_api.py``'s round trip on
  both packages, field by field equal.  The port refuses the reference's
  ``impl="pallas_interpret"`` on purpose, so its case takes ``"pallas"``,
  and one more case checks the refusal.
* ``repro_torch.api.solve_fleet``: bit for bit ``Session.solve_fleet``,
  and the reference's ``solve_fleet`` at ``tests/test_torch_fleet.py``'s
  tolerances (policy and counts exact, values within 1e-9).
* ``repro_torch.core``'s exports; its ``solve`` / ``solve_many`` shims
  warn with the reference's category and words.
* ``outer_step``: stepped to ``done``, bit for bit ``solve_chunk``
  (values, policy, counts, traces); against the reference's
  ``outer_step`` step by step, within ``tests/test_torch_solve.py``'s
  tolerances (``vi`` bit for bit; ``max(1e-9 |v|_inf, gap bound)`` in
  float64, ``1e-4 |v|_inf`` in float32) with exact policy and counts;
  the input state unchanged.
* ``impl=None`` resolves as ``"auto"`` on both packages (the port has no
  process-wide default: ``-kernel_impl`` picks per call), and the
  kernels package's ``__all__``.
* ``models.layers.apply_mlp`` against the reference's on the same
  weights.

No module fixture; each case takes under 3 s alone (the slowest: both
packages' fleet solves), ~15 s for the file serial.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core as jcore
import repro_torch.api as tapi
import repro_torch.core as tcore
from repro.core import generators as jgen
from repro.core import io as jio
from repro.core import ipi as jipi
from repro.core.comm import Axes as JAxes
from repro.core.ipi import IPIOptions as JOpts
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core import io as tio
from repro_torch.core import ipi as tipi
from repro_torch.core.comm import Axes as TAxes
from repro_torch.core.ipi import IPIOptions as TOpts
from repro_torch.core.mdp import as_fleet, stack_mdps
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers

jax.config.update("jax_enable_x64", True)

GARNET = dict(n=61, m=4, k=3, gamma=0.95, seed=3)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.atleast_1d(np.asarray(x))).view(np.uint8)


def _tables(core) -> tuple:
    return tuple(np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
                 for t in (core.idx, core.val, core.cost))


def _assert_same_tables(a, b) -> None:
    for x, y in zip(_tables(a), _tables(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))
    assert (a.n_global, a.m_global, float(a.gamma)) == \
        (b.n_global, b.m_global, float(b.gamma))


# --------------------------------------------------------------------------- #
# MDP.save                                                                    #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("mode", ["mincost", "maxreward"])
def test_save_is_read_by_the_other_package(tmp_path, mode, n_blocks):
    want = jgen.garnet(**GARNET)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    japi.MDP(want, mode=mode).save(jdir, n_blocks=n_blocks)
    # an array-backed MDP writes its container as it is: no device asked
    tapi.MDP(tgen.garnet(**GARNET), mode=mode).save(tdir, n_blocks=n_blocks)
    for path in (jdir, tdir):
        for core in (tio.load_mdp(path), jio.load_mdp(path),
                     tapi.MDP.from_file(path).core,
                     japi.MDP.from_file(path).build()):
            _assert_same_tables(core, want)
        assert tapi.MDP.from_file(path).mode == mode
        assert japi.MDP.from_file(path).mode == mode
        assert tio.load_manifest(path) == jio.load_manifest(path)
    assert jio.load_manifest(jdir) == jio.load_manifest(tdir)


def test_save_of_a_function_backed_mdp_builds_it(tmp_path):
    kw = dict(n=45, m=3, k=4, gamma=0.9, seed=5)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tapi.MDP.from_generator("garnet", deferred=True, **kw).save(
        tdir, n_blocks=2, device="cpu")
    japi.MDP.from_generator("garnet", deferred=True, **kw).save(
        jdir, n_blocks=2)
    _assert_same_tables(tio.load_mdp(tdir), jio.load_mdp(jdir))


def test_save_of_a_function_backed_mdp_asks_for_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda is a legal device here")
    mdp = tapi.MDP.from_generator("garnet", deferred=True, n=20, m=2, k=2)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        mdp.save(str(tmp_path / "t"))
    assert not (tmp_path / "t").exists()


def test_save_refuses_a_dense_mdp_on_both_sides(tmp_path):
    g = jgen.garnet(**GARNET)
    p = np.zeros((g.n_global, g.m_global, g.n_global), np.float32)
    idx, val = np.asarray(g.idx), np.asarray(g.val)
    for s in range(g.n_global):
        for a in range(g.m_global):
            np.add.at(p[s, a], idx[s, a], val[s, a])
    cost = np.asarray(g.cost)
    for api in (japi, tapi):
        dense = api.MDP.from_arrays(p=p, cost=cost, gamma=0.9)
        with pytest.raises(ValueError, match="ELL representation only"):
            dense.save(str(tmp_path / api.__name__))
        assert not (tmp_path / api.__name__).exists()


# --------------------------------------------------------------------------- #
# Options.from_ipi / unset                                                    #
# --------------------------------------------------------------------------- #

def _ipi_kw(impl):
    return dict(method="ipi_bicgstab", mode="maxreward", atol=1e-6,
                max_outer=123, max_inner=7, forcing_eta=0.2, restart=5,
                omega=0.9, mpi_sweeps=11, safeguard=False, impl=impl,
                dtype="float64", halo=3, gather_dtype="float32")


def _solver_fields(db, api) -> dict:
    fields = api.options._IPI_FIELDS
    return {name: db.get(name) for name in sorted(fields)}


@pytest.mark.parametrize("impl", ["pallas", "xla", None])
def test_options_ipi_roundtrip_lossless_on_both(impl):
    ipis = {japi: JOpts(**_ipi_kw(impl)), tapi: TOpts(**_ipi_kw(impl))}
    dbs = {}
    for api, ipi in ipis.items():
        dbs[api] = api.Options.from_ipi(ipi)
        assert dbs[api].to_ipi() == ipi
        db = api.Options({"-atol": 1e-5, "-method": "mpi",
                          "-mpi_sweeps": 9})
        again = api.Options.from_ipi(db.to_ipi())
        assert again.get("-atol") == 1e-5
        assert again.get("-method") == "mpi"
        assert again.get("-mpi_sweeps") == 9
    assert japi.options._IPI_FIELDS == tapi.options._IPI_FIELDS
    assert _solver_fields(dbs[japi], japi) == _solver_fields(dbs[tapi], tapi)
    assert dbs[japi].as_dict(explicit_only=True) == \
        dbs[tapi].as_dict(explicit_only=True)
    want = {f: getattr(ipis[japi], f)
            for f in japi.options._IPI_FIELDS.values()}
    assert {f: getattr(ipis[tapi], f) for f in want} == want


def test_options_defaults_round_trip_on_both():
    for api, opts in ((japi, JOpts), (tapi, TOpts)):
        assert api.Options().to_ipi() == opts()
        assert api.Options.from_ipi(opts()).to_ipi() == opts()


def test_port_still_refuses_the_pallas_interpreter():
    with pytest.raises(ValueError, match="has no interpreter"):
        TOpts(**_ipi_kw("pallas_interpret"))
    with pytest.raises(tapi.OptionTypeError, match="has no interpreter"):
        tapi.Options({"-kernel_impl": "pallas_interpret"})
    # the reference's database takes it, and so writes a file the port
    # refuses by name
    db = japi.Options.from_ipi(JOpts(**_ipi_kw("pallas_interpret")))
    with pytest.raises(tapi.OptionTypeError, match="-kernel_impl"):
        tapi.Options(db.as_dict(explicit_only=True))


def test_options_unset_on_both():
    for api in (japi, tapi):
        db = api.Options({"-atol": 1e-5, "impl": "xla"})
        db.unset("atol")
        db.unset("-kernel_impl")      # the alias's key
        db.unset("-max_outer")        # not set: a no-op
        assert not db.is_set("-atol") and not db.is_set("-impl")
        assert db.get("-atol") == 1e-8 and db.get("-kernel_impl") is None
        assert db.as_dict(explicit_only=True) == {}
        with pytest.raises(api.UnknownOptionError, match="-atoll"):
            db.unset("-atoll")
        # an unset key takes a lower-precedence value again
        db.set("-atol", 1e-3, source="cli")
        db.unset("-atol")
        db.set("-atol", 1e-2, source="env")
        assert db.get("-atol") == 1e-2


# --------------------------------------------------------------------------- #
# api.solve_fleet                                                             #
# --------------------------------------------------------------------------- #

FLEET = [dict(n=120, m=6, k=4, gamma=0.95, seed=s) for s in (0, 1, 2)]
FLEET_OPTS = {"-method": "ipi_gmres", "-atol": 1e-9, "-dtype": "float64",
              "-max_outer": 20000}


@pytest.fixture
def host_default_session(monkeypatch):
    """Makes the shared default session on the host (``MADUPITE_OPTIONS``,
    which it reads when made), closed after the case; the process's own
    is put back."""
    monkeypatch.setattr(tapi, "_default_session", None)

    def make():
        with monkeypatch.context() as env:
            env.setenv("MADUPITE_OPTIONS", "-device cpu")
            return tapi._default()
    yield make
    if tapi._default_session is not None:
        tapi._default_session.close()


def test_solve_fleet_is_the_session_fleet_and_the_reference(
        host_default_session):
    tm = [tapi.MDP(tgen.garnet(**kw)) for kw in FLEET]
    with tapi.Session({**FLEET_OPTS, "-device": "cpu"}) as s:
        want = s.solve_fleet(tm)
    one_shot = tapi.solve_fleet(tm, {**FLEET_OPTS, "-device": "cpu"})
    host_default_session()
    on_default = tapi.solve_fleet(
        tm, **{k[1:]: v for k, v in FLEET_OPTS.items()})
    assert tapi._default_session.device.type == "cpu"
    jrs = japi.solve_fleet([jgen.garnet(**kw) for kw in FLEET],
                           {**FLEET_OPTS, "-kernel_impl": "xla"})
    for got in (one_shot, on_default):
        for w, g in zip(want, got, strict=True):
            np.testing.assert_array_equal(_bits(g.v), _bits(w.v))
            np.testing.assert_array_equal(g.policy, w.policy)
            assert (g.outer_iterations, g.inner_iterations) == \
                (w.outer_iterations, w.inner_iterations)
            np.testing.assert_array_equal(_bits(g.trace_residual),
                                          _bits(w.trace_residual))
    for j, t in zip(jrs, want, strict=True):
        assert j.converged and t.converged
        np.testing.assert_array_equal(t.policy, j.policy)
        np.testing.assert_allclose(t.v, j.v, atol=1e-9, rtol=0)
        assert (t.outer_iterations, t.inner_iterations) == \
            (j.outer_iterations, j.inner_iterations)
        np.testing.assert_array_equal(t.trace_inner, j.trace_inner)
        np.testing.assert_allclose(t.trace_residual, j.trace_residual,
                                   atol=1e-12, rtol=1e-4)
    assert "bucket_indices" in tapi.__all__ and "solve_fleet" in tapi.__all__
    assert tapi.bucket_indices([5, 500, 6]) == \
        japi.bucket_indices([5, 500, 6])


# --------------------------------------------------------------------------- #
# core's exports and shims                                                    #
# --------------------------------------------------------------------------- #

def test_core_exports_the_references_names():
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    assert tcore.METHODS == jcore.METHODS == jipi.METHODS == tipi.METHODS
    assert tcore.MODES == jcore.MODES
    assert tcore.Axes is TAxes and tcore.SolveResult is tdriver.SolveResult
    for name in ("bellman", "generators", "methods", "partition"):
        assert getattr(tcore, name).__name__ == f"repro_torch.core.{name}"
    ns = {}
    exec("from repro_torch.core import *", ns)
    assert set(tcore.__all__) <= set(ns)


def test_core_shims_warn_as_the_references_do():
    jm = jgen.garnet(n=40, m=3, k=3, gamma=0.9, seed=0)
    tm = tgen.garnet(n=40, m=3, k=3, gamma=0.9, seed=0)
    jo, to = JOpts(method="vi", atol=1e-6, impl="xla"), \
        TOpts(method="vi", atol=1e-6)
    calls = {"solve": ((jm, jo), (tm, to)),
             "solve_many": (([jm, jm], jo), ([tm, tm], to))}
    for name, (jargs, targs) in calls.items():
        with pytest.warns(DeprecationWarning) as jw:
            jr = getattr(jcore, name)(*jargs)
        with pytest.warns(DeprecationWarning, match="repro_torch.api") as tw:
            tr = getattr(tcore, name)(*targs, device="cpu")
        assert str(tw[0].message) == \
            str(jw[0].message).replace("repro.", "repro_torch.")
        assert tw[0].filename == __file__
        want = getattr(tdriver, name)(*targs, device="cpu")
        for j, t, w in zip(np.atleast_1d(jr), np.atleast_1d(tr),
                           np.atleast_1d(want), strict=True):
            np.testing.assert_array_equal(_bits(t.v), _bits(w.v))
            np.testing.assert_array_equal(_bits(t.v), _bits(j.v))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdriver.solve(tm, to, device="cpu")       # the engine: no warning


# --------------------------------------------------------------------------- #
# ipi.outer_step                                                              #
# --------------------------------------------------------------------------- #

def _snapshot(state) -> dict:
    return {f.name: (np.copy(v) if isinstance(v, np.ndarray)
                     else None if v is None else v.clone())
            for f in dataclasses.fields(state)
            for v in [getattr(state, f.name)]}


def _assert_state_equal(a, b) -> None:
    """Field by field, bit for bit (a snapshot dict or a state)."""
    get = (lambda s, k: s[k]) if isinstance(a, dict) else getattr
    for f in dataclasses.fields(b):
        x, y = get(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
            continue
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=f.name)


def _port_steps(mdp, opts) -> list:
    ax = TAxes()
    states = [tipi.init_state(mdp, ax, opts)]
    stop, _, _, k = tipi.stop_flags(states[-1])
    while not stop.all() and k.max() < opts.max_outer:
        before = _snapshot(states[-1])
        state, flags = tipi.outer_step(mdp, states[-1], opts, ax,
                                       with_flags=True)
        _assert_state_equal(before, states[-1])
        # the step's flags are stop_flags of the state it returns
        for got, want in zip(flags, tipi.stop_flags(state)):
            np.testing.assert_array_equal(got, want)
        states.append(state)
        stop, _, _, k = flags
    return states


CASES = [("vi", "float64"), ("mpi", "float32"), ("ipi_gmres", "float64"),
         ("ipi_bicgstab", "float32")]


@pytest.mark.parametrize("method, dtype", CASES)
def test_outer_step_is_solve_chunk_and_the_reference(method, dtype):
    atol = {"float64": 1e-8, "float32": 1e-4}[dtype]
    common = dict(method=method, dtype=dtype, atol=atol, max_outer=1000)
    topts = TOpts(**common)
    tm = as_fleet(tgen.garnet(**GARNET))
    steps = _port_steps(tm, topts)
    assert len(steps) > 2
    chunked = tipi.solve_chunk(tm, tipi.init_state(tm, TAxes(), topts),
                               topts.max_outer, topts, TAxes())
    _assert_state_equal(steps[-1], chunked)

    jopts = JOpts(impl="xla", **common)
    jm = jgen.garnet(**GARNET)
    step = jax.jit(jipi.outer_step, static_argnums=(2, 3))
    js = jipi.init_state(jm, JAxes(), jopts)
    scale = float(np.abs(np.asarray(steps[-1].v)).max())
    for k, ts in enumerate(steps):
        if k:
            js = step(jm, js, jopts, JAxes())
        assert int(js.k) == int(ts.k[0]) == k
        assert int(js.inner_total) == int(ts.inner_total[0])
        assert bool(js.done) == bool(ts.done[0])
        np.testing.assert_array_equal(np.asarray(js.pi), ts.pi[0].numpy())
        np.testing.assert_array_equal(np.asarray(js.trace_inner),
                                      ts.trace_inner[0].numpy())
        jv, tv = np.asarray(js.v), ts.v[0].numpy()
        if method == "vi":
            np.testing.assert_array_equal(_bits(tv), _bits(jv))
            np.testing.assert_array_equal(_bits(ts.trace_res[0].numpy()),
                                          _bits(np.asarray(js.trace_res)))
        else:
            dv = float(np.abs(jv.astype(np.float64) - tv).max())
            bound = 1e-9 * scale if dtype == "float64" else 1e-4 * scale
            if bool(js.done):
                bound = max(bound, float(js.res) / (1 - GARNET["gamma"]))
            assert dv <= bound, (k, dv, bound)
    assert bool(js.done)


def test_outer_step_on_a_fleet_steps_every_lane():
    mdps = [tgen.garnet(**kw) for kw in FLEET]
    fleet = stack_mdps(mdps)
    opts = TOpts(method="ipi_gmres", dtype="float64", atol=1e-9,
                 max_outer=100)
    ax = TAxes()
    s0 = tipi.init_state(fleet, ax, opts)
    one = tipi.outer_step(fleet, s0, opts, ax)
    chunk = tipi.solve_chunk(fleet, tipi.init_state(fleet, ax, opts), 1,
                             opts, ax)
    _assert_state_equal(one, chunk)
    # a lane's step in the fleet is its step alone (GMRES lanes agree to
    # rounding: the batched dots, tests/test_torch_fleet.py)
    for b, m in enumerate(mdps):
        alone = as_fleet(m)
        lane = tipi.outer_step(alone, tipi.init_state(alone, ax, opts), opts,
                               ax)
        np.testing.assert_array_equal(one.pi[b].numpy(), lane.pi[0].numpy())
        np.testing.assert_allclose(one.v[b].numpy(), lane.v[0].numpy(),
                                   atol=1e-12, rtol=0)
        assert one.inner_total[b] == lane.inner_total[0]
    # lanes apart (as a chunk leaves them when some stop) are refused
    apart = dataclasses.replace(one, k=np.array([1, 2, 1]))
    with pytest.raises(ValueError, match="one outer index"):
        tipi.outer_step(fleet, apart, opts, ax)
    full = dataclasses.replace(one, k=np.full(3, 100))
    with pytest.raises(ValueError, match="max_outer = 100"):
        tipi.outer_step(fleet, full, opts, ax)


def test_outer_step_takes_the_discounts_of_gamma_t():
    kw = {**GARNET, "gamma": 0.9}
    opts = TOpts(method="ipi_gmres", dtype="float64", atol=1e-9)
    at_95, at_90 = as_fleet(tgen.garnet(**GARNET)), as_fleet(tgen.garnet(**kw))
    s0 = tipi.init_state(at_90, TAxes(), opts)
    got = tipi.outer_step(at_95, s0, opts, TAxes(),
                          gamma_t=torch.tensor([0.9], dtype=torch.float64))
    _assert_state_equal(got, tipi.outer_step(at_90, s0, opts, TAxes()))


# --------------------------------------------------------------------------- #
# kernels.ops: impl=None and -kernel_impl                                     #
# --------------------------------------------------------------------------- #

def test_no_impl_resolves_as_auto_on_both():
    cpu = torch.device("cpu")
    assert jops.get_default_impl() == "auto"
    assert tops.resolve(None, cpu) == tops.resolve("auto", cpu) == "torch"
    assert not hasattr(tops, "set_default_impl")
    assert tops.resolve("blocked", cpu) == "blocked"
    for alias, impl in tops.ALIASES.items():
        if impl != "cuda":
            assert tops.resolve(alias, cpu) == impl


def test_kernel_impl_picks_a_solves_kernels_as_the_references(monkeypatch):
    calls = []
    blocked = tops.ref.ell_backup_blocked
    monkeypatch.setattr(tops.ref, "ell_backup_blocked",
                        lambda *a, **k: calls.append(1) or blocked(*a, **k))
    tm, jm = tgen.garnet(**GARNET), jgen.garnet(**GARNET)
    opts = dict(method="vi", dtype="float64", atol=1e-8)
    plain = tdriver.solve(tm, TOpts(**opts), device="cpu")
    assert not calls                                  # None: the plain one
    got = tdriver.solve(tm, TOpts(impl="blocked", **opts), device="cpu")
    assert calls                                      # the blocked backup
    want = jcore.driver.solve(jm, JOpts(impl="xla", **opts))
    for r in (got, want):
        np.testing.assert_array_equal(_bits(r.v), _bits(plain.v))
        np.testing.assert_array_equal(r.policy, plain.policy)
        assert r.outer_iterations == plain.outer_iterations
    n = len(calls)
    tdriver.solve(tm, TOpts(impl="torch", **opts), device="cpu")
    assert len(calls) == n


def test_kernels_package_exports_ops_and_ref():
    import repro.kernels as jk
    import repro_torch.kernels as tk

    assert tk.__all__ == jk.__all__ == ["ops", "ref"]
    ns = {}
    exec("from repro_torch.kernels import *", ns)
    assert ns["ops"] is tops and ns["ref"] is tops.ref


# --------------------------------------------------------------------------- #
# models.layers.apply_mlp                                                     #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2", "gelu"])
def test_apply_mlp_matches_the_reference(mlp_type):
    rng = np.random.default_rng(7)
    d, f = 24, 40
    w = {name: (rng.standard_normal(shape) * 0.2).astype(np.float32)
         for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                             ("w_down", (f, d)))
         if mlp_type == "swiglu" or name != "w_gate"}
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    want = np.asarray(jlayers.apply_mlp(
        {k: jax.numpy.asarray(v) for k, v in w.items()},
        jax.numpy.asarray(x), mlp_type))
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got = tlayers.apply_mlp(tw, torch.from_numpy(x), mlp_type)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    mlp = tlayers.MLP(d, f, mlp_type, torch.float32, "cpu")
    with torch.no_grad():
        for k, v in tw.items():
            getattr(mlp, k).copy_(v)
        np.testing.assert_array_equal(_bits(mlp(torch.from_numpy(x))),
                                      _bits(got))
    with pytest.raises(ValueError, match="unknown mlp_type"):
        tlayers.apply_mlp(tw, torch.from_numpy(x), "relu")
