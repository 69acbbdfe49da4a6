"""The torch port's user registries against the JAX package's.

* The same user KSP (three fixed Richardson sweeps) and the same ad-hoc
  stop predicate, registered in each package and solved through each
  package's ``Session``, give an equal policy and equal outer and inner
  counts; values agree within ``max(1e-9 |v|_inf, gap bound)`` (a sweep is
  ``x + (b - A x)``, one rounding more or less where XLA contracts).
* ``unregister_*`` restores the builtin registries.
* Unknown-name and duplicate-name messages equal the reference's, with
  the hint naming this package's ``repro_torch.api`` where the
  reference's names ``repro.api``; the registered-name lists are the
  reference's; ``async_vi`` and the virtual ``auto``, the last two
  ported, are registered as the reference registers them.
* ``method_table``, ``ksp_table`` and ``stop_table`` equal the
  reference's.

Registries are process-global: every test that registers a name
unregisters it in its fixture's teardown.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api import MDP as JMDP
from repro.api import Session as JSession
from repro.core import methods as jmethods
import repro_torch.api as tapi
from repro_torch.api import MDP, madupite_session
from repro_torch.core import methods as tmethods

jax.config.update("jax_enable_x64", True)

GARNET = dict(n=97, m=5, k=3, gamma=0.95, seed=1)
SWEEPS = 3


def _jax_sweeps(matvec, b, x0, *, tol, maxiter, axes):
    """Three Richardson sweeps, whatever the tolerance (lax control)."""
    x = jax.lax.fori_loop(0, SWEEPS, lambda i, x: x + (b - matvec(x)), x0)
    return x, jnp.int32(SWEEPS), axes.norm_inf(b - matvec(x))


def _torch_sweeps(matvec, b, x0, *, tol, maxiter, axes):
    """Three Richardson sweeps, whatever the tolerance."""
    x = x0
    for _ in range(SWEEPS):
        x = x + (b - matvec(x))
    return x, SWEEPS, axes.norm_inf(b - matvec(x))


def _jax_stop(m):
    return (m.span <= m.atol) | (m.res <= 0.5 * m.atol)


def _torch_stop(m):
    return (m.span <= m.atol) | (m.res <= 0.5 * m.atol)


@pytest.fixture
def adhoc_cleanup():
    """Unregister the ad-hoc stop criteria a test's solves register."""
    before = (set(jmethods.stop_names()), set(tmethods.stop_names()))
    yield
    for mod, names in zip((jmethods, tmethods), before):
        for name in set(mod.stop_names()) - names:
            mod.unregister_stop_criterion(name)


@pytest.fixture
def sweeps_registered():
    japi.register_ksp("sweeps3", _jax_sweeps)
    tapi.register_ksp("sweeps3", _torch_sweeps)
    yield
    japi.unregister_ksp("sweeps3")
    tapi.unregister_ksp("sweeps3")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_user_ksp_and_adhoc_stop_match_reference(sweeps_registered,
                                                 adhoc_cleanup, dtype):
    opts = {"-ksp_type": "sweeps3", "-dtype": dtype, "-max_outer": 3000,
            "-atol": 1e-8 if dtype == "float64" else 1e-4}
    with JSession({**opts, "-layout": "single", "-kernel_impl": "xla",
                   "-kernel_tune": "off"}) as js:
        rj = js.solve(JMDP.from_generator("garnet", **GARNET),
                      stop_criterion=_jax_stop)
        jstats = js.stats[-1]
    with madupite_session({**opts, "-device": "cpu"}) as s:
        rt = s.solve(MDP.from_generator("garnet", **GARNET),
                     stop_criterion=_torch_stop)
        tstats = s.stats[-1]
    assert rj.converged and rt.converged
    assert jstats["method"] == tstats["method"] == "ipi_sweeps3"
    assert jstats["stop_criterion"].startswith("custom_")
    assert tstats["stop_criterion"].startswith("custom_")
    np.testing.assert_array_equal(rt.policy, rj.policy)
    assert (rt.outer_iterations, rt.inner_iterations) == \
        (rj.outer_iterations, rj.inner_iterations)
    assert rt.inner_iterations == SWEEPS * rt.outer_iterations
    scale = float(np.abs(rj.v).max())
    bound = max(1e-9 * scale, rj.gap_bound) if dtype == "float64" \
        else 1e-4 * scale
    assert float(np.abs(rj.v.astype(np.float64) - rt.v).max()) <= bound


def test_adhoc_stop_names_are_stable_per_callable(adhoc_cleanup):
    name = tmethods.adhoc_stop_criterion(_torch_stop)
    assert tmethods.adhoc_stop_criterion(_torch_stop) == name
    assert tmethods.get_stop(name).needs_span


def test_user_ksp_receives_only_what_it_accepts(sweeps_registered):
    """A KSP without ``opts`` / ``context`` / ``precond`` is called
    without them; one with ``**kw`` gets all three, on the solve device,
    with ``context["gamma"]`` the MDP's discount."""
    seen = {}

    def greedy(matvec, b, x0, *, tol, maxiter, axes, **kw):
        seen.update(kw, device=x0.device, dtype=x0.dtype)
        return x0, 0, axes.norm_inf(b - matvec(x0))

    tapi.register_ksp("spy", greedy, preconditioned=True)
    try:
        with madupite_session({"-ksp_type": "spy", "-device": "cpu",
                               "-dtype": "float64", "-pc_type": "jacobi",
                               "-max_outer": 5}) as s:
            s.solve(MDP.from_generator("garnet", **GARNET))
        r = madupite_session({"-ksp_type": "sweeps3", "-device": "cpu",
                              "-max_outer": 5}).solve(
            MDP.from_generator("garnet", **GARNET))
    finally:
        tapi.unregister_ksp("spy")
    assert set(seen) == {"opts", "context", "precond", "device", "dtype"}
    assert seen["context"] == {"gamma": 0.95}
    assert callable(seen["precond"]) and seen["opts"].pc_type == "jacobi"
    assert seen["device"] == torch.device("cpu")
    assert seen["dtype"] == torch.float64
    assert r.outer_iterations == 5


def test_unregister_restores_builtin_state():
    before = (tmethods.ksp_names(), tmethods.method_names(),
              tmethods.stop_names())
    tapi.register_ksp("tmp_ksp", _torch_sweeps)
    tapi.register_method("tmp_method", ksp="tmp_ksp", inner="sweeps")
    tapi.register_stop_criterion("tmp_stop", _torch_stop)
    assert "ipi_tmp_ksp" in tmethods.method_names()
    tapi.unregister_method("tmp_method")
    tapi.unregister_ksp("tmp_ksp")
    tapi.unregister_stop_criterion("tmp_stop")
    after = (tmethods.ksp_names(), tmethods.method_names(),
             tmethods.stop_names())
    assert after == before
    assert after == (tmethods.ksp_names(builtin_only=True),
                     tmethods.method_names(builtin_only=True),
                     tmethods.stop_names(builtin_only=True))
    with pytest.raises(ValueError, match="refusing to unregister builtin"):
        tapi.unregister_ksp("gmres")


_KINDS = {"ksp": ("ksp", "_KSPS", "register_ksp"),
          "method": ("method", "_METHODS", "register_method"),
          "stop": ("stop criterion", "_STOPS", "register_stop_criterion")}


@pytest.mark.parametrize("kind,name", [("ksp", "gmress"),
                                       ("ksp", "bicg"),
                                       ("method", "ipi_gmress"),
                                       ("method", "chebyshev"),
                                       ("stop", "spam"),
                                       ("stop", "atoll")])
def test_unknown_name_messages_match_reference(kind, name):
    """The reference's message builder over the same registered names
    (either package's registry may hold names other tests in the process
    registered), with this package's import path in the hint."""
    label, registry, hint = _KINDS[kind]
    names = list(getattr(tmethods, registry))
    want = jmethods._unknown(label, name, names, hint).replace(
        "repro.api.", "repro_torch.api.")
    got = getattr(tmethods, f"check_{kind}")(name)
    assert got == want
    with pytest.raises(ValueError) as e:
        getattr(tmethods, f"get_{kind}")(name)
    assert str(e.value) == got
    # with the builtin registries the name lists are the reference's
    assert getattr(tmethods, f"{kind}_names")(builtin_only=True) == \
        getattr(jmethods, f"{kind}_names")(builtin_only=True)


@pytest.mark.parametrize("kind,name", [("ksp", "gmres"), ("method", "vi"),
                                       ("stop criterion", "span"),
                                       ("ksp", "user")])
def test_duplicate_name_messages_match_reference(kind, name):
    def register(mod, fn):
        if kind == "ksp":
            mod.register_ksp(name, fn, auto_method=False)
        elif kind == "method":
            mod.register_method(name, ksp=None, inner="none")
        else:
            mod.register_stop_criterion(name, fn)

    msgs = []
    for mod, fn in ((jmethods, _jax_sweeps), (tmethods, _torch_sweeps)):
        try:
            if name == "user":
                register(mod, fn)          # first registration: free
            with pytest.raises(ValueError) as e:
                register(mod, fn)
            msgs.append(str(e.value))
        finally:
            if name == "user":
                mod.unregister_ksp(name)
    assert msgs[1] == msgs[0]


@pytest.mark.parametrize("name", ("async_vi", "auto"))
def test_unported_methods_name_their_queue_item(name):
    """The two methods ported last (ROADMAP queue 1 items 10 and 12) are
    registered as the reference registers them."""
    assert name in jmethods.method_names()
    spec, jspec = tmethods.get_method(name), jmethods.get_method(name)
    assert tmethods.check_method(name) is None
    assert (spec.ksp, spec.inner, spec.safeguarded, spec.doc,
            spec.virtual) == (jspec.ksp, jspec.inner, jspec.safeguarded,
                              jspec.doc, jspec.virtual)
    assert (spec.outer is not None) == (name == "async_vi")
    assert tapi.Options({"-method": name}).get("-method") == name


def test_tables_match_reference_less_unported_rows():
    assert tapi.method_table() == japi.method_table()
    assert tapi.ksp_table() == japi.ksp_table()
    assert tapi.stop_table() == japi.stop_table()
    assert tapi.method_names(builtin_only=True) == \
        japi.method_names(builtin_only=True)


def test_option_table_rows_match_reference_types_and_defaults():
    """Every port key renders with the reference's type column and default
    (``-device`` is the port's own key; ``-kernel_impl`` takes the port's
    implementation names beside every reference name but the Pallas
    interpreter's, which has no counterpart in the port)."""
    def rows(table):
        out = {}
        for line in table.splitlines()[2:]:
            cells = [c.strip() for c in line.strip("|").split(" | ")]
            out[cells[0]] = cells[1:3]
        return out

    jrows, trows = rows(japi.option_table()), rows(tapi.option_table())
    for key, (typ, default) in trows.items():
        if key == "`-device`":
            continue
        assert key in jrows, key
        jtyp, jdefault = jrows[key]
        assert default == jdefault, key
        if key == "`-kernel_impl`":
            names = lambda t: set(t.split(" \\| "))
            assert names(jtyp) - {"`pallas_interpret`"} <= names(typ), key
            continue
        assert typ == jtyp, key
