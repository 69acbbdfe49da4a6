"""Halo windows, compressed gathers and asynchronous VI on one device,
against the JAX reference.

* ``-halo`` (the banded window ``[start - halo, stop + halo)``, with the
  successor ids shifted once at placement) is bit for bit the all-gather
  solve (``-halo 0``): values, counts and the residual trace, for ``vi``,
  ``ipi_gmres`` and ``ipi_bicgstab`` (the cases of
  ``tests/test_halo.py``), and its counts are the reference's halo
  solve's.  A band wider than the halo is rejected with the reference's
  message.
* ``-gather_dtype float32`` (the inner matvecs' window rounded through
  float32) converges with the reference's outer and inner counts.
* ``async_vi`` with ``-async_sweeps 1`` is ``vi`` bit for bit; with 8
  sweeps it has the reference's counts and policy, in fewer value
  exchanges than ``vi``, and its span certificate holds.
* The new option keys validate with the reference's messages.

The sharded forms of the same paths run in
``tests/test_torch_distributed.py``.
"""

import jax
import numpy as np
import pytest

from repro.core import driver as jdriver
from repro.core import generators as jgen
from repro.core.ipi import IPIOptions as JOpts
from repro_torch.api import Options
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core.ipi import IPIOptions as TOpts

jax.config.update("jax_enable_x64", True)


def _bits(a):
    return np.asarray(a, np.float64).view(np.uint64)


def _same_solve(a, b):
    """Bit for bit: values, policy, counts and residual trace."""
    np.testing.assert_array_equal(_bits(a.v), _bits(b.v))
    np.testing.assert_array_equal(a.policy, b.policy)
    assert (a.outer_iterations, a.inner_iterations) == \
        (b.outer_iterations, b.inner_iterations)
    np.testing.assert_array_equal(a.trace_residual, b.trace_residual)


def _both(family, kw, **opts):
    rj = jdriver.solve(jgen.REGISTRY[family](**kw),
                       JOpts(impl="xla", **opts))
    rt = tdriver.solve(tgen.REGISTRY[family](**kw), TOpts(**opts),
                       device="cpu")
    return rj, rt


@pytest.mark.parametrize("method", ["vi", "ipi_gmres", "ipi_bicgstab"])
def test_halo_single_device_exact(method):
    maze = dict(size=20, gamma=0.99)               # bandwidth 20
    common = dict(method=method, atol=1e-8, dtype="float64")
    base = tdriver.solve(tgen.maze2d(**maze), TOpts(**common), device="cpu")
    rj, halo = _both("maze2d", maze, halo=24, **common)
    _same_solve(halo, base)
    assert halo.converged and rj.converged
    assert (halo.outer_iterations, halo.inner_iterations) == \
        (rj.outer_iterations, rj.inner_iterations)
    np.testing.assert_array_equal(halo.policy, rj.policy)
    assert np.abs(halo.v - rj.v).max() <= 1e-9 * np.abs(rj.v).max()


@pytest.mark.parametrize("size,halo", [(7, 7), (12, 30)])
def test_halo_at_and_above_the_band_is_exact(size, halo):
    common = dict(method="ipi_gmres", atol=1e-7, dtype="float64")
    mdp = tgen.maze2d(size=size, gamma=0.95, slip=0.2)
    _same_solve(tdriver.solve(mdp, TOpts(halo=halo, **common), device="cpu"),
                tdriver.solve(mdp, TOpts(**common), device="cpu"))


def test_halo_rejects_wide_band():
    """A bandwidth violation must be caught, not silently mis-solved."""
    mdp = tgen.garnet(100, 4, 3, seed=0)           # random columns
    with pytest.raises(ValueError, match="bandwidth") as e:
        tdriver.solve(mdp, TOpts(method="vi", atol=1e-6, halo=5),
                      device="cpu")
    with pytest.raises(ValueError) as je:
        jdriver.solve(jgen.garnet(100, 4, 3, seed=0),
                      JOpts(method="vi", atol=1e-6, halo=5, impl="xla"))
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="ELL representation"):
        tdriver.solve(tgen.maze2d(size=5).as_dense(),
                      TOpts(method="vi", halo=5), device="cpu")


@pytest.mark.parametrize("method", ["ipi_richardson", "ipi_gmres"])
def test_compressed_gather_converges_with_reference_counts(method):
    """The f32 wire's noise (~1e-6 |v|) sits far below atol, so the
    forcing term absorbs it: converged, near the exact gather's values,
    and the reference's counts and policy."""
    chain = dict(n=400, gamma=0.9)                 # ||v*|| ~ 10
    common = dict(method=method, atol=1e-4, dtype="float64")
    base = tdriver.solve(tgen.chain_walk(**chain), TOpts(**common),
                         device="cpu")
    rj, comp = _both("chain_walk", chain, gather_dtype="float32", **common)
    assert comp.converged and rj.converged
    assert np.abs(comp.v - base.v).max() < 1e-3
    assert (comp.outer_iterations, comp.inner_iterations) == \
        (rj.outer_iterations, rj.inner_iterations)
    np.testing.assert_array_equal(comp.policy, rj.policy)


def test_compressed_dense_gather_keeps_the_reference_product_dtype():
    """A dense solve's inner product runs in float32 under an f32 wire,
    as the reference's promotion gives: the reference's counts."""
    kw = dict(n=60, m=4, k=3, gamma=0.9, seed=2)
    common = dict(method="ipi_richardson", atol=1e-4, dtype="float64",
                  gather_dtype="float32")
    rj = jdriver.solve(jgen.garnet(**kw).as_dense(),
                       JOpts(impl="xla", **common))
    rt = tdriver.solve(tgen.garnet(**kw).as_dense(), TOpts(**common),
                       device="cpu")
    assert rt.converged and rj.converged
    assert (rt.outer_iterations, rt.inner_iterations) == \
        (rj.outer_iterations, rj.inner_iterations)


ASYNC = dict(atol=1e-6, stop_criterion="span", dtype="float64",
             max_outer=20000)


def test_async_sweeps_one_is_vi():
    chain = tgen.chain_walk(512, gamma=0.99)
    _same_solve(tdriver.solve(chain, TOpts(method="async_vi",
                                           async_sweeps=1, **ASYNC),
                              device="cpu"),
                tdriver.solve(chain, TOpts(method="vi", **ASYNC),
                              device="cpu"))


@pytest.mark.parametrize("halo", [0, 2])
def test_async_vi_matches_reference(halo):
    chain = dict(n=512, gamma=0.99)
    rj, rt = _both("chain_walk", chain, method="async_vi", async_sweeps=8,
                   halo=halo, **ASYNC)
    sync = tdriver.solve(tgen.chain_walk(**chain),
                         TOpts(method="vi", **ASYNC), device="cpu")
    ref = tdriver.solve(tgen.chain_walk(**chain),
                        TOpts(method="vi", atol=1e-10, dtype="float64",
                              max_outer=20000), device="cpu")
    assert rt.converged
    assert (rt.outer_iterations, rt.inner_iterations) == \
        (rj.outer_iterations, rj.inner_iterations)
    assert rt.outer_iterations < sync.outer_iterations
    np.testing.assert_array_equal(rt.policy, rj.policy)
    np.testing.assert_array_equal(rt.policy, sync.policy)
    assert np.abs(rt.v - rj.v).max() <= 1e-9 * np.abs(rj.v).max()
    # the certificate is a guarantee, not a heuristic
    assert 0 < rt.gap_bound
    assert np.abs(rt.v - ref.v).max() <= rt.gap_bound * 1.01 + 1e-9


def test_async_vi_resumes_from_a_checkpoint(tmp_path):
    """The exchanged window is checkpointed empty and restored as zeros,
    a valid stale window: the resumed solve converges to the policy."""
    chain = tgen.chain_walk(128, gamma=0.95)
    opts = TOpts(method="async_vi", async_sweeps=4, **ASYNC)
    whole = tdriver.solve(chain, opts, device="cpu")
    ck = str(tmp_path / "ck")
    tdriver.solve(chain, TOpts(method="async_vi", async_sweeps=4,
                               atol=1e-6, stop_criterion="span",
                               dtype="float64", max_outer=3),
                  checkpoint_dir=ck, chunk=3, device="cpu")
    again = tdriver.solve(chain, opts, checkpoint_dir=ck, device="cpu")
    assert again.converged
    np.testing.assert_array_equal(again.policy, whole.policy)


def test_async_vi_fleet_lanes_are_single_solves(tmp_path):
    """A fleet's async_vi lanes are their unbatched solves bit for bit,
    and a fleet checkpoint resumes with zero windows."""
    mdps = [tgen.chain_walk(128, gamma=g) for g in (0.9, 0.95)]
    opts = TOpts(method="async_vi", async_sweeps=4, atol=1e-8,
                 dtype="float64", max_outer=5000)
    fleet = tdriver.solve_many(mdps, opts, device="cpu")
    singles = [tdriver.solve(m, opts, device="cpu") for m in mdps]
    for f, s in zip(fleet, singles):
        _same_solve(f, s)
    ck = str(tmp_path / "ck")
    tdriver.solve_many(mdps, TOpts(method="async_vi", async_sweeps=4,
                                   atol=1e-8, dtype="float64", max_outer=3),
                       checkpoint_dir=ck, chunk=3, device="cpu")
    again = tdriver.solve_many(mdps, opts, checkpoint_dir=ck, device="cpu")
    for a, s in zip(again, singles):
        assert a.converged
        np.testing.assert_array_equal(a.policy, s.policy)


@pytest.mark.parametrize("kw,match", [
    (dict(comm_overlap="sometimes"), "comm_overlap"),
    (dict(async_sweeps=0), "async_sweeps"),
    (dict(halo=-1), "halo"),
    (dict(gather_dtype="float64"), "wider than the value dtype"),
    (dict(gather_dtype="int32"), "floating dtype"),
    (dict(overlap_plan=(1,)), "overlap_plan")])
def test_option_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match) as e:
        TOpts(**kw)
    with pytest.raises(ValueError) as je:
        JOpts(**kw)
    if "gather_dtype" not in kw:
        assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="not a dtype"):
        TOpts(gather_dtype="float17")


def test_option_keys_map_onto_ipi_options():
    o = Options({"-halo": 24, "-gather_dtype": "bfloat16",
                 "-comm_overlap": "on", "-async_sweeps": 8,
                 "-method": "async_vi", "-dtype": "float64"})
    assert o.to_ipi() == TOpts(halo=24, gather_dtype="bfloat16",
                               comm_overlap="on", async_sweeps=8,
                               method="async_vi", dtype="float64")
    assert Options({"-layout": "2d"}).get("-layout") == "2d"
