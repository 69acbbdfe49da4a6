"""Whole solves of the torch port against the JAX reference: vi and mpi.

The same generator tables go through ``repro.core.driver.solve`` (kernel
impl ``xla``) and ``repro_torch.core.driver.solve`` on the CPU, over
{garnet, maze2d, sis, chain_walk (gamma=0.99)} x {mincost, maxreward} x
{float32, float64}.

Tolerances and their reasons:

* ``vi`` touches only the backup, whose roundings both packages pin, so
  the whole solve is bit for bit: values, policy, counts and the residual
  trace.
* ``mpi`` adds Richardson sweeps over ``A_pi x = x - gamma * y``, which
  XLA:CPU contracts into one fused multiply-add; the port computes the
  same single rounding (``torch.addcmul``), so policy and counts are exact
  and values are held to the same bound as the Krylov methods:
  ``max(1e-9 |v|_inf, gap bound)`` in float64, ``1e-4 |v|_inf`` in
  float32 (a fusion choice XLA makes differently would move the last
  bits, not the iteration).
"""

import jax
import numpy as np
import pytest

from repro.core import driver as jdriver
from repro.core import generators as jgen
from repro.core.ipi import IPIOptions as JOpts
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core.ipi import IPIOptions as TOpts

jax.config.update("jax_enable_x64", True)

INSTANCES = {
    "garnet": dict(n=97, m=5, k=3, gamma=0.95, seed=1),
    "maze2d": dict(size=9, gamma=0.99),
    "sis": dict(pop=50, n_actions=4, gamma=0.99),
    "chain_walk": dict(n=100, gamma=0.99),
}
ATOL = {"float64": 1e-8, "float32": 1e-4}


def solve_both(family, method, mode, dtype, **extra):
    kw = INSTANCES[family]
    common = dict(method=method, mode=mode, dtype=dtype, atol=ATOL[dtype],
                  max_outer=2000, **extra)
    rj = jdriver.solve(jgen.REGISTRY[family](**kw),
                       JOpts(impl="xla", **common))
    rt = tdriver.solve(tgen.REGISTRY[family](**kw), TOpts(**common),
                       device="cpu")
    assert rj.converged and rt.converged
    return rj, rt


def assert_close(rj, rt, dtype):
    scale = float(np.abs(rj.v).max())
    dv = float(np.abs(rj.v.astype(np.float64) - rt.v).max())
    if dtype == "float64":
        assert dv <= max(1e-9 * scale, rj.gap_bound), (dv, rj.gap_bound)
    else:
        assert dv <= 1e-4 * scale, (dv, scale)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["mincost", "maxreward"])
@pytest.mark.parametrize("family", sorted(INSTANCES))
def test_vi_bit_for_bit(family, mode, dtype):
    rj, rt = solve_both(family, "vi", mode, dtype)
    assert rt.v.dtype == rj.v.dtype
    np.testing.assert_array_equal(rt.v.view(np.uint8), rj.v.view(np.uint8))
    np.testing.assert_array_equal(rt.policy, rj.policy)
    assert rt.policy.dtype == np.int32
    assert (rt.outer_iterations, rt.inner_iterations) == \
        (rj.outer_iterations, rj.inner_iterations)
    np.testing.assert_array_equal(rt.trace_residual.view(np.uint8),
                                  rj.trace_residual.view(np.uint8))
    np.testing.assert_array_equal(rt.trace_inner, rj.trace_inner)
    assert rt.residual == rj.residual and rt.gap_bound == rj.gap_bound


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["mincost", "maxreward"])
@pytest.mark.parametrize("family", sorted(INSTANCES))
def test_mpi_matches_reference(family, mode, dtype):
    rj, rt = solve_both(family, "mpi", mode, dtype)
    np.testing.assert_array_equal(rt.policy, rj.policy)
    assert (rt.outer_iterations, rt.inner_iterations) == \
        (rj.outer_iterations, rj.inner_iterations)
    np.testing.assert_array_equal(rt.trace_inner, rj.trace_inner)
    assert_close(rj, rt, dtype)
