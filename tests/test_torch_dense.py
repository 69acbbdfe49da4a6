"""The torch port's dense-MDP path against the JAX reference.

The same numpy tables go through both packages on the CPU (reference
kernel impl ``xla``).  Tolerances and their reasons:

* The port's dense dot sums in the CUDA kernel's fixed order (32 lane
  partial sums, then a halving tree; ``repro_torch.kernels.ref``); the
  reference leaves its dot to XLA.  So the plain backup agrees with the
  reference's to ``rtol = 2e-5`` in float32 (the JAX package's own
  tolerance for its dense kernel) and ``1e-12`` in float64, with the same
  argmin.  The Pallas kernel computes in float32 whatever ``v`` is (a TPU
  artifact), so it is held to ``2e-5`` in both dtypes.
* ``as_dense`` accumulates duplicate successors in the reference's order:
  bit for bit.
* Whole solves: the backup's last bits differ, so values are held as
  ``tests/test_torch_solve.py`` holds them (``max(1e-9 |v|_inf, gap
  bound)`` in float64, ``1e-4 |v|_inf`` in float32); the policy and the
  outer and inner counts are exact on both instances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bellman as jbellman
from repro.core import driver as jdriver
from repro.core import generators as jgen
from repro.core.comm import Axes as JAxes
from repro.core.ipi import IPIOptions as JOpts
from repro.core.mdp import DenseMDP as JDense
from repro.core.solvers import dense_policy_value as j_policy_value
from repro.kernels import dense_backup as j_dense_backup
from repro.kernels import ref as jref
from repro_torch.api import MDP, Session
from repro_torch.core import bellman as tbellman
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core.comm import Axes as TAxes
from repro_torch.core.ipi import IPIOptions as TOpts
from repro_torch.core.mdp import DenseMDP as TDense
from repro_torch.core.solvers import dense_policy_value
from repro_torch.kernels import ref as tref

jax.config.update("jax_enable_x64", True)

GAMMA = 0.9
SHAPES = [(8, 2, 8), (64, 4, 200), (130, 3, 700), (50, 1, 77), (40, 17, 45)]
RTOL = {np.float32: 2e-5, np.float64: 1e-12}
ATOL = {"float64": 1e-8, "float32": 1e-4}
FAMILIES = {
    "garnet": dict(n=97, m=5, k=3, gamma=0.95, seed=1),
    "maze2d": dict(size=9, gamma=0.99),
    "sis": dict(pop=50, n_actions=4, gamma=0.99),
    "chain_walk": dict(n=100, gamma=0.99),
}


def _tables(n, m, n_cols, v_dtype, seed=2):
    """Row-stochastic float32 ``p``, float32 ``cost`` and a positive ``v``
    of ``v_dtype`` (positive, as in the reference's own dense kernel test,
    so that no Q value cancels to near zero and a relative tolerance
    holds)."""
    rng = np.random.default_rng(seed)
    p = rng.random((n, m, n_cols)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    cost = rng.random((n, m)).astype(np.float32)
    v = (rng.random(n_cols) * 40.0).astype(v_dtype)
    return p, cost, v


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_backup_matches_jax_ref_and_pallas(shape, v_dtype):
    p, cost, v = _tables(*shape, v_dtype)
    got_v, got_pi = tref.dense_backup(_t(p), _t(cost), GAMMA, _t(v))
    assert got_v.dtype == _t(v).dtype and got_pi.dtype == torch.int32
    want_v, want_pi = jax.jit(jref.dense_backup)(p, cost, GAMMA, v)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=RTOL[v_dtype])
    np.testing.assert_array_equal(got_pi.numpy(), np.asarray(want_pi))
    pal_v, pal_pi = j_dense_backup.dense_backup(p, cost, GAMMA, v,
                                                interpret=True)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(pal_v), rtol=2e-5)
    np.testing.assert_array_equal(got_pi.numpy(), np.asarray(pal_pi))


def test_plain_dense_dot_follows_the_lane_order():
    """The order the kernel fixes, written out as scalar loops: lane sums
    over ``c = l (mod 32)`` from +0, then the halving tree."""
    rng = np.random.default_rng(5)
    p = rng.random((3, 2, 75)).astype(np.float32)
    for v_dtype in (np.float32, np.float64):
        v = (rng.random(75) * 8.0 - 4.0).astype(v_dtype)
        got = tref.dense_dot(_t(p), _t(v)).numpy()
        for s in range(3):
            for a in range(2):
                lanes = [v_dtype(0.0)] * 32
                for c in range(75):
                    lanes[c % 32] = v_dtype(lanes[c % 32]
                                            + v_dtype(v_dtype(p[s, a, c])
                                                      * v[c]))
                w = 32
                while w > 1:
                    w //= 2
                    lanes = [v_dtype(lanes[i] + lanes[i + w])
                             for i in range(w)]
                assert got[s, a].tobytes() == lanes[0].tobytes()


def test_ties_break_to_the_first_minimum():
    p, cost, v = _tables(30, 6, 40, np.float64)
    p[:] = p[:, :1]
    cost[:] = cost[:, :1]
    cost[::3, 2:] -= np.float32(0.25)
    _, pi = tref.dense_backup(_t(p), _t(cost), GAMMA, _t(v))
    assert (pi.numpy()[1::3] == 0).all() and (pi.numpy()[::3] == 2).all()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_as_dense_bitmatches_reference(family):
    jd = jgen.REGISTRY[family](**FAMILIES[family]).as_dense()
    td = tgen.REGISTRY[family](**FAMILIES[family]).as_dense()
    want = np.asarray(jd.p)
    assert td.p.dtype == torch.float32 and tuple(td.p.shape) == want.shape
    np.testing.assert_array_equal(td.p.numpy().view(np.uint8),
                                  want.view(np.uint8))
    np.testing.assert_array_equal(td.cost.numpy(), np.asarray(jd.cost))
    assert (td.gamma, td.n_global, td.m_global) == \
        (jd.gamma, jd.n_global, jd.m_global)
    td.validate()


def test_dense_mdp_validates_on_its_device():
    p, cost, _ = _tables(6, 2, 6, np.float32)
    TDense.from_numpy(p, cost, 0.9, 6, 2).validate()
    bad = p.copy()
    bad[4, 1, 0] += 0.5
    with pytest.raises(ValueError, match=r"row \(4, 1\) sums to"):
        TDense.from_numpy(bad, cost, 0.9, 6, 2).validate()
    neg = p.copy()
    neg[0, 0, :2] += np.float32([0.5, -0.5])
    with pytest.raises(ValueError, match=">= 0"):
        TDense.from_numpy(neg, cost, 0.9, 6, 2).validate()
    with pytest.raises(ValueError, match="gamma"):
        TDense.from_numpy(p, cost, 1.0, 6, 2).validate()
    with pytest.raises(ValueError, match="n_global"):
        TDense.from_numpy(p, cost, 0.9, 7, 2).validate()


def _dense_random():
    rng = np.random.default_rng(9)
    n, m = 80, 4
    p = rng.random((n, m, n)) ** 4
    p /= p.sum(-1, keepdims=True)
    return p.astype(np.float32), rng.random((n, m)).astype(np.float32), 0.95


def _garnet_dense():
    d = jgen.garnet(**FAMILIES["garnet"]).as_dense()
    return np.asarray(d.p), np.asarray(d.cost), d.gamma


INSTANCES = {"garnet_dense": _garnet_dense, "dense_random": _dense_random}


@functools.lru_cache(maxsize=None)   # the oracle test reuses a solve
def _solve_both(instance, method, mode, dtype):
    p, cost, gamma = INSTANCES[instance]()
    n, m = cost.shape
    common = dict(method=method, mode=mode, dtype=dtype, atol=ATOL[dtype],
                  max_outer=2000)
    jm = JDense(p=jnp.asarray(p), cost=jnp.asarray(cost), gamma=gamma,
                n_global=n, m_global=m)
    rj = jdriver.solve(jm, JOpts(impl="xla", **common))
    tm = TDense.from_numpy(p, cost, gamma, n, m)
    rt = tdriver.solve(tm, TOpts(**common), device="cpu")
    assert rj.converged and rt.converged
    return rj, rt, tm


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["mincost", "maxreward"])
@pytest.mark.parametrize("method", ["vi", "mpi", "ipi_gmres"])
@pytest.mark.parametrize("instance", sorted(INSTANCES))
def test_dense_solve_matches_reference(instance, method, mode, dtype):
    rj, rt, _ = _solve_both(instance, method, mode, dtype)
    np.testing.assert_array_equal(rt.policy, rj.policy)
    assert (rt.outer_iterations, rt.inner_iterations) == \
        (rj.outer_iterations, rj.inner_iterations)
    np.testing.assert_array_equal(rt.trace_inner, rj.trace_inner)
    assert rt.v.dtype == rj.v.dtype
    scale = float(np.abs(rj.v).max())
    dv = float(np.abs(rj.v.astype(np.float64) - rt.v).max())
    if dtype == "float64":
        assert dv <= max(1e-9 * scale, rj.gap_bound), (dv, rj.gap_bound)
    else:
        assert dv <= 1e-4 * scale, (dv, scale)


@pytest.mark.parametrize("instance", sorted(INSTANCES))
def test_policy_value_oracle_matches_solves(instance):
    """The LU oracle (float32, as the reference's) against the float64
    solve's values and against the reference's oracle."""
    rj, rt, tm = _solve_both(instance, "ipi_gmres", "mincost", "float64")
    v_pi = dense_policy_value(tm, torch.from_numpy(rt.policy))
    assert v_pi.dtype == torch.float32 and v_pi.shape == (tm.n_local,)
    scale = float(np.abs(rt.v).max())
    assert np.abs(v_pi.numpy() - rt.v).max() <= 1e-5 * scale
    jm = JDense(p=jnp.asarray(tm.p.numpy()), cost=jnp.asarray(
        tm.cost.numpy()), gamma=tm.gamma, n_global=tm.n_global,
        m_global=tm.m_global)
    want = np.asarray(j_policy_value(jm, jnp.asarray(rj.policy)))
    assert np.abs(v_pi.numpy() - want).max() <= 1e-5 * scale


def test_policy_value_oracle_on_an_ell_mdp():
    ell = tgen.garnet(n=60, m=3, k=4, gamma=0.9, seed=2)
    r = tdriver.solve(ell, TOpts(method="ipi_gmres", dtype="float64",
                                 atol=1e-10), device="cpu")
    v_pi = dense_policy_value(ell, torch.from_numpy(r.policy))
    assert np.abs(v_pi.numpy() - r.v).max() <= 1e-5 * np.abs(r.v).max()
    with pytest.raises(ValueError, match="unsharded"):
        dense_policy_value(TDense(p=ell.as_dense().p[:30], cost=ell.cost[:30],
                                  gamma=0.9, n_global=60, m_global=3),
                           torch.zeros(30, dtype=torch.int32))


@pytest.mark.parametrize("v_dtype", [torch.float32, torch.float64])
def test_dense_policy_operators_match_reference(v_dtype):
    """policy_rows casts P_pi once to the accumulation dtype; T_pi and
    A_pi then agree with the reference's jitted operators."""
    p, cost, _ = _tables(70, 4, 70, np.float32, seed=3)
    rng = np.random.default_rng(4)
    pi = rng.integers(0, 4, 70).astype(np.int32)
    x = rng.random(70) * 30.0
    jm = JDense(p=jnp.asarray(p), cost=jnp.asarray(cost), gamma=0.97,
                n_global=70, m_global=4)
    tm = TDense.from_numpy(p, cost, 0.97, 70, 4)
    rj = jbellman.policy_rows(jm, jnp.asarray(pi), JAxes())
    rt = tbellman.policy_rows(tm, _t(pi), TAxes(), dtype=v_dtype)
    assert rt.idx is None and rt.p.dtype == v_dtype
    np.testing.assert_array_equal(rt.p.numpy(), np.asarray(rj.p))
    np.testing.assert_array_equal(rt.g.numpy(), np.asarray(rj.g))
    xt = torch.from_numpy(x).to(v_dtype)
    # the products sum in each library's order: a few ulps of |x|_inf
    atol = 8 * torch.finfo(v_dtype).eps * float(xt.abs().max())
    for name in ("t_pi", "a_pi_matvec"):
        want = jax.jit(lambda x, fn=getattr(jbellman, name):
                       fn(rj, x, JAxes(), impl="xla"))(xt.numpy())
        got = getattr(tbellman, name)(rt, xt, TAxes())
        assert got.dtype == v_dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)


def test_from_arrays_dense_through_a_session(tmp_path):
    p, cost, gamma = _dense_random()
    mdp = MDP.from_arrays(p=p.astype(np.float64), cost=cost, gamma=gamma,
                          mode="maxreward")
    core = mdp.build("cpu")
    assert isinstance(core, TDense) and core.p.dtype == torch.float32
    assert (mdp.n, mdp.m) == (80, 4)
    assert repr(mdp).startswith("MDP(DenseMDP, n=80, m=4")
    pol = tmp_path / "pi.npy"
    with Session({"-device": "cpu", "-method": "ipi_gmres",
                  "-dtype": "float64", "-atol": 1e-9,
                  "-file_policy": str(pol)}) as s:
        r = s.solve(mdp)
        r_core = s.solve(core, mode="maxreward")
    want = tdriver.solve(TDense.from_numpy(p, cost, gamma, 80, 4),
                         TOpts(method="ipi_gmres", dtype="float64",
                               atol=1e-9, mode="maxreward"), device="cpu")
    assert r.converged and s.stats[0]["solves"][0]["n"] == 80
    np.testing.assert_array_equal(r.v, want.v)
    np.testing.assert_array_equal(r_core.v, want.v)
    np.testing.assert_array_equal(np.load(pol), want.policy)
    with pytest.raises(ValueError, match="not both"):
        MDP.from_arrays(p=p, idx=np.zeros((80, 4, 1), np.int32),
                        cost=cost)
    bad = p.copy()
    bad[3, 2] *= 2
    with pytest.raises(ValueError, match=r"row \(3, 2\) sums to"):
        MDP.from_arrays(p=bad, cost=cost)
    with pytest.raises(ValueError, match="idx\\+val \\(ELL\\) or p"):
        MDP.from_arrays(cost=cost)
