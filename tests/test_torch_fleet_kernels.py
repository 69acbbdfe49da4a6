"""Fleets at the kernel and operator level: the batched plain versions,
the fleet containers and the batched Bellman operators of the torch port,
against the JAX reference and against the port's own unbatched forms.

* Every batched plain version (``ell_backup``, ``ell_matvec``,
  ``ell_qvalues``, ``dense_backup``) is the unbatched plain version lane
  by lane, bit for bit, for a shared or a batched ``idx`` / ``v`` and a
  float or a ``(B,)`` gamma, in float32 and float64.
* Against the reference's batched ``ops.*`` (``impl="xla"``; its lane axis
  is a ``vmap`` and its gamma one float): the ELL results bit for bit, as
  the unbatched tests hold them; the dense backup to the unbatched dense
  tolerance (the reference's dot sums in XLA's order).
* ``stack_mdps`` builds the reference's tables bit for bit (padding,
  shared topology, gammas) and raises its errors.
* The batched Bellman operators equal the unbatched ones lane by lane.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import generators as jgen
from repro.core import mdp as jmdp
from repro.kernels import ops as jops
from repro_torch.core import bellman as tbellman
from repro_torch.core import generators as tgen
from repro_torch.core import mdp as tmdp
from repro_torch.core.comm import Axes
from repro_torch.kernels import bellman_ell, dense_backup, ops, spmv_ell
from repro_torch.kernels import ref as tref

jax.config.update("jax_enable_x64", True)

B, GAMMA = 3, 0.997
GAMMAS = (0.9, 0.95, 0.997)
DENSE_RTOL = {np.float32: 2e-5, np.float64: 1e-12}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bitequal(got, want):
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _ell(n, m, k, v_dtype, shared_idx, shared_v, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, m, k) if shared_idx else (B, n, m, k))
    val = rng.random((B, n, m, k)).astype(np.float32)
    cost = rng.random((B, n, m)).astype(np.float32)
    v = (rng.random(n if shared_v else (B, n)) * 40.0 - 20.0)
    return idx.astype(np.int32), val, cost, v.astype(v_dtype)


def _gamma(kind, v_dtype):
    """The kernels' gamma operand: one float, or a (B,) tensor in the
    accumulation dtype."""
    if kind == "float":
        return GAMMA
    return torch.tensor(GAMMAS, dtype=torch.from_numpy(
        np.zeros(1, v_dtype)).dtype)


def _lane_gamma(gamma, b):
    return GAMMA if not isinstance(gamma, torch.Tensor) else GAMMAS[b]


def _lane(x, b, dims):
    return x[b] if x.ndim == dims else x


CASES = [(dt, si, sv, g) for dt in (np.float32, np.float64)
         for si in (True, False) for sv in (True, False)
         for g in ("float", "lanes")]
IDS = [f"{np.dtype(dt).name}-{'shared' if si else 'batched'}_idx-"
       f"{'shared' if sv else 'batched'}_v-{g}_gamma"
       for dt, si, sv, g in CASES]


@pytest.mark.parametrize("v_dtype, shared_idx, shared_v, gamma_kind", CASES,
                         ids=IDS)
def test_batched_plain_backup_and_qvalues(v_dtype, shared_idx, shared_v,
                                          gamma_kind):
    idx, val, cost, v = _ell(61, 5, 3, v_dtype, shared_idx, shared_v)
    gamma = _gamma(gamma_kind, v_dtype)
    tv, pi = tref.ell_backup(_t(idx), _t(val), _t(cost), gamma, _t(v))
    q = tref.ell_qvalues(_t(idx), _t(val), _t(cost), gamma, _t(v))
    assert tv.shape == (B, 61) and pi.dtype == torch.int32
    # the CPU dispatch is the plain version
    got = ops.ell_backup(_t(idx), _t(val), _t(cost), gamma, _t(v))
    _bitequal(got[0].numpy(), tv.numpy())
    _bitequal(ops.ell_qvalues(_t(idx), _t(val), _t(cost), gamma,
                              _t(v)).numpy(), q.numpy())
    for b in range(B):
        li, lv = _t(_lane(idx, b, 4)), _t(_lane(v, b, 2))
        g = _lane_gamma(gamma, b)
        want = tref.ell_backup(li, _t(val[b]), _t(cost[b]), g, lv)
        _bitequal(tv[b].numpy(), want[0].numpy())
        np.testing.assert_array_equal(pi[b].numpy(), want[1].numpy())
        _bitequal(q[b].numpy(), tref.ell_qvalues(li, _t(val[b]), _t(cost[b]),
                                                 g, lv).numpy())
    if gamma_kind == "float":
        # the reference's lane axis: vmap over the same op, one gamma
        jv, jpi = jops.ell_backup(idx, val, cost, GAMMA, v, impl="xla")
        _bitequal(tv.numpy(), jv)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
        _bitequal(q.numpy(), jops.ell_qvalues(idx, val, cost, GAMMA, v,
                                              impl="xla"))
    else:
        for b in range(B):
            jv, jpi = jops.ell_backup(_lane(idx, b, 4), val[b], cost[b],
                                      GAMMAS[b], _lane(v, b, 2), impl="xla")
            _bitequal(tv[b].numpy(), jv)
            np.testing.assert_array_equal(pi[b].numpy(), np.asarray(jpi))


MV_CASES = [(dt, si, sx) for dt in (np.float32, np.float64)
            for si in (True, False) for sx in (True, False)]


@pytest.mark.parametrize("v_dtype, shared_idx, shared_x", MV_CASES,
                         ids=[f"{np.dtype(d).name}-{si}-{sx}"
                              for d, si, sx in MV_CASES])
def test_batched_plain_matvec(v_dtype, shared_idx, shared_x):
    idx, val, _, x = _ell(77, 1, 8, v_dtype, shared_idx, shared_x, seed=3)
    idx, val = idx[..., 0, :], val[:, :, 0, :]
    y = tref.ell_matvec(_t(idx), _t(val), _t(x))
    _bitequal(ops.ell_matvec(_t(idx), _t(val), _t(x)).numpy(), y.numpy())
    for b in range(B):
        _bitequal(y[b].numpy(), tref.ell_matvec(
            _t(_lane(idx, b, 3)), _t(val[b]), _t(_lane(x, b, 2))).numpy())
    _bitequal(y.numpy(), jops.ell_matvec(idx, val, x, impl="xla"))


DENSE_CASES = [(dt, sv, g) for dt in (np.float32, np.float64)
               for sv in (True, False) for g in ("float", "lanes")]


@pytest.mark.parametrize("v_dtype, shared_v, gamma_kind", DENSE_CASES,
                         ids=[f"{np.dtype(d).name}-{sv}-{g}"
                              for d, sv, g in DENSE_CASES])
def test_batched_plain_dense_backup(v_dtype, shared_v, gamma_kind):
    rng = np.random.default_rng(2)
    n, m, n_cols = 40, 4, 70
    p = rng.random((B, n, m, n_cols)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    cost = rng.random((B, n, m)).astype(np.float32)
    v = (rng.random(n_cols if shared_v else (B, n_cols)) * 40.0) \
        .astype(v_dtype)
    gamma = _gamma(gamma_kind, v_dtype)
    tv, pi = tref.dense_backup(_t(p), _t(cost), gamma, _t(v))
    got = ops.dense_backup(_t(p), _t(cost), gamma, _t(v))
    _bitequal(got[0].numpy(), tv.numpy())
    for b in range(B):
        want = tref.dense_backup(_t(p[b]), _t(cost[b]),
                                 _lane_gamma(gamma, b), _t(_lane(v, b, 2)))
        _bitequal(tv[b].numpy(), want[0].numpy())
        np.testing.assert_array_equal(pi[b].numpy(), want[1].numpy())
        jv, jpi = jops.dense_backup(p[b], cost[b], _lane_gamma(gamma, b),
                                    _lane(v, b, 2), impl="xla")
        np.testing.assert_allclose(tv[b].numpy(), np.asarray(jv),
                                   rtol=DENSE_RTOL[v_dtype])
        np.testing.assert_array_equal(pi[b].numpy(), np.asarray(jpi))
    if gamma_kind == "float":
        jv, jpi = jops.dense_backup(p, cost, GAMMA, v, impl="xla")
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   rtol=DENSE_RTOL[v_dtype])
        np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))


def test_batched_cpu_dispatch_counts_nothing_and_wrappers_refuse_host():
    idx, val, cost, v = _ell(20, 2, 2, np.float64, False, False)
    ops.reset_launch_counts()
    ops.ell_backup(_t(idx), _t(val), _t(cost), GAMMA, _t(v))
    ops.ell_matvec(_t(idx[:, :, 0]), _t(val[:, :, 0]), _t(v))
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        bellman_ell.ell_backup(_t(idx), _t(val), _t(cost), GAMMA, _t(v))
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmv_ell.ell_matvec(_t(idx[:, :, 0]), _t(val[:, :, 0]), _t(v))
    with pytest.raises(ValueError, match="CUDA tensors"):
        dense_backup.dense_backup(torch.full((B, 20, 2, 20), 0.05),
                                  _t(cost), GAMMA, _t(v))


# --------------------------------------------------------------------------- #
# Containers                                                                  #
# --------------------------------------------------------------------------- #

def _both(family, **kw):
    return (jgen.REGISTRY[family](**kw), tgen.REGISTRY[family](**kw))


def _same_tables(j, t):
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    _bitequal(t.val.numpy(), np.asarray(j.val))
    _bitequal(t.cost.numpy(), np.asarray(j.cost))
    assert (t.gamma, t.n_global, t.m_global, t.batch, t.shared_topology) \
        == (j.gamma, j.n_global, j.m_global, j.batch, j.shared_topology)


@pytest.mark.parametrize("fleet", ["seeds", "gamma_sweep", "ragged"])
def test_stack_mdps_builds_the_reference_tables(fleet):
    if fleet == "seeds":
        kws = [dict(n=50, m=4, k=3, gamma=0.95, seed=s) for s in range(3)]
    elif fleet == "gamma_sweep":
        kws = [dict(n=50, m=4, k=3, gamma=g, seed=1) for g in GAMMAS]
    else:
        kws = [dict(n=n, m=4, k=3, gamma=0.95, seed=s)
               for s, n in enumerate((30, 50, 41))]
    pairs = [_both("garnet", **kw) for kw in kws]
    js = jmdp.stack_mdps([j for j, _ in pairs])
    ts = tmdp.stack_mdps([t for _, t in pairs])
    _same_tables(js, ts)
    assert ts.shared_topology == (fleet == "gamma_sweep")
    ts.validate()
    for b, (_, t) in enumerate(pairs):
        inst = ts.instance(b)
        assert inst.gamma == t.gamma
        n = t.n_global
        np.testing.assert_array_equal(inst.idx[:n].numpy(), t.idx.numpy())
        _bitequal(inst.val[:n].numpy(), t.val.numpy())
    gt = tmdp.batch_parts(ts, torch.float32)
    if fleet == "gamma_sweep":
        assert gt.dtype == torch.float32
        _bitequal(gt.numpy(), np.asarray(GAMMAS, np.float32))
        assert tmdp.gammas_of(ts) == GAMMAS
    else:
        assert gt is None and tmdp.gammas_of(ts) == (0.95,) * 3


def test_stack_mdps_dense_and_errors():
    ells = [tgen.garnet(n=20, m=3, k=2, gamma=0.9, seed=s) for s in (0, 1)]
    dense = [e.as_dense() for e in ells]
    jd = jmdp.stack_mdps([jgen.garnet(n=20, m=3, k=2, gamma=0.9,
                                      seed=s).as_dense() for s in (0, 1)])
    td = tmdp.stack_mdps(dense)
    assert td.batch == 2 and not td.shared_topology
    _bitequal(td.p.numpy(), np.asarray(jd.p))
    td.validate()
    _bitequal(td.instance(1).p.numpy(), dense[1].p.numpy())
    with pytest.raises(ValueError, match="as_dense"):
        tmdp.stack_mdps(ells).as_dense()
    bad = [
        ([], "at least one"),
        ([ells[0], dense[0]], "container"),
        ([tmdp.stack_mdps(ells)], "unbatched"),
        ([ells[0], tgen.garnet(n=20, m=4, k=2)], "action counts"),
        ([ells[0], tgen.garnet(n=20, m=3, k=3)], "nnz"),
        ([dense[0], tgen.garnet(n=25, m=3, k=2).as_dense()], "state counts"),
    ]
    for mdps, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tmdp.stack_mdps(mdps)
    with pytest.raises(TypeError, match="queue 1 item 11"):
        tmdp.stack_mdps([ells[0], object()])
    with pytest.raises(ValueError, match="batched MDP"):
        tmdp.batch_parts(ells[0], torch.float64)
    with pytest.raises(ValueError, match="instance"):
        ells[0].instance(0)
    broken = tmdp.stack_mdps(ells)
    broken.val[1, 0, 0, 0] += 0.5
    with pytest.raises(ValueError, match="sums to"):
        broken.validate()


def test_generate_many_matches_the_reference():
    for kw in (dict(n=40, m=3, k=2, seed=10),
               dict(n=40, m=3, k=2, sweep={"gamma": list(GAMMAS)})):
        js = jgen.generate_many("garnet", 3, **kw)
        ts = tgen.generate_many("garnet", 3, **kw)
        for j, t in zip(js, ts):
            _same_tables(j, t)
    sw = tgen.generate_many("chain_walk", 3, n=40,
                            sweep={"gamma": [0.9, 0.99, 0.999]})
    assert [m.gamma for m in sw] == [0.9, 0.99, 0.999]
    with pytest.raises(ValueError, match="sweep"):
        tgen.generate_many("garnet", 3, n=50, m=3, k=2,
                           sweep={"gamma": [0.9]})
    with pytest.raises(ValueError, match="batch"):
        tgen.generate_many("garnet", 0, n=50, m=3, k=2)


# --------------------------------------------------------------------------- #
# Batched Bellman operators                                                   #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mode", ["mincost", "maxreward"])
@pytest.mark.parametrize("fleet", ["seeds", "gamma_sweep"])
@pytest.mark.parametrize("v_dtype", [torch.float32, torch.float64])
def test_fleet_operators_equal_the_unbatched_lanes(fleet, mode, v_dtype):
    """backup / residual / policy rows / b_pi / A_pi / T_pi on a stacked
    fleet are the unbatched operators lane by lane, bit for bit."""
    if fleet == "seeds":
        mdps = [tgen.garnet(n=45, m=4, k=3, gamma=0.95, seed=s)
                for s in range(B)]
    else:
        mdps = [tgen.garnet(n=45, m=4, k=3, gamma=g, seed=2) for g in GAMMAS]
    st = tmdp.stack_mdps(mdps)
    gamma_t = tmdp.batch_parts(st, v_dtype)
    axes = Axes()
    rng = np.random.default_rng(7)
    v = torch.from_numpy(rng.random((B, 45)) * 10.0).to(v_dtype)
    tv, pi = tbellman.backup(st, v, axes, mode=mode, gamma_t=gamma_t)
    res = tbellman.residual_norm(st, v, v, axes, mode=mode, gamma_t=gamma_t)
    rows = tbellman.policy_rows(st, pi, axes, dtype=v_dtype, gamma_t=gamma_t)
    x = torch.from_numpy(rng.random((B, 45))).to(v_dtype)
    ax = tbellman.a_pi_matvec(rows, x, axes)
    tx = tbellman.t_pi(rows, x, axes)
    for b, m in enumerate(mdps):
        want_tv, want_pi = tbellman.backup(m, v[b], axes, mode=mode)
        _bitequal(tv[b].numpy(), want_tv.numpy())
        np.testing.assert_array_equal(pi[b].numpy(), want_pi.numpy())
        _bitequal(res[b].numpy(), tbellman.residual_norm(
            m, v[b], v[b], axes, mode=mode).numpy())
        want_rows = tbellman.policy_rows(m, want_pi, axes, dtype=v_dtype)
        np.testing.assert_array_equal(rows.idx[b].numpy(),
                                      want_rows.idx.numpy())
        _bitequal(rows.val[b].numpy(), want_rows.val.numpy())
        _bitequal(tbellman.b_pi(rows, axes)[b].numpy(),
                  tbellman.b_pi(want_rows, axes).numpy())
        _bitequal(ax[b].numpy(),
                  tbellman.a_pi_matvec(want_rows, x[b], axes).numpy())
        _bitequal(tx[b].numpy(), tbellman.t_pi(want_rows, x[b], axes).numpy())
        lane = rows.lane(b, m.gamma)
        _bitequal(tbellman.a_pi_matvec(lane, x[b], axes).numpy(),
                  ax[b].numpy())


def test_dense_fleet_policy_matvec_is_a_batched_product():
    """Dense fleet rows: the policy rows bit for bit, the batched product
    (``torch.bmm``) within rounding of the unbatched ``torch.mv``."""
    mdps = [tgen.garnet(n=30, m=3, k=3, gamma=0.9, seed=s).as_dense()
            for s in range(B)]
    st = tmdp.stack_mdps(mdps)
    axes = Axes()
    v = torch.rand(B, 30, dtype=torch.float64)
    tv, pi = tbellman.backup(st, v, axes)
    rows = tbellman.policy_rows(st, pi, axes, dtype=torch.float64)
    ax = tbellman.a_pi_matvec(rows, v, axes)
    for b, m in enumerate(mdps):
        want_tv, want_pi = tbellman.backup(m, v[b], axes)
        _bitequal(tv[b].numpy(), want_tv.numpy())
        want_rows = tbellman.policy_rows(m, want_pi, axes,
                                         dtype=torch.float64)
        _bitequal(rows.p[b].numpy(), want_rows.p.numpy())
        np.testing.assert_allclose(
            ax[b].numpy(), tbellman.a_pi_matvec(want_rows, v[b], axes)
            .numpy(), rtol=1e-13, atol=1e-15)
