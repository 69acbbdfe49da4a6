"""The torch port's kernels against the JAX reference, bit for bit.

The port's plain versions (``repro_torch.kernels.ref``) must equal both the
reference's pure-jnp oracles (``repro.kernels.ref``) and the Pallas TPU
kernels run in interpret mode, bit for bit: the K-sum order and the two
pinned roundings are the same in all three.  (The CUDA kernels are held
to the plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bellman as jbellman
from repro.core.comm import Axes as JAxes
from repro.core.mdp import EllMDP as JEll
from repro.kernels import bellman_ell as j_bellman_ell
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import spmv_ell as j_spmv_ell
from repro_torch.core import bellman as tbellman
from repro_torch.core.comm import Axes as TAxes
from repro_torch.core.mdp import EllMDP as TEll
from repro_torch.kernels import bellman_ell, build, dense_backup, ops
from repro_torch.kernels import spmv_ell
from repro_torch.kernels import ref as tref

jax.config.update("jax_enable_x64", True)

GAMMA = 0.997


def _tables(n, m, k, v_dtype, seed=0, ties=False):
    """Random ELL tables (f32 val/cost as the containers store them) and a
    value vector of ``v_dtype``.  ``ties`` makes every action of a row
    share one successor row, so Q ties exactly across actions."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, m, k)).astype(np.int32)
    val = rng.random((n, m, k)).astype(np.float32)
    cost = rng.random((n, m)).astype(np.float32)
    if ties:
        idx[:] = idx[:, :1]
        val[:] = val[:, :1]
        cost[:] = cost[:, :1]
        cost[::3, 2:] -= np.float32(0.25)   # a later minimum on some rows
    v = (rng.random(n) * 40.0 - 20.0).astype(v_dtype)
    return idx, val, cost, v


def _bits(x):
    return np.atleast_1d(np.asarray(x)).view(np.uint8)


def _assert_bitequal(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _t(x):
    return torch.from_numpy(np.asarray(x))


SHAPES = [(97, 5, 1), (130, 3, 2), (64, 17, 3), (301, 6, 8)]


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_backup_bitmatches_jax_ref(shape, v_dtype):
    idx, val, cost, v = _tables(*shape, v_dtype)
    want = jax.jit(jref.ell_backup)(idx, val, cost, GAMMA, v)
    got = tref.ell_backup(_t(idx), _t(val), _t(cost), GAMMA, _t(v))
    assert str(got[0].dtype) == f"torch.{np.asarray(want[0]).dtype.name}"
    _assert_bitequal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_backup_bitmatches_pallas_interpret(shape, v_dtype):
    idx, val, cost, v = _tables(*shape, v_dtype, seed=1)
    want = j_bellman_ell.ell_backup(idx, val, cost, GAMMA, v,
                                    interpret=True, tile_n=32, tile_m=4,
                                    tile_v=64)
    got = tref.ell_backup(_t(idx), _t(val), _t(cost), GAMMA, _t(v))
    _assert_bitequal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_plain_matvec_bitmatches_jax_ref_and_pallas(k, v_dtype):
    n = 211
    rng = np.random.default_rng(k)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    val = rng.random((n, k)).astype(np.float32)
    x = (rng.random(n) * 10.0 - 5.0).astype(v_dtype)
    got = tref.ell_matvec(_t(idx), _t(val), _t(x)).numpy()
    _assert_bitequal(got, jax.jit(jref.ell_matvec)(idx, val, x))
    _assert_bitequal(got, j_spmv_ell.ell_matvec(idx, val, x, interpret=True,
                                                tile_n=64, tile_v=50))


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_ell_qvalues_bitmatches_reference_op(shape, v_dtype):
    """``ops.ell_qvalues`` on the CPU is the plain version: bit for bit the
    reference op's pinned XLA path.  The reference's Pallas path leaves its
    ``cost + gamma * pv`` epilogue unpinned, and XLA fuses it into one
    multiply-add, so it skips the rounding of ``gamma * pv``: the two agree
    within one ulp of that product plus one of the result."""
    idx, val, cost, v = _tables(*shape, v_dtype, seed=5)
    got = ops.ell_qvalues(_t(idx), _t(val), _t(cost), GAMMA, _t(v))
    assert got.shape == shape[:2]
    want = jops.ell_qvalues(idx, val, cost, GAMMA, v, impl="xla")
    _assert_bitequal(got.numpy(), want)
    pallas = np.asarray(jops.ell_qvalues(idx, val, cost, GAMMA, v,
                                         impl="pallas_interpret"))
    got = got.numpy()
    assert pallas.dtype == got.dtype
    prod = (GAMMA * tref.ell_gather_dot(_t(idx), _t(val), _t(v))).numpy()
    bound = np.spacing(np.abs(prod)) + np.spacing(np.maximum(np.abs(got),
                                                             np.abs(pallas)))
    assert (np.abs(got - pallas) <= bound).all()


def test_ties_break_to_the_first_minimum():
    for v_dtype in (np.float32, np.float64):
        idx, val, cost, v = _tables(120, 6, 3, v_dtype, ties=True)
        got = tref.ell_backup(_t(idx), _t(val), _t(cost), GAMMA, _t(v))
        want = jax.jit(jref.ell_backup)(idx, val, cost, GAMMA, v)
        _assert_bitequal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        # tied rows pick action 0; the rows with a lower cost tail pick 2
        assert (got[1].numpy()[1::3] == 0).all()
        assert (got[1].numpy()[::3] == 2).all()


@pytest.mark.parametrize("mode", ["mincost", "maxreward"])
@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
def test_bellman_backup_modes_bitmatch_reference(mode, v_dtype):
    """maxreward is the negated backup on negated costs, in both packages."""
    n, m, k = 150, 4, 3
    idx, val, cost, v = _tables(n, m, k, v_dtype, seed=7)
    jm = JEll(idx=jnp.asarray(idx), val=jnp.asarray(val),
              cost=jnp.asarray(cost), gamma=GAMMA, n_global=n, m_global=m)
    tm = TEll.from_numpy(idx, val, cost, GAMMA, n, m, device="cpu")
    want = jbellman.backup(jm, jnp.asarray(v), JAxes(), impl="xla",
                           mode=mode)
    got = tbellman.backup(tm, _t(v), TAxes(), mode=mode)
    _assert_bitequal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if mode == "maxreward":
        neg = tref.ell_backup(tm.idx, tm.val, -tm.cost, GAMMA, -_t(v))
        _assert_bitequal(got[0].numpy(), (-neg[0]).numpy())


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
def test_policy_operators_bitmatch_reference(v_dtype):
    """policy_rows, T_pi, A_pi (with the reference's contracted
    ``x - gamma * y``) and the residual norm, against the jitted reference
    operators."""
    n, m, k = 300, 5, 4
    idx, val, cost, _ = _tables(n, m, k, v_dtype, seed=3)
    jm = JEll(idx=jnp.asarray(idx), val=jnp.asarray(val),
              cost=jnp.asarray(cost), gamma=0.97, n_global=n, m_global=m)
    tm = TEll.from_numpy(idx, val, cost, 0.97, n, m, device="cpu")
    rng = np.random.default_rng(4)
    pi = rng.integers(0, m, n).astype(np.int32)
    x = (rng.random(n) * 30.0).astype(v_dtype)
    rj = jbellman.policy_rows(jm, jnp.asarray(pi), JAxes())
    rt = tbellman.policy_rows(tm, _t(pi), TAxes())
    for f in ("idx", "val", "g"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    for name in ("t_pi", "a_pi_matvec"):
        want = jax.jit(lambda x, fn=getattr(jbellman, name):
                       fn(rj, x, JAxes(), impl="xla"))(x)
        got = getattr(tbellman, name)(rt, _t(x), TAxes())
        _assert_bitequal(got.numpy(), want)
    want = jax.jit(lambda v: jbellman.residual_norm(jm, v, v, JAxes(),
                                                    impl="xla"))(x)
    got = tbellman.residual_norm(tm, _t(x), _t(x), TAxes())
    _assert_bitequal(got.numpy(), want)


def test_cpu_dispatch_uses_plain_versions_and_counts_nothing():
    idx, val, cost, v = _tables(50, 3, 2, np.float64)
    ops.reset_launch_counts()
    got = ops.ell_backup(_t(idx), _t(val), _t(cost), GAMMA, _t(v))
    want = tref.ell_backup(_t(idx), _t(val), _t(cost), GAMMA, _t(v))
    _assert_bitequal(got[0].numpy(), want[0].numpy())
    y = ops.ell_matvec(_t(idx[:, 0]), _t(val[:, 0]), _t(v))
    _assert_bitequal(y.numpy(), tref.ell_matvec(_t(idx[:, 0]),
                                                _t(val[:, 0]), _t(v)).numpy())
    p = torch.rand(50, 3, 50, dtype=torch.float32)
    got = ops.dense_backup(p, _t(cost), GAMMA, _t(v))
    want = tref.dense_backup(p, _t(cost), GAMMA, _t(v))
    _assert_bitequal(got[0].numpy(), want[0].numpy())
    q = ops.ell_qvalues(_t(idx), _t(val), _t(cost), GAMMA, _t(v))
    _assert_bitequal(q.numpy(), tref.ell_qvalues(_t(idx), _t(val), _t(cost),
                                                 GAMMA, _t(v)).numpy())
    assert ops.launch_counts() == {"ell_backup": 0, "ell_matvec": 0,
                                   "dense_backup": 0, "ell_qvalues": 0,
                                   "flash_attention": 0}


def test_kernel_wrappers_refuse_host_tensors():
    """The CUDA wrappers never fall back to the plain version."""
    idx, val, cost, v = _tables(20, 2, 2, np.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bellman_ell.ell_backup(_t(idx), _t(val), _t(cost), GAMMA, _t(v))
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmv_ell.ell_matvec(_t(idx[:, 0]), _t(val[:, 0]), _t(v))
    with pytest.raises(ValueError, match="CUDA tensors"):
        dense_backup.dense_backup(torch.full((20, 2, 20), 0.05), _t(cost),
                                  GAMMA, _t(v))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bellman_ell.ell_qvalues(_t(idx), _t(val), _t(cost), GAMMA, _t(v))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build_all([bellman_ell.SOURCE, spmv_ell.SOURCE,
                         dense_backup.SOURCE])


def test_build_targets_are_keyed_by_source_hash():
    a = build._target(bellman_ell.SOURCE)
    b = build._target(spmv_ell.SOURCE)
    assert a.parent == build.BUILD_DIR and a != b
    assert a.name.startswith("ell_backup-") and a.suffix == ".so"
    assert build._target(bellman_ell.SOURCE) == a


def test_launch_errors_raise():
    build.check(0, "ok")
    with pytest.raises(build.KernelLaunchError, match="CUDA error 9"):
        build.check(9, "ell_backup launch")
