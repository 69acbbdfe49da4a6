"""The torch port on the card: CUDA kernels against their plain versions.

Every case needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a GPU machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
"""

import numpy as np
import pytest
import torch

from repro_torch.core import driver, generators
from repro_torch.core.ipi import IPIOptions
from repro_torch.kernels import bellman_ell, dense_backup, ops, ref
from repro_torch.kernels import spmv_ell

GAMMA = 0.997
SHAPES = [(97, 5, 1), (130, 3, 2), (64, 17, 3), (301, 6, 8)]
# (n, m, n_cols): n_cols below, between and above the kernel's 32-lane and
# 256-column steps, none but 256 a multiple of them; m = 1 and m = 17
DENSE_SHAPES = [(8, 2, 8), (64, 1, 200), (40, 17, 45), (130, 3, 700),
                (33, 4, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _tables(n, m, k, v_dtype, device, seed=11):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, n, (n, m, k)).astype(np.int32))
    val = torch.from_numpy(rng.random((n, m, k)).astype(np.float32))
    cost = torch.from_numpy(rng.random((n, m)).astype(np.float32))
    v = torch.from_numpy((rng.random(n) * 40.0 - 20.0).astype(v_dtype))
    return tuple(t.to(device) for t in (idx, val, cost, v))


def _bitequal(a: torch.Tensor, b: torch.Tensor) -> bool:
    ints = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_kernels_bitmatch_plain_versions(cuda, shape, v_dtype):
    idx, val, cost, v = _tables(*shape, v_dtype, cuda)
    before = ops.launch_counts()
    got = bellman_ell.ell_backup(idx, val, cost, GAMMA, v)
    want = ref.ell_backup(idx, val, cost, GAMMA, v)
    assert _bitequal(got[0], want[0]) and torch.equal(got[1], want[1])
    rows_i, rows_v = idx[:, 0].contiguous(), val[:, 0].contiguous()
    y = spmv_ell.ell_matvec(rows_i, rows_v, v)
    assert _bitequal(y, ref.ell_matvec(rows_i, rows_v, v))
    after = ops.launch_counts()
    assert after["ell_backup"] == before["ell_backup"] + 1
    assert after["ell_matvec"] == before["ell_matvec"] + 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    idx, val, cost, v = _tables(40, 3, 2, np.float64, cuda)
    with pytest.raises(ValueError, match="int32 idx"):
        bellman_ell.ell_backup(idx.long(), val, cost, GAMMA, v)
    with pytest.raises(ValueError, match="contiguous"):
        bellman_ell.ell_backup(idx, val, cost.t().contiguous().t(), GAMMA, v)
    with pytest.raises(ValueError, match="is on"):
        bellman_ell.ell_backup(idx, val.cpu(), cost, GAMMA, v)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_ell.ell_matvec(idx[:, 0], val[:, 0], v)
    with pytest.raises(ValueError, match="float32/float64"):
        spmv_ell.ell_matvec(idx[:, 0].contiguous(), val[:, 0].contiguous(),
                            v.half())


def _dense_tables(n, m, n_cols, v_dtype, device, seed=13):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.random((n, m, n_cols)).astype(np.float32))
    cost = torch.from_numpy(rng.random((n, m)).astype(np.float32))
    v = torch.from_numpy((rng.random(n_cols) * 40.0 - 20.0).astype(v_dtype))
    return tuple(t.to(device) for t in (p, cost, v))


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", DENSE_SHAPES,
                         ids=[str(s) for s in DENSE_SHAPES])
def test_dense_kernel_bitmatches_plain_version(cuda, shape, v_dtype):
    p, cost, v = _dense_tables(*shape, v_dtype, cuda)
    before = ops.launch_counts()["dense_backup"]
    got = dense_backup.dense_backup(p, cost, GAMMA, v)
    want = ref.dense_backup(p, cost, GAMMA, v)
    torch.cuda.synchronize()
    assert _bitequal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int32
    assert ops.launch_counts()["dense_backup"] == before + 1


def test_dense_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    p, cost, v = _dense_tables(20, 3, 40, np.float64, cuda)
    with pytest.raises(ValueError, match="float32 p/cost"):
        dense_backup.dense_backup(p.double(), cost, GAMMA, v)
    with pytest.raises(ValueError, match="contiguous"):
        dense_backup.dense_backup(p.transpose(0, 1).contiguous()
                                  .transpose(0, 1), cost, GAMMA, v)
    with pytest.raises(ValueError, match="is on"):
        dense_backup.dense_backup(p, cost.cpu(), GAMMA, v)
    with pytest.raises(ValueError, match="shapes"):
        dense_backup.dense_backup(p, cost, GAMMA, v[:30].contiguous())
    with pytest.raises(ValueError, match="float32/float64"):
        dense_backup.dense_backup(p, cost, GAMMA, v.half())


@pytest.mark.parametrize("method", ["vi", "mpi", "ipi_gmres"])
def test_dense_gpu_solve_matches_cpu_solve(cuda, method):
    mdp = generators.garnet(n=600, m=5, k=6, gamma=0.95, seed=8).as_dense()
    opts = IPIOptions(method=method, mode="maxreward", dtype="float64",
                      atol=1e-8)
    before = ops.launch_counts()
    rg = driver.solve(mdp, opts, device=cuda)
    rc = driver.solve(mdp, opts, device="cpu")
    after = ops.launch_counts()
    assert after["dense_backup"] > before["dense_backup"]
    assert after["ell_backup"] == before["ell_backup"]
    np.testing.assert_array_equal(rg.policy, rc.policy)
    assert (rg.outer_iterations, rg.inner_iterations) == \
        (rc.outer_iterations, rc.inner_iterations)
    # vi touches only the backup kernel, bitwise equal to its plain
    # version; mpi and GMRES add dense products that cuBLAS and the CPU
    # library sum in other orders
    if method == "vi":
        np.testing.assert_array_equal(rg.v, rc.v)
    else:
        assert np.abs(rg.v - rc.v).max() <= max(
            1e-10 * np.abs(rc.v).max(), rc.gap_bound)


@pytest.mark.parametrize("method", ["vi", "mpi", "ipi_gmres"])
def test_gpu_solve_matches_cpu_solve(cuda, method):
    mdp = generators.garnet(n=2000, m=6, k=4, gamma=0.95, seed=5)
    opts = IPIOptions(method=method, mode="maxreward", dtype="float64",
                      atol=1e-8)
    before = ops.launch_counts()
    rg = driver.solve(mdp, opts, device=cuda)
    rc = driver.solve(mdp, opts, device="cpu")
    assert ops.launch_counts()["ell_backup"] > before["ell_backup"]
    np.testing.assert_array_equal(rg.policy, rc.policy)
    assert (rg.outer_iterations, rg.inner_iterations) == \
        (rc.outer_iterations, rc.inner_iterations)
    # vi touches only the backup kernel, which equals its plain version
    # bit for bit; the Krylov dot products reduce in another order on the
    # card, so the other methods agree to the certificate's scale
    if method == "vi":
        np.testing.assert_array_equal(rg.v, rc.v)
    else:
        assert np.abs(rg.v - rc.v).max() <= max(
            1e-10 * np.abs(rc.v).max(), rc.gap_bound)
