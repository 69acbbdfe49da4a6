"""The torch port on the card: CUDA kernels against their plain versions.

Every case needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a GPU machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import driver, generators
from repro_torch.core.ipi import IPIOptions
from repro_torch.kernels import bellman_ell, dense_backup, lanes, ops, ref
from repro_torch.kernels import flash_attention, spmv_ell, tuning
from repro_torch.models import DecoderLM, WhisperModel, build_model
from repro_torch.train.steps import make_decode_step, make_prefill_step

GAMMA = 0.997
SHAPES = [(97, 5, 1), (130, 3, 2), (64, 17, 3), (301, 6, 8)]
# (n, m, K): K with and without the 16-byte load path (K % 4 == 0), m
# below, at and above the actions a warp holds at once; n = 301 is no
# multiple of the states or rows any block takes
ELL_SHAPES = SHAPES + [(301, m, k) for k in (1, 2, 3, 4, 5, 8, 12)
                       for m in (1, 5, 16, 17)]
# (n, m, n_cols): n_cols below, between and above the kernel's 32-lane and
# 256-column steps, none but 256 a multiple of them; m = 1 and m = 17
DENSE_SHAPES = [(8, 2, 8), (64, 1, 200), (40, 17, 45), (130, 3, 700),
                (33, 4, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _isolated_tuner(tmp_path):
    """Every case tunes into a file of its own, never the user's cache."""
    prev = (tuning.enabled(), tuning.cache_path())
    tuning.reset(cache_path=str(tmp_path / "autotune.json"))
    yield
    tuning.reset(cache_path=prev[1])
    tuning.configure(enabled=prev[0])


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


def _bitequal_or_both_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, except that a NaN equals a NaN in the same place (the
    payload bits of a NaN are not part of the contract)."""
    ints = {4: torch.int32, 8: torch.int64}[a.element_size()]
    same = (a.view(ints) == b.view(ints)) | (torch.isnan(a) & torch.isnan(b))
    return a.dtype == b.dtype and a.shape == b.shape and bool(same.all())


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary: a row-slice view of a larger buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", ELL_SHAPES, ids=[str(s) for s in ELL_SHAPES])
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


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m, k", [(17, 3), (17, 8), (5, 2)])
def test_ell_kernels_read_misaligned_views(cuda, m, k, v_dtype):
    """Tables that start 4 bytes past a 16-byte boundary take the 4-byte
    load path (the launchers pick it from the pointers); at K = 8 the
    aligned tables take the 16-byte one.  K = 2 and 3 give a row one
    lane.  All equal the plain versions bit for bit."""
    idx, val, cost, v = _tables(301, m, k, v_dtype, cuda)
    assert (idx.data_ptr() | val.data_ptr()) % 16 == 0
    mi, mv = _misaligned(idx), _misaligned(val)
    want = ref.ell_backup(idx, val, cost, GAMMA, v)
    for i, w in ((idx, val), (mi, val), (idx, mv), (mi, mv)):
        got = bellman_ell.ell_backup(i, w, cost, GAMMA, v)
        assert _bitequal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert _bitequal(ops.ell_qvalues(i, w, cost, GAMMA, v),
                         ref.ell_qvalues(idx, val, cost, GAMMA, v))
    rows_i, rows_v = _misaligned(idx[:, 0]), _misaligned(val[:, 0])
    assert _bitequal(spmv_ell.ell_matvec(rows_i, rows_v, v),
                     ref.ell_matvec(rows_i, rows_v, v))


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("k", [8, 3, 2])
def test_ell_kernels_on_ties_and_non_finite_values(cuda, k, aligned,
                                                   v_dtype):
    """Duplicated action columns tie exactly: the first action must win.
    A NaN and an inf in cost and in v: min and argmin as the plain
    version's strict-< scan in action order gives them (a NaN Q at action
    0 stays the minimum, a later one is passed over).  K = 8 spreads a
    row over lanes, K = 3 and 2 give it one lane."""
    idx, val, cost, v = _tables(301, 6, k, v_dtype, cuda)
    for dup, src in ((3, 1), (4, 0), (5, 3)):
        idx[:, dup], val[:, dup], cost[:, dup] = idx[:, src], val[:, src], \
            cost[:, src]
    cost[::4, 1] -= 0.5          # ties at the minimum on some rows
    cost[::4, 3] -= 0.5
    cost[7, 0] = cost[8, 2] = float("nan")
    cost[9, 1], cost[10, 0] = float("inf"), -float("inf")
    v[3], v[4], v[5] = float("nan"), float("inf"), -float("inf")
    if not aligned:
        idx, val = _misaligned(idx), _misaligned(val)
    got = bellman_ell.ell_backup(idx, val, cost, GAMMA, v)
    want = ref.ell_backup(idx, val, cost, GAMMA, v)
    assert torch.isnan(want[0]).any() and torch.isinf(want[0]).any()
    assert (want[1][::4] == 1).any()      # a tie that the first index won
    assert _bitequal_or_both_nan(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert _bitequal_or_both_nan(ops.ell_qvalues(idx, val, cost, GAMMA, v),
                                 ref.ell_qvalues(idx, val, cost, GAMMA, v))
    rows_i, rows_v = idx[:, 0].contiguous(), val[:, 0].contiguous()
    assert _bitequal_or_both_nan(spmv_ell.ell_matvec(rows_i, rows_v, v),
                                 ref.ell_matvec(rows_i, rows_v, v))


def test_ell_kernels_past_2_31_table_slots(cuda):
    """n = 2^24 + 3, m = 16, K = 8: 2.15e9 slots (17.2 GB of idx + val),
    tables drawn on the card from a seeded generator.  The last 4,096
    states of the backup, and their rows of the SpMV over the (n*m, K)
    rows (ell_qvalues' product), against the plain version."""
    n, m, k, tail = 2 ** 24 + 3, 16, 8, 4096
    gen = torch.Generator(device=cuda).manual_seed(15)
    idx = torch.randint(0, n, (n, m, k), generator=gen, device=cuda,
                        dtype=torch.int32)
    val = torch.rand((n, m, k), generator=gen, device=cuda)
    cost = torch.rand((n, m), generator=gen, device=cuda)
    assert idx.numel() > 2 ** 31
    for dt in (torch.float32, torch.float64):
        v = (torch.rand(n, generator=gen, device=cuda, dtype=torch.float64)
             * 40.0 - 20.0).to(dt)
        got_v, got_pi = bellman_ell.ell_backup(idx, val, cost, GAMMA, v)
        want_v, want_pi = ref.ell_backup(idx[-tail:], val[-tail:],
                                         cost[-tail:], GAMMA, v)
        assert _bitequal(got_v[-tail:], want_v)
        assert torch.equal(got_pi[-tail:], want_pi)
        rows_i, rows_v = idx.view(n * m, k), val.view(n * m, k)
        y = spmv_ell.ell_matvec(rows_i, rows_v, v)
        assert _bitequal(y[-tail * m:], ref.ell_matvec(rows_i[-tail * m:],
                                                       rows_v[-tail * m:], v))
        del got_v, got_pi, y


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


@pytest.mark.parametrize("method", ["vi", "mpi", "ipi_gmres"])
def test_outer_step_on_the_card_is_the_solve(cuda, method):
    """``outer_step`` from ``init_state`` until the lane stops: the card's
    ``driver.solve`` bit for bit (values, policy, counts, residual trace)
    with the same kernel launches."""
    from repro_torch.core import ipi
    from repro_torch.core.comm import Axes
    from repro_torch.core.mdp import as_fleet

    mdp = generators.garnet(n=3000, m=6, k=4, gamma=0.95, seed=7)
    opts = IPIOptions(method=method, dtype="float64", atol=1e-8)
    ops.reset_launch_counts()
    want = driver.solve(mdp, opts, device=cuda)
    solve_launches = ops.launch_counts()
    dev, axes = as_fleet(mdp.to(cuda)), Axes()
    ops.reset_launch_counts()
    state = ipi.init_state(dev, axes, opts)
    stop, _, _, k = ipi.stop_flags(state, axes)
    while not stop.all() and k.max() < opts.max_outer:
        # the step's own read gives the flags: one read a step
        state, (stop, _, _, k) = ipi.outer_step(dev, state, opts, axes,
                                               with_flags=True)
    assert ops.launch_counts() == solve_launches
    assert solve_launches["ell_backup"] > want.outer_iterations
    assert bool(state.done[0]) and want.converged
    assert (int(state.k[0]), int(state.inner_total[0])) == \
        (want.outer_iterations, want.inner_iterations)
    np.testing.assert_array_equal(state.v[0].cpu().numpy().view(np.int64),
                                  want.v.view(np.int64))
    np.testing.assert_array_equal(state.pi[0].cpu().numpy(), want.policy)
    np.testing.assert_array_equal(
        state.trace_res[0, :want.outer_iterations + 1].cpu().numpy()
        .view(np.int64), want.trace_residual.view(np.int64))


# the other KSPs, their preconditioners and deterministic GMRES
NEW_PATHS = {"bicgstab": dict(method="ipi_bicgstab"),
             "bicgstab_jacobi": dict(method="ipi_bicgstab",
                                     pc_type="jacobi"),
             "bicgstab_bjacobi": dict(method="ipi_bicgstab",
                                      pc_type="bjacobi"),
             "chebyshev": dict(method="ipi_chebyshev"),
             "anderson": dict(method="ipi_anderson"),
             "gmres_deterministic": dict(method="ipi_gmres",
                                         deterministic_dots=True),
             "gmres_jacobi": dict(method="ipi_gmres", pc_type="jacobi"),
             "gmres_bjacobi": dict(method="ipi_gmres", pc_type="bjacobi")}


@pytest.mark.parametrize("path", sorted(NEW_PATHS))
def test_new_ksp_gpu_solve_matches_cpu_solve(cuda, path):
    """Each new path launches both ELL kernels and gives the CPU's policy
    and counts; values agree to the certificate's scale (the dots and the
    tile inverses reduce in other orders on the card)."""
    mdp = generators.garnet(n=2000, m=6, k=4, gamma=0.95, seed=5)
    opts = IPIOptions(mode="maxreward", dtype="float64", atol=1e-8,
                      **NEW_PATHS[path])
    before = ops.launch_counts()
    rg = driver.solve(mdp, opts, device=cuda)
    after = ops.launch_counts()
    rc = driver.solve(mdp, opts, device="cpu")
    assert rg.converged and rc.converged
    assert after["ell_backup"] > before["ell_backup"]
    assert after["ell_matvec"] > before["ell_matvec"]
    np.testing.assert_array_equal(rg.policy, rc.policy)
    assert (rg.outer_iterations, rg.inner_iterations) == \
        (rc.outer_iterations, rc.inner_iterations)
    assert np.abs(rg.v - rc.v).max() <= max(1e-10 * np.abs(rc.v).max(),
                                            rc.gap_bound)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("block", [32, 7])
def test_bjacobi_build_on_the_card_is_reproducible(cuda, block, dtype):
    """Two block-Jacobi builds on the card are bit for bit equal (the
    strip accumulates one K slot at a time: no colliding atomics), and
    equal to the CPU build within ``4 kappa`` float32 ulps of ``|M x|``
    (``kappa`` the largest tile condition number: the two inversions
    round differently, and an inverse moves by about kappa ulps)."""
    from repro_torch.core import bellman
    from repro_torch.core.comm import Axes
    from repro_torch.core.solvers import build_precond

    mdp = generators.chain_walk(n=1000, gamma=0.99)
    pi = torch.from_numpy(np.random.default_rng(3).integers(
        0, mdp.m_local, mdp.n_local).astype(np.int32))
    x = torch.from_numpy(np.random.default_rng(4).random(mdp.n_local)) \
        .to(dtype)

    def apply(device):
        m = mdp.to(device)
        rows = bellman.policy_rows(m, pi.to(device), Axes(), dtype=dtype)
        M = build_precond(rows, axes=Axes(), n_local=m.n_local,
                          gamma=m.gamma, pc_type="bjacobi", block=block,
                          dtype=dtype)
        return M(x.to(device))

    g1, g2, c = apply(cuda), apply(cuda), apply("cpu")
    assert _bitequal(g1, g2)
    # the largest tile condition number, from the policy's dense rows
    b, n = block, mdp.n_local
    nb = -(-n // b)
    strip = torch.zeros((nb * b, b), dtype=torch.float64)
    dense = mdp.as_dense().p[torch.arange(n), pi.long()].double()
    for i in range(n):
        lo = (i // b) * b
        hi = min(lo + b, n)
        strip[i, :hi - lo] = dense[i, lo:hi]
    tiles = torch.eye(b, dtype=torch.float64) - 0.99 * strip.view(nb, b, b)
    kappa = float(torch.linalg.cond(tiles).max())
    scale = float(torch.abs(c).max())
    eps32 = float(np.finfo(np.float32).eps)
    assert float(torch.max(torch.abs(g1.cpu() - c))) <= \
        4 * kappa * eps32 * scale


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", ELL_SHAPES, ids=[str(s) for s in ELL_SHAPES])
def test_ell_qvalues_bitmatches_plain_version(cuda, shape, v_dtype):
    idx, val, cost, v = _tables(*shape, v_dtype, cuda)
    before = ops.launch_counts()
    got = ops.ell_qvalues(idx, val, cost, GAMMA, v)
    want = ref.ell_qvalues(idx, val, cost, GAMMA, v)
    torch.cuda.synchronize()
    assert got.shape == shape[:2] and _bitequal(got, want)
    after = ops.launch_counts()
    assert after["ell_qvalues"] == before["ell_qvalues"] + 1
    assert after["ell_matvec"] == before["ell_matvec"]


# (B, T, S, H, KV, d): MHA / GQA / MQA, T and S ragged against the kernels'
# 64-row (f32) and 192-row (bf16) query blocks and 64-key tiles, d below,
# at and between their 16-column steps
FLASH_SHAPES = [(1, 64, 64, 4, 4, 16), (2, 96, 96, 8, 2, 64),
                (1, 130, 130, 6, 1, 80), (2, 200, 200, 4, 2, 128),
                (1, 33, 100, 4, 4, 64), (1, 1, 1, 2, 1, 16),
                (2, 70, 150, 8, 1, 128)]


def flash_within_tolerance(got: torch.Tensor, want: torch.Tensor) -> bool:
    """f32: 2e-5 abs + rel (the same online softmax in other summation
    orders).  bf16: one bf16 ulp of the larger value (2^-7 relative; both
    round an f32 result that differs in its last bits) plus 1e-5."""
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        return bool(((g - w).abs() <= 2e-5 + 2e-5 * w.abs()).all())
    return bool(((g - w).abs()
                 <= 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=[str(s) for s in FLASH_SHAPES])
def test_flash_kernel_matches_plain_version(cuda, shape, causal, dtype):
    b, t, s, h, kv, d = shape
    gen = torch.Generator(device=cuda).manual_seed(t * s + d)
    q, k, v = (torch.randn(shp, generator=gen, device=cuda).to(dtype)
               for shp in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d)))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, t, h, d)
    assert flash_within_tolerance(got, want)
    assert ops.launch_counts()["flash_attention"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_flash_kernel_reads_strided_inputs(cuda, offset, dtype):
    """q/k/v as views into fused projections (no contiguous copies).  With
    ``offset=1`` the views start one element into their buffer and rows
    are 513 elements apart: no row is 16-byte aligned, so the bf16 kernel
    stages them with element loads instead of 16-byte copies."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    buf = torch.randn(2, 90, (4 + 2 + 2) * 64 + offset, generator=gen,
                      device=cuda).to(dtype)
    qkv = buf[:, :, offset:].unflatten(2, (8, 64))
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = flash_attention.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert flash_within_tolerance(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 300, 300, 8, 2, 80),
                                   (1, 77, 333, 4, 4, 80),
                                   (1, 200, 45, 2, 1, 80)],
                         ids=str)
def test_flash_kernel_bf16_head_dim_80_ragged(cuda, shape, causal):
    """stablelm-3b's head dim (five 16-column steps) with T and S no
    multiple of the bf16 kernel's 192-row query blocks (64 rows a
    warpgroup) or 64-key tiles, T below, equal to and above S."""
    b, t, s, h, kv, d = shape
    gen = torch.Generator(device=cuda).manual_seed(t + s)
    q, k, v = (torch.randn(shp, generator=gen, device=cuda).bfloat16()
               for shp in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d)))
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == (b, t, h, d) and got.dtype == torch.bfloat16
    assert flash_within_tolerance(got, want)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 8, 4, 64, device=cuda)
    kv = torch.randn(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="multiple of"):
        flash_attention.flash_attention(q, kv[:, :, :1].expand(1, 8, 3, 64),
                                        kv[:, :, :1].expand(1, 8, 3, 64))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(
            torch.randn(1, 8, 2, 160, device=cuda),
            torch.randn(1, 8, 2, 160, device=cuda),
            torch.randn(1, 8, 2, 160, device=cuda))
    with pytest.raises(ValueError, match="contiguous in its head dim"):
        flash_attention.flash_attention(q, kv, kv.transpose(1, 3)
                                        .contiguous().transpose(1, 3))
    with pytest.raises(ValueError, match="is on"):
        flash_attention.flash_attention(q, kv.cpu(), kv)


@pytest.mark.parametrize("arch", ["minitron-8b", "granite-34b"])
def test_smoke_lm_on_the_card_matches_the_host(cuda, arch):
    """Same weights (drawn on the host) on both devices, float32: prefill
    and decode logits within 1e-4 of the largest |logit| (cuBLAS and the
    host BLAS, the flash kernel and its plain version, sum in other
    orders), greedy tokens equal, one flash launch per layer in prefill
    and none in decode."""
    cfg = get_smoke_config(arch)
    host = build_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    card = DecoderLM(cfg, device=cuda)
    card.load_state_dict(host.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (3, 45),
                         generator=torch.Generator().manual_seed(1))
    runs = {}
    for name, model in (("host", host), ("card", card)):
        dev = model.embed.device
        prefill, decode = make_prefill_step(model), make_decode_step(model)
        ops.reset_launch_counts()
        logits, cache = prefill(toks.to(dev))
        n_prefill = ops.launch_counts()["flash_attention"]
        cache = model.extend_cache(cache, 6)
        tok, out, steps = torch.argmax(logits, -1), [], [logits]
        for _ in range(6):
            out.append(tok)
            tok, logits, cache = decode(tok, cache)
            steps.append(logits)
        n_decode = ops.launch_counts()["flash_attention"] - n_prefill
        runs[name] = (torch.cat(out, 1).cpu(), [x.cpu() for x in steps],
                      n_prefill, n_decode)
    assert runs["host"][2:] == (0, 0)
    assert runs["card"][2:] == (cfg.n_layers, 0)
    assert torch.equal(runs["card"][0], runs["host"][0])
    for got, want in zip(runs["card"][1], runs["host"][1]):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


# the other families' prefill layouts (B, T, S, H, KV, d, causal), T and S
# cut: olmoe (MHA, d 128), zamba2's shared block (d 64), llava and arctic
# (GQA group 7), whisper's encoder (non-causal over its 1500 frames, no
# multiple of any tile) and decoder
FAMILY_FLASH = [(1, 257, 257, 16, 16, 128, True),
                (1, 200, 200, 32, 32, 64, True),
                (1, 333, 333, 56, 8, 128, True),
                (1, 1500, 1500, 8, 8, 64, False),
                (2, 77, 77, 8, 8, 64, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FAMILY_FLASH, ids=str)
def test_flash_kernel_at_the_families_layouts(cuda, shape, dtype):
    b, t, s, h, kv, d, causal = shape
    gen = torch.Generator(device=cuda).manual_seed(h * d + t)
    q, k, v = (torch.randn(shp, generator=gen, device=cuda).to(dtype)
               for shp in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d)))
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == (b, t, h, d) and got.dtype == dtype
    assert flash_within_tolerance(got, want)


def _attention_layers(cfg) -> int:
    """Flash launches of one prefill: one per attention layer (the hybrid's
    shared block once a call site; whisper's encoder and decoder)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "encdec":
        return cfg.encoder_layers + cfg.n_layers
    return cfg.n_layers


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b", "mamba2-130m",
                                  "zamba2-1.2b", "llava-next-34b",
                                  "whisper-base"])
def test_smoke_family_on_the_card_matches_the_host(cuda, arch):
    """As the dense case above, for the other families: the same weights
    and inputs (patches / frames) on both devices, float32, prefill and
    four greedy decode steps."""
    cfg = get_smoke_config(arch)
    host = build_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    card = (WhisperModel if cfg.family == "encdec" else DecoderLM)(
        cfg, device=cuda)
    card.load_state_dict(host.state_dict())
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (3, 45), generator=gen)
    n = {"vlm": cfg.n_patches, "encdec": cfg.encoder_len}.get(cfg.family)
    extra = None if n is None else torch.randn((3, n, cfg.d_model),
                                               generator=gen)
    runs = {}
    for name, model in (("host", host), ("card", card)):
        dev = model.embed.device
        prefill, decode = make_prefill_step(model), make_decode_step(model)
        ops.reset_launch_counts()
        logits, cache = prefill(toks.to(dev),
                                None if extra is None else extra.to(dev))
        n_prefill = ops.launch_counts()["flash_attention"]
        cache = model.extend_cache(cache, 4)
        tok, out, steps = torch.argmax(logits, -1), [], [logits]
        for _ in range(4):
            out.append(tok)
            tok, logits, cache = decode(tok, cache)
            steps.append(logits)
        n_decode = ops.launch_counts()["flash_attention"] - n_prefill
        runs[name] = (torch.cat(out, 1).cpu(), [x.cpu() for x in steps],
                      n_prefill, n_decode)
    assert runs["host"][2:] == (0, 0)
    assert runs["card"][2:] == (_attention_layers(cfg), 0)
    assert torch.equal(runs["card"][0], runs["host"][0])
    for got, want in zip(runs["card"][1], runs["host"][1]):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


# --------------------------------------------------------------------------- #
# Fleets: the kernels' lane axis                                              #
# --------------------------------------------------------------------------- #

FLEET_B = 3
FLEET_GAMMAS = (0.9, 0.95, 0.997)
LANE_CASES = [(dt, si, sv, g, order) for dt in (np.float32, np.float64)
              for si in (True, False) for sv in (True, False)
              for g in ("float", "lanes") for order in ("fastest", "slowest")]


def _fleet_tables(n, m, k, v_dtype, device, shared_idx, shared_v, seed=13):
    rng = np.random.default_rng(seed)
    b = FLEET_B
    idx = rng.integers(0, n, (n, m, k) if shared_idx else (b, n, m, k))
    val = rng.random((b, n, m, k)).astype(np.float32)
    cost = rng.random((b, n, m)).astype(np.float32)
    v = (rng.random(n if shared_v else (b, n)) * 40.0 - 20.0).astype(v_dtype)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (idx.astype(np.int32), val, cost, v))


def _fleet_gamma(kind, dtype, device):
    if kind == "float":
        return GAMMA
    return torch.tensor(FLEET_GAMMAS, dtype=dtype, device=device)


@pytest.mark.parametrize("v_dtype, shared_idx, shared_v, gamma, order",
                         LANE_CASES)
@pytest.mark.parametrize("shape", [(301, 5, 8), (130, 17, 3)],
                         ids=["k8", "k3"])
def test_lane_axis_bitmatches_plain_versions_and_lanes(
        cuda, shape, v_dtype, shared_idx, shared_v, gamma, order):
    """One launch for the fleet, in either grid order: bit for bit the
    batched plain version and, lane by lane, the unbatched kernel."""
    idx, val, cost, v = _fleet_tables(*shape, v_dtype, cuda, shared_idx,
                                      shared_v)
    g = _fleet_gamma(gamma, v.dtype, cuda)
    before = ops.launch_counts()
    tv, pi = bellman_ell.ell_backup(idx, val, cost, g, v, lane_order=order)
    q = bellman_ell.ell_qvalues(idx, val, cost, g, v, lane_order=order)
    rows_i = idx[..., 0, :].contiguous()
    if rows_i.dim() == 2:
        rows_i = rows_i.expand(FLEET_B, -1, -1).contiguous()
    rows_v = val[:, :, 0].contiguous()
    y = spmv_ell.ell_matvec(rows_i, rows_v, v, lane_order=order)
    after = ops.launch_counts()
    assert after["ell_backup"] == before["ell_backup"] + 1
    assert after["ell_qvalues"] == before["ell_qvalues"] + 1
    assert after["ell_matvec"] == before["ell_matvec"] + 1
    want = ref.ell_backup(idx, val, cost, g, v)
    assert _bitequal(tv, want[0]) and torch.equal(pi, want[1])
    assert _bitequal(q, ref.ell_qvalues(idx, val, cost, g, v))
    assert _bitequal(y, ref.ell_matvec(rows_i, rows_v, v))
    for b in range(FLEET_B):
        li = idx if shared_idx else idx[b]
        lv = v if shared_v else v[b]
        lg = g if gamma == "float" else FLEET_GAMMAS[b]
        one = bellman_ell.ell_backup(li, val[b], cost[b], lg, lv)
        assert _bitequal(tv[b], one[0]) and torch.equal(pi[b], one[1])
        assert _bitequal(y[b], spmv_ell.ell_matvec(rows_i[b], rows_v[b], lv))


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [4, 3])
def test_lane_axis_reads_misaligned_fleet_tables(cuda, k, v_dtype):
    """Fleet tables whose base starts 4 bytes past a 16-byte boundary put
    every lane off it: the launcher takes the 4-byte path for the whole
    fleet (K = 4 aligned takes the 16-byte one), bit for bit either way."""
    idx, val, cost, v = _fleet_tables(33, 2, k, v_dtype, cuda, False, False)
    want = ref.ell_backup(idx, val, cost, GAMMA, v)
    for i, w in ((idx, val), (_misaligned(idx), val),
                 (_misaligned(idx), _misaligned(val))):
        got = bellman_ell.ell_backup(i, w, cost, GAMMA, v)
        assert _bitequal(got[0], want[0]) and torch.equal(got[1], want[1])
    rows_i, rows_v = idx[:, :, 0].contiguous(), val[:, :, 0].contiguous()
    got = spmv_ell.ell_matvec(_misaligned(rows_i), _misaligned(rows_v), v)
    assert _bitequal(got, ref.ell_matvec(rows_i, rows_v, v))


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("gamma", ["float", "lanes"])
@pytest.mark.parametrize("shared_v", [True, False])
def test_dense_lane_axis_bitmatches_plain_versions(cuda, v_dtype, gamma,
                                                   shared_v):
    rng = np.random.default_rng(3)
    n, m, n_cols = 40, 3, 300
    p = torch.from_numpy(rng.random((FLEET_B, n, m, n_cols))
                         .astype(np.float32)).to(cuda)
    cost = torch.from_numpy(rng.random((FLEET_B, n, m))
                            .astype(np.float32)).to(cuda)
    v = torch.from_numpy((rng.random(n_cols if shared_v
                                     else (FLEET_B, n_cols)) * 9.0)
                         .astype(v_dtype)).to(cuda)
    g = _fleet_gamma(gamma, v.dtype, cuda)
    tv, pi = dense_backup.dense_backup(p, cost, g, v)
    want = ref.dense_backup(p, cost, g, v)
    assert _bitequal(tv, want[0]) and torch.equal(pi, want[1])
    for b in range(FLEET_B):
        one = dense_backup.dense_backup(
            p[b], cost[b], GAMMA if gamma == "float" else FLEET_GAMMAS[b],
            v if shared_v else v[b])
        assert _bitequal(tv[b], one[0]) and torch.equal(pi[b], one[1])


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
def test_lane_axis_reads_strided_vector_lanes(cuda, v_dtype):
    """A fleet's vector may be a view with contiguous rows at any lane
    stride (GMRES hands the SpMV its basis column ``V[:, j]``): the
    kernels read it through their lane stride, bit for bit."""
    idx, val, cost, _ = _fleet_tables(200, 4, 8, v_dtype, cuda, False,
                                      False)
    basis = torch.from_numpy(np.random.default_rng(4).random(
        (FLEET_B, 5, 200)).astype(v_dtype)).to(cuda)
    x = basis[:, 3]
    assert not x.is_contiguous() and x.stride() == (1000, 1)
    rows_i, rows_v = idx[:, :, 1].contiguous(), val[:, :, 1].contiguous()
    assert _bitequal(spmv_ell.ell_matvec(rows_i, rows_v, x),
                     ref.ell_matvec(rows_i, rows_v, x.contiguous()))
    got = bellman_ell.ell_backup(idx, val, cost, GAMMA, x)
    want = ref.ell_backup(idx, val, cost, GAMMA, x.contiguous())
    assert _bitequal(got[0], want[0]) and torch.equal(got[1], want[1])
    p = torch.rand(FLEET_B, 7, 3, 200, device=cuda)
    got = dense_backup.dense_backup(p, cost[:, :7, :3].contiguous(), GAMMA,
                                    x)
    want = ref.dense_backup(p, cost[:, :7, :3].contiguous(), GAMMA,
                            x.contiguous())
    assert _bitequal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_lane_wrappers_reject_what_the_kernels_do_not_take(cuda):
    idx, val, cost, v = _fleet_tables(50, 3, 4, np.float32, cuda, False,
                                      False)
    with pytest.raises(ValueError, match="lanes"):
        bellman_ell.ell_backup(idx, val, cost,
                               torch.tensor([0.9, 0.9], device=cuda), v)
    with pytest.raises(ValueError, match="B lanes"):
        bellman_ell.ell_backup(idx, val, cost, GAMMA, v[:2])
    with pytest.raises(ValueError, match="shapes"):
        bellman_ell.ell_backup(idx[:2], val, cost, GAMMA, v)
    with pytest.raises(ValueError, match="lane order"):
        bellman_ell.ell_backup(idx, val, cost, GAMMA, v, lane_order="x")
    with pytest.raises(ValueError, match="contiguous rows"):
        spmv_ell.ell_matvec(idx[:, :, 0].contiguous(),
                            val[:, :, 0].contiguous(), v.t().contiguous().t())


@pytest.mark.parametrize("method", ["vi", "mpi", "ipi_gmres",
                                    "ipi_bicgstab", "ipi_chebyshev"])
def test_gpu_fleet_matches_cpu_fleet_with_one_launch_a_step(cuda, method):
    """A gamma sweep on the card: one launch of each kernel per step for
    the fleet, the CPU fleet's policies and counts; vi / mpi lanes bit for
    bit the card's unbatched solves."""
    mdps = [generators.garnet(n=1500, m=5, k=4, gamma=g, seed=6)
            for g in (0.9, 0.95, 0.99)]
    opts = IPIOptions(method=method, dtype="float64", atol=1e-8)
    ops.reset_launch_counts()
    rg = driver.solve_many(mdps, opts, device=cuda)
    fleet_launches = ops.launch_counts()
    rc = driver.solve_many(mdps, opts, device="cpu")
    ops.reset_launch_counts()
    singles = [driver.solve(m, opts, device=cuda) for m in mdps]
    single_launches = ops.launch_counts()
    assert fleet_launches["ell_backup"] < single_launches["ell_backup"]
    if method == "ipi_chebyshev":
        # no batched form: each lane's own solve, its own launches
        assert fleet_launches["ell_matvec"] == single_launches["ell_matvec"]
    elif method != "vi":
        assert 0 < fleet_launches["ell_matvec"] < \
            single_launches["ell_matvec"]
    for g, c, s in zip(rg, rc, singles):
        np.testing.assert_array_equal(g.policy, c.policy)
        assert (g.outer_iterations, g.inner_iterations) == \
            (c.outer_iterations, c.inner_iterations)
        if method in ("vi", "mpi", "ipi_chebyshev"):
            np.testing.assert_array_equal(g.v, s.v)
        else:
            assert np.abs(g.v - c.v).max() <= max(
                1e-10 * np.abs(c.v).max(), c.gap_bound)


# --------------------------------------------------------------------------- #
# Sharded solves on the card (torch.distributed over NCCL)                    #
# --------------------------------------------------------------------------- #

@pytest.fixture
def nccl_world1(cuda):
    """A process group of one rank on NCCL in this process, torn down
    after the test."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as lm
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    lm.init_distributed("cuda", store=dist.HashStore(), rank=0,
                        world_size=1)
    try:
        yield lm
    finally:
        lm.shutdown()


def _same_bits(a, b):
    return (np.array_equal(a.v.view(np.uint64), b.v.view(np.uint64))
            and np.array_equal(a.policy, b.policy)
            and (a.outer_iterations, a.inner_iterations)
            == (b.outer_iterations, b.inner_iterations))


@pytest.mark.parametrize("layout", ["1d", "2d"])
@pytest.mark.parametrize("dense", [False, True])
def test_world1_nccl_solve_is_the_single_solve(nccl_world1, layout, dense):
    """World size 1 runs every collective through NCCL: the sharded solve
    is bit for bit the single-device one, and the kernels launch."""
    mdp = generators.garnet(n=3001, m=7, k=5, gamma=0.99, seed=3)
    if dense:
        mdp = mdp.as_dense()
    opts = IPIOptions(method="ipi_gmres", dtype="float64", atol=1e-9)
    single = driver.solve(mdp, opts, device="cuda")
    mesh = nccl_world1.make_host_mesh((1, 1), device="cuda")
    ops.reset_launch_counts()
    r = driver.solve(mdp, opts, mesh=mesh, layout=layout, device="cuda")
    counts = ops.launch_counts()
    assert r.converged and _same_bits(r, single)
    assert counts["dense_backup" if dense else "ell_backup"] > 0


@pytest.mark.parametrize("method", ["vi", "ipi_gmres", "async_vi"])
def test_halo_solve_is_the_all_gather_solve_on_the_card(nccl_world1,
                                                        method):
    maze = generators.maze2d(size=40, gamma=0.99)
    common = dict(method=method, dtype="float64", atol=1e-8,
                  max_outer=20 if method == "ipi_gmres" else 5000)
    base = driver.solve(maze, IPIOptions(**common), device="cuda")
    halo = driver.solve(maze, IPIOptions(halo=40, **common), device="cuda")
    assert _same_bits(halo, base)
    mesh = nccl_world1.make_host_mesh((1, 1), device="cuda")
    for extra in (dict(halo=40), dict(comm_overlap="on")):
        r = driver.solve(maze, IPIOptions(**extra, **common), mesh=mesh,
                         layout="1d", device="cuda")
        assert _same_bits(r, base)


def test_multi_card_ranks_match_the_single_solve(cuda):
    """Over every card (``torchrun`` of chip_smoke's phase 3m (d) at a
    small size): 1d / 2d give the single solve's policy and counts, the
    maze trajectories are bitwise across halo and overlap."""
    import subprocess
    import sys
    from pathlib import Path
    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        pytest.skip("needs two or more CUDA devices (one rank a card)")
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n_dev), str(root / "chip_smoke.py"),
         "--ranks", "cuda", "20000", "60"], capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"[phase3m] (d) world={n_dev}" in proc.stdout


# --------------------------------------------------------------------------- #
# Function-backed MDPs and the matrix-free operator on the card               #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name, kw", [
    ("garnet", dict(n=5000, m=6, k=8, gamma=0.99, seed=2)),
    ("sis", dict(pop=4999, n_actions=5, gamma=0.99)),
    ("maze2d", dict(size=70, gamma=0.99))])
def test_constructors_on_the_card_give_the_host_tables(cuda, name, kw):
    """The device pipeline on the card builds the host's tables bit for
    bit (the constructors' integer hashing and float32 arithmetic are
    the same IEEE operations on both)."""
    from repro_torch.api import MDP
    mdp = MDP.from_generator(name, deferred=True, **kw)
    card, host = mdp.build(cuda), mdp.build("cpu")
    for f in ("idx", "val", "cost"):
        assert _bitequal(getattr(card, f).cpu(), getattr(host, f)), f


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
def test_matrix_free_chunk_kernel_bitmatches_plain_version(cuda, v_dtype):
    """The tile body on rebuilt garnet chunks: the kernel, one launch a
    chunk, equals the plain version and the backup of the stored table."""
    from repro_torch.api import MDP
    from repro_torch.kernels import matrix_free
    mdp = MDP.from_generator("garnet", deferred=True, n=3000, m=7, k=8,
                             seed=4)
    spec = mdp._row_spec()
    v = torch.from_numpy((np.random.default_rng(5).random(3000) * 40 - 20)
                         .astype(v_dtype)).to(cuda)
    rows = torch.arange(1000, 1777, dtype=torch.int32, device=cuda)
    idx, val, cost, _ = matrix_free.build_rows_block(spec, rows,
                                                     tuple(range(7)),
                                                     "mincost")
    ops.reset_launch_counts()
    got = ops.ell_backup_chunk(idx, val, cost, GAMMA, v)
    assert ops.launch_counts()["ell_backup"] == 1
    want = ref.ell_backup(idx.cpu(), val.cpu(), cost.cpu(), GAMMA, v.cpu())
    assert _bitequal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    ops.reset_launch_counts()
    tiled = matrix_free.mf_backup(spec, 0, 3000, tuple(range(7)), GAMMA, v,
                                  block_rows=1024)
    assert ops.launch_counts()["ell_backup"] == 3
    table = mdp.build(cuda)
    whole = ops.ell_backup(table.idx, table.val, table.cost, GAMMA, v)
    assert _bitequal(tiled[0], whole[0]) and torch.equal(tiled[1], whole[1])


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("order", ["fastest", "slowest"])
def test_fleet_backup_on_shared_tables(cuda, v_dtype, order):
    """A matrix-free fleet's launch: every table shared, v ``(B, n)``, a
    per-lane gamma or one — lane b is the unbatched kernel on v[b]."""
    idx, val, cost, _ = _tables(301, 6, 8, v_dtype, cuda)
    v = torch.from_numpy((np.random.default_rng(9).random((3, 301)) * 40
                          - 20).astype(v_dtype)).to(cuda)
    dt = torch.float64 if v_dtype == np.float64 else torch.float32
    for gamma in (GAMMA, torch.tensor(FLEET_GAMMAS, dtype=dt, device=cuda)):
        got = bellman_ell.ell_backup(idx, val, cost, gamma, v,
                                     lane_order=order)
        want = ref.ell_backup(idx.cpu(), val.cpu(), cost.cpu(),
                              gamma.cpu() if isinstance(gamma, torch.Tensor)
                              else gamma, v.cpu())
        assert _bitequal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        for b in range(3):
            g = gamma[b] if isinstance(gamma, torch.Tensor) else gamma
            one = bellman_ell.ell_backup(idx, val, cost, float(g),
                                         v[b].contiguous())
            assert _bitequal(got[0][b], one[0])


@pytest.mark.parametrize("method", ["vi", "mpi", "ipi_gmres"])
def test_matrix_free_solve_on_the_card_is_the_materialized_solve(cuda,
                                                                 method):
    """Bit for bit the device-materialized solve on the card, both ELL
    kernels launched (the backup once a chunk); a gamma sweep of the
    operator bit for bit its lanes' solo solves, one launch a chunk for
    the fleet."""
    from repro_torch.api import MDP
    from repro_torch.kernels import matrix_free
    mdp = MDP.from_generator("garnet", deferred=True, n=20_000, m=6, k=8,
                             gamma=0.99, seed=1)
    # vi: the trajectory over 60 outer steps (it converges in ~2,000)
    opts = IPIOptions(method=method, dtype="float64", atol=1e-8,
                      max_outer=60 if method == "vi" else 500)
    ops.reset_launch_counts()
    mat = driver.solve(mdp.build(cuda), opts, device=cuda)
    n_mat = ops.launch_counts()
    mf_core = mdp.build(cuda, materialize="matrix_free")
    ops.reset_launch_counts()
    mf = driver.solve(mf_core, opts, device=cuda)
    n_mf = ops.launch_counts()
    assert (mf.converged or method == "vi") and _same_bits(mf, mat)
    chunks = -(-20_000 // matrix_free.chunk_rows(mf_core.spec, 6))
    assert n_mf["ell_backup"] == n_mat["ell_backup"] * chunks
    assert n_mf["ell_matvec"] == n_mat["ell_matvec"]
    if method != "mpi":
        return
    gammas = (0.9, 0.95, 0.99)
    cores = [MDP.from_generator("garnet", deferred=True, n=20_000, m=6,
                                k=8, gamma=g, seed=1).build(
        cuda, materialize="matrix_free") for g in gammas]
    ops.reset_launch_counts()
    fleet = driver.solve_many(cores, opts, device=cuda)
    n_fleet = ops.launch_counts()["ell_backup"]
    solo = [driver.solve(c, opts, device=cuda) for c in cores]
    assert all(_same_bits(f, s) for f, s in zip(fleet, solo))
    assert n_fleet % chunks == 0 and n_fleet < 3 * n_mf["ell_backup"]


@pytest.mark.parametrize("layout", ["fleet", "fleet2d"])
def test_fleet_layout_on_the_card_is_the_mesh_less_fleet(cuda, layout):
    """A fleet of host garnets under a fleet layout on a world of one rank
    (NCCL, in this process): the rank stacks its lanes into page-locked
    memory and copies them to the card; every lane bit for bit the
    mesh-less fleet, with the same kernel launches."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as lm
    mdps = [generators.garnet(n=n, m=6, k=4, gamma=0.97, seed=s)
            for s, n in enumerate((300, 257, 300))]
    opts = IPIOptions(method="ipi_gmres", dtype="float64", atol=1e-9)
    ops.reset_launch_counts()
    base = driver.solve_many(mdps, opts, device="cuda")
    want = ops.launch_counts()
    lm.init_distributed("cuda", store=dist.HashStore(), rank=0,
                        world_size=1)
    try:
        mesh = lm.make_fleet_mesh(1, layout=layout, device="cuda")
        ops.reset_launch_counts()
        got = driver.solve_many(mdps, opts, mesh=mesh, layout=layout,
                                device="cuda")
        assert ops.launch_counts() == want
    finally:
        lm.shutdown()
    for g, w in zip(got, base):
        assert np.array_equal(g.v.view(np.uint64), w.v.view(np.uint64))
        assert np.array_equal(g.policy, w.policy)
        assert (g.outer_iterations, g.inner_iterations) == \
            (w.outer_iterations, w.inner_iterations)


# --------------------------------------------------------------------------- #
# Launch shapes and the tuner                                                 #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES + [(301, 16, 8), (301, 40, 12)],
                         ids=str)
def test_every_cta_size_bitmatches_plain_versions(cuda, shape, v_dtype):
    """Each CTA size of the ELL kernels and of the dense one: bit for bit
    the plain version."""
    idx, val, cost, v = _tables(*shape, v_dtype, cuda)
    want = ref.ell_backup(idx, val, cost, GAMMA, v)
    rows_i, rows_v = idx[:, 0].contiguous(), val[:, 0].contiguous()
    want_y = ref.ell_matvec(rows_i, rows_v, v)
    want_q = ref.ell_qvalues(idx, val, cost, GAMMA, v)
    for t in lanes.THREADS:
        got = bellman_ell.ell_backup(idx, val, cost, GAMMA, v, threads=t)
        assert _bitequal(got[0], want[0]) and torch.equal(got[1], want[1])
        y = spmv_ell.ell_matvec(rows_i, rows_v, v, threads=t)
        assert _bitequal(y, want_y)
        q = bellman_ell.ell_qvalues(idx, val, cost, GAMMA, v, threads=t)
        assert _bitequal(q, want_q)
    n, m, _ = shape
    p, dcost, dv = _dense_tables(n, m, 3 * n + 7, v_dtype, cuda)
    want = ref.dense_backup(p, dcost, GAMMA, dv)
    for w in dense_backup.WARPS:
        got = dense_backup.dense_backup(p, dcost, GAMMA, dv, warps=w)
        assert _bitequal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shared_idx", [True, False])
def test_every_fleet_launch_shape_bitmatches_plain_versions(
        cuda, shared_idx, v_dtype):
    """Each (CTA size, grid order) of a fleet, batched and shared tables:
    bit for bit the batched plain version."""
    idx, val, cost, v = _fleet_tables(130, 17, 4, v_dtype, cuda, shared_idx,
                                      False)
    g = _fleet_gamma("lanes", v.dtype, cuda)
    want = ref.ell_backup(idx, val, cost, g, v)
    shared = ref.ell_backup(idx[0] if not shared_idx else idx, val[0],
                            cost[0], g, v)
    for t in lanes.THREADS:
        for order in lanes.LANE_ORDERS:
            got = bellman_ell.ell_backup(idx, val, cost, g, v, threads=t,
                                         lane_order=order)
            assert _bitequal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            one = bellman_ell.ell_backup(
                idx[0] if not shared_idx else idx, val[0], cost[0], g, v,
                threads=t, lane_order=order)
            assert _bitequal(one[0], shared[0])
            assert torch.equal(one[1], shared[1])


def test_wrappers_reject_cta_sizes_outside_the_set(cuda):
    idx, val, cost, v = _tables(64, 3, 4, np.float32, cuda)
    with pytest.raises(ValueError, match="threads must be one of"):
        bellman_ell.ell_backup(idx, val, cost, GAMMA, v, threads=384)
    with pytest.raises(ValueError, match="threads must be one of"):
        spmv_ell.ell_matvec(idx[:, 0].contiguous(), val[:, 0].contiguous(),
                            v, threads=64)
    p, dcost, dv = _dense_tables(20, 3, 40, np.float32, cuda)
    with pytest.raises(ValueError, match="warps must be one of"):
        dense_backup.dense_backup(p, dcost, GAMMA, dv, warps=32)


def test_tune_launches_are_not_path_launches(cuda, monkeypatch):
    """A tuned call times its candidates on its own operands: those
    launches count under ``tune_launches``, the call itself once under
    ``launches``; a second call is served from the cache.  The threshold
    is lowered so that a small table tunes."""
    monkeypatch.setattr(tuning, "MIN_TUNE_ELEMS", 1)
    idx, val, cost, v = _tables(301, 5, 8, np.float64, cuda)
    rows_i, rows_v = idx[:, 0].contiguous(), val[:, 0].contiguous()
    p, dcost, dv = _dense_tables(64, 3, 200, np.float64, cuda)
    fi, fval, fcost, fv = _fleet_tables(130, 5, 4, np.float64, cuda, True,
                                        False)
    per_cand = 2 * tuning._TIMING_REPS      # measure: a warm-up, one timed
    calls = [
        ("ell_backup", len(lanes.THREADS),
         lambda: ops.ell_backup(idx, val, cost, GAMMA, v),
         ref.ell_backup(idx, val, cost, GAMMA, v)),
        ("ell_matvec", len(lanes.THREADS),
         lambda: ops.ell_matvec(rows_i, rows_v, v),
         ref.ell_matvec(rows_i, rows_v, v)),
        ("dense_backup", len(dense_backup.WARPS),
         lambda: ops.dense_backup(p, dcost, GAMMA, dv),
         ref.dense_backup(p, dcost, GAMMA, dv)),
        ("ell_backup", len(lanes.THREADS) * len(lanes.LANE_ORDERS),
         lambda: ops.ell_backup(fi, fval, fcost, GAMMA, fv),
         ref.ell_backup(fi, fval, fcost, GAMMA, fv)),
    ]
    for name, n_cands, call, want in calls:
        for first in (True, False):
            before = ops.launch_counts()[name]
            tuned = ops.tune_launch_counts()[name]
            got = call()
            assert ops.launch_counts()[name] == before + 1
            assert ops.tune_launch_counts()[name] - tuned == \
                (n_cands * per_cand if first else 0)
            pairs = zip(got, want) if isinstance(got, tuple) \
                else [(got, want)]
            for a, b in pairs:
                assert torch.equal(a, b) if a.dtype == torch.int32 \
                    else _bitequal(a, b)
    entries = json.load(open(tuning.cache_path()))["entries"]
    card = torch.cuda.get_device_name(0)
    assert set(entries) == {
        f"ell_backup|torch-cuda:{card}|n512|m5|k8|float64",
        f"ell_matvec|torch-cuda:{card}|n512|m1|k8|float64",
        f"dense_backup|torch-cuda:{card}|n64|m3|k200|float64",
        f"ell_backup[fleet]|torch-cuda:{card}|n256|m5|k4|float64"}


def test_tuning_off_launches_the_fixed_shapes(cuda, monkeypatch):
    monkeypatch.setattr(tuning, "MIN_TUNE_ELEMS", 1)
    tuning.configure(enabled=False)
    idx, val, cost, v = _tables(301, 5, 8, np.float32, cuda)
    ops.reset_launch_counts()
    ops.ell_backup(idx, val, cost, GAMMA, v)
    assert ops.tune_launch_counts()["ell_backup"] == 0
    [shape] = [c for k, c in ops.launch_shapes().items()
               if k.startswith("ell_backup|") and "|n512|m5|k8|float32" in k]
    assert shape == lanes.DEFAULT_THREADS


def test_torch_impl_on_the_card_launches_no_kernel(cuda):
    mdp = generators.garnet(n=300, m=6, k=4, gamma=0.97, seed=3)
    opts = dict(method="ipi_gmres", dtype="float64", atol=1e-9)
    ops.reset_launch_counts()
    plain = driver.solve(mdp, IPIOptions(impl="torch", **opts),
                         device="cuda")
    assert not any(ops.launch_counts().values())
    kern = driver.solve(mdp, IPIOptions(impl="cuda", **opts), device="cuda")
    assert ops.launch_counts()["ell_backup"] > 0
    assert np.array_equal(plain.v.view(np.uint64), kern.v.view(np.uint64))
    assert np.array_equal(plain.policy, kern.policy)


@pytest.mark.parametrize("arch", ["stablelm-3b", "olmoe-1b-7b",
                                  "zamba2-1.2b", "whisper-base"])
def test_smoke_train_step_on_the_card_is_the_host_step(cuda, arch):
    """One Adam step at the smoke config (f32, an f32 accumulator, 2
    microbatches) on the card and on the host from the same weights and
    batch: no kernel launched on the card (the train mode takes the
    chunked scan, never the flash kernel), every attention projection's
    gradient non-zero, metrics within 1e-4 relative, every gradient
    within 1e-4 of its largest magnitude and every updated weight within
    1e-4 of its largest magnitude plus 1e-3 of the step's learning rate
    (a weight that starts at zero, mamba's ``conv_b``, is its update
    alone: ``lr * g / (|g| + eps)``, whose tiny gradients eps makes
    sensitive)."""
    import dataclasses

    from repro_torch.configs import get_train_config
    from repro_torch.data.pipeline import SyntheticSource
    from repro_torch.train.optimizer import apply_updates, init_opt_state
    from repro_torch.train.steps import accumulate_grads

    cfg = get_smoke_config(arch)
    tcfg = dataclasses.replace(get_train_config(arch), grad_dtype="float32")
    card = build_model(cfg, generator=torch.Generator(device="cuda")
                       .manual_seed(3), device="cuda")
    host = (WhisperModel if cfg.family == "encdec" else DecoderLM)(
        cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    batch = SyntheticSource(
        cfg.vocab_size, 24 + cfg.n_patches, 4, n_patches=cfg.n_patches,
        d_model=cfg.d_model, device="cuda",
        encoder_len=cfg.encoder_len if cfg.family == "encdec" else 0
    ).next_batch(0)
    out = {}
    for name, model in (("card", card), ("host", host)):
        dev = model.embed.device
        ops.reset_launch_counts()
        grads, met = accumulate_grads(
            model, tcfg, {k: v.to(dev) for k, v in batch.items()},
            n_microbatches=2)
        _, gnorm = apply_updates(model, grads, init_opt_state(model, tcfg),
                                 0, tcfg)
        if name == "card":
            assert not any(ops.launch_counts().values())
        out[name] = ({**{k: float(v) for k, v in met.items()},
                      "grad_norm": float(gnorm)},
                     {n: g.cpu() for n, g in grads.items()},
                     {n: p.detach().cpu() for n, p in model.named_parameters()})
    for k, want in out["host"][0].items():
        assert abs(out["card"][0][k] - want) <= 1e-4 * abs(want), k
    lr = tcfg.learning_rate / 100          # step 0 of the warmup
    for i, extra in ((1, 0.0), (2, 1e-3 * lr)):
        for n, want in out["host"][i].items():
            got = out["card"][i][n]
            assert float((got - want).abs().max()) <= \
                1e-4 * float(want.abs().max()) + extra, n
    proj = [n for n in out["card"][1] if n.endswith((".wq", ".wk", ".wv",
                                                     ".wo"))]
    assert proj and all(float(out["card"][1][n].abs().sum()) > 0
                        for n in proj)


@pytest.mark.parametrize("arch", ["stablelm-3b", "olmoe-1b-7b",
                                  "zamba2-1.2b", "whisper-base"])
def test_sharded_train_step_on_the_card_is_the_one_device_step(cuda, arch):
    """The train step of a model placed on a ``(1, 1)`` mesh over a world
    of one rank (NCCL, in this process) is the unplaced step on the card
    bit for bit: metrics and every updated weight (every collective over
    one rank copies), no kernel launched."""
    import torch.distributed as dist

    from repro_torch.configs import get_train_config
    from repro_torch.data.pipeline import SyntheticSource
    from repro_torch.launch import mesh as lm
    from repro_torch.train import sharding as shd
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.steps import make_train_step

    cfg, tcfg = get_smoke_config(arch), get_train_config(arch)
    batch = SyntheticSource(
        cfg.vocab_size, 32, 8, d_model=cfg.d_model, device="cuda",
        encoder_len=cfg.encoder_len if cfg.family == "encdec" else 0
    ).next_batch(0)
    models = [build_model(cfg, generator=torch.Generator(device="cuda")
                          .manual_seed(3), device="cuda") for _ in range(2)]
    lm.init_distributed("cuda", store=dist.HashStore(), rank=0,
                        world_size=1)
    try:
        mesh = lm.make_host_mesh((1, 1), device="cuda")
        shd.place(models[1], mesh, shd.infer_param_specs(models[1], mesh))
        out = []
        for model, m in zip(models, (None, mesh)):
            ops.reset_launch_counts()
            _, met = make_train_step(model, tcfg, n_microbatches=2, mesh=m)(
                init_opt_state(model, tcfg), 0, batch)
            assert not any(ops.launch_counts().values())
            out.append((met, {n: (p.to_local() if m else p).detach().cpu()
                              for n, p in model.named_parameters()}))
    finally:
        lm.shutdown()
    (met0, w0), (met1, w1) = out
    for k in met0:
        assert torch.equal(met0[k].cpu(), met1[k].cpu()), k
    for n, w in w0.items():
        assert torch.equal(w1[n], w), n


@pytest.mark.parametrize("arch", ["minitron-8b", "olmoe-1b-7b",
                                  "zamba2-1.2b", "whisper-base",
                                  "llava-next-34b"])
def test_placed_serving_on_the_card_is_the_one_device_serving(cuda, arch):
    """Prefill and 4 greedy decode steps of a model placed on a ``(1, 1)``
    mesh over a world of one rank (NCCL, in this process) are the unplaced
    model's on the card bit for bit: tokens and every step's logits, one
    flash launch a prefill's attention layer in each."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lm
    from repro_torch.launch.serve_lm import stub_inputs
    from repro_torch.train import sharding as shd

    cfg = get_smoke_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    model = build_model(cfg, generator=gen, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (4, 12), generator=gen,
                            device="cuda")
    extra = stub_inputs(cfg, 4, gen)

    def serve(place=None):
        ops.reset_launch_counts()
        logits, cache = make_prefill_step(model)(prompts, extra)
        flash = ops.launch_counts()["flash_attention"]
        cache = model.extend_cache(cache, 4)
        if place is not None:
            cache = place(cache)
        decode, tok, steps = make_decode_step(model), logits.argmax(-1), \
            [logits]
        for _ in range(4):
            tok, logits, cache = decode(tok, cache)
            steps.append(logits)
        return tok, steps, flash

    want = serve()
    lm.init_distributed("cuda", store=dist.HashStore(), rank=0,
                        world_size=1)
    try:
        mesh = lm.make_host_mesh((1, 1), device="cuda")
        shd.place(model, mesh, shd.infer_param_specs(model, mesh))
        got = serve(lambda c: shd.place_cache(c, mesh, cfg, 4))
    finally:
        lm.shutdown()
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert got[2] == want[2] and (want[2] > 0) == (cfg.family != "ssm")


# --------------------------------------------------------------------------- #
# Spans and reads of the solve path on the card (repro_torch.utils.trace)     #
# --------------------------------------------------------------------------- #

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


def _card_fleet(cuda, count=3, n=20_000):
    return [generators.garnet(n=n, m=6, k=4, gamma=0.95, seed=20 + i)
            .to(cuda) for i in range(count)]


@pytest.mark.parametrize("method", ["ipi_gmres", "mpi"])
def test_every_sync_of_a_fleet_solve_is_a_counted_read(cuda, method):
    """Under the sync debug mode every synchronising call of a fleet solve
    on the card is one the read funnel counted: no read, and no other
    wait on the device, is left outside it."""
    import warnings

    from repro_torch.api import Session
    from repro_torch.utils import trace
    session = Session({"-device": "cuda", "-method": method,
                       "-dtype": "float64", "-atol": 1e-8})
    mdps = _card_fleet(cuda)
    session.solve_fleet(mdps)
    torch.cuda.synchronize()
    trace.clear()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                trace.recording():
            warnings.simplefilter("always")
            session.solve_fleet(mdps)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    call, = trace.calls()
    reads = call.summary()["reads"]
    assert len(syncs) == sum(reads.values()) > 0, \
        sorted({f"{w.filename}:{w.lineno}" for w in syncs})


def test_launch_records_fall_inside_the_spans_that_issued_them(cuda):
    """Spans and the profiler's records share one clock on the card:
    launches issued inside a span are recorded inside its interval, and a
    fleet solve's launches inside its root span, each Arnoldi step's
    orthogonalization issuing as many as every other."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Session
    from repro_torch.utils import trace
    x = torch.ones(1 << 16, device=cuda)
    session = Session({"-device": "cuda", "-method": "ipi_gmres",
                       "-dtype": "float64", "-atol": 1e-8})
    mdps = _card_fleet(cuda)
    session.solve_fleet(mdps)
    torch.cuda.synchronize()
    trace.clear()
    spans = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(4):
            with trace.span(f"probe{i}") as sp:
                for _ in range(3):
                    x = x * 1.0 + 1.0
            spans.append(sp)
            time.sleep(0.002)
        session.solve_fleet(mdps)
        torch.cuda.synchronize()
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if e.name() in LAUNCHES]
    inside = lambda s, lo, hi: s.start_ns <= lo and hi <= s.end_ns
    for sp in spans:
        assert sum(inside(sp, lo, hi) for lo, hi in launches) == 6
    call = [c for c in trace.calls() if c.root.name == "session.solve_fleet"]
    root = call[0].root
    rest = [(lo, hi) for lo, hi in launches
            if not any(inside(sp, lo, hi) for sp in spans)]
    assert rest and all(inside(root, lo, hi) for lo, hi in rest)
    per_step = {sum(inside(s, lo, hi) for lo, hi in rest)
                for s in call[0].spans if s.name == "gmres.orthogonalize"}
    assert len(per_step) == 1 and per_step.pop() > 0
