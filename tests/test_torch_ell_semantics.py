"""What the ELL backup is held to on ties and non-finite Q values.

The port's CUDA backup kernel must equal its plain version
(``repro_torch.kernels.ref.ell_backup``) bit for bit, so the plain version
fixes the semantics: a running strict-``<`` minimum over the actions in
order (``ref.rowmin_argmin``).  The first minimum wins a tie; a NaN Q at
action 0 stays the minimum (nothing compares below it), and a NaN at a
later action is passed over.  These tests hold the plain version to the JAX
package's own scan, ``repro.kernels.ref.rowmin_argmin`` (its cache-blocked
CPU path), on ties, NaN and inf, from numpy inputs.

The JAX package is not of one mind here: ``jnp.min`` / ``jnp.argmin``
(``repro.kernels.ref.ell_backup``, and the Pallas kernel's tile reduce)
return NaN and the first NaN's index on a row that holds a NaN, where its
``rowmin_argmin`` does not.  Nothing below asserts either way about
``jnp.min`` / ``jnp.argmin``; the port follows ``rowmin_argmin``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

GAMMA = 0.997
NAN, INF = float("nan"), float("inf")

# rows of Q over 4 actions, each with what it exercises
Q_CASES = {
    "tie_first_wins": [[2.0, 1.0, 1.0, 3.0], [1.0, 1.0, 1.0, 1.0]],
    "nan_first": [[NAN, 1.0, 0.5, 0.2], [NAN, NAN, -1.0, 2.0]],
    "nan_later": [[1.0, NAN, 0.5, 0.2], [0.0, 1.0, NAN, NAN]],
    "all_nan": [[NAN, NAN, NAN, NAN], [NAN, NAN, NAN, NAN]],
    "inf": [[INF, INF, 5.0, INF], [INF, INF, INF, INF]],
    "minus_inf_ties": [[1.0, -INF, 0.0, -INF], [-INF, NAN, -INF, 0.0]],
    "signed_zero": [[0.0, -0.0, 1.0, -0.0], [-0.0, 0.0, 0.0, -1e-300]],
    "mixed": [[3.0, NAN, INF, -INF], [INF, 2.0, NAN, 2.0]],
}


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    """Bit for bit, except that a NaN equals a NaN in the same place."""
    ints = {4: np.int32, 8: np.int64}[got.dtype.itemsize]
    same = (got.view(ints) == want.view(ints)) | (np.isnan(got)
                                                  & np.isnan(want))
    return got.dtype == want.dtype and got.shape == want.shape \
        and bool(same.all())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(Q_CASES))
def test_rowmin_argmin_matches_the_reference_scan(case, dtype):
    q = np.asarray(Q_CASES[case], dtype=dtype)
    got_v, got_a = tref.rowmin_argmin(torch.from_numpy(q))
    want_v, want_a = jref.rowmin_argmin(jnp.asarray(q))
    assert _same(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    assert got_a.dtype == torch.int32


def _special_tables(n, m, k, v_dtype, seed):
    """Random ELL tables with duplicated action columns (exact ties, some
    at the minimum) and a NaN and an inf in both cost and v."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, m, k)).astype(np.int32)
    val = rng.random((n, m, k)).astype(np.float32)
    cost = rng.random((n, m)).astype(np.float32)
    v = (rng.random(n) * 40.0 - 20.0).astype(v_dtype)
    for dup, src in ((3, 1), (4, 0)):
        idx[:, dup], val[:, dup], cost[:, dup] = idx[:, src], val[:, src], \
            cost[:, src]
    cost[::3, 1] -= np.float32(0.5)
    cost[::3, 3] -= np.float32(0.5)
    cost[2, 0], cost[5, 2], cost[6, 1] = NAN, NAN, INF
    cost[8, 0] = -INF
    v[1], v[4], v[7] = NAN, INF, -INF
    return idx, val, cost, v


@pytest.mark.parametrize("v_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_ell_backup_matches_the_reference_scan_on_non_finite_tables(
        k, v_dtype):
    idx, val, cost, v = _special_tables(64, 5, k, v_dtype, seed=k)
    got_v, got_a = tref.ell_backup(*map(torch.from_numpy,
                                        (idx, val, cost)), GAMMA,
                                   torch.from_numpy(v))
    q = jref.ell_qvalues(jnp.asarray(idx), jnp.asarray(val),
                         jnp.asarray(cost), GAMMA, jnp.asarray(v))
    want_v, want_a = jref.rowmin_argmin(q)
    want_v, want_a = np.asarray(want_v), np.asarray(want_a)
    # the tables reach every case: NaN and +-inf minima, ties
    assert np.isnan(want_v).any() and np.isinf(want_v).any()
    assert not np.isin(want_a, (3, 4)).any()
    assert _same(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    # the CPU dispatch is the plain version
    ops_v, ops_a = ops.ell_backup(*map(torch.from_numpy, (idx, val, cost)),
                                  GAMMA, torch.from_numpy(v))
    assert _same(ops_v.numpy(), got_v.numpy())
    assert torch.equal(ops_a, got_a)
