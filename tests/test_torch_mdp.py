"""The torch port's MDP tables against the JAX reference's, bit for bit.

Both packages draw the generator tables with the same numpy calls, so
every table must be identical; ``EllMDP.from_numpy`` carries a reference
container across unchanged.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import generators as jgen
from repro_torch.core import generators as tgen
from repro_torch.core.mdp import EllMDP

jax.config.update("jax_enable_x64", True)

FAMILIES = [
    ("garnet", dict(n=157, m=6, k=5, gamma=0.95, seed=3)),
    ("garnet", dict(n=157, m=6, k=5, gamma=0.95, seed=3, rows=(40, 90))),
    ("maze2d", dict(size=9, gamma=0.99, slip=0.2)),
    ("sis", dict(pop=77, n_actions=5, gamma=0.99)),
    ("chain_walk", dict(n=64, gamma=0.99, p_fwd=0.65)),
]


@pytest.mark.parametrize("family,kw", FAMILIES,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(FAMILIES)])
def test_generator_tables_bit_identical(family, kw):
    jm = jgen.REGISTRY[family](**kw)
    tm = tgen.REGISTRY[family](**kw)
    for field in ("idx", "val", "cost"):
        want = np.asarray(getattr(jm, field))
        got = getattr(tm, field)
        assert got.device.type == "cpu"
        assert got.numpy().dtype == want.dtype, field
        np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                      want.view(np.uint8), err_msg=field)
    assert (tm.gamma, tm.n_global, tm.m_global) == \
        (jm.gamma, jm.n_global, jm.m_global)
    if "rows" not in kw:
        tm.validate()


def test_from_numpy_round_trip():
    jm = jgen.garnet(n=90, m=4, k=3, gamma=0.9, seed=5)
    tm = EllMDP.from_numpy(np.asarray(jm.idx), np.asarray(jm.val),
                           np.asarray(jm.cost), jm.gamma, jm.n_global,
                           jm.m_global, device="cpu")
    back = (tm.idx.numpy(), tm.val.numpy(), tm.cost.numpy())
    for got, want in zip(back, (jm.idx, jm.val, jm.cost)):
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got.dtype == np.asarray(want).dtype
    assert (tm.n_local, tm.m_local, tm.nnz_per_row) == (90, 4, 3)
    assert tm.to("cpu") is tm
    # float64 inputs are stored as the reference stores them: float32
    f64 = EllMDP.from_numpy(np.asarray(jm.idx, np.int64),
                            np.asarray(jm.val, np.float64),
                            np.asarray(jm.cost, np.float64), 0.9, 90, 4)
    assert f64.idx.dtype == torch.int32 and f64.val.dtype == torch.float32
    assert torch.equal(f64.val, tm.val)


def test_validate_rejects_bad_tables():
    tm = tgen.garnet(n=40, m=3, k=2, seed=1)
    bad_val = tm.val.clone()
    bad_val[3, 1, 0] += 0.5
    with pytest.raises(ValueError, match=r"row \(3, 1\) sums to"):
        EllMDP(tm.idx, bad_val, tm.cost, tm.gamma, 40, 3).validate()
    bad_idx = tm.idx.clone()
    bad_idx[0, 0, 0] = 40
    with pytest.raises(ValueError, match="successor ids"):
        EllMDP(bad_idx, tm.val, tm.cost, tm.gamma, 40, 3).validate()
    with pytest.raises(ValueError, match="gamma"):
        EllMDP(tm.idx, tm.val, tm.cost, 1.0, 40, 3).validate()


def test_cuda_placement_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: placement on cuda is legal here")
    tm = tgen.chain_walk(n=10)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        tm.to("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        EllMDP.from_numpy(tm.idx.numpy(), tm.val.numpy(), tm.cost.numpy(),
                          tm.gamma, 10, 2, device="cuda")
