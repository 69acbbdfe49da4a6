"""The torch port's checkpoints (``repro_torch.utils.checkpoint`` and the
driver's chunk checkpoint and resume) against the JAX package's.

* A port solve stopped at ``max_outer=3`` with ``checkpoint_dir`` and then
  resumed equals the uninterrupted port solve bit for bit (values,
  policy, counts, traces), for vi, mpi and ipi_gmres.
* A checkpoint written by the JAX package resumes in the port, and the
  reverse.  Against the uninterrupted solve of the package that finishes:
  bit for bit for vi in float64 (the two packages' vi solves are bitwise
  equal, ``tests/test_torch_solve.py``); for ipi_gmres the same policy
  and counts, values within ``max(1e-9 |v|_inf, gap bound)``
  (``tests/test_torch_solve_gmres.py``'s bound).
* A torn newest file falls back to the older step; a leaf-count or ``n``
  mismatch raises the reference's errors.
"""

import json
import os

import jax
import numpy as np
import pytest

from repro.core import driver as jdriver
from repro.core import generators as jgen
from repro.core.ipi import IPIOptions as JOpts
from repro.utils import checkpoint as jckpt
from repro_torch.api import MDP, madupite_session
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core import methods as tmethods
from repro_torch.core.ipi import IPIOptions as TOpts
from repro_torch.launch import solve as tcli
from repro_torch.utils import checkpoint as tckpt

jax.config.update("jax_enable_x64", True)

GARNET = dict(n=97, m=5, k=3, gamma=0.95, seed=1)
CHAIN = dict(n=100, gamma=0.99)


def _equal(a, b):
    np.testing.assert_array_equal(a.v.view(np.uint8), b.v.view(np.uint8))
    np.testing.assert_array_equal(a.policy, b.policy)
    assert (a.outer_iterations, a.inner_iterations, a.converged) == \
        (b.outer_iterations, b.inner_iterations, b.converged)
    np.testing.assert_array_equal(a.trace_residual, b.trace_residual)
    np.testing.assert_array_equal(a.trace_inner, b.trace_inner)
    assert (a.residual, a.gap_bound) == (b.residual, b.gap_bound)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method", ["vi", "mpi", "ipi_gmres"])
def test_stop_and_resume_equals_uninterrupted(method, dtype, tmp_path,
                                              capsys):
    common = dict(method=method, dtype=dtype,
                  atol=1e-8 if dtype == "float64" else 1e-4)
    m = tgen.garnet(**GARNET)          # more than 3 outer steps for each
    whole = tdriver.solve(m, TOpts(**common), device="cpu")
    assert whole.outer_iterations > 3
    ck = str(tmp_path / "ck")
    part = tdriver.solve(m, TOpts(max_outer=3, **common), device="cpu",
                         checkpoint_dir=ck, chunk=2)
    assert part.outer_iterations == 3 and not part.converged
    assert sorted(os.listdir(ck)) == ["step_0000000002.npz",
                                      "step_0000000003.npz"]
    resumed = tdriver.solve(m, TOpts(**common), device="cpu",
                            checkpoint_dir=ck, verbose=True)
    assert "[driver] resumed at outer k=3" in capsys.readouterr().out
    _equal(resumed, whole)


def test_checkpoint_file_is_the_reference_format(tmp_path):
    ck = str(tmp_path / "ck")
    tdriver.solve(tgen.garnet(**GARNET),
                  TOpts(method="ipi_gmres", dtype="float64", max_outer=2),
                  device="cpu", checkpoint_dir=ck)
    with np.load(os.path.join(ck, "step_0000000002.npz")) as z:
        man = json.loads(str(z["__manifest__"]))
        leaves = [z[f"leaf_{i}"] for i in range(man["n_leaves"])]
    assert set(man) == {"step", "treedef", "n_leaves", "meta"}
    assert man["step"] == 2 and man["n_leaves"] == 14
    assert man["meta"] == {"method": "ipi_gmres", "n": 97}
    shapes = [x.shape for x in leaves]
    assert shapes == [(97,), (97,), (97,), (), (), (), (3,), (2,), (), (),
                      (), (), (), (0,)]
    dtypes = [x.dtype.name for x in leaves]
    assert dtypes == ["float64", "float64", "int32", "float64", "int32",
                      "int32", "float64", "int32", "float64", "float64",
                      "bool", "bool", "int32", "float64"]
    assert int(leaves[4]) == 2 and int(leaves[12]) == 97


def _ref_like(path, mdp, opts):
    """The reference's own restore of a port checkpoint (its driver's
    like-structure from ``eval_shape``)."""
    from repro.core import ipi as jipi
    from repro.core.comm import Axes
    like = jax.eval_shape(lambda: jipi.init_state(mdp, Axes(), opts))
    return jckpt.restore(path, like)


@pytest.mark.parametrize("method,dtype", [("vi", "float64"),
                                          ("ipi_gmres", "float64"),
                                          ("ipi_gmres", "float32")])
def test_jax_checkpoint_resumes_in_the_port(method, dtype, tmp_path):
    common = dict(method=method, dtype=dtype,
                  atol=1e-8 if dtype == "float64" else 1e-4)
    ck = str(tmp_path / "ck")
    rj_whole = jdriver.solve(jgen.garnet(**GARNET),
                             JOpts(impl="xla", **common))
    jdriver.solve(jgen.garnet(**GARNET),
                  JOpts(impl="xla", max_outer=3, **common),
                  checkpoint_dir=ck)
    rt = tdriver.solve(tgen.garnet(**GARNET), TOpts(**common),
                       device="cpu", checkpoint_dir=ck)
    _held(rt, rj_whole, method, dtype)


@pytest.mark.parametrize("method,dtype", [("vi", "float64"),
                                          ("ipi_gmres", "float64"),
                                          ("ipi_gmres", "float32")])
def test_port_checkpoint_resumes_in_jax(method, dtype, tmp_path):
    common = dict(method=method, dtype=dtype,
                  atol=1e-8 if dtype == "float64" else 1e-4)
    ck = str(tmp_path / "ck")
    rt_whole = tdriver.solve(tgen.garnet(**GARNET), TOpts(**common),
                             device="cpu")
    tdriver.solve(tgen.garnet(**GARNET), TOpts(max_outer=3, **common),
                  device="cpu", checkpoint_dir=ck)
    jm = jgen.garnet(**GARNET)
    tree, step, meta = _ref_like(ck, jm, JOpts(impl="xla", max_outer=3,
                                               **common))
    assert step == 3 and meta["n"] == 97
    rj = jdriver.solve(jm, JOpts(impl="xla", **common), checkpoint_dir=ck)
    _held(rj, rt_whole, method, dtype)


def _held(got, want, method, dtype):
    if method == "vi" and dtype == "float64":
        _equal(got, want)
        return
    np.testing.assert_array_equal(got.policy, want.policy)
    if dtype == "float64":
        assert (got.outer_iterations, got.inner_iterations) == \
            (want.outer_iterations, want.inner_iterations)
    else:
        assert abs(got.outer_iterations - want.outer_iterations) <= 1
    scale = float(np.abs(want.v).max())
    bound = max(1e-9 * scale, want.gap_bound) if dtype == "float64" \
        else 1e-4 * scale
    assert float(np.abs(got.v.astype(np.float64)
                        - want.v.astype(np.float64)).max()) <= bound


def test_torn_newest_file_falls_back_to_the_older_step(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    opts = TOpts(method="vi", dtype="float64")
    m = tgen.chain_walk(**CHAIN)
    whole = tdriver.solve(m, opts, device="cpu")
    tdriver.solve(m, TOpts(method="vi", dtype="float64", max_outer=6),
                  device="cpu", checkpoint_dir=ck, chunk=3)
    newest = os.path.join(ck, "step_0000000006.npz")
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    leaves, step, _ = tckpt.restore(ck, 14)
    assert step == 3 and len(leaves) == 14
    assert jckpt.restore(ck, [0] * 14)[1] == 3        # the reference agrees
    resumed = tdriver.solve(m, opts, device="cpu", checkpoint_dir=ck,
                            verbose=True)
    assert "[driver] resumed at outer k=3" in capsys.readouterr().out
    _equal(resumed, whole)


def test_leaf_count_and_n_mismatch_raise_the_reference_errors(tmp_path):
    ck = str(tmp_path / "ck")
    tckpt.save(ck, 4, [np.zeros(3), np.int32(1)], meta=dict(n=3))
    with pytest.raises(ValueError) as got:
        tckpt.restore(ck, 14)
    with pytest.raises(ValueError) as want:
        jckpt.restore(ck, [0] * 14)
    assert str(got.value) == str(want.value)
    assert "holds 2 leaves but this run's state has 14" in str(got.value)
    with pytest.raises(ValueError, match="holds 2 leaves"):
        tdriver.solve(tgen.garnet(**GARNET), TOpts(method="vi"),
                      device="cpu", checkpoint_dir=ck)

    other = str(tmp_path / "other")
    tdriver.solve(tgen.garnet(**GARNET), TOpts(method="vi", max_outer=2),
                  device="cpu", checkpoint_dir=other)
    small = dict(n=60, m=5, k=3, gamma=0.95, seed=1)
    with pytest.raises(ValueError) as got:
        tdriver.solve(tgen.garnet(**small), TOpts(method="vi"),
                      device="cpu", checkpoint_dir=other)
    with pytest.raises(ValueError) as want:
        jdriver.solve(jgen.garnet(**small), JOpts(impl="xla", method="vi"),
                      checkpoint_dir=other)
    assert str(got.value) == str(want.value)
    assert "was written for n=97 but this solve has n=60" in str(got.value)


def test_interrupt_mode_writes_only_on_divergence(tmp_path):
    def overshoot(matvec, b, x0, *, tol, maxiter, axes):
        x = x0 + 50.0 * (b - matvec(x0))
        return x, 1, axes.norm_inf(b - matvec(x))

    tmethods.register_ksp("overshoot", overshoot, auto_method=False)
    tmethods.register_method("ipi_overshoot", ksp="overshoot",
                             inner="forcing", safeguarded=False)
    try:
        calm, wild = str(tmp_path / "calm"), str(tmp_path / "wild")
        r = tdriver.solve(tgen.garnet(**GARNET), TOpts(method="vi"),
                          device="cpu", checkpoint_dir=calm,
                          checkpoint_mode="interrupt")
        assert r.converged and not os.path.exists(calm)
        r = tdriver.solve(tgen.garnet(**GARNET),
                          TOpts(method="ipi_overshoot", dtype="float64",
                                divtol=10.0),
                          device="cpu", checkpoint_dir=wild,
                          checkpoint_mode="interrupt")
        assert r.diverged
        assert os.listdir(wild) == [f"step_{r.outer_iterations:010d}.npz"]
    finally:
        tmethods.unregister_method("ipi_overshoot")
        tmethods.unregister_ksp("overshoot")
    with pytest.raises(ValueError, match="checkpoint_mode"):
        tdriver.solve(tgen.garnet(**GARNET), TOpts(), device="cpu",
                      checkpoint_mode="always")


def test_session_and_cli_checkpoint_dir(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    with madupite_session({"-device": "cpu", "-method": "ipi_gmres",
                           "-dtype": "float64", "-max_outer": 2,
                           "-checkpoint_dir": ck}) as s:
        r = s.solve(MDP.from_generator("garnet", **GARNET))
    assert r.outer_iterations == 2 and os.listdir(ck)
    rc = tcli.main(["--instance", "garnet", "--n", "97", "--m", "5", "--k",
                    "3", "--gamma", "0.95", "--seed", "1", "--device", "cpu",
                    "--method", "ipi_gmres", "--ckpt-dir", ck, "--monitor"])
    out = capsys.readouterr().out
    assert rc == 0 and "[driver] resumed at outer k=2" in out
    whole = tdriver.solve(tgen.garnet(**GARNET),
                          TOpts(method="ipi_gmres", dtype="float64",
                                max_outer=2000), device="cpu")
    assert out.count("[monitor] k=") == whole.outer_iterations - 2 + 1
