"""The torch port's other KSPs, preconditioners and deterministic GMRES
against the JAX reference: one call at a time, and the shared whole-solve
parity check the ``test_torch_ksp_*.py`` matrix files use.

One call at a time (same operator, right-hand side and start, fixed
iteration counts): BiCGStab, Chebyshev, Anderson (both modes) and GMRES
(deterministic, and with a preconditioner) agree with the reference to a
few ulps of the solution's scale (``BODY_TOL``: the dots and products sum
in BLAS's order in the port and XLA's in the reference); Jacobi and block
Jacobi built from the same policy rows give the same ``M x`` (Jacobi bit
for bit).

Whole solves (:func:`check_parity`), on the CPU, the reference held with
``impl="xla"``.  The KSP bodies agree to rounding, but iPI amplifies the
last bits on the ill-conditioned families (sis, chain_walk at gamma =
0.99): a residual crosses its forcing tolerance one inner step earlier,
or a greedy action on an exact tie flips.  The rules, with the worst gap
measured on these instances:

* **garnet and maze2d, float64**: policy, outer and inner counts exact
  for every KSP and preconditioner.
* **policy**: exact, except on the maxreward chain_walk, whose far
  states tie exactly (reference Q-gap 0).  There a state may differ only
  if its reference Q-gap is within ``2 * gamma * dv`` (``dv`` the value
  difference, the most the two Q tables can move apart) plus 8 ulps of
  ``|v|_inf``; measured up to 46 differing states of 100, every one with
  a Q-gap below 0.03 ``dv``.
* **sis and chain_walk, float64**: outer counts within 1 (BiCGStab with
  and without Jacobi, GMRES with block Jacobi: 5 against 4) and inner
  counts within 25% of the larger (measured 244 against 194, BiCGStab
  with Jacobi on the mincost chain); most cases are exact.
* **float32**: the outer counts of garnet and maze2d within 1 (as
  ``tests/test_torch_solve_gmres.py``), except Chebyshev, which on a
  nonsymmetric spectrum stalls at a few percent per outer step until a
  greedy flip (40 against 67 on the mincost garnet).  No other float32
  count is held: the forcing tolerance ``eta * res`` at ``atol = 1e-4``
  sits at float32's floor for the preconditioned and short-recurrence
  residuals, so a solve either crosses it or stagnates to ``max_inner``
  (GMRES with block Jacobi on the mincost chain: 1 outer and 7 inner
  steps in the reference, 2 and 508 in the port; BiCGStab with Jacobi
  there: 2 and 125 against 5 and 252).  Both solves must converge.
* **values**: within ``max(1e-9 |v|_inf, gap bound)`` in float64 and
  ``1e-4 |v|_inf`` in float32 where the outer counts agree, as in
  ``tests/test_torch_solve_gmres.py``; where they differ the two iterates
  stop at different points inside their certificates, and the bound is
  the sum of the two gap bounds (the triangle inequality through v*).
"""

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
from repro.core.solvers import anderson as janderson
from repro.core.solvers import bicgstab as jbicgstab
from repro.core.solvers import chebyshev as jchebyshev
from repro.core.solvers import gmres as jgmres
from repro.core.solvers.precond import build_precond as jbuild_precond
from repro_torch.core import bellman as tbellman
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core.comm import Axes as TAxes
from repro_torch.core.ipi import IPIOptions as TOpts
from repro_torch.core.solvers import anderson, bicgstab, build_precond
from repro_torch.core.solvers import chebyshev, gmres

jax.config.update("jax_enable_x64", True)

INSTANCES = {
    "garnet": dict(n=97, m=5, k=3, gamma=0.95, seed=1),
    "maze2d": dict(size=9, gamma=0.99),
    "sis": dict(pop=50, n_actions=4, gamma=0.99),
    "chain_walk": dict(n=100, gamma=0.99),
}
ATOL = {"float64": 1e-8, "float32": 1e-4}
EXACT_FAMILIES = {"garnet", "maze2d"}
NEAR_TIE_CASES = {("chain_walk", "maxreward")}
TIE_ULPS = 8
INNER_DRIFT_F64 = 0.25


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


def q_gaps(family, mode, v):
    """Reference Q-gap (best against second-best action, float64) of
    every state at ``v``."""
    m = jgen.REGISTRY[family](**INSTANCES[family])
    idx, val = np.asarray(m.idx), np.asarray(m.val, np.float64)
    sign = -1.0 if mode == "maxreward" else 1.0
    q = sign * (np.asarray(m.cost, np.float64)
                + m.gamma * (val * v.astype(np.float64)[idx]).sum(-1))
    q.sort(axis=-1)
    return q[:, 1] - q[:, 0]


def check_parity(family, mode, dtype, method, **extra):
    """One whole solve through both packages, held to the module's rules."""
    rj, rt = solve_both(family, method, mode, dtype, **extra)
    scale = float(np.abs(rj.v).max())
    dv = float(np.abs(rj.v.astype(np.float64) - rt.v).max())
    f64 = dtype == "float64"
    exact = f64 and family in EXACT_FAMILIES
    # policy
    if (family, mode) in NEAR_TIE_CASES and not exact:
        gamma = INSTANCES[family]["gamma"]
        ulp = float(np.spacing(np.dtype(dtype).type(scale)))
        window = 2 * gamma * dv + TIE_ULPS * ulp
        differ = rt.policy != rj.policy
        assert not (differ & (q_gaps(family, mode, rj.v) > window)).any()
    else:
        np.testing.assert_array_equal(rt.policy, rj.policy)
    # counts
    jo, to = rj.outer_iterations, rt.outer_iterations
    ji, ti = rj.inner_iterations, rt.inner_iterations
    if exact:
        assert (to, ti) == (jo, ji), ((to, ti), (jo, ji))
    elif f64:
        assert abs(to - jo) <= 1, (to, jo)
        assert abs(ti - ji) <= INNER_DRIFT_F64 * max(ti, ji), (ti, ji)
    elif family in EXACT_FAMILIES and method != "ipi_chebyshev":
        assert abs(to - jo) <= 1, (to, jo)
    # values
    if to == jo:
        bound = max(1e-9 * scale, rj.gap_bound) if f64 else 1e-4 * scale
    else:
        bound = max(1e-9 * scale if f64 else 1e-4 * scale,
                    rj.gap_bound + rt.gap_bound)
    assert dv <= bound, (dv, bound)


# --------------------------------------------------------------------------- #
# One call at a time                                                          #
# --------------------------------------------------------------------------- #

# a few ulps of the solution's scale, per dtype
BODY_TOL = {np.float64: 1e-13, np.float32: 1e-5}


def _system(dtype, n=60, gamma=0.9, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.random((n, n))
    p /= p.sum(1, keepdims=True)
    a = np.eye(n) - gamma * p
    b = rng.random(n)
    tdt = getattr(torch, np.dtype(dtype).name)
    aj, at = jnp.asarray(a, dtype), torch.tensor(a, dtype=tdt)
    return (lambda x: aj @ x, jnp.asarray(b, dtype), jnp.zeros(n, dtype),
            lambda x: at @ x, torch.tensor(b, dtype=tdt),
            torch.zeros(n, dtype=tdt), np.diag(a))


def _ksp_calls(name, gamma=0.9):
    if name == "bicgstab":
        return (lambda mv, b, x0, ax: jbicgstab(mv, b, x0, tol=0.0,
                                                maxiter=6, axes=ax),
                lambda mv, b, x0, ax: bicgstab(mv, b, x0, tol=0.0,
                                               maxiter=6, axes=ax))
    if name == "chebyshev":
        kw = dict(tol=0.0, maxiter=12, lo=1 - gamma, hi=1 + gamma)
        return (lambda mv, b, x0, ax: jchebyshev(mv, b, x0, axes=ax, **kw),
                lambda mv, b, x0, ax: chebyshev(mv, b, x0, axes=ax, **kw))
    if name.startswith("anderson"):
        kw = dict(tol=0.0, maxiter=12, window=4, mixing=0.9,
                  deterministic=name.endswith("det"))
        return (lambda mv, b, x0, ax: janderson(mv, b, x0, axes=ax, **kw),
                lambda mv, b, x0, ax: anderson(mv, b, x0, axes=ax, **kw))
    kw = dict(tol=0.0, maxiter=10, restart=8,
              deterministic=name.endswith("det"))
    return (lambda mv, b, x0, ax: jgmres(mv, b, x0, axes=ax, **kw),
            lambda mv, b, x0, ax: gmres(mv, b, x0, axes=ax, **kw))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["bicgstab", "chebyshev", "anderson",
                                  "anderson_det", "gmres_det"])
def test_ksp_body_matches_reference(name, dtype):
    mvj, bj, xj0, mvt, bt, xt0, _ = _system(dtype)
    fj, ft = _ksp_calls(name)
    xj, ij, rj = fj(mvj, bj, xj0, JAxes())
    xt, it, rt = ft(mvt, bt, xt0, TAxes())
    xj = np.asarray(xj)
    assert int(it) == int(ij)
    scale = float(np.abs(xj).max())
    assert float(np.abs(xj - xt.numpy()).max()) <= BODY_TOL[dtype] * scale
    assert abs(float(rt) - float(rj)) <= BODY_TOL[dtype] * max(
        float(np.abs(np.asarray(bj)).max()), 1.0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["bicgstab", "gmres", "gmres_det"])
def test_preconditioned_ksp_body_matches_reference(name, dtype):
    """The right-preconditioned paths (``precond`` = Jacobi's apply) and
    their measured-residual stop."""
    mvj, bj, xj0, mvt, bt, xt0, diag = _system(dtype)
    inv = 1.0 / diag
    mj = lambda x: x * jnp.asarray(inv, dtype)
    mt = lambda x: x * torch.tensor(inv, dtype=xt0.dtype)
    if name == "bicgstab":
        xj, ij, _ = jbicgstab(mvj, bj, xj0, tol=0.0, maxiter=6,
                              axes=JAxes(), precond=mj)
        xt, it, _ = bicgstab(mvt, bt, xt0, tol=0.0, maxiter=6, axes=TAxes(),
                             precond=mt)
    else:
        det = name.endswith("det")
        xj, ij, _ = jgmres(mvj, bj, xj0, tol=0.0, maxiter=10, axes=JAxes(),
                           restart=8, deterministic=det, precond=mj)
        xt, it, _ = gmres(mvt, bt, xt0, tol=0.0, maxiter=10, axes=TAxes(),
                          restart=8, deterministic=det, precond=mt)
    xj = np.asarray(xj)
    assert int(it) == int(ij)
    assert float(np.abs(xj - xt.numpy()).max()) <= \
        BODY_TOL[dtype] * float(np.abs(xj).max())


def test_gmres_deterministic_mode_is_reproducible_and_close_to_blas():
    """The deterministic path repeats bit for bit and agrees with the BLAS
    path to rounding."""
    _, _, _, mvt, bt, xt0, _ = _system(np.float64, n=80, gamma=0.99)
    runs = [gmres(mvt, bt, xt0, tol=1e-10, maxiter=64, axes=TAxes(),
                  restart=16, deterministic=True) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    blas = gmres(mvt, bt, xt0, tol=1e-10, maxiter=64, axes=TAxes(),
                 restart=16)
    assert runs[0][1] == blas[1]
    assert float(torch.max(torch.abs(runs[0][0] - blas[0]))) <= 1e-12


# --------------------------------------------------------------------------- #
# Preconditioners, built from the same policy rows                            #
# --------------------------------------------------------------------------- #

def _rows(family, dense, dtype):
    kw = INSTANCES[family]
    jm, tm = jgen.REGISTRY[family](**kw), tgen.REGISTRY[family](**kw)
    if dense:
        jm, tm = jm.as_dense(), tm.as_dense()
    n = tm.n_local
    pi = np.random.default_rng(5).integers(0, tm.m_local, n).astype(np.int32)
    jrows = jbellman.policy_rows(jm, jnp.asarray(pi), JAxes())
    trows = tbellman.policy_rows(tm, torch.from_numpy(pi), TAxes(),
                                 dtype=getattr(torch, dtype))
    return jrows, trows, n, kw["gamma"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dense", [False, True], ids=["ell", "dense"])
@pytest.mark.parametrize("pc_type,block", [("jacobi", 32), ("bjacobi", 32),
                                           ("bjacobi", 7)])
@pytest.mark.parametrize("family", ["chain_walk", "sis", "maze2d"])
def test_build_precond_matches_reference(family, pc_type, block, dense,
                                         dtype):
    """``M x`` from both packages' builds.  Jacobi is elementwise and
    bit for bit (``1 - gamma d`` is one rounding in both).  Block Jacobi
    inverts float32 tiles (LAPACK in the port, XLA's solve in the
    reference): within 1e-5 of ``|M x|_inf`` (measured up to 1.7e-6;
    float32 tiles at gamma = 0.99).  ``block = 7`` leaves a trailing
    partial block."""
    jrows, trows, n, gamma = _rows(family, dense, dtype)
    x = np.random.default_rng(6).random(n).astype(dtype)
    apply_j = jax.jit(lambda rows, x: jbuild_precond(
        rows, axes=JAxes(), n_local=n, gamma=gamma, pc_type=pc_type,
        block=block, dtype=jnp.dtype(dtype))(x))
    mt = build_precond(trows, axes=TAxes(), n_local=n, gamma=gamma,
                       pc_type=pc_type, block=block,
                       dtype=getattr(torch, dtype))
    want = np.asarray(apply_j(jrows, jnp.asarray(x)))
    got = mt(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if pc_type == "jacobi":
        np.testing.assert_array_equal(got, want)
    else:
        assert float(np.abs(got - want).max()) <= \
            1e-5 * float(np.abs(want).max())


def test_bjacobi_strip_sums_duplicate_successors_in_slot_order():
    """Duplicate in-block successors of a row accumulate into one tile
    cell; the build repeats bit for bit."""
    from repro_torch.core.bellman import PolicyRows
    idx = torch.tensor([[0, 0, 1], [1, 1, 1], [0, 2, 2]], dtype=torch.int32)
    val = torch.tensor([[0.25, 0.5, 0.25], [0.1, 0.2, 0.7],
                        [0.3, 0.3, 0.4]], dtype=torch.float32)
    rows = PolicyRows(idx=idx, val=val, p=None,
                      g=torch.zeros(3, dtype=torch.float32), gamma=0.5)
    m1 = build_precond(rows, axes=TAxes(), n_local=3, gamma=0.5,
                       pc_type="bjacobi", block=2)
    m2 = build_precond(rows, axes=TAxes(), n_local=3, gamma=0.5,
                       pc_type="bjacobi", block=2)
    x = torch.tensor([1.0, 2.0, 3.0])
    assert torch.equal(m1(x), m2(x))
    # block 0 = rows {0, 1}: I - 0.5 [[0.75, 0.25], [0, 1.0]]; block 1 =
    # row 2 (its in-block successor 2 carries 0.7, row 2 col 2), padded
    t0 = np.eye(2) - 0.5 * np.array([[0.75, 0.25], [0.0, 1.0]])
    want0 = np.linalg.solve(t0, [1.0, 2.0])
    want2 = 3.0 / (1 - 0.5 * 0.7)
    np.testing.assert_allclose(m1(x).numpy(), [*want0, want2], rtol=1e-6)


# --------------------------------------------------------------------------- #
# Option validation, and a few whole solves off the matrix                    #
# --------------------------------------------------------------------------- #

FIELD_ERRORS = [dict(method="ipi_bicgstab", deterministic_dots=True),
                dict(pc_type="ilu"), dict(method="vi", pc_type="jacobi"),
                dict(method="ipi_anderson", pc_type="jacobi"),
                dict(pc_type="bjacobi", deterministic_dots=True),
                dict(pc_block=0), dict(anderson_window=0),
                dict(monitor_mode="sometimes")]


@pytest.mark.parametrize("kw", FIELD_ERRORS,
                         ids=["-".join(map(str, k.values()))
                              for k in FIELD_ERRORS])
def test_new_option_errors_match_reference(kw):
    with pytest.raises(ValueError) as want:
        JOpts(**kw)
    with pytest.raises(ValueError) as got:
        TOpts(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_deterministic_anderson_solve_matches_reference(dtype):
    check_parity("garnet", "mincost", dtype, "ipi_anderson",
                 deterministic_dots=True, anderson_window=3, omega=0.9)


def test_deterministic_gmres_with_jacobi_solve_matches_reference():
    check_parity("garnet", "maxreward", "float64", "ipi_gmres",
                 deterministic_dots=True, pc_type="jacobi")


@pytest.mark.parametrize("pc_type", ["jacobi", "bjacobi"])
def test_preconditioned_dense_solve_matches_reference(pc_type):
    """The preconditioners on a dense MDP (``as_dense()`` of the garnet),
    float64: float32 tiles from the float64 ``P_pi`` rows, as the
    reference's float32 rows."""
    kw = INSTANCES["garnet"]
    common = dict(method="ipi_bicgstab", dtype="float64", atol=1e-8,
                  pc_type=pc_type, pc_block=16)
    rj = jdriver.solve(jgen.garnet(**kw).as_dense(),
                       JOpts(impl="xla", **common))
    rt = tdriver.solve(tgen.garnet(**kw).as_dense(), TOpts(**common),
                       device="cpu")
    np.testing.assert_array_equal(rt.policy, rj.policy)
    assert (rt.outer_iterations, rt.inner_iterations) == \
        (rj.outer_iterations, rj.inner_iterations)
    assert np.abs(rj.v - rt.v).max() <= max(1e-9 * np.abs(rj.v).max(),
                                            rj.gap_bound)
