"""Function-backed MDPs and the matrix-free operator of the torch port,
against the port's own materialized solves and the JAX reference.

The port's invariant: a matrix-free solve — row chunks rebuilt from the
``from_functions`` constructors inside every backup and policy-row
extraction, never a stored table — is bit for bit the solve of the
device-materialized table of the same functions: values, policies,
counts and residual traces, for every generator family, method, mode and
chunk size.

Against the reference (``IPIOptions(impl="xla")``, ``jax_enable_x64`` as
``tests/conftest.py`` sets it):

* the deferred families' tables bit for bit, row ids ``>= n`` and
  negative ones included: garnet (the reference's counter-based draws
  under x64), maze2d, chain_walk, and sis at these sizes — the port
  computes sis's float32 arithmetic as XLA:CPU compiles the reference's,
  and XLA's fusion of it varies with the shape (the reference's own
  8-row block is a ulp off its full table here, and at pop 333 1263 of
  its full table's probabilities are; its docstring promises sis only
  "to rounding");
* matrix-free solves: ``vi`` and ``async_vi`` (backups only) bit for bit;
  ``mpi`` and ``ipi_gmres`` with the same policy and counts and values
  within ``max(1e-9 |v|_inf, gap bound)`` (float64) — the rules
  ``tests/test_torch_solve.py`` holds the materialized solves to.

Plus the seams: materialization rules and their errors, the
``from_functions`` surface (the reference's ``tests/test_api.py``), band
metadata for the partition planner, ``stack_mdps`` on operators, a
matrix-free gamma sweep through ``solve_many`` and ``Session.solve_fleet``,
and ``Session.close``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.api import MDP as JMDP
from repro.core import generators as jgen
from repro.core.driver import solve as jsolve
from repro.core.ipi import IPIOptions as JOpts
from repro.kernels import matrix_free as jmf
from repro_torch.api import MDP, Session
from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core import partition
from repro_torch.core.driver import _validate_banded
from repro_torch.core.comm import Axes
from repro_torch.core.ipi import IPIOptions as TOpts
from repro_torch.core.mdp import MatrixFreeMDP, stack_mdps
from repro_torch.kernels import matrix_free, ops

jax.config.update("jax_enable_x64", True)

# small instances of every family: global random columns, 5-point
# stencil, birth-death band, 2-successor chain
FAMS = {
    "garnet": dict(n=120, m=3, k=4, gamma=0.9, seed=0),
    "maze2d": dict(size=12, gamma=0.95),
    "sis": dict(pop=150, n_actions=4, gamma=0.95),
    "chain_walk": dict(n=200, gamma=0.95),
}
METHODS = ("vi", "mpi", "ipi_gmres", "async_vi")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint64 if x.dtype == np.float64 else np.uint32)


def _same(a, b):
    assert np.array_equal(_bits(a.v), _bits(b.v))
    assert np.array_equal(a.policy, b.policy)
    assert (a.outer_iterations, a.inner_iterations) == \
        (b.outer_iterations, b.inner_iterations)
    assert np.array_equal(a.trace_residual, b.trace_residual,
                          equal_nan=True)


def _opts(method, mode="mincost", **kw):
    return {**dict(method=method, mode=mode, atol=1e-8, dtype="float64",
                   max_outer=3000), **kw}


def _port_pair(name, mode="mincost"):
    mdp = MDP.from_generator(name, deferred=True, mode=mode, **FAMS[name])
    return (mdp.build("cpu", materialize="device"),
            mdp.build("cpu", materialize="matrix_free"))


def _chunked(monkeypatch, n, m, k, rows):
    """Make every rebuilt chunk ``rows`` rows (the byte cap that gives
    it)."""
    per_row = m * (8 * k + 4) + matrix_free.CONSTRUCTOR_SLOT_BYTES * k
    monkeypatch.setattr(matrix_free, "CHUNK_BYTES", rows * per_row)


# --------------------------------------------------------------------------- #
# Tables: the deferred families against the reference's                      #
# --------------------------------------------------------------------------- #

ROWS = np.concatenate([np.arange(0, 260), [299, 300, 301, 1000, 2**31 - 1,
                                            -1, -7]]).astype(np.int32)


@pytest.mark.parametrize("name", sorted(FAMS))
def test_constructors_match_the_reference(name):
    """Raw constructor outputs (unmasked) on any int32 row id."""
    jspec = jgen.FN_REGISTRY[name](**FAMS[name])
    tspec = tgen.FN_REGISTRY[name](**FAMS[name])
    rows = torch.from_numpy(ROWS)
    for a in range(jspec["m"]):
        jids, jp = jax.jit(lambda r: jspec["P_fn"](r, a))(jnp.asarray(ROWS))
        jg = jax.jit(lambda r: jspec["g_fn"](r, a))(jnp.asarray(ROWS))
        tids, tp = tspec["P_fn"](rows, a)
        tg = tspec["g_fn"](rows, a)
        assert tids.dtype == torch.int32 and tp.dtype == torch.float32
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        assert np.array_equal(_bits(tp.numpy()), _bits(np.asarray(jp)))
        # the reference's garnet cost is a float64 uniform, cast to
        # float32 by the row builder
        assert np.array_equal(_bits(tg.to(torch.float32).numpy()),
                              _bits(np.asarray(jg, np.float32)))


@pytest.mark.parametrize("name", sorted(FAMS))
def test_constructors_keep_no_state_between_calls(name):
    """Each call depends on its arguments alone: interleaved calls on two
    row blocks, a rows tensor changed in place, calls under
    ``torch.inference_mode`` and calls on other rows inside a chunk's
    build (whose memo holds that chunk's keys) give the outputs of a lone
    call."""
    spec = tgen.FN_REGISTRY[name](**FAMS[name])
    alone = lambda r, a: (*spec["P_fn"](r.clone(), a),
                          spec["g_fn"](r.clone(), a))
    r1 = torch.arange(0, 16, dtype=torch.int32)
    r2 = torch.arange(40, 56, dtype=torch.int32)
    want = {(i, a): alone(r, a) for i, r in ((1, r1), (2, r2))
            for a in range(spec["m"])}

    def same(got, key):
        for g, w in zip(got, want[key]):
            assert torch.equal(g, w), (name, key)

    for a in range(spec["m"]):
        for i, r in ((1, r1), (2, r2)):
            same((*spec["P_fn"](r, a), spec["g_fn"](r, a)), (i, a))
    rows = r1.clone()
    spec["P_fn"](rows, 0)
    rows.copy_(r2)
    same((*spec["P_fn"](rows, 0), spec["g_fn"](rows, 0)), (2, 0))
    with torch.inference_mode():
        r = torch.arange(40, 56, dtype=torch.int32)
        same((*spec["P_fn"](r, 0), spec["g_fn"](r, 0)), (2, 0))
    seen = []

    def p_fn(r, a):
        seen.append((a, (*spec["P_fn"](r2, a), spec["g_fn"](r2, a))))
        return spec["P_fn"](r, a)

    acts = tuple(range(spec["m"]))
    idx, val, cost, _ = matrix_free.build_rows_block(
        matrix_free.RowSpec(p_fn, spec["g_fn"], spec["n"], spec["m"],
                            spec["nnz"], True), r1, acts, "mincost")
    assert len(seen) == len(acts)
    for a, got in seen:
        same(got, (2, a))
        ids, probs, g = want[(1, a)]
        assert torch.equal(idx[:, a], ids) and torch.equal(val[:, a], probs)
        assert torch.equal(cost[:, a], g.to(torch.float32))


@pytest.mark.parametrize("name", sorted(FAMS))
def test_device_pipeline_builds_the_reference_tables(name):
    """The device pipeline's table against the reference's device build,
    and the shard-padding rows of one block (rows >= n): absorbing
    zero-cost self-loops in both."""
    tcore = MDP.from_generator(name, deferred=True,
                               **FAMS[name]).build("cpu")
    jcore = JMDP.from_generator(name, deferred=True, **FAMS[name]).build()
    for f in ("idx", "val", "cost"):
        t, j = getattr(tcore, f).numpy(), np.asarray(getattr(jcore, f))
        assert np.array_equal(t.view(np.uint32), j.view(np.uint32)), f
    spec = tgen.FN_REGISTRY[name](**FAMS[name])
    jfn = jgen.FN_REGISTRY[name](**FAMS[name])
    n = spec["n"]
    rows = torch.arange(n - 3, n + 5, dtype=torch.int32)
    acts = tuple(range(spec["m"] + 2))        # two padded action columns
    tsp = matrix_free.RowSpec(spec["P_fn"], spec["g_fn"], n, spec["m"],
                              spec["nnz"], True)
    jsp = jmf.RowSpec(jfn["P_fn"], jfn["g_fn"], n, jfn["m"], jfn["nnz"],
                      True)
    for mode in ("mincost", "maxreward"):
        got = matrix_free.build_rows_block(tsp, rows, acts, mode)
        want = jax.jit(lambda r: jmf.build_rows_block(jsp, r, acts, mode))(
            jnp.asarray(rows.numpy()))
        for t, j in zip(got[:3], want[:3]):
            t, j = t.numpy(), np.asarray(j)
            if name == "sis" and t.dtype == np.float32:
                # XLA contracts the sis cost's product and add into an
                # FMA in some fusions and not in others: this 8-row
                # block's cost is a ulp off its full-table build, which
                # the port matches bit for bit (above)
                np.testing.assert_array_max_ulp(t, j, maxulp=1)
            else:
                assert np.array_equal(_bits(t), _bits(j))
        assert got[3].tolist() == np.asarray(want[3]).sum(0).tolist()


# --------------------------------------------------------------------------- #
# Bitwise parity with the materialized table, and with the reference          #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(FAMS))
def test_matrix_free_is_the_materialized_solve(name, chunks, monkeypatch):
    """Every method in both modes, rebuilt in one, two and three chunks
    (one is the rule's here): the trajectory over 6 outer steps at
    ``atol=1e-12`` (unconverged, so every step's bits are compared) is bit
    for bit the device-materialized table's — values, policy, counts and
    residual trace."""
    spec = tgen.FN_REGISTRY[name](**FAMS[name])
    if chunks > 1:
        _chunked(monkeypatch, spec["n"], spec["m"], spec["nnz"],
                 -(-spec["n"] // chunks))
    for mode in ("mincost", "maxreward"):
        mat, mf = _port_pair(name, mode)
        for method in METHODS:
            opts = TOpts(**_opts(method, mode, atol=1e-12, max_outer=6,
                                 async_sweeps=3))
            _same(tdriver.solve(mat, opts, device="cpu"),
                  tdriver.solve(mf, opts, device="cpu"))


@pytest.mark.parametrize("method, pc", [("ipi_gmres", "jacobi"),
                                        ("ipi_gmres", "bjacobi"),
                                        ("ipi_bicgstab", "jacobi")])
def test_preconditioners_from_rebuilt_policy_rows(method, pc):
    """Jacobi and block Jacobi are built from the policy rows the matvec
    holds — rebuilt ones here — and give the materialized solve's bits."""
    mat, mf = _port_pair("chain_walk")
    opts = TOpts(**_opts(method, pc_type=pc, pc_block=16))
    _same(tdriver.solve(mat, opts, device="cpu"),
          tdriver.solve(mf, opts, device="cpu"))


def _reference_mf(name, method, mode="mincost"):
    core = JMDP.from_generator(name, deferred=True, mode=mode,
                               **FAMS[name]).build("matrix_free")
    return jsolve(core, JOpts(impl="xla", **_opts(method, mode)))


def _held_to_reference(rt, rj, exact_values):
    np.testing.assert_array_equal(rt.policy, rj.policy)
    assert (rt.outer_iterations, rt.inner_iterations) == \
        (rj.outer_iterations, rj.inner_iterations)
    if exact_values:
        assert np.array_equal(_bits(rt.v), _bits(rj.v))
    else:
        scale = float(np.abs(rj.v).max())
        dv = float(np.abs(rt.v - rj.v).max())
        assert dv <= max(1e-9 * scale, rj.gap_bound), dv


@pytest.mark.parametrize("name", sorted(FAMS))
def test_ipi_gmres_every_family_against_the_reference(name):
    """ipi_gmres runs the whole operator — backups for the residual,
    rebuilt policy rows for the inner Krylov solve."""
    _, mf = _port_pair(name)
    rt = tdriver.solve(mf, TOpts(**_opts("ipi_gmres")), device="cpu")
    _held_to_reference(rt, _reference_mf(name, "ipi_gmres"), False)


@pytest.mark.parametrize("mode", ["mincost", "maxreward"])
@pytest.mark.parametrize("method", ["vi", "mpi", "async_vi"])
def test_methods_and_modes_against_the_reference(method, mode):
    """The backup-only methods bit for bit, mpi to the Krylov bound —
    maxreward through the negation inside the rebuilt chunk."""
    _, mf = _port_pair("maze2d", mode)
    rt = tdriver.solve(mf, TOpts(**_opts(method, mode)), device="cpu")
    _held_to_reference(rt, _reference_mf("maze2d", method, mode),
                       method != "mpi")


def test_chunked_rebuild_gives_the_same_bits():
    """The backup over rebuilt chunks of 37 and 64 rows is the backup
    over the whole block, which is the materialized table's."""
    mdp = MDP.from_generator("sis", deferred=True, **FAMS["sis"])
    spec = mdp._row_spec()
    v = torch.linspace(-2.0, 2.0, spec.n, dtype=torch.float32)
    acts = tuple(range(spec.m))
    whole = matrix_free.mf_backup(spec, 0, spec.n, acts, 0.9, v)
    core = mdp.build("cpu")
    mat = ops.ell_backup_chunk(core.idx, core.val, core.cost, 0.9, v)
    for bn in (37, 64):
        tiled = matrix_free.mf_backup(spec, 0, spec.n, acts, 0.9, v,
                                      block_rows=bn)
        for got in (whole, mat):
            assert np.array_equal(_bits(got[0]), _bits(tiled[0])), bn
            assert torch.equal(got[1], tiled[1]), bn


def test_chunk_rule_and_memory_model():
    """The fixed chunk rule keeps a chunk's modelled transient under the
    cap; the memory model is the reference's."""
    spec = MDP.from_generator("garnet", deferred=True, n=10**6, m=16,
                              k=8)._row_spec()
    bn = matrix_free.chunk_rows(spec, 16)
    assert 1 <= bn and matrix_free.chunk_bytes(spec, 16, bn) \
        <= matrix_free.CHUNK_BYTES < matrix_free.chunk_bytes(spec, 16,
                                                             bn + 1)
    assert matrix_free.chunk_rows(spec, 16, block_rows=5) == 5
    for args in ((10**6, 16, 8), (333, 4, 3)):
        assert matrix_free.table_bytes(*args) == jmf.table_bytes(*args)
        for krylov in (True, False):
            assert matrix_free.operator_bytes(args[0], args[2],
                                              krylov=krylov) == \
                jmf.operator_bytes(args[0], args[2], krylov=krylov)
    assert matrix_free.table_bytes(10**6, 16, 8) == 1_088_000_000


# --------------------------------------------------------------------------- #
# Materialization rules and the from_functions surface                        #
# --------------------------------------------------------------------------- #

def _chain_torch(n):
    """The chain's constructors in torch: the device pipeline."""
    def P_fn(rows, a):
        left = torch.clamp(rows - 1, 0, n - 1)
        right = torch.clamp(rows + 1, 0, n - 1)
        fwd, bwd = (left, right) if a == 0 else (right, left)
        return (torch.stack([fwd, bwd], -1).to(torch.int32),
                torch.tensor([0.7, 0.3]).expand(rows.shape[0], 2))

    def g_fn(rows, a):
        return (rows != 0).to(torch.float32)

    return P_fn, g_fn


def _chain_np_vec(n):
    def P_fn(rows, a):
        left = np.clip(rows - 1, 0, n - 1)
        right = np.clip(rows + 1, 0, n - 1)
        fwd, bwd = (left, right) if a == 0 else (right, left)
        return (np.stack([fwd, bwd], -1),
                np.broadcast_to(np.array([0.7, 0.3]), (len(rows), 2)))

    def g_fn(rows, a):
        return np.where(rows == 0, 0.0, 1.0)

    return P_fn, g_fn


def _chain_scalar(n):
    def P_fn(s, a):
        left, right = max(s - 1, 0), min(s + 1, n - 1)
        return ([left, right], [0.7, 0.3]) if a == 0 \
            else ([right, left], [0.7, 0.3])

    def g_fn(s, a):
        return 0.0 if s == 0 else 1.0

    return P_fn, g_fn


def test_from_functions_matches_generator():
    n = 60
    fmdp = MDP.from_functions(*_chain_scalar(n), n, 2, nnz=2, gamma=0.99)
    assert fmdp.deferred and fmdp.n == n and fmdp.m == 2
    assert "functions" in repr(fmdp)
    ref = tgen.chain_walk(n=n, gamma=0.99)
    opts = TOpts(method="ipi_gmres", atol=1e-9, dtype="float64")
    r1 = tdriver.solve(fmdp.build("cpu"), opts, device="cpu")
    r2 = tdriver.solve(ref, opts, device="cpu")
    np.testing.assert_array_equal(r1.policy, r2.policy)
    np.testing.assert_allclose(r1.v, r2.v, atol=1e-8)


def test_pipelines_and_forms_build_the_same_tables():
    """Host scalar, host vectorized, device vectorized and device
    per-state (``torch.func.vmap``) constructors: one table, the
    generator's."""
    n = 40
    P_t, g_t = _chain_torch(n)

    def P_one(r, a):         # a per-state torch constructor
        ids, p = P_t(r[None], a)
        return ids[0], p[0]

    built = [
        MDP.from_functions(*_chain_np_vec(n), n, 2, nnz=2, gamma=0.99,
                           vectorized=True).build("cpu"),
        MDP.from_functions(*_chain_scalar(n), n, 2, nnz=2,
                           gamma=0.99).build("cpu"),
        MDP.from_functions(P_t, g_t, n, 2, nnz=2, gamma=0.99,
                           vectorized=True).build("cpu"),
        MDP.from_functions(P_one, lambda r, a: g_t(r, a), n, 2, nnz=2,
                           gamma=0.99, device=True).build("cpu"),
    ]
    ref = tgen.chain_walk(n=n, gamma=0.99)
    for core in built:
        for f in ("idx", "val", "cost"):
            assert torch.equal(getattr(core, f), getattr(ref, f)), f


def test_from_functions_rejects_bad_successors():
    def P_fn(s, a):
        return [s, s + 999], [0.5, 0.5]      # out of range

    mdp = MDP.from_functions(P_fn, lambda s, a: 1.0, 10, 1, nnz=2,
                             gamma=0.9)
    with pytest.raises(ValueError, match="successor ids"):
        mdp.build("cpu")

    def P_t(rows, a):                        # the device pipeline's check
        return (torch.stack([rows, rows + 999], -1),
                torch.full((rows.shape[0], 2), 0.5))

    dmdp = MDP.from_functions(P_t, lambda r, a: torch.ones(r.shape[0]), 10,
                              1, nnz=2, gamma=0.9, vectorized=True)
    with pytest.raises(ValueError, match="successor ids"):
        dmdp.build("cpu")
    with pytest.raises(ValueError, match="successor ids"):
        dmdp.build("cpu", materialize="matrix_free")

    def P_sum(rows, a):
        return (torch.stack([rows, rows], -1),
                torch.full((rows.shape[0], 2), 0.4))

    smdp = MDP.from_functions(P_sum, lambda r, a: torch.ones(r.shape[0]),
                              10, 1, nnz=2, gamma=0.9, vectorized=True)
    with pytest.raises(ValueError, match="sum to"):
        smdp.build("cpu")


def test_from_functions_rejects_successors_in_padding_range():
    """Successor ids in [n, n_pad_to) are rejected too — on a padded
    (sharded) build they would route probability mass into the
    zero-value padding states."""
    def P_fn(s, a):
        return [min(s + 1, 10)], [1.0]       # id 10 == n: out of range

    mdp = MDP.from_functions(P_fn, lambda s, a: 1.0, 10, 1, nnz=1,
                             gamma=0.9)
    with pytest.raises(ValueError, match="successor ids"):
        mdp._block(np.arange(12), np.arange(1), n_pad_to=12, m_pad_to=1)


def test_from_functions_pad_sign_follows_solve_mode():
    """A per-solve mode override flips the never-greedy padding sign of
    both pipelines (padded actions: +BIG under argmin, -BIG under
    argmax)."""
    mdp = MDP.from_functions(*_chain_scalar(8), 8, 2, nnz=2, gamma=0.9)
    _, _, cost = mdp._block(np.arange(8), np.arange(4), n_pad_to=8,
                            m_pad_to=4, mode="maxreward")
    assert (cost[:, 2:] < 0).all()
    _, _, cost = mdp._block(np.arange(8), np.arange(4), n_pad_to=8,
                            m_pad_to=4)
    assert (cost[:, 2:] > 0).all()
    spec = MDP.from_functions(*_chain_torch(8), 8, 2, nnz=2,
                              vectorized=True)._row_spec()
    for mode, sign in (("mincost", 1), ("maxreward", -1)):
        _, _, cost, _ = matrix_free.build_rows_block(
            spec, torch.arange(8, dtype=torch.int32), (0, 1, 2, 3), mode)
        assert (torch.sign(cost[:, 2:]) == sign).all()


def test_pipeline_auto_detection():
    """torch constructors -> device; numpy or Python constructors ->
    host; pins and the option override, and requiring the device
    pipeline of numpy constructors raises with the reason."""
    n = 24
    jm = MDP.from_functions(*_chain_torch(n), n, 2, nnz=2, vectorized=True)
    nm = MDP.from_functions(*_chain_np_vec(n), n, 2, nnz=2, vectorized=True)
    sm = MDP.from_functions(*_chain_scalar(n), n, 2, nnz=2)
    assert jm.materialization() == "device"
    assert nm.materialization() == "host"
    assert sm.materialization() == "host"
    assert jm.materialization("host") == "host"
    with pytest.raises(ValueError, match="not torch functions"):
        nm.materialization("device")
    pinned = MDP.from_functions(*_chain_np_vec(n), n, 2, nnz=2,
                                vectorized=True, device=True)
    with pytest.raises(ValueError, match="not torch functions"):
        pinned.build("cpu")
    off = MDP.from_functions(*_chain_torch(n), n, 2, nnz=2,
                             vectorized=True, device=False)
    assert off.materialization("device") == "host"
    with pytest.raises(ValueError, match="unknown materialization"):
        jm.materialization("lazy")
    with pytest.raises(ValueError, match="function-backed"):
        MDP.from_generator("chain_walk", n=10).materialization()


def test_matrix_free_rules():
    """numpy constructors cannot be rerun inside a backup; auto never
    picks matrix-free; a host pin wins; the container is O(n)."""
    with pytest.raises(ValueError, match="torch"):
        MDP.from_functions(*_chain_np_vec(64), 64, 2, nnz=2,
                           vectorized=True).materialization("matrix_free")
    mdp = MDP.from_generator("chain_walk", deferred=True,
                             **FAMS["chain_walk"])
    assert mdp.materialization() == "device"
    assert mdp.materialization("matrix_free") == "matrix_free"
    fam = dict(tgen.FN_REGISTRY["chain_walk"](**FAMS["chain_walk"]))
    assert MDP.from_functions(**fam, device=False).materialization(
        "matrix_free") == "host"
    core = mdp.build("cpu", materialize="matrix_free")
    assert isinstance(core, MatrixFreeMDP)
    assert core.tag.dtype == torch.int8 and core.n_local == 200
    assert core.gamma == 0.95 and core.acts == (0, 1)
    core.validate()
    fam["band"] = -1
    with pytest.raises(ValueError, match="band"):
        MDP.from_functions(**fam)
    with pytest.raises(ValueError, match="unknown generator"):
        MDP.from_generator("nope", deferred=True)
    with pytest.raises(ValueError, match="core container"):
        MDP.from_generator("chain_walk", deferred=True, n=10).core


# --------------------------------------------------------------------------- #
# Band metadata, fleets and the session                                       #
# --------------------------------------------------------------------------- #

def test_band_metadata_drives_partition_planning():
    """No table to measure: margins and reach come from the declared
    band — sis is birth-death (band=1), garnet declares none."""
    sis = MDP.from_generator("sis", deferred=True, pop=149,
                             n_actions=4).build(
        "cpu", materialize="matrix_free")           # n = 150
    assert sis.spec.band == 1
    assert partition.overlap_margins(sis, 5) == (1, 1)
    assert partition.frontier_reach(sis, 5) == 1
    assert partition.overlap_margins(sis, 1) is None
    _, gar = _port_pair("garnet")
    assert gar.spec.band is None
    assert partition.overlap_margins(gar, 5) is None
    assert partition.frontier_reach(gar, 5) is None
    with pytest.raises(ValueError, match="declared matrix"):
        _validate_banded(gar, 2, Axes(), None)
    maze = MDP.from_generator("maze2d", deferred=True, size=6).build(
        "cpu", materialize="matrix_free")           # band 6
    _validate_banded(maze, 6, Axes(), None)
    with pytest.raises(ValueError, match="exceeds halo"):
        _validate_banded(maze, 5, Axes(), None)


def test_halo_on_one_device_is_the_gathered_solve():
    """-halo at the declared band and -comm_overlap: bit for bit."""
    mat, mf = _port_pair("maze2d")
    base = TOpts(**_opts("vi"))
    ref = tdriver.solve(mat, base, device="cpu")
    for extra in (dict(halo=12), dict(comm_overlap="on")):
        _same(ref, tdriver.solve(mf, TOpts(**_opts("vi", **extra)),
                                 device="cpu"))


def test_stack_requires_one_spec():
    _, a = _port_pair("chain_walk")
    _, b = _port_pair("chain_walk")
    stacked = stack_mdps([a, b])
    assert stacked.batch == 2 and tuple(stacked.tag.shape) == (2, 200)
    assert stacked.instance(1).spec == a.spec
    other = MDP.from_generator("chain_walk", deferred=True, n=150).build(
        "cpu", materialize="matrix_free")
    with pytest.raises(ValueError, match="one row spec"):
        stack_mdps([a, other])


def test_gamma_sweep_lanes_are_their_solo_solves():
    """A gamma sweep over one constructor pair: one spec, each chunk
    rebuilt once for the lanes; each lane bit for bit its solo
    materialized solve, through solve_many and Session.solve_fleet."""
    gammas = (0.8, 0.9, 0.95)
    mdps = [MDP.from_generator("chain_walk", deferred=True, n=100, gamma=g)
            for g in gammas]
    opts = TOpts(method="vi", atol=1e-7, max_outer=3000, dtype="float64")
    cores = [m.build("cpu", materialize="matrix_free") for m in mdps]
    assert len({c.spec for c in cores}) == 1
    rs = tdriver.solve_many(cores, opts, device="cpu")
    with Session({"-device": "cpu", "-method": "vi", "-atol": 1e-7,
                  "-dtype": "float64", "-max_outer": 3000,
                  "-mdp_materialize": "matrix_free"}) as s:
        fleet = s.solve_fleet(mdps)
    for m, r, f in zip(mdps, rs, fleet):
        solo = tdriver.solve(m.build("cpu", materialize="device"), opts,
                             device="cpu")
        _same(r, solo)
        _same(f, solo)


def test_session_solves_matrix_free_and_frees_it_on_close():
    fam = FAMS["chain_walk"]
    s = Session({"-device": "cpu", "-method": "vi", "-atol": 1e-7,
                 "-mdp_materialize": "matrix_free"})
    mdp = MDP.from_generator("chain_walk", deferred=True, **fam)
    r = s.solve(mdp)
    key = ("built", "matrix_free", torch.device("cpu"))
    assert key in mdp._device_cache and r.converged
    ref = Session({"-device": "cpu", "-method": "vi", "-atol": 1e-7,
                   "-mdp_materialize": "device"}).solve(
        MDP.from_generator("chain_walk", deferred=True, **fam))
    _same(r, ref)
    s.close()
    assert key not in mdp._device_cache
    assert mdp.evict(builders=True) == 0
