"""Sharded matrix-free solves of the torch port on 4 gloo ranks, against
the port's single-device matrix-free solve and the JAX reference's
``shard_map`` on 4 forced host devices.

One module fixture runs everything once, each launch with a timeout:

* a world of 4 gloo ranks (``torchrun --standalone``), which solves every
  case on a ``(4, 1)`` mesh (``1d``) and pickles each rank's results;
* the JAX reference on 4 forced host devices (a subprocess, as the
  reference's own distributed tests run): the same cases on its ``1d``
  mesh;
* the single-device matrix-free solves, in this process.

Cases (trajectories over at most 40 outer steps): sis (pop 333, so n =
334 pads to 336 and the row builder makes the padding rows) with ``vi`` at
``atol=1e-12``, matrix-free and shard-locally materialized
(``-mdp_materialize device`` through a ``Session``); sis (pop 319) under
``-halo 1`` (its declared band) and ``-comm_overlap on`` / ``off``;
maze2d 24 (band 24) with ``ipi_gmres`` at ``1e-8``, matrix-free and
shard-locally materialized, and four ways — ``-halo 0`` / ``24`` x
``-comm_overlap on`` / ``off`` — with ``vi`` and ``mpi``.

Held:

* the backup-only and Richardson paths (``vi``, ``mpi``: no dot products)
  bit for bit the single-device matrix-free solve, every way, with the
  reference's policy and counts; maze2d's ``vi`` bit for bit the
  reference's sharded solve, sis's within two float32 ulps of its largest
  cost over ``1 - gamma`` (the reference's own sharded rebuild holds sis
  costs a ulp off its single-device tables: XLA contracts that cost into
  a fused multiply-add in some fusions only);
* ``ipi_gmres``: bit for bit between the matrix-free and the shard-locally
  materialized solve on the same world; against the single device the
  same policy and outer count (the shards' partial dots add in another
  order, so the inner count may differ), against the reference the same
  policy and counts; values within ``1e-10 |v|_inf`` of both;
* every rank returns the same bits;
* the ``2d`` layout (actions sharded) and ``-halo`` without a declared
  band raise the reference's messages on every rank.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.api import MDP
from repro_torch.core import driver as tdriver
from repro_torch.core.ipi import IPIOptions as TOpts

SRC = Path(__file__).resolve().parent.parent / "src"
TIMEOUT = 300           # seconds, each launch
WORLD = 4
_LAUNCHED = []

SIS = dict(pop=333, n_actions=4, gamma=0.99)
SIS_HALO = dict(pop=319, n_actions=4, gamma=0.99)       # n = 320: 4 x 80
MAZE = dict(size=24, gamma=0.99)                         # band 24
TRAJ = dict(atol=1e-12, max_outer=40, dtype="float64")
SIS_MAX_COST = 2.15        # sis: 2 (full load) + the largest action cost
# (tag, family, family kwargs, method, extra options): every case is
# solved matrix-free on the world, on one device and by the reference
CASES = [("sis/vi", "sis", SIS, "vi", {}),
         ("maze/ipi_gmres", "maze2d", MAZE, "ipi_gmres", {"atol": 1e-8}),
         ("sis/vi/halo", "sis", SIS_HALO, "vi", {"halo": 1}),
         ("sis/vi/overlap_on", "sis", SIS_HALO, "vi", {"comm_overlap": "on"}),
         ("sis/vi/overlap_off", "sis", SIS_HALO, "vi",
          {"comm_overlap": "off"})]
for _m in ("vi", "mpi"):
    for _h in (0, 24):
        for _ov in ("on", "off"):
            CASES.append((f"maze/{_m}/halo{_h}/{_ov}", "maze2d", MAZE, _m,
                          {"halo": _h, "comm_overlap": _ov}))
BITWISE = [c[0] for c in CASES if c[3] != "ipi_gmres"]

_WORLD_SCRIPT = r'''
import pickle, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.api import MDP, Session
from repro_torch.core import driver
from repro_torch.core.ipi import IPIOptions
from repro_torch.launch import mesh as lm

out_dir = sys.argv[1]
cfg = pickle.loads(bytes.fromhex(sys.argv[2]))
lm.init_distributed("cpu")
mesh = lm.make_host_mesh((4, 1), device="cpu")
mesh2d = lm.make_host_mesh((2, 2), device="cpu")
res = {}


def keep(tag, r):
    res[tag] = dict(v=r.v, pi=r.policy, outer=r.outer_iterations,
                    inner=r.inner_iterations, converged=r.converged,
                    trace=r.trace_residual)


def mf(fam, kw):
    return MDP.from_generator(fam, deferred=True, **kw).build(
        "cpu", materialize="matrix_free")


for tag, fam, kw, method, extra in cfg["cases"]:
    keep(tag, driver.solve(mf(fam, kw), IPIOptions(
        method=method, **{**cfg["traj"], **extra}), mesh=mesh, layout="1d",
        device="cpu"))
# the shard-locally materialized solves: each rank builds its own block
for fam, kw, method, atol in (("sis", cfg["sis"], "vi", 1e-12),
                              ("maze2d", cfg["maze"], "ipi_gmres", 1e-8)):
    with Session({"-device": "cpu", "-layout": "1d", "-method": method,
                  "-mdp_materialize": "device", "-atol": atol,
                  "-max_outer": 40, "-dtype": "float64"}) as s:
        keep(f"{fam[:4]}/{method}/materialized", s.solve(
            MDP.from_generator(fam, deferred=True, **kw)))
with Session({"-device": "cpu", "-layout": "1d", "-method": "vi",
              "-mdp_materialize": "matrix_free", "-atol": 1e-12,
              "-max_outer": 40, "-dtype": "float64"}) as s:
    keep("sis/vi/session", s.solve(
        MDP.from_generator("sis", deferred=True, **cfg["sis"])))
errors = {}
for tag, call in (
        ("2d", lambda: driver.solve(mf("sis", cfg["sis"]),
                                    IPIOptions(method="vi"), mesh=mesh2d,
                                    layout="2d", device="cpu")),
        ("halo_no_band", lambda: driver.solve(
            mf("garnet", dict(n=64, m=3, k=2)), IPIOptions(halo=2),
            mesh=mesh, layout="1d", device="cpu"))):
    try:
        call()
        errors[tag] = None
    except ValueError as e:
        errors[tag] = str(e)
res["errors"] = errors
with open(f"{out_dir}/rank{dist.get_rank()}.pkl", "wb") as f:
    pickle.dump(res, f)
lm.shutdown()
'''

_JAX_SCRIPT = r'''
import os, json, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from repro.api import MDP
from repro.core.driver import solve
from repro.core.ipi import IPIOptions
from repro.launch.mesh import mesh_kwargs

cfg = json.loads(sys.argv[1])
mesh = jax.make_mesh((4,), ("data",), **mesh_kwargs(1))
out = {}
for tag, fam, kw, method, extra in cfg["cases"]:
    core = MDP.from_generator(fam, deferred=True, **kw).build("matrix_free")
    r = solve(core, IPIOptions(impl="xla", method=method,
                               **{**cfg["traj"], **extra}), mesh=mesh,
              layout="1d")
    out[tag] = dict(v=np.asarray(r.v).tolist(),
                    pi=np.asarray(r.policy).tolist(),
                    outer=int(r.outer_iterations),
                    inner=int(r.inner_iterations))
print("RESULT " + json.dumps(out))
'''


def _spawn(argv, **env):
    """A launch in a session of its own, so that a timeout or a failed
    check stops its whole process tree."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1", **env)
    env.pop("WORLD_SIZE", None)
    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    _LAUNCHED.append(proc)
    return proc


def _wait(proc, what, deadline):
    try:
        out, err = proc.communicate(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{what} timed out:\n{err[-3000:]}")
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    try:
        yield _launch_all(tmp_path_factory.mktemp("mf_dist"))
    finally:
        for proc in _LAUNCHED:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        _LAUNCHED.clear()


def _launch_all(tmp):
    deadline = time.time() + TIMEOUT
    cfg = dict(cases=CASES, traj=TRAJ, sis=SIS, maze=MAZE)
    ref = _spawn([sys.executable, "-c", _JAX_SCRIPT, json.dumps(cfg)],
                 JAX_PLATFORMS="cpu")
    script = tmp / "world.py"
    script.write_text(_WORLD_SCRIPT)
    world = _spawn(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), str(script), str(tmp),
         pickle.dumps(cfg).hex()])
    # the single-device matrix-free solves, while the ranks work
    single = {}
    for tag, fam, kw, method, extra in CASES:
        core = MDP.from_generator(fam, deferred=True, **kw).build(
            "cpu", materialize="matrix_free")
        single[tag] = tdriver.solve(core, TOpts(method=method,
                                                **{**TRAJ, **extra}),
                                    device="cpu")
    rc, _, err = _wait(world, "the 4-rank world", deadline)
    assert rc == 0, err[-3000:]
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    rc, out, err = _wait(ref, "the JAX reference", deadline)
    assert rc == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][0]
    return dict(ranks=ranks, single=single,
                ref=json.loads(line[len("RESULT "):]))


def _bits(v):
    return np.asarray(v, np.float64).view(np.uint64)


def _same(got, want):
    assert np.array_equal(_bits(got["v"]), _bits(want.v))
    assert np.array_equal(got["pi"], want.policy)
    assert (got["outer"], got["inner"]) == (want.outer_iterations,
                                            want.inner_iterations)
    assert np.array_equal(got["trace"], want.trace_residual,
                          equal_nan=True)


def test_every_rank_returns_the_same_bits(runs):
    first = runs["ranks"][0]
    assert len(first) == len(CASES) + 4
    for other in runs["ranks"][1:]:
        assert other.keys() == first.keys()
        assert other["errors"] == first["errors"]
        for tag, r in first.items():
            if tag == "errors":
                continue
            o = other[tag]
            assert np.array_equal(_bits(r["v"]), _bits(o["v"])), tag
            assert np.array_equal(r["pi"], o["pi"]), tag
            assert (r["outer"], r["inner"]) == (o["outer"], o["inner"]), tag


@pytest.mark.parametrize("tag", BITWISE)
def test_sharded_matrix_free_is_the_single_device_solve(runs, tag):
    got = runs["ranks"][0][tag]
    assert got["v"].shape == (runs["single"][tag].v.shape[0],)
    _same(got, runs["single"][tag])
    ref = runs["ref"][tag]
    np.testing.assert_array_equal(got["pi"], ref["pi"])
    assert (got["outer"], got["inner"]) == (ref["outer"], ref["inner"])
    if tag.startswith("maze/vi"):
        assert np.array_equal(_bits(got["v"]), _bits(ref["v"]))
    else:
        # sis: XLA contracts the reference's sis cost into a fused
        # multiply-add in some fusions and not in others, so its sharded
        # rebuild holds costs a ulp off its own single-device tables (which
        # the port matches bit for bit): values within two ulps of the
        # largest cost over 1 - gamma, what such a cost perturbation moves
        # a value by
        bound = 2 * np.spacing(np.float32(SIS_MAX_COST)) / (1 - SIS["gamma"])
        assert float(np.abs(got["v"] - np.asarray(ref["v"])).max()) \
            <= bound


def test_maze_four_ways_are_one_solve(runs):
    r = runs["ranks"][0]
    for m in ("vi", "mpi"):
        ways = [r[f"maze/{m}/halo{h}/{ov}"] for h in (0, 24)
                for ov in ("on", "off")]
        for w in ways[1:]:
            assert np.array_equal(_bits(w["v"]), _bits(ways[0]["v"])), m
            assert np.array_equal(w["trace"], ways[0]["trace"],
                                  equal_nan=True)


def test_sharded_gmres_against_materialized_single_and_reference(runs):
    r = runs["ranks"][0]
    got, mat = r["maze/ipi_gmres"], r["maze/ipi_gmres/materialized"]
    assert np.array_equal(_bits(got["v"]), _bits(mat["v"]))
    assert (got["outer"], got["inner"]) == (mat["outer"], mat["inner"])
    one = runs["single"]["maze/ipi_gmres"]
    np.testing.assert_array_equal(got["pi"], one.policy)
    assert got["outer"] == one.outer_iterations
    scale = float(np.abs(one.v).max())
    assert float(np.abs(got["v"] - one.v).max()) <= 1e-10 * scale
    ref = runs["ref"]["maze/ipi_gmres"]
    np.testing.assert_array_equal(got["pi"], ref["pi"])
    assert (got["outer"], got["inner"]) == (ref["outer"], ref["inner"])
    assert float(np.abs(got["v"] - np.asarray(ref["v"])).max()) \
        <= 1e-10 * scale


def test_materialized_and_session_paths_are_the_operator(runs):
    """The shard-locally built tables (each rank its own block, padding
    rows from the row builder) and a Session under -mdp_materialize
    matrix_free give the matrix-free world's vi bits."""
    r = runs["ranks"][0]
    for tag in ("sis/vi/materialized", "sis/vi/session"):
        assert np.array_equal(_bits(r[tag]["v"]), _bits(r["sis/vi"]["v"]))
        assert r[tag]["outer"] == r["sis/vi"]["outer"]
        assert r[tag]["v"].shape == (SIS["pop"] + 1,)


def test_2d_and_bandless_halo_raise_the_reference_messages(runs):
    errors = runs["ranks"][0]["errors"]
    assert "shard states only" in errors["2d"]
    assert "declared matrix bandwidth" in errors["halo_no_band"]


def test_single_device_rejects_a_bandless_halo_too():
    core = MDP.from_generator("garnet", deferred=True, n=64, m=3,
                              k=2).build("cpu", materialize="matrix_free")
    with pytest.raises(ValueError, match="declared matrix bandwidth"):
        tdriver.solve(core, TOpts(halo=2), device="cpu")
