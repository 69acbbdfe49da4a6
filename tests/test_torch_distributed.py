"""Sharded solves of the torch port on gloo ranks, against the port's
single-device solve and the JAX reference on the same mesh shapes.

One module fixture runs everything once, each launch with a timeout:

* a world of 4 gloo ranks (``torchrun --standalone``: its rendezvous
  takes a free port), which solves every case below on a ``(4, 1)`` mesh
  (``1d``: states over both axes, the world group) or a ``(2, 2)`` mesh
  (``2d``: states over ``data``, actions over ``model``), and pickles
  each rank's results;
* the JAX reference on 4 forced host devices (a subprocess, as the
  reference's own distributed tests run), on the same mesh shapes;
* the CLI under ``torchrun --nproc-per-node 2 ... --device cpu``, once to
  convergence and once stopped at ``--max-outer 3`` with ``--ckpt-dir``
  (a checkpoint written at world 2, which the world of 4 and a
  single-device solve resume).

Cases: garnet (997, 11, 6, gamma 0.99) with f64 ``ipi_gmres`` to 1e-8,
ELL and ``as_dense()``, ``1d`` and ``2d``, ``1d`` with
``-deterministic_dots`` (twice), and ``2d`` over a 3-axis mesh; maze2d
24 under ``-halo 24``; ``-comm_overlap on`` against ``off`` on
chain_walk 512 and maze2d 24 (the instances of
``tests/test_async.py``: the trajectories at ``atol=1e-12`` of ``vi``
over 40 outer steps, ``mpi`` over 8, GMRES over 3); ``async_vi`` with 8
sweeps, and with 1 against ``vi`` over 300 steps; the resumed
checkpoint; ``Session.solve`` with ``-layout 2d``.

Each case is held two ways:

* against the port's single-device solve: the same policy and outer
  count, values within ``1e-10 |v|_inf`` (the shards' partial dots add in
  another order than one device's);
* against the reference: the same policy and outer count, inner counts
  equal on garnet and maze2d.

GMRES on the ill-conditioned chain is held within ROADMAP queue 3's gaps
on that family: its outer count may differ by one from one device's
(with the reference's, it must not) and its inner count by 25% from the
reference's.

Every rank returns the same bits, ``-comm_overlap on`` is bit for bit
``off``, and the deterministic dots give the same bits on a rerun.
"""

import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core.ipi import IPIOptions as TOpts

SRC = Path(__file__).resolve().parent.parent / "src"
TIMEOUT = 300           # seconds, each launch
WORLD = 4
_LAUNCHED = []          # the fixture's launches, stopped when it ends

GARNET = dict(n=997, m=11, k=6, gamma=0.99, seed=7)
GMRES = dict(method="ipi_gmres", atol=1e-8, dtype="float64")
# the overlap pairs: the unconverged trajectory at atol 1e-12, as the
# reference's test_async.py runs it: vi over 40 outer steps, mpi over 8,
# GMRES over 3 (~500 inner steps on the chain)
PAIR = {"vi": dict(atol=1e-12, max_outer=40), "mpi": dict(atol=1e-12,
        max_outer=8), "ipi_gmres": dict(atol=1e-12, max_outer=3)}
ASYNC = dict(atol=1e-6, stop_criterion="span", dtype="float64",
             max_outer=20000)
# (tag, instance, method, layout, extra options) of the overlap pairs
PAIRS = [("chain/vi/1d", "chain", "vi", "1d", {}),
         ("chain/mpi/1d", "chain", "mpi", "1d", {}),
         ("chain/ipi_gmres/1d", "chain", "ipi_gmres", "1d", {}),
         ("maze/vi/1d", "maze", "vi", "1d", {}),
         ("maze/vi/halo", "maze", "vi", "1d", {"halo": 24})]

_WORLD_SCRIPT = r'''
import os, pickle, sys, time
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.api import MDP, Session
from repro_torch.core import driver, generators
from repro_torch.core.ipi import IPIOptions
from repro_torch.launch import mesh as lm

out_dir, ck = sys.argv[1], sys.argv[2]
cfg = pickle.loads(bytes.fromhex(sys.argv[3]))
lm.init_distributed("cpu")
meshes = {"1d": lm.make_host_mesh((4, 1), device="cpu"),
          "2d": lm.make_host_mesh((2, 2), device="cpu")}
res = {}


def keep(tag, r):
    res[tag] = dict(v=r.v, pi=r.policy, outer=r.outer_iterations,
                    inner=r.inner_iterations, converged=r.converged,
                    trace=r.trace_residual, gap=r.gap_bound)


def solve(tag, mdp, layout, **opts):
    keep(tag, driver.solve(mdp, IPIOptions(**opts), mesh=meshes[layout],
                           layout=layout, device="cpu"))


garnet = generators.garnet(**cfg["garnet"])
inst = {"chain": generators.chain_walk(512, gamma=0.99),
        "maze": generators.maze2d(24, gamma=0.99)}
for lay in ("1d", "2d"):
    solve(f"garnet/ell/{lay}", garnet, lay, **cfg["gmres"])
    solve(f"garnet/dense/{lay}", garnet.as_dense(), lay, **cfg["gmres"])
solve("garnet/det/1d", garnet, "1d", deterministic_dots=True,
      **cfg["gmres"])
solve("garnet/det/1d/again", garnet, "1d", deterministic_dots=True,
      **cfg["gmres"])
# 2d over a 3-axis mesh: states over (pod, data), actions over model --
# the (2, 2) mesh's shards, through groups built from the mesh's ids
meshes["2d3"] = lm.make_host_mesh((2, 1, 2), ("pod", "data", "model"),
                                  device="cpu")
keep("garnet/ell/2d3", driver.solve(garnet, IPIOptions(**cfg["gmres"]),
                                    mesh=meshes["2d3"], layout="2d",
                                    device="cpu"))
solve("maze/halo", inst["maze"], "1d", method="vi", dtype="float64",
      atol=1e-8, halo=24)
for tag, name, method, lay, extra in cfg["pairs"]:
    for ov in ("off", "on"):
        solve(f"overlap/{tag}/{ov}", inst[name], lay, method=method,
              comm_overlap=ov, dtype="float64", **extra,
              **cfg["pair"][method])
solve("async/8", inst["chain"], "1d", method="async_vi", async_sweeps=8,
      **cfg["async"])
# async_sweeps=1 is vi: 300 steps of both, bit for bit
short = dict(cfg["async"], max_outer=300)
solve("async/1", inst["chain"], "1d", method="async_vi", async_sweeps=1,
      **short)
solve("async/vi", inst["chain"], "1d", method="vi", **short)
# the world-2 checkpoint: the CLI's run writes it while this world starts
deadline = time.time() + 240
while not os.path.exists(ck + ".ready"):
    if time.time() > deadline:
        raise TimeoutError("no world-2 checkpoint")
    time.sleep(0.2)
keep("ckpt/world4", driver.solve(
    garnet, IPIOptions(**cfg["gmres"]), mesh=meshes["1d"], layout="1d",
    checkpoint_dir=ck, device="cpu"))
with Session({"-device": "cpu", "-layout": "2d", "-method": "ipi_gmres",
              "-dtype": "float64", "-atol": 1e-8}) as s:
    keep("session/2d", s.solve(MDP(garnet)))
    res["session/2d"]["layout"] = (s.stats[-1]["layout"],
                                   s.stats[-1]["mesh"])
with open(f"{out_dir}/rank{dist.get_rank()}.pkl", "wb") as f:
    pickle.dump(res, f)
lm.shutdown()
'''

_JAX_SCRIPT = r'''
import os, json, sys
# four host devices, each computing on one thread: the tier-1 run shares
# the machine with other test workers
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import generators
from repro.core.driver import solve
from repro.core.ipi import IPIOptions
from repro.core.mdp import DenseMDP
from repro.core.partition import mesh_axes
from repro.launch.mesh import mesh_kwargs

cfg = json.loads(sys.argv[1])
meshes = {"1d": jax.make_mesh((4, 1), ("data", "model"), **mesh_kwargs(2)),
          "2d": jax.make_mesh((2, 2), ("data", "model"), **mesh_kwargs(2))}
out = {}


def run(tag, mdp, layout, **opts):
    r = solve(mdp, IPIOptions(impl="xla", **opts), mesh=meshes[layout],
              layout=layout)
    # a pre-placed dense MDP reports its padded states too
    n = cfg["garnet"]["n"] if tag.startswith("garnet/") else None
    out[tag] = dict(pi=np.asarray(r.policy)[:n].tolist(),
                    outer=int(r.outer_iterations),
                    inner=int(r.inner_iterations),
                    converged=bool(r.converged))


def placed_dense(layout):
    """The reference's partition pads ELL tables only: its dense mesh
    path takes a dense MDP already padded (zero-cost absorbing states,
    BIG-cost actions to state 0: the ELL padding's as_dense) and
    placed."""
    mesh = meshes[layout]
    axes = mesh_axes(mesh, layout)
    size = lambda a: 1 if a is None else int(np.prod(
        [mesh.shape[x] for x in ((a,) if isinstance(a, str) else a)]))
    ell = generators.garnet(**cfg["garnet"])
    from repro.core.partition import pad_mdp
    pad = pad_mdp(ell, size(axes.state), size(axes.action))
    dense = pad.as_dense()
    spec = P(axes.state, axes.action)
    put = lambda a, s: jax.device_put(a, NamedSharding(mesh, s))
    return DenseMDP(p=put(dense.p, P(axes.state, axes.action, None)),
                    cost=put(dense.cost, spec), gamma=dense.gamma,
                    n_global=dense.n_global, m_global=dense.m_global)


garnet = generators.garnet(**cfg["garnet"])
inst = {"chain": generators.chain_walk(512, gamma=0.99),
        "maze": generators.maze2d(24, gamma=0.99)}
for lay in ("1d", "2d"):
    run(f"garnet/ell/{lay}", garnet, lay, **cfg["gmres"])
    run(f"garnet/dense/{lay}", placed_dense(lay), lay, **cfg["gmres"])
run("garnet/det/1d", garnet, "1d", deterministic_dots=True, **cfg["gmres"])
run("maze/halo", inst["maze"], "1d", method="vi", dtype="float64",
    atol=1e-8, halo=24)
for tag, name, method, lay, extra in cfg["pairs"]:
    run(f"overlap/{tag}/off", inst[name], lay, method=method,
        comm_overlap="off", dtype="float64", **extra, **cfg["pair"][method])
run("async/8", inst["chain"], "1d", method="async_vi", async_sweeps=8,
    **cfg["async"])
print("RESULT " + json.dumps(out))
'''


def _cli(tmp, tag, *extra):
    """The CLI on 2 gloo ranks under torchrun, started (not waited for)."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "repro_torch.launch.solve",
            "--", "--instance", "garnet", "--n", str(GARNET["n"]),
            "--m", str(GARNET["m"]), "--k", str(GARNET["k"]),
            "--gamma", str(GARNET["gamma"]), "--seed", str(GARNET["seed"]),
            "--method", "ipi_gmres", "--atol", "1e-8", "--device", "cpu",
            "--layout", "1d", *extra]
    return _spawn(argv)


def _spawn(argv, **env):
    """A launch in a session of its own, so that a timeout or a failed
    check stops its whole process tree (torchrun's workers too)."""
    proc = subprocess.Popen(argv, env=_env(**env), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    _LAUNCHED.append(proc)
    return proc


def _stop_all():
    for proc in _LAUNCHED:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    _LAUNCHED.clear()


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               **extra)
    env.pop("WORLD_SIZE", None)
    return env


def _wait(proc, what, deadline):
    try:
        out, err = proc.communicate(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{what} timed out:\n{err[-3000:]}")
    return proc.returncode, out, err


def _single(mdp, **opts):
    return tdriver.solve(mdp, TOpts(**opts), device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    try:
        yield _launch_all(tmp_path_factory.mktemp("dist"))
    finally:
        _stop_all()


def _launch_all(tmp):
    deadline = time.time() + TIMEOUT
    cfg = dict(garnet=GARNET, gmres=GMRES, pair=PAIR, pairs=PAIRS,
               **{"async": ASYNC})
    ref = _spawn([sys.executable, "-c", _JAX_SCRIPT, json.dumps(cfg)],
                 JAX_PLATFORMS="cpu")
    files = {k: str(tmp / f"cli_{k}") for k in ("v.npy", "pi.npy",
                                               "stats.jsonl")}
    cli = _cli(tmp, "full", "--option", f"file_cost={files['v.npy']}",
               "--option", f"file_policy={files['pi.npy']}",
               "--option", f"file_stats={files['stats.jsonl']}")
    ck = tmp / "ck"
    script = tmp / "world.py"
    script.write_text(_WORLD_SCRIPT)
    world = _spawn(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), str(script), str(tmp),
         str(tmp / "ck_world"), pickle.dumps(cfg).hex()])
    stopped = _cli(tmp, "ckpt", "--max-outer", "3", "--ckpt-dir", str(ck))
    rc_stop, out_stop, err = _wait(stopped, "CLI --max-outer 3", deadline)
    assert rc_stop == 1, err[-3000:]       # stopped unconverged: exit 1
    ck_single = tmp / "ck_single"
    shutil.copytree(ck, ck_single)
    shutil.copytree(ck, tmp / "ck_world")
    (tmp / "ck_world.ready").touch()

    # the single-device solves, while the ranks work
    garnet = tgen.garnet(**GARNET)
    chain, maze = tgen.chain_walk(512, gamma=0.99), tgen.maze2d(24,
                                                               gamma=0.99)
    inst = {"chain": chain, "maze": maze}
    single = {"garnet/ell": _single(garnet, **GMRES),
              "garnet/dense": _single(garnet.as_dense(), **GMRES),
              "garnet/det": _single(garnet, deterministic_dots=True,
                                    **GMRES),
              "maze/halo": _single(maze, method="vi", dtype="float64",
                                   atol=1e-8),
              "async/8": _single(chain, method="async_vi", async_sweeps=8,
                                 **ASYNC),
              "async/vi": _single(chain, method="vi", **ASYNC),
              "ckpt/single": tdriver.solve(garnet, TOpts(**GMRES),
                                           checkpoint_dir=str(ck_single),
                                           device="cpu")}
    for tag, name, method, _, extra in PAIRS:
        single[f"overlap/{tag}"] = _single(inst[name], method=method,
                                           dtype="float64", **extra,
                                           **PAIR[method])

    rc, _, err = _wait(world, "the 4-rank world", deadline)
    assert rc == 0, err[-3000:]
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    rc_cli, out_cli, err = _wait(cli, "CLI on 2 ranks", deadline)
    assert rc_cli == 0, err[-3000:]
    rc, out, err = _wait(ref, "the JAX reference", deadline)
    assert rc == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][0]
    return dict(ranks=ranks, single=single, cli=out_cli, files=files,
                stopped=out_stop, ref=json.loads(line[len("RESULT "):]))


def _held(got, want, rtol=1e-10, outer_gap=0):
    """Same policy and outer count (within ``outer_gap``), values within
    rtol |v|_inf."""
    np.testing.assert_array_equal(got["pi"], want.policy)
    assert abs(got["outer"] - want.outer_iterations) <= outer_gap
    if not outer_gap:
        assert got["converged"] == want.converged
    scale = float(np.abs(want.v).max())
    assert float(np.abs(got["v"] - want.v).max()) <= rtol * scale


def _held_ref(got, ref, inner_gap=0.0):
    np.testing.assert_array_equal(got["pi"], ref["pi"])
    assert got["outer"] == ref["outer"]
    assert abs(got["inner"] - ref["inner"]) <= inner_gap * ref["inner"]


GARNET_CASES = [f"garnet/{kind}/{lay}" for kind in ("ell", "dense")
                for lay in ("1d", "2d")] + ["garnet/det/1d"]


def test_every_rank_returns_the_same_bits(runs):
    first = runs["ranks"][0]
    assert len(first) >= 20
    for other in runs["ranks"][1:]:
        assert other.keys() == first.keys()
        for tag, r in first.items():
            o = other[tag]
            assert np.array_equal(r["v"].view(np.uint64),
                                  o["v"].view(np.uint64)), tag
            assert np.array_equal(r["pi"], o["pi"]), tag
            assert (r["outer"], r["inner"]) == (o["outer"], o["inner"]), tag


@pytest.mark.parametrize("case", GARNET_CASES)
def test_garnet_matches_single_device_and_reference(runs, case):
    got = runs["ranks"][0][case]
    assert got["converged"] and got["v"].shape == (GARNET["n"],)
    _held(got, runs["single"][case.rsplit("/", 1)[0]])
    _held_ref(got, runs["ref"][case])


def test_2d_over_three_mesh_axes_is_the_2x2_layout(runs):
    r = runs["ranks"][0]
    a, b = r["garnet/ell/2d3"], r["garnet/ell/2d"]
    assert np.array_equal(a["v"].view(np.uint64), b["v"].view(np.uint64))
    assert (a["outer"], a["inner"]) == (b["outer"], b["inner"])


def test_deterministic_dots_repeat_bit_for_bit(runs):
    r = runs["ranks"][0]
    a, b = r["garnet/det/1d"], r["garnet/det/1d/again"]
    assert np.array_equal(a["v"].view(np.uint64), b["v"].view(np.uint64))
    assert np.array_equal(a["trace"], b["trace"])


def test_halo_matches_single_device_and_reference(runs):
    got = runs["ranks"][0]["maze/halo"]
    assert got["converged"]
    _held(got, runs["single"]["maze/halo"])
    _held_ref(got, runs["ref"]["maze/halo"])


@pytest.mark.parametrize("tag", [p[0] for p in PAIRS])
def test_overlap_is_bitwise_invisible(runs, tag):
    r = runs["ranks"][0]
    off, on = r[f"overlap/{tag}/off"], r[f"overlap/{tag}/on"]
    assert np.array_equal(off["v"].view(np.uint64), on["v"].view(np.uint64))
    assert np.array_equal(off["pi"], on["pi"])
    assert np.array_equal(off["trace"], on["trace"], equal_nan=True)
    assert (off["outer"], off["inner"]) == (on["outer"], on["inner"])
    # GMRES on the ill-conditioned chain: the shards' dot order may end it
    # an outer step apart from one device's, and its inner count 25% apart
    # from the reference's (ROADMAP queue 3's gaps); vi and mpi are exact
    krylov = "ipi_gmres" in tag
    _held(off, runs["single"][f"overlap/{tag}"], outer_gap=int(krylov))
    _held_ref(off, runs["ref"][f"overlap/{tag}/off"], 0.25 * krylov)


def test_async_vi_matches_and_certifies(runs):
    r = runs["ranks"][0]
    got, vi = r["async/8"], runs["single"]["async/vi"]
    assert got["converged"] and got["outer"] < vi.outer_iterations
    # the stale sweeps depend on the shard count: the reference on the
    # same mesh gives the same iteration, one device another one with the
    # same policy, each within its certificate of the optimum
    _held_ref(got, runs["ref"]["async/8"])
    one_dev = runs["single"]["async/8"]
    np.testing.assert_array_equal(got["pi"], one_dev.policy)
    assert np.abs(got["v"] - one_dev.v).max() <= \
        got["gap"] + one_dev.gap_bound
    np.testing.assert_array_equal(got["pi"], vi.policy)
    one, vi = r["async/1"], r["async/vi"]
    assert np.array_equal(one["v"].view(np.uint64), vi["v"].view(np.uint64))
    assert np.array_equal(one["trace"], vi["trace"])


def test_world2_checkpoint_resumes_at_world4_and_on_one_device(runs):
    assert "[driver] resumed" not in runs["stopped"]
    full = runs["single"]["garnet/ell"]
    _held(runs["ranks"][0]["ckpt/world4"], full)
    one = runs["single"]["ckpt/single"]
    _held(dict(v=one.v, pi=one.policy, outer=one.outer_iterations,
               converged=one.converged), full)


def test_session_layout_2d(runs):
    got = runs["ranks"][0]["session/2d"]
    _held(got, runs["single"]["garnet/ell"])
    assert got["layout"] == ("2d", {"data": 2, "model": 2})


def test_cli_under_torchrun(runs):
    out = runs["cli"]
    assert "[solve] rank 0 of 2 on cpu" in out
    assert "[solve] rank 1 of 2 on cpu" in out
    assert out.count("(certificate)") == 1 and "layout=1d over 2" in out
    v = np.load(runs["files"]["v.npy"])
    pi = np.load(runs["files"]["pi.npy"])
    full = runs["single"]["garnet/ell"]
    _held(dict(v=v, pi=pi, outer=full.outer_iterations, converged=True),
          full)
    stats = [json.loads(ln) for ln in
             Path(runs["files"]["stats.jsonl"]).read_text().splitlines()]
    assert len(stats) == 1 and stats[0]["layout"] == "1d"
    assert stats[0]["mesh"] == {"data": 2, "model": 1}
    assert stats[0]["solves"][0]["outer_iterations"] == \
        full.outer_iterations
