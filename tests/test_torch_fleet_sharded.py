"""Fleet-sharded solves of the torch port on gloo ranks, against the port's
one-device ``solve_many`` and the JAX reference on the same mesh shapes.

One module fixture runs everything once, each launch with a timeout:

* a world of 4 gloo ranks (``torchrun --standalone``) that solves every
  case below and pickles each rank's results: ``fleet`` on ``(4, 1)``
  (instances over all four ranks) and ``(2, 2)`` (two fleet slices of two
  state shards), ``fleet2d`` on ``(2, 1, 2)`` (actions over the last
  axis), and the fleet replicated over ``1d`` ``(4, 1)`` and ``2d``
  ``(2, 2)``;
* the JAX reference on 4 forced host devices (a subprocess, as the
  reference's own fleet tests run), on the same mesh shapes;
* the port's one-device solves, in this process while the others run.

Cases, after ``tests/test_fleet.py``: B = 5 garnets ``(120, 5, 4, 0.95)``
(so a 4-way fleet axis pads with 3 dummy lanes) under ``vi`` and f64
``ipi_gmres`` to 1e-8 on every layout; a mixed-gamma fleet; ``pad_fleet=
False`` raising before any device work; a dense fleet; function-backed
fleets through ``place_function_fleet`` (a ``Session``'s auto layout,
twice: its fleet cache misses, then hits); a matrix-free gamma sweep
under ``fleet``; one monitor record per outer step (stream and chunk);
the span criterion, on garnets and on chain walks of non-divisible
``n``; a user-registered KSP chosen by ``-ksp_type``; ``Session.
solve_fleet`` under a forced ``-layout fleet -fleet 2``; the CLI under
the world with ``--batch 5 --layout fleet2d --fleet 2``; and a ``Server``
whose rank 0 takes 10 requests from 4 client threads (the port of the
reference's ``test_serve_fleet_sharded_subprocess``).

Each case is held two ways:

* against the port's one-device ``solve_many``: ``vi`` bit for bit;
  Krylov methods with the same policy and outer / inner counts, values
  within ``1e-10 |v|_inf`` (the lanes' and shards' sums group
  differently);
* against the reference's fleet-sharded solve on the same shape: the
  same policy and outer count per lane, inner counts equal on garnet.
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

from repro_torch.core import driver as tdriver
from repro_torch.core import generators as tgen
from repro_torch.core import methods as tmethods
from repro_torch.core.ipi import IPIOptions as TOpts
from repro_torch.core.solvers import richardson as trich

SRC = Path(__file__).resolve().parent.parent / "src"
TIMEOUT = 300           # seconds, each launch
WORLD = 4
_LAUNCHED = []          # the fixture's launches, stopped when it ends

GARNET = dict(n=120, m=5, k=4, gamma=0.95)
SEEDS = range(5)
METHODS = {"vi": dict(method="vi", atol=1e-8, dtype="float64",
                      max_outer=20000),
           "ipi_gmres": dict(method="ipi_gmres", atol=1e-8,
                             dtype="float64", max_outer=20000)}
# (tag, layout, mesh shape) of the fleet's layouts over the 4 ranks
LAYOUTS = [("fleet", "fleet", (4, 1)), ("fleet22", "fleet", (2, 2)),
           ("fleet2d", "fleet2d", (2, 1, 2)), ("1d", "1d", (4, 1)),
           ("2d", "2d", (2, 2))]
MIXED = dict(n=100, m=5, k=4, seed=1, gammas=(0.9, 0.95, 0.98, 0.99))
MIXED_OPTS = dict(method="ipi_gmres", atol=1e-9, dtype="float64")
FN = dict(ns=(300, 280, 300), gamma=0.95)         # chain walks by function
MF = dict(n=200, gammas=(0.9, 0.93, 0.95, 0.97))  # matrix-free sweep
SPAN = dict(method="vi", atol=1e-8, dtype="float64", max_outer=20000,
            stop_criterion="span")
CHAIN = dict(ns=(301, 297), gamma=0.99)           # n not divisible by 2
SERVE_NS = (120, 180, 120, 180, 120, 120, 180, 120, 180, 120)

_WORLD_SCRIPT = r'''
import os, pickle, sys, threading
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.api import MDP, Options, Session
from repro_torch.core import driver, generators, methods, partition
from repro_torch.core.ipi import IPIOptions
from repro_torch.core.mdp import stack_mdps
from repro_torch.core.solvers import richardson
from repro_torch.launch import mesh as lm
from repro_torch.launch import solve as cli
from repro_torch.serve import Server

out_dir = sys.argv[1]
cfg = pickle.loads(bytes.fromhex(sys.argv[2]))
lm.init_distributed("cpu")
rank = dist.get_rank()
meshes = {}
for tag, layout, shape in cfg["layouts"]:
    if layout in partition.FLEET_LAYOUTS:
        meshes[tag] = lm.make_fleet_mesh(shape[0], layout=layout,
                                         device="cpu")
    else:
        meshes[tag] = lm.make_host_mesh(shape, device="cpu")
lay = {tag: layout for tag, layout, _ in cfg["layouts"]}
res = {}


def keep(tag, rs, **extra):
    res[tag] = dict(lanes=[dict(v=r.v, pi=r.policy, outer=r.outer_iterations,
                                inner=r.inner_iterations,
                                converged=r.converged,
                                trace=r.trace_residual,
                                trace_inner=r.trace_inner) for r in rs],
                    **extra)


def many(mdps, mesh_tag, **opts):
    return driver.solve_many(mdps, IPIOptions(**opts), mesh=meshes[mesh_tag],
                             layout=lay[mesh_tag], device="cpu")


g = cfg["garnet"]
mdps = [generators.garnet(seed=s, **g) for s in cfg["seeds"]]
for method, opts in cfg["methods"].items():
    for tag in meshes:
        keep(f"{method}/{tag}", many(mdps, tag, **opts))
mx = cfg["mixed"]
gmdps = [generators.garnet(n=mx["n"], m=mx["m"], k=mx["k"], gamma=gm,
                           seed=mx["seed"]) for gm in mx["gammas"]]
keep("mixed/ipi_gmres", many(gmdps, "fleet", **cfg["mixed_opts"]))
keep("mixed/vi", many(gmdps, "fleet", **cfg["methods"]["vi"]))
try:
    driver.solve_many(mdps, IPIOptions(method="vi", atol=1e-6),
                      mesh=meshes["fleet"], layout="fleet", pad_fleet=False,
                      device="cpu")
    res["pad_error"] = None
except ValueError as e:
    res["pad_error"] = str(e)
dense = [m.as_dense() for m in mdps]
keep("dense/fleet", many(dense, "fleet", **cfg["methods"]["ipi_gmres"]))
keep("dense/fleet2d", many(dense, "fleet2d", **cfg["methods"]["ipi_gmres"]))
# function-backed chain walks through the Session's auto placement (a
# fleet of 3 over 4 ranks: a 2-way fleet axis), twice
fn = cfg["fn"]
fmdps = [MDP.from_generator("chain_walk", deferred=True, n=n,
                            gamma=fn["gamma"]) for n in fn["ns"]]
with Session({"-device": "cpu", "-method": "vi", "-atol": 1e-9,
              "-dtype": "float64", "-max_outer": 20000}) as s:
    keep("fn/fleet", s.solve_fleet(fmdps),
         layout=(s.stats[-1]["layout"], s.stats[-1]["mesh"]),
         cache_first=dict(s.cache_stats["fleet"]))
    placed = list(s._fleet_cache.values())[0]
    res["fn/fleet"]["placed"] = dict(
        kind=type(placed).__name__, batch=placed.batch,
        lanes_here=placed.block.batch, n_local=placed.block.n_local)
    keep("fn/fleet/again", s.solve_fleet(fmdps),
         cache_second=dict(s.cache_stats["fleet"]))
# a matrix-free gamma sweep under the fleet layout
mf = cfg["mf"]
mfs = [MDP.from_generator("chain_walk", deferred=True, n=mf["n"], gamma=gm)
       for gm in mf["gammas"]]
with Session({"-device": "cpu", "-method": "vi", "-atol": 1e-8,
              "-dtype": "float64", "-max_outer": 20000,
              "-mdp_materialize": "matrix_free", "-layout": "fleet",
              "-fleet": 4}) as s:
    keep("mf/fleet", s.solve_fleet(mfs), layout=s.stats[-1]["layout"])
# monitors: one record a step on rank 0, lanes trimmed to the true B
for tag, mode in (("fleet", "stream"), ("fleet2d", "stream"),
                  ("fleet22", "chunk")):
    recs = []
    rs = driver.solve_many(
        mdps, IPIOptions(monitor=True, monitor_mode=mode,
                         **cfg["methods"]["vi"]),
        mesh=meshes[tag], layout=lay[tag], monitor=recs.append, chunk=7,
        device="cpu")
    keep(f"monitor/{tag}/{mode}", rs,
         ks=[r["k"] for r in recs], rows=[len(r["res"]) for r in recs],
         res=[list(map(float, r["res"])) for r in recs])
keep("span/fleet", many(mdps, "fleet", **cfg["span"]))
ch = cfg["chain"]
chains = [generators.chain_walk(n, gamma=ch["gamma"]) for n in ch["ns"]]
keep("span/chain/fleet22", many(chains, "fleet22", **cfg["span"]))
keep("span/chain/2d", many(chains, "2d", **cfg["span"]))
# a user KSP chosen through MADUPITE_OPTIONS
methods.register_ksp(
    "fs_rich", lambda mv, b, x0, *, tol, maxiter, axes: richardson(
        mv, b, x0, tol=tol, maxiter=maxiter, axes=axes, omega=0.9))
os.environ["MADUPITE_OPTIONS"] = "-ksp_type fs_rich"
uopts = Options.from_sources(values={"-atol": 1e-8, "-dtype": "float64",
                                     "-max_outer": 20000}).to_ipi()
os.environ.pop("MADUPITE_OPTIONS")
keep("user_ksp/fleet", driver.solve_many(mdps, uopts, mesh=meshes["fleet"],
                                         layout="fleet", device="cpu"),
     method=uopts.method)
methods.unregister_ksp("fs_rich")
with Session({"-device": "cpu", "-layout": "fleet", "-fleet": 2,
              "-method": "ipi_gmres", "-atol": 1e-8, "-dtype": "float64",
              "-max_outer": 20000}) as s:
    keep("session/fleet", s.solve_fleet([MDP(m) for m in mdps]),
         layout=(s.stats[-1]["layout"], s.stats[-1]["mesh"]))
# the CLI in this world: --batch 5 --layout fleet2d --fleet 2
files = {k: os.path.join(out_dir, f"cli_{k}") for k in ("v.npz", "pi.npz")}
rc = cli.main(["--instance", "garnet", "--n", str(g["n"]), "--m",
               str(g["m"]), "--k", str(g["k"]), "--gamma", str(g["gamma"]),
               "--seed", "0", "--batch", str(len(cfg["seeds"])),
               "--layout", "fleet2d", "--fleet", "2", "--device", "cpu",
               "--method", "ipi_gmres", "--atol", "1e-8",
               "--option", f"file_cost={files['v.npz']}",
               "--option", f"file_policy={files['pi.npz']}"])
res["cli"] = dict(rc=rc, files=files)
# the solve server: rank 0 takes 10 requests from 4 client threads
smdps = [MDP.from_generator("garnet", n=n, m=4, k=4, gamma=0.95, seed=i)
         for i, n in enumerate(cfg["serve_ns"])]
with Server({"-device": "cpu", "-method": "vi", "-atol": 1e-8,
             "-dtype": "float64", "-verbose": False,
             "-serve_batch_window": 0.5}) as srv:
    mesh, layout = srv.session.placement(fleet_size=8)
    if rank == 0:
        reqs = [None] * len(smdps)

        def client(i0):
            for i in range(i0, len(smdps), 4):
                reqs[i] = srv.submit(smdps[i])

        ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        rs = [r.result(timeout=240) for r in reqs]
        st = srv.stats()
        keep("serve", rs, layout=layout, dispatches=st["dispatches"],
             completed=st["completed"])
    else:
        try:
            srv.submit(smdps[0])
            res["serve_follower_submit"] = None
        except RuntimeError as e:
            res["serve_follower_submit"] = str(e)
with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
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
from jax.sharding import NamedSharding
from repro.api import MDP, Options, Session, register_ksp
from repro.core import generators, solve_many
from repro.core.generators import chain_walk_functions
from repro.core.ipi import IPIOptions
from repro.core.mdp import stack_mdps
from repro.core.partition import mdp_pspecs, mesh_axes, pad_fleet_dim
from repro.core.solvers import richardson
from repro.launch.mesh import make_fleet_mesh, make_host_mesh

cfg = json.loads(sys.argv[1])
meshes = {"fleet": make_fleet_mesh(4), "fleet22": make_fleet_mesh(2),
          "fleet2d": make_fleet_mesh(2, layout="fleet2d")}
lay = {"fleet": "fleet", "fleet22": "fleet", "fleet2d": "fleet2d"}
out = {}


def keep(tag, rs):
    out[tag] = [dict(pi=np.asarray(r.policy).tolist(),
                     outer=int(r.outer_iterations),
                     inner=int(r.inner_iterations),
                     converged=bool(r.converged)) for r in rs]


def opts(**kw):
    return IPIOptions(impl="xla", **kw)


g = cfg["garnet"]
mdps = [generators.garnet(seed=s, **g) for s in cfg["seeds"]]
for method, kw in cfg["methods"].items():
    for tag in meshes:
        keep(f"{method}/{tag}", solve_many(mdps, opts(**kw),
                                           mesh=meshes[tag],
                                           layout=lay[tag]))
mx = cfg["mixed"]
gmdps = [generators.garnet(n=mx["n"], m=mx["m"], k=mx["k"], gamma=gm,
                           seed=mx["seed"]) for gm in mx["gammas"]]
keep("mixed/ipi_gmres", solve_many(gmdps, opts(**cfg["mixed_opts"]),
                                   mesh=meshes["fleet"], layout="fleet"))
# the reference pads ELL tables only: its dense fleet goes in padded to
# the fleet axis and placed
dense = pad_fleet_dim(stack_mdps([m.as_dense() for m in mdps]), 8)
specs = mdp_pspecs(dense, mesh_axes(meshes["fleet"], "fleet"))
put = lambda a, s: jax.device_put(a, NamedSharding(meshes["fleet"], s))
placed = type(dense)(p=put(dense.p, specs.p), cost=put(dense.cost,
                                                       specs.cost),
                     gamma=dense.gamma, n_global=dense.n_global,
                     m_global=dense.m_global)
keep("dense/fleet", solve_many(placed, opts(**cfg["methods"]["ipi_gmres"]),
                               mesh=meshes["fleet"], layout="fleet",
                               origin=(len(mdps), g["n"])))
fn = cfg["fn"]


def chain_fn(n, gamma):
    spec = chain_walk_functions(n, gamma=gamma)
    return MDP.from_functions(spec["P_fn"], spec["g_fn"], n, 2, nnz=2,
                              gamma=gamma, vectorized=True)


with Session({"-method": "vi", "-atol": 1e-9, "-dtype": "float64",
              "-max_outer": 20000, "-impl": "xla"}) as s:
    keep("fn/fleet", s.solve_fleet([chain_fn(n, fn["gamma"])
                                    for n in fn["ns"]]))
    out["fn/layout"] = [s.stats[-1]["layout"], dict(s.stats[-1]["mesh"])]
mf = cfg["mf"]
with Session({"-method": "vi", "-atol": 1e-8, "-dtype": "float64",
              "-max_outer": 20000, "-impl": "xla",
              "-mdp_materialize": "matrix_free", "-layout": "fleet",
              "-fleet": 4}) as s:
    keep("mf/fleet", s.solve_fleet([chain_fn(mf["n"], gm)
                                    for gm in mf["gammas"]]))
keep("span/fleet", solve_many(mdps, opts(**cfg["span"]),
                              mesh=meshes["fleet"], layout="fleet"))
ch = cfg["chain"]
chains = [generators.chain_walk(n, gamma=ch["gamma"]) for n in ch["ns"]]
keep("span/chain/fleet22", solve_many(chains, opts(**cfg["span"]),
                                      mesh=meshes["fleet22"],
                                      layout="fleet"))
register_ksp("fs_rich", lambda mv, b, x0, *, tol, maxiter, axes: richardson(
    mv, b, x0, tol=tol, maxiter=maxiter, axes=axes, omega=0.9))
uopts = Options.from_sources(values={"-atol": 1e-8, "-dtype": "float64",
                                     "-max_outer": 20000,
                                     "-ksp_type": "fs_rich",
                                     "-impl": "xla"}).to_ipi()
keep("user_ksp/fleet", solve_many(mdps, uopts, mesh=meshes["fleet"],
                                  layout="fleet"))
print("RESULT " + json.dumps(out))
'''


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
    for key in ("WORLD_SIZE", "MADUPITE_OPTIONS"):
        env.pop(key, None)
    return env


def _wait(proc, what, deadline):
    try:
        out, err = proc.communicate(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{what} timed out:\n{err[-3000:]}")
    return proc.returncode, out, err


def _many(mdps, **opts):
    return tdriver.solve_many(mdps, TOpts(**opts), device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    try:
        yield _launch_all(tmp_path_factory.mktemp("fleet_sharded"))
    finally:
        _stop_all()


def _launch_all(tmp):
    deadline = time.time() + TIMEOUT
    cfg = dict(garnet=GARNET, seeds=list(SEEDS), methods=METHODS,
               layouts=LAYOUTS, mixed=MIXED, mixed_opts=MIXED_OPTS, fn=FN,
               mf=MF, span=SPAN, chain=CHAIN, serve_ns=SERVE_NS)
    ref = _spawn([sys.executable, "-c", _JAX_SCRIPT, json.dumps(cfg)],
                 JAX_PLATFORMS="cpu")
    script = tmp / "world.py"
    script.write_text(_WORLD_SCRIPT)
    world = _spawn(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), str(script), str(tmp),
         pickle.dumps(cfg).hex()])

    # the port's one-device solves, while the ranks work
    mdps = [tgen.garnet(seed=s, **GARNET) for s in SEEDS]
    single = {m: _many(mdps, **opts) for m, opts in METHODS.items()}
    gmdps = [tgen.garnet(n=MIXED["n"], m=MIXED["m"], k=MIXED["k"], gamma=g,
                         seed=MIXED["seed"]) for g in MIXED["gammas"]]
    single["mixed/ipi_gmres"] = _many(gmdps, **MIXED_OPTS)
    single["mixed/vi"] = _many(gmdps, **METHODS["vi"])
    single["dense"] = _many([m.as_dense() for m in mdps],
                            **METHODS["ipi_gmres"])
    single["fn"] = _many([tgen.chain_walk(n, gamma=FN["gamma"])
                          for n in FN["ns"]], method="vi", atol=1e-9,
                         dtype="float64", max_outer=20000)
    single["mf"] = [tdriver.solve(tgen.chain_walk(MF["n"], gamma=g),
                                  TOpts(**METHODS["vi"]), device="cpu")
                    for g in MF["gammas"]]
    single["span"] = _many(mdps, **SPAN)
    chains = [tgen.chain_walk(n, gamma=CHAIN["gamma"]) for n in CHAIN["ns"]]
    single["span/chain"] = _many(chains, **SPAN)
    tmethods.register_ksp(
        "fs_rich", lambda mv, b, x0, *, tol, maxiter, axes: trich(
            mv, b, x0, tol=tol, maxiter=maxiter, axes=axes, omega=0.9))
    try:
        single["user_ksp"] = _many(mdps, method="ipi_fs_rich", atol=1e-8,
                                   dtype="float64", max_outer=20000)
    finally:
        tmethods.unregister_ksp("fs_rich")
    smdps = [tgen.garnet(n=n, m=4, k=4, gamma=0.95, seed=i)
             for i, n in enumerate(SERVE_NS)]
    single["serve"] = [tdriver.solve(m, TOpts(**METHODS["vi"]),
                                     device="cpu") for m in smdps]

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


def _bits(x):
    return np.asarray(x).view(np.uint64)


def _held(got, want, *, bitwise: bool, rtol: float = 1e-10):
    """Lane by lane: the same policy and counts; values bit for bit, or
    within ``rtol |v|_inf``."""
    assert len(got["lanes"]) == len(want)
    for g, w in zip(got["lanes"], want):
        assert g["converged"] and w.converged
        np.testing.assert_array_equal(g["pi"], w.policy)
        assert (g["outer"], g["inner"]) == (w.outer_iterations,
                                             w.inner_iterations)
        if bitwise:
            assert np.array_equal(_bits(g["v"]), _bits(w.v))
            assert np.array_equal(g["trace"], w.trace_residual,
                                  equal_nan=True)
        else:
            scale = float(np.abs(w.v).max())
            assert float(np.abs(g["v"] - w.v).max()) <= rtol * scale


def _held_ref(got, ref, *, inner: bool = True):
    """Lane by lane: the reference's policy and outer count (and inner
    count)."""
    assert len(got["lanes"]) == len(ref)
    for g, r in zip(got["lanes"], ref):
        assert r["converged"]
        np.testing.assert_array_equal(g["pi"], r["pi"])
        assert g["outer"] == r["outer"]
        if inner:
            assert g["inner"] == r["inner"]


def test_every_rank_returns_the_same_bits(runs):
    first = runs["ranks"][0]
    assert len(first) >= 25
    for other in runs["ranks"][1:]:
        for tag, r in first.items():
            if not isinstance(r, dict) or "lanes" not in r \
                    or tag == "serve":
                continue
            for a, b in zip(r["lanes"], other[tag]["lanes"]):
                assert np.array_equal(_bits(a["v"]), _bits(b["v"])), tag
                assert np.array_equal(a["pi"], b["pi"]), tag
                assert (a["outer"], a["inner"]) == (b["outer"],
                                                    b["inner"]), tag


@pytest.mark.parametrize("tag", [t for t, _, _ in LAYOUTS])
@pytest.mark.parametrize("method", list(METHODS))
def test_garnet_fleet_matches_one_device_and_reference(runs, method, tag):
    """B = 5 over every layout: vi bit for bit the one-device fleet,
    ipi_gmres with its counts and policy; the reference's counts and
    policies on the fleet meshes (dummy lanes never leak: 5 results)."""
    got = runs["ranks"][0][f"{method}/{tag}"]
    _held(got, runs["single"][method], bitwise=method == "vi")
    if tag.startswith("fleet"):
        _held_ref(got, runs["ref"][f"{method}/{tag}"])


@pytest.mark.parametrize("method", ["vi", "ipi_gmres"])
def test_mixed_gamma_fleet(runs, method):
    got = runs["ranks"][0][f"mixed/{method}"]
    _held(got, runs["single"][f"mixed/{method}"], bitwise=method == "vi")
    if method == "ipi_gmres":
        _held_ref(got, runs["ref"]["mixed/ipi_gmres"])


def test_pad_fleet_disabled_raises_actionable(runs):
    msg = runs["ranks"][0]["pad_error"]
    assert msg is not None, "pad_fleet=False did not raise"
    assert "B=5" in msg and "4-way" in msg and "pad_fleet" in msg, msg


@pytest.mark.parametrize("tag", ["fleet", "fleet2d"])
def test_dense_fleet(runs, tag):
    got = runs["ranks"][0][f"dense/{tag}"]
    _held(got, runs["single"]["dense"], bitwise=False)
    if tag == "fleet":
        _held_ref(got, runs["ref"]["dense/fleet"])


def test_function_backed_fleet_places_each_ranks_lanes(runs):
    """The Session's auto placement of 3 function-backed chain walks over
    4 ranks: the fleet layout on a 2-way fleet axis, each rank building
    2 lanes of 150 states (never the fleet, never all states), results
    bit for bit the one-device fleet of host-built instances and trimmed
    to each true n; the fleet cache misses, then hits."""
    got = runs["ranks"][0]["fn/fleet"]
    assert got["layout"] == ("fleet", {"fleet": 2, "data": 2})
    assert runs["ref"]["fn/layout"] == ["fleet", {"fleet": 2, "data": 2}]
    assert got["placed"] == dict(kind="FleetBlock", batch=4, lanes_here=2,
                                 n_local=150)
    assert [len(lane["v"]) for lane in got["lanes"]] == list(FN["ns"])
    _held(got, runs["single"]["fn"], bitwise=True)
    _held_ref(got, runs["ref"]["fn/fleet"])
    again = runs["ranks"][0]["fn/fleet/again"]
    assert got["cache_first"]["misses"] >= 1
    assert got["cache_first"]["hits"] == 0
    assert again["cache_second"]["hits"] >= 1
    _held(again, runs["single"]["fn"], bitwise=True)


def test_matrix_free_fleet_layout(runs):
    got = runs["ranks"][0]["mf/fleet"]
    assert got["layout"] == "fleet"
    _held(got, runs["single"]["mf"], bitwise=True)
    _held_ref(got, runs["ref"]["mf/fleet"])


@pytest.mark.parametrize("tag", ["fleet/stream", "fleet2d/stream",
                                 "fleet22/chunk"])
def test_monitor_one_record_per_outer_step(runs, tag):
    """One record per outer step on rank 0 (k = 0 included), ks
    contiguous, each carrying the 5 true lanes (not the padded 8); the
    stream and chunk records alike."""
    got = runs["ranks"][0][f"monitor/{tag}"]
    k_max = max(lane["outer"] for lane in got["lanes"])
    assert got["ks"] == list(range(k_max + 1))
    assert set(got["rows"]) == {5}
    _held(got, runs["single"]["vi"], bitwise=True)
    assert got["res"] == runs["ranks"][0]["monitor/fleet/stream"]["res"]
    for other in runs["ranks"][1:]:
        assert other[f"monitor/{tag}"]["ks"] == []


def test_span_criterion_under_fleet_layout(runs):
    got = runs["ranks"][0]["span/fleet"]
    _held(got, runs["single"]["span"], bitwise=True)
    _held_ref(got, runs["ref"]["span/fleet"])
    assert all(s["outer"] < a.outer_iterations for s, a in
               zip(got["lanes"], runs["single"]["vi"]))


@pytest.mark.parametrize("tag", ["fleet22", "2d"])
def test_span_masks_mesh_padding_nondivisible_n(runs, tag):
    """n = 301 and 297 on 2 state shards pad to 302 and 298 states (and
    the fleet to 302): the padded rows' 0 residual stays out of the span,
    so the sharded fleet stops at the one-device fleet's steps."""
    got = runs["ranks"][0][f"span/chain/{tag}"]
    assert [len(lane["v"]) for lane in got["lanes"]] == list(CHAIN["ns"])
    _held(got, runs["single"]["span/chain"], bitwise=True)
    if tag == "fleet22":
        _held_ref(got, runs["ref"]["span/chain/fleet22"])


def test_user_registered_ksp_under_fleet_layout(runs):
    got = runs["ranks"][0]["user_ksp/fleet"]
    assert got["method"] == "ipi_fs_rich"
    _held(got, runs["single"]["user_ksp"], bitwise=False)
    _held_ref(got, runs["ref"]["user_ksp/fleet"])


def test_session_solve_fleet_under_a_mesh(runs):
    got = runs["ranks"][0]["session/fleet"]
    assert got["layout"] == ("fleet", {"fleet": 2, "data": 2})
    _held(got, runs["single"]["ipi_gmres"], bitwise=False)


def test_cli_fleet2d_under_the_world(runs):
    cli = runs["ranks"][0]["cli"]
    assert cli["rc"] == 0
    want = runs["single"]["ipi_gmres"]
    with np.load(cli["files"]["v.npz"]) as zv, \
            np.load(cli["files"]["pi.npz"]) as zp:
        for b, w in enumerate(want):
            np.testing.assert_array_equal(zp[f"instance_{b}"], w.policy)
            scale = float(np.abs(w.v).max())
            assert float(np.abs(zv[f"instance_{b}"] - w.v).max()) <= \
                1e-10 * scale


def test_server_over_the_mesh(runs):
    """10 requests in fewer dispatches, each bit for bit its solo vi
    solve; the other ranks follow and refuse submits."""
    got = runs["ranks"][0]["serve"]
    assert got["layout"] == "fleet"
    assert got["completed"] == 10 and got["dispatches"] < 10
    _held(got, runs["single"]["serve"], bitwise=True)
    for other in runs["ranks"][1:]:
        assert "rank 0 only" in other["serve_follower_submit"]


# --------------------------------------------------------------------------- #
# Rank-free cases (no process group), against the reference's                 #
# --------------------------------------------------------------------------- #

def test_fleet_layout_guards():
    from repro.core import IPIOptions as JOpts, generators as jgen
    from repro.core.driver import solve as jsolve, solve_many as jsolve_many
    mdp = tgen.garnet(n=40, m=3, k=2, gamma=0.9, seed=0)
    jmdp = jgen.garnet(n=40, m=3, k=2, gamma=0.9, seed=0)
    for solve, m, opts in ((tdriver.solve, mdp, TOpts()),
                           (jsolve, jmdp, JOpts())):
        kw = dict(device="cpu") if solve is tdriver.solve else {}
        with pytest.raises(ValueError, match="solve_many"):
            solve(m, opts, layout="fleet", **kw)
    for solve_many, m, opts in ((tdriver.solve_many, mdp, TOpts()),
                                (jsolve_many, jmdp, JOpts())):
        kw = dict(device="cpu") if solve_many is tdriver.solve_many else {}
        with pytest.raises(ValueError, match="mesh"):
            solve_many([m, m], opts, layout="fleet", **kw)


def test_fleet_padded_batch_matches_reference():
    from repro.core.partition import fleet_padded_batch as jpad
    from repro_torch.core.partition import fleet_padded_batch as tpad
    for b, f in ((8, 4), (5, 4), (4, 4), (1, 3), (7, 1)):
        assert tpad(b, f) == jpad(b, f)
        assert tpad(b, f, pad=True) == jpad(b, f, pad=True)
    with pytest.raises(ValueError, match="pad_fleet") as e:
        tpad(5, 4, pad=False)
    with pytest.raises(ValueError) as je:
        jpad(5, 4, pad=False)
    assert str(e.value) == str(je.value)
    assert tpad(4, 4, pad=False) == 4


@pytest.mark.parametrize("kind", ["ell", "ell_shared", "dense"])
def test_pad_fleet_dim_dummy_instances_are_frozen(kind):
    """Dummy lanes carry zero cost and valid probability rows (value 0,
    residual 0 at the zero start, so done at k = 0), the last lane's
    gamma, and leave the real lanes untouched: the reference's padding,
    array for array."""
    import torch
    from repro.core import generators as jgen, stack_mdps as jstack
    from repro.core.partition import pad_fleet_dim as jpad
    from repro_torch.core import ipi as tipi
    from repro_torch.core.comm import Axes
    from repro_torch.core.mdp import gammas_of, stack_mdps
    from repro_torch.core.partition import pad_fleet_dim
    seeds = (0, 0, 0) if kind == "ell_shared" else (0, 1, 2)
    gammas = (0.9, 0.95, 0.99)
    tm = [tgen.garnet(n=30, m=3, k=2, gamma=g, seed=s)
          for s, g in zip(seeds, gammas)]
    jm = [jgen.garnet(n=30, m=3, k=2, gamma=g, seed=s)
          for s, g in zip(seeds, gammas)]
    if kind == "dense":
        tm, jm = [m.as_dense() for m in tm], [m.as_dense() for m in jm]
    st, jst = stack_mdps(tm), jstack(jm)
    padded, jpadded = pad_fleet_dim(st, 4), jpad(jst, 4)
    assert padded.batch == 4
    assert gammas_of(padded) == (0.9, 0.95, 0.99, 0.99)
    fields = ("p", "cost") if kind == "dense" else ("idx", "val", "cost")
    for f in fields:
        np.testing.assert_array_equal(getattr(padded, f).numpy(),
                                      np.asarray(getattr(jpadded, f)))
    assert padded.shared_topology == (kind == "ell_shared")
    assert (padded.cost[3] == 0).all()
    state = tipi.init_state(padded, Axes(), TOpts(dtype="float64"))
    assert bool(state.done[3]) and float(state.res[3]) == 0.0
    assert not torch.equal(state.res[:3], torch.zeros(3, dtype=torch.float64))
    assert pad_fleet_dim(st, 3) is st
    with pytest.raises(ValueError, match="batched"):
        pad_fleet_dim(tm[0], 4)
    with pytest.raises(ValueError, match="down"):
        pad_fleet_dim(st, 2)


def _fake_mesh(shape, names):
    import types
    jm = types.SimpleNamespace(shape=dict(zip(names, shape)),
                               axis_names=names)
    tm = types.SimpleNamespace(shape=tuple(shape), mesh_dim_names=names)
    return jm, tm


@pytest.mark.parametrize("shape,names,layout", [
    ((1, 1), ("fleet", "data"), "fleet"),
    ((4, 2), ("fleet", "data"), "fleet"),
    ((2, 1, 2), ("fleet", "data", "model"), "fleet2d"),
    ((2, 2, 2, 1), ("fleet", "pod", "data", "model"), "fleet2d"),
    ((2, 2), ("data", "model"), "2d")])
def test_mesh_axes_fleet_layouts_match_reference(shape, names, layout):
    """The mesh dimensions each layout shards over (the port's process
    groups are built along them) are the reference's axis names."""
    from repro.core.partition import mesh_axes as jaxes
    from repro.core.partition import padded_extents as jext
    from repro_torch.core import partition as tpart
    jmesh, tmesh = _fake_mesh(shape, names)
    ja = jaxes(jmesh, layout)
    as_tuple = lambda a: () if a is None else ((a,) if isinstance(a, str)
                                               else tuple(a))
    state, action = tpart.layout_dims(tmesh, layout)
    assert state == as_tuple(ja.state) and action == as_tuple(ja.action)
    assert tpart.fleet_dims(tmesh, layout) == as_tuple(ja.fleet)
    for n, m in ((997, 11), (64, 3)):
        assert tpart.padded_extents(tmesh, layout, n, m) == \
            jext(jmesh, ja, n, m)
    for bad in ("nope", "3d"):
        with pytest.raises(ValueError, match="layout"):
            tpart.layout_dims(tmesh, bad)


def test_make_fleet_mesh_shapes_and_errors_match_reference():
    """make_fleet_mesh's shapes and errors over a world of 8, without a
    process group (the shape logic only; the mesh is built where one is
    up)."""
    from unittest import mock
    from repro_torch.launch import mesh as lm
    made = []
    with mock.patch.object(lm, "make_host_mesh",
                           lambda shape, axes, device: made.append(
                               (shape, axes))):
        lm.make_fleet_mesh(4, world=8)
        lm.make_fleet_mesh(2, layout="fleet2d", world=8)
        lm.make_fleet_mesh(4, layout="fleet2d", world=4)
        lm.make_fleet_mesh(1, layout="fleet2d", world=6)
    assert made == [((4, 2), ("fleet", "data")),
                    ((2, 2, 2), ("fleet", "data", "model")),
                    ((4, 1, 1), ("fleet", "data", "model")),
                    ((1, 3, 2), ("fleet", "data", "model"))]
    with pytest.raises(ValueError, match="must divide the device count 8"):
        lm.make_fleet_mesh(3, world=8)
    with pytest.raises(ValueError, match="serves the fleet layouts"):
        lm.make_fleet_mesh(2, layout="1d", world=8)


def test_fleet_lanes_stack_only_their_lanes():
    """A rank's lanes of a ragged fleet: only those instances stacked,
    padded to the fleet's state count, dummies past B (lane 0's
    transitions, zero cost, the last gamma)."""
    from repro_torch.core.mdp import gammas_of
    from repro_torch.core.partition import fleet_lanes
    mdps = [tgen.garnet(n=n, m=3, k=2, gamma=g, seed=i) for i, (n, g) in
            enumerate(((30, 0.9), (40, 0.95), (35, 0.99)))]
    lanes = fleet_lanes(mdps, 2, 4)
    assert lanes.batch == 2 and lanes.n_global == 40
    assert gammas_of(lanes) == (0.99, 0.99)
    np.testing.assert_array_equal(lanes.val[0, :35].numpy(),
                                  mdps[2].val.numpy())
    np.testing.assert_array_equal(lanes.val[1, :30].numpy(),
                                  mdps[0].val.numpy())
    assert (lanes.cost[1] == 0).all()
