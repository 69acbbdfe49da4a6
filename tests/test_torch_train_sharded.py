"""The torch port's sharded train step on 4 gloo ranks, against the JAX
reference on 4 forced host devices at the same mesh and against the port's
own one-device step.

One module fixture runs everything once, each launch with a timeout:

* the reference's weights of the cases below, drawn here (``init`` of
  the JAX package) and written as ``.npz`` files that both sides read
  (the port through ``repro_torch.models.convert``);
* a world of 4 gloo ranks (``torchrun --standalone``) that places each
  case's model on its mesh (``infer_param_specs``, ``place``), records
  every parameter's and optimizer tensor's placements, local shape and
  bytes, its batch rows, and runs one train step of the global batch,
  counting its collectives by kind, count and bytes
  (:class:`repro_torch.launch.dryrun.StepMeter`, the dry run's counter,
  which ``tests/test_torch_dryrun.py`` holds against a fake world's);
* the reference in a subprocess on 4 forced host devices: ``place`` on
  ``jax.make_mesh``, the jitted ``make_train_step`` on placed inputs;
* meanwhile, the port's one-device step of every case, here, on one
  thread (cases that differ only in their mesh share it).

Cases: the widened dense config (``DENSE``: stablelm's smoke config at
``d_model=512, d_ff=1024, vocab_size=2048``, so that FSDP's threshold is
reached by ``w_up``, ``w_gate``, ``w_down`` and ``embed`` / ``unembed``,
and the vocab splits) with Adam, 2 microbatches and the bf16 accumulator
at ``(4, 1)``, ``(2, 2)`` and ``(pod 2, data 2, model 1)``, and with
Adafactor at ``(2, 2)`` (``wq`` / ``wo`` / the MLP factor over a dim split
over ``model``); olmoe's smoke config at ``vocab_size=128`` (EP: 8
experts over ``model``; the vocab splits) at ``(2, 2)`` and ``(4, 1)``
(the aux losses over ``data``); and, against the port's one-device step
only (the reference's families are held one device against the other in
``tests/test_torch_train_families.py``), mamba2, zamba2 and whisper at
``(2, 2)`` (heads over ``model``), llava at ``(1, 4)`` (2 KV heads do not
split over 4: ``wk`` / ``wv`` gathered, each rank picks the KV head its
query head reads) and arctic at ``(2, 2)`` with Adafactor (EP beside the
dense residual MLP).

Tolerances are ``tests/test_torch_train.py``'s: loss and aux losses 1e-5
relative, the grad norm 2e-4, each weight's update in units of the step's
learning rate (99.9% within 0.1 lr, all within 2.01 lr).  The sharded
sums run in other orders than one device's, as the reference's do.  One
is wider: the widened dense config's grad norm against the reference's,
3e-3.  The jitted reference sums the squares of its 7.3M gradient entries
in one fused f32 loop, whose error grows with the count (the 2e-4 of
``tests/test_torch_train.py`` is for ~1e5 entries): on this step its norm
is 2.4291 at ``(1, 1)``, 2.4297 at ``(4, 1)`` and 2.4300 at ``(2, 2)``,
3.7e-4 apart across its own meshes, and 2.3e-3 below the exact norm of
the port's gradients (2.4348), which the port's one-device step gives to
1e-6 (``test_port_grad_norm_is_the_exact_norm``).
"""

import dataclasses
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import build_model as jbuild_model
from repro_torch import configs as tconfigs
from repro_torch.models import DecoderLM, WhisperModel
from repro_torch.train import optimizer as toptimizer
from repro_torch.train.steps import make_train_step
from test_torch_train import (UPDATE_BULK, UPDATE_MAX, UPDATE_SHARE,
                              _convert, batches)

SRC = Path(__file__).resolve().parent.parent / "src"
TIMEOUT = 600           # seconds, the fixture's launches together
WORLD = 4
BATCH, SEQ, MICRO, STEP = 8, 32, 2, 150
GNORM_TOL = 2e-4
GNORM_WIDE_TOL = 3e-3   # the widened dense config against the reference
DENSE = dict(d_model=512, d_ff=1024, vocab_size=2048)
MOE = dict(vocab_size=128)
DP2 = ((2, 2), ("data", "model"))
# tag -> (arch, override, mesh shape, mesh names, optimizer, reference)
CASES = {
    "dense/4x1": ("stablelm-3b", DENSE, (4, 1), ("data", "model"), "adam",
                  True),
    "dense/2x2": ("stablelm-3b", DENSE, *DP2, "adam", True),
    "dense/pod": ("stablelm-3b", DENSE, (2, 2, 1), ("pod", "data", "model"),
                  "adam", True),
    "adafactor/2x2": ("stablelm-3b", DENSE, *DP2, "adafactor", True),
    "moe/2x2": ("olmoe-1b-7b", MOE, *DP2, "adam", True),
    "moe/4x1": ("olmoe-1b-7b", MOE, (4, 1), ("data", "model"), "adam", True),
    "mamba2/2x2": ("mamba2-130m", {}, *DP2, "adam", False),
    "zamba2/2x2": ("zamba2-1.2b", {}, *DP2, "adam", False),
    "whisper/2x2": ("whisper-base", {}, *DP2, "adam", False),
    "llava/1x4": ("llava-next-34b", {}, (1, 4), ("data", "model"), "adam",
                  False),
    "arctic/2x2": ("arctic-480b", {}, *DP2, "adafactor", False),
}
# the placement cases: every tensor of both optimizers' states
PLACEMENT_MESHES = ("dense/4x1", "dense/2x2", "dense/pod")
_LAUNCHED = []

_WORLD_SCRIPT = r'''
import dataclasses, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticSource
from repro_torch.launch import mesh as lm
from repro_torch.launch import specs as tspecs
from repro_torch.launch.dryrun import StepMeter
from repro_torch.models import DecoderLM, WhisperModel
from repro_torch.models.convert import (lm_params_from_numpy,
                                        whisper_params_from_numpy)
from repro_torch.train import sharding as shd
from repro_torch.train.optimizer import init_opt_state, local
from repro_torch.train.steps import make_train_step

tmp = sys.argv[1]
cfgs = pickle.loads(bytes.fromhex(sys.argv[2]))
lm.init_distributed("cpu")
rank = dist.get_rank()
meshes, out = {}, {}


def tree(path):
    flat = dict(np.load(path))
    nested = {}
    for k, a in flat.items():
        d = nested
        *head, leaf = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[leaf] = a
    return nested


def model_of(case):
    cfg = dataclasses.replace(configs.get_smoke_config(case["arch"]),
                              **case["override"])
    enc = cfg.family == "encdec"
    model = (WhisperModel if enc else DecoderLM)(cfg, device="cpu")
    if case["ref"]:
        conv = whisper_params_from_numpy if enc else lm_params_from_numpy
        model.load_state_dict(conv(tree(f"{tmp}/{case['file']}.npz"), cfg))
    else:
        model.reset_parameters(torch.Generator().manual_seed(0))
    return cfg, model


def describe(t):
    return dict(placements=[repr(p) for p in t.placements],
                local=tuple(local(t).shape), shape=tuple(t.shape),
                bytes=local(t).numel() * local(t).element_size())


for case in cfgs["cases"]:
    key = (case["shape"], case["names"])
    if key not in meshes:
        meshes[key] = lm.make_host_mesh(case["shape"], case["names"],
                                        device="cpu")
    mesh = meshes[key]
    cfg, model = model_of(case)
    tcfg = dataclasses.replace(configs.get_train_config(case["arch"]),
                               optimizer=case["optimizer"])
    specs = shd.infer_param_specs(model, mesh)
    shd.place(model, mesh, specs)
    rec = dict(params={n: describe(p) for n, p in model.named_parameters()})
    if case["tag"] in cfgs["placement"]:
        for opt in ("adam", "adafactor"):
            t2 = dataclasses.replace(tcfg, optimizer=opt)
            st = init_opt_state(model, t2)
            rec[opt] = {f"{k}.{n}": describe(t) for k, d in st.items()
                        for n, t in d.items()}
            ospecs = {k: {n: shd.infer_param_specs(
                {f"{k}.{m}": t.shape for m, t in d.items()}, mesh)[f"{k}.{n}"]
                for n in d} for k, d in st.items()}
            rec[opt + "_bytes"] = tspecs.rank_bytes(model, st, t2, mesh,
                                                    specs, ospecs)
    state = init_opt_state(model, tcfg)
    src = SyntheticSource(cfg.vocab_size, cfgs["seq"] + cfg.n_patches,
                          cfgs["batch"], n_patches=cfg.n_patches,
                          d_model=cfg.d_model,
                          encoder_len=cfg.encoder_len
                          if cfg.family == "encdec" else 0, device="cpu")
    batch = src.next_batch(3)
    rec["rows"] = shd.batch_rows(batch, mesh, cfgs["micro"])["tokens"]
    step = make_train_step(model, tcfg, n_microbatches=cfgs["micro"],
                           mesh=mesh)
    with StepMeter() as meter:
        state, met = step(state, cfgs["step"], batch)
    rec["collectives"] = meter.by_kind()
    rec["metrics"] = {k: float(v) for k, v in met.items()}
    weights = {n: p.detach().full_tensor() for n, p in
               model.named_parameters()}
    if rank == 0:
        rec["weights"] = weights
    out[case["tag"]] = rec
with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
lm.shutdown()
'''

_JAX_SCRIPT = r'''
import os, pickle, sys
# four host devices, each computing on one thread: the tier-1 run shares
# the machine with other test workers
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import dataclasses
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.configs import get_smoke_config, get_train_config
from repro.data.pipeline import SyntheticSource
from repro.launch.mesh import mesh_kwargs
from repro.models import build_model
from repro.train import sharding as shd
from repro.train.optimizer import init_opt_state
from repro.train.steps import make_train_step

tmp = sys.argv[1]
cfgs = pickle.loads(bytes.fromhex(sys.argv[2]))
out = {}


def tree(path):
    flat = dict(np.load(path))
    nested = {}
    for k, a in flat.items():
        d = nested
        *head, leaf = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[leaf] = jnp.asarray(a)
    return nested


for case in cfgs["cases"]:
    if not case["ref"]:
        continue
    cfg = dataclasses.replace(get_smoke_config(case["arch"]),
                              **case["override"])
    tcfg = dataclasses.replace(get_train_config(case["arch"]),
                               optimizer=case["optimizer"])
    model = build_model(cfg)
    mesh = jax.make_mesh(case["shape"], case["names"],
                         **mesh_kwargs(len(case["shape"])))
    params = tree(f"{tmp}/{case['file']}.npz")
    params = shd.place(params, mesh, shd.infer_param_specs(params, mesh))
    opt = init_opt_state(params, tcfg)
    batch = SyntheticSource(cfg.vocab_size, cfgs["seq"], cfgs["batch"],
                            d_model=cfg.d_model).next_batch(3)
    batch = shd.place(batch, mesh, jax.tree.map(
        lambda x: shd.data_spec(mesh, x.ndim), batch))
    step = jax.jit(make_train_step(model, tcfg,
                                   n_microbatches=cfgs["micro"]))
    _, opt, met = step(params, opt, jnp.int32(cfgs["step"]), batch)
    out[case["tag"]] = dict(
        metrics={k: float(v) for k, v in met.items()},
        master=jax.tree.map(np.asarray, opt["master"]))
with open(f"{tmp}/ref.pkl", "wb") as f:
    pickle.dump(out, f)
'''


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               **extra)
    env.pop("WORLD_SIZE", None)
    return env


def _spawn(argv, **env):
    """A launch in a session of its own, so that a timeout or a failed
    check stops its whole process tree (torchrun's workers too)."""
    proc = subprocess.Popen(argv, env=_env(**env), stdout=subprocess.PIPE,
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


def _case(tag):
    arch, override, shape, names, optimizer, ref = CASES[tag]
    return dict(tag=tag, file=tag.replace("/", "_"), arch=arch,
                override=override, shape=shape, names=names,
                optimizer=optimizer, ref=ref)


def _cfg(case):
    return dataclasses.replace(tconfigs.get_smoke_config(case["arch"]),
                               **case["override"])


def _tcfg(case):
    return dataclasses.replace(tconfigs.get_train_config(case["arch"]),
                               optimizer=case["optimizer"])


def _write_reference_weights(tmp, case, params=None):
    """The reference's ``init`` of the case (or ``params``, drawn so for
    a case of the same config), flat ``a/b/c`` keys."""
    if params is None:
        jcfg = dataclasses.replace(jget_smoke(case["arch"]),
                                   **case["override"])
        params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(tmp / f"{case['file']}.npz", **flat)
    return params


def _one_device(case, params):
    """The port's one-device step of the case: metrics and weights."""
    cfg = _cfg(case)
    model = (WhisperModel if cfg.family == "encdec" else DecoderLM)(
        cfg, device="cpu")
    if params is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(_convert(params, cfg))
    tcfg = _tcfg(case)
    state = toptimizer.init_opt_state(model, tcfg)
    _, batch = batches(cfg, BATCH, SEQ)
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, met = make_train_step(model, tcfg, n_microbatches=MICRO)(
        state, STEP, batch)
    return dict(metrics={k: float(v) for k, v in met.items()}, w0=w0,
                weights={n: p.detach().clone()
                         for n, p in model.named_parameters()},
                lr=float(toptimizer._schedule(STEP, tcfg)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    try:
        yield _launch_all(tmp_path_factory.mktemp("train_sharded"))
    finally:
        for proc in _LAUNCHED:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        _LAUNCHED.clear()


def _same_step(case):
    """Cases that differ only in their mesh share one one-device step."""
    return (case["arch"], tuple(sorted(case["override"].items())),
            case["optimizer"], case["ref"])


def _launch_all(tmp):
    deadline = time.time() + TIMEOUT
    cases = [_case(t) for t in CASES]
    drawn = {}
    for c in cases:
        if c["ref"]:
            drawn[_same_step(c)] = _write_reference_weights(
                tmp, c, drawn.get(_same_step(c)))
    params = {c["tag"]: drawn.get(_same_step(c)) for c in cases}
    cfgs = pickle.dumps(dict(cases=cases, placement=PLACEMENT_MESHES,
                             batch=BATCH, seq=SEQ, micro=MICRO,
                             step=STEP)).hex()
    ref = _spawn([sys.executable, "-c", _JAX_SCRIPT, str(tmp), cfgs],
                 JAX_PLATFORMS="cpu")
    script = tmp / "world.py"
    script.write_text(_WORLD_SCRIPT)
    world = _spawn([sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", str(WORLD),
                    str(script), str(tmp), cfgs])
    # one thread here, as in each rank: the world and the reference run
    # beside this process, and the tier-1 run shares the machine
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        steps = {}
        for c in cases:
            if _same_step(c) not in steps:
                steps[_same_step(c)] = _one_device(c, params[c["tag"]])
    finally:
        torch.set_num_threads(threads)
    single = {c["tag"]: steps[_same_step(c)] for c in cases}
    rc, _, err = _wait(world, "the 4-rank world", deadline)
    assert rc == 0, err[-3000:]
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    rc, _, err = _wait(ref, "the JAX reference", deadline)
    assert rc == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return dict(ranks=ranks, single=single, ref=ref)


def _held(met, want, weights, want_w, w0, lr, gnorm_tol=GNORM_TOL):
    """Metrics and updates within the module docstring's tolerances."""
    for k in ("loss", "load_balance_loss", "router_z_loss"):
        assert abs(met[k] - want[k]) <= 1e-5 * abs(want[k]), k
    assert abs(met["grad_norm"] - want["grad_norm"]) <= \
        gnorm_tol * want["grad_norm"]
    for n, w in weights.items():
        base = w0[n].double().numpy()
        du = np.abs((w.double().numpy() - base)
                    - (np.asarray(want_w[n], np.float64) - base)) / lr
        assert np.mean(du <= UPDATE_BULK) >= UPDATE_SHARE, \
            (n, float(np.mean(du <= UPDATE_BULK)))
        assert du.max() <= UPDATE_MAX, (n, float(du.max()))


def _spec_placements(spec, names):
    """The placements a spec asks for: mesh dim ``a`` named at tensor dim
    ``d`` -> ``Shard(dim=d)``, else ``Replicate()``."""
    at = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            at[a] = d
    return [f"Shard(dim={at[n]})" if n in at else "Replicate()"
            for n in names]


def _local_shape(shape, spec, sizes):
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= sizes.get(a, 1)
    return tuple(out)


@pytest.mark.parametrize("tag", PLACEMENT_MESHES)
def test_every_tensor_lies_on_the_reference_spec(runs, tag):
    """Every parameter's and optimizer tensor's placements (and local
    shape) are the reference's spec on the mesh, Adam's and Adafactor's
    state alike; each rank's local bytes are ``rank_bytes``'s."""
    from repro_torch.train.sharding import infer_param_specs
    _, _, shape, names, _, _ = CASES[tag]
    sizes = dict(zip(names, shape))
    for rank in runs["ranks"]:
        rec = rank[tag]
        want = infer_param_specs({n: d["shape"] for n, d in
                                  rec["params"].items()}, sizes)
        for n, d in rec["params"].items():
            assert d["placements"] == _spec_placements(want[n], names), n
            assert d["local"] == _local_shape(d["shape"], want[n], sizes), n
        for opt in ("adam", "adafactor"):
            state = rec[opt]
            want = infer_param_specs({n: d["shape"] for n, d in
                                      state.items()}, sizes)
            for n, d in state.items():
                assert d["placements"] == _spec_placements(want[n],
                                                           names), n
                assert d["local"] == _local_shape(d["shape"], want[n],
                                                  sizes), n
            master = {n[len("master."):]: d for n, d in state.items()
                      if n.startswith("master.")}
            assert {n: d["placements"] for n, d in master.items()} == \
                {n: d["placements"] for n, d in rec["params"].items()}
            got = rec[opt + "_bytes"]
            assert got["params"] == sum(d["bytes"] for d in
                                        rec["params"].values())
            assert got["opt_state"] == sum(d["bytes"] for d in
                                           state.values())
            assert got["total"] == got["params"] + got["opt_state"] + \
                got["grads"]


def test_fsdp_and_vocab_split_reached(runs):
    """The widened config reaches FSDP's threshold and splits the vocab:
    at ``(2, 2)`` ``w_up`` is split over both axes and ``embed`` over
    ``model`` (vocab) and ``data``."""
    params = runs["ranks"][0]["dense/2x2"]["params"]
    assert params["blocks.0.mlp.w_up"]["placements"] == \
        ["Shard(dim=0)", "Shard(dim=1)"]
    assert params["embed"]["placements"] == ["Shard(dim=1)", "Shard(dim=0)"]
    assert params["final_norm"]["placements"] == ["Replicate()"] * 2


@pytest.mark.parametrize("tag", [t for t, c in CASES.items() if c[5]])
def test_sharded_step_matches_reference(runs, tag):
    got = runs["ranks"][0][tag]
    want = runs["ref"][tag]
    cfg = _cfg(_case(tag))
    single = runs["single"][tag]
    _held(got["metrics"], want["metrics"], got["weights"],
          {n: t.numpy() for n, t in _convert(want["master"], cfg).items()},
          single["w0"], single["lr"],
          GNORM_WIDE_TOL if CASES[tag][1] is DENSE else GNORM_TOL)


def test_port_grad_norm_is_the_exact_norm():
    """The port's grad norm (a sum of squares a tensor at a time) is the
    f64 norm of its accumulated gradients, at the widened dense config."""
    from repro_torch.train.steps import accumulate_grads
    case = _case("dense/4x1")
    cfg = _cfg(case)
    model = DecoderLM(cfg, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    tcfg = _tcfg(case)
    _, batch = batches(cfg, BATCH, SEQ)
    grads, _ = accumulate_grads(model, tcfg, batch, n_microbatches=MICRO)
    exact = float(sum((g.double() ** 2).sum() for g in grads.values())) \
        ** 0.5
    _, gnorm = toptimizer.apply_updates(
        model, grads, toptimizer.init_opt_state(model, tcfg), STEP, tcfg)
    assert abs(float(gnorm) - exact) <= 1e-6 * exact


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_step_matches_one_device(runs, tag):
    got = runs["ranks"][0][tag]
    single = runs["single"][tag]
    _held(got["metrics"], single["metrics"], got["weights"],
          {n: t.numpy() for n, t in single["weights"].items()},
          single["w0"], single["lr"])
    if CASES[tag][0] in ("olmoe-1b-7b", "arctic-480b"):
        assert got["metrics"]["load_balance_loss"] > 0


@pytest.mark.parametrize("tag", list(CASES))
def test_every_rank_has_the_same_metrics(runs, tag):
    first = runs["ranks"][0][tag]["metrics"]
    for other in runs["ranks"][1:]:
        assert other[tag]["metrics"] == first


@pytest.mark.parametrize("tag", ["dense/4x1", "dense/2x2", "dense/pod"])
def test_batch_rows_follow_the_microbatch_grouping(runs, tag):
    """Rank ``k`` of the batch axes holds rows ``[k b, (k + 1) b)`` of each
    global microbatch (the reference's ``reshape(n, B / n, ...)``), ``b =
    B / (n dp)``, microbatch by microbatch."""
    _, _, shape, names, _, _ = CASES[tag]
    sizes = dict(zip(names, shape))
    dp = sizes["data"] * sizes.get("pod", 1)
    cfg = _cfg(_case(tag))
    jb, _ = batches(cfg, BATCH, SEQ)
    mbs = np.asarray(jb["tokens"]).reshape(MICRO, BATCH // MICRO, -1)
    b = BATCH // (MICRO * dp)
    for r, rank in enumerate(runs["ranks"]):
        coord = np.unravel_index(r, shape)
        k = int(np.ravel_multi_index(
            [coord[names.index(a)] for a in names if a != "model"],
            [sizes[a] for a in names if a != "model"]))
        want = np.concatenate([mbs[i, k * b:(k + 1) * b]
                               for i in range(MICRO)])
        assert np.array_equal(rank[tag]["rows"].numpy(), want), r


@pytest.mark.parametrize("tag", list(CASES))
def test_every_rank_counts_the_same_collectives(runs, tag):
    """The dry run's counter on the step: every rank issues the same
    collectives (kinds, counts and bytes), and each step sums gradients
    or statistics over ranks (a reduce-scatter or an all-reduce), each
    kind counted with its bytes."""
    first = runs["ranks"][0][tag]["collectives"]
    for other in runs["ranks"][1:]:
        assert other[tag]["collectives"] == first
    nbytes, counts = first
    assert counts["reduce-scatter"] + counts["all-reduce"] > 0
    assert all((counts[k] > 0) == (nbytes[k] > 0) for k in counts)

