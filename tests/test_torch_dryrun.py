"""The torch port's dry run (``repro_torch.launch.dryrun``) against the JAX
reference's input specs and against a real world's collectives.

One module fixture launches, each with a timeout, side by side:

* for each production mesh (``pod`` (16, 16), ``multipod`` (2, 16, 16)),
  the port's fake world of 256 or 512 ranks placing every arch x cell's
  inputs (``place_cell``) and recording, as rank 0, each weight's,
  optimizer tensor's, batch leaf's, cache leaf's and decode token's local
  shape;
* the reference's ``launch/specs.py::input_specs`` on
  ``make_production_mesh`` in one subprocess with 512 forced host devices,
  recording each leaf's ``NamedSharding.shard_shape`` (no compile);
* a fake world of 4 ranks at ``(2, 2)`` running the widened dense
  config's train step of ``tests/test_torch_train_sharded.py`` (``DENSE``,
  batch 8, seq 32, 2 microbatches) under the dry run's counter, and that
  module's 4-rank gloo world on the same case, whose worker counts its
  collectives with the same counter;
* the dry-run CLI on one small cell.

The fixture took 73.9 s under the tier-1 run's ``-n 6`` (~70 s alone);
its launches together have ``TIMEOUT``.

The reference stacks a layer group's weights on a leading ``L`` axis; a
port layer's local shape is compared with the stacked shard shape less
that entry, by ``models/convert.py``'s names (``blocks/attn/wq`` is
``blocks.{i}.attn.wq``).
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import test_torch_train_sharded as ts
from repro_torch.configs import ARCHS, cells

SRC = Path(__file__).resolve().parent.parent / "src"
TIMEOUT = 600           # seconds, the fixture's launches together
MESHES = ("pod", "multipod")
CELLS = [(a, s.name) for a in ARCHS for s in cells(a)]
_LAUNCHED = []

_PORT_SCRIPT = r'''
import pickle, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import ARCHS, cells
from repro_torch.launch import dryrun

mesh = dryrun.production_mesh(sys.argv[1])
out = {}
for arch in ARCHS:
    for shape in cells(arch):
        cell = dryrun.place_cell(arch, shape.name, mesh)
        out[(arch, shape.name)] = dict(local=cell["local"],
                                       args=cell["argument_bytes"])
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
'''

_REF_SCRIPT = r'''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import ARCHS, cells
from repro.launch import specs as S
from repro.launch.mesh import make_production_mesh


def shards(tree, prefix=""):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        out[prefix + name] = tuple(leaf.sharding.shard_shape(leaf.shape))
    return out


res = {}
for mesh_name, multi in (("pod", False), ("multipod", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCHS:
        for shape in cells(arch):
            si = S.input_specs(arch, shape.name, mesh)
            rec = {"params": shards(si["params"])}
            if "opt" in si:
                rec["opt"] = shards(si["opt"])
            if "batch" in si:
                rec["batch"] = shards(si["batch"])
            if "cache" in si:
                rec["cache"] = {k: v for k, v in shards(si["cache"]).items()
                                if k != "len"}
                rec["token"] = {"token": tuple(si["token"].sharding
                                               .shard_shape(si["token"].shape))}
            res[(arch, shape.name, mesh_name)] = rec
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''

_FAKE_STEP_SCRIPT = r'''
import dataclasses, pickle, sys
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.launch import dryrun, specs
from repro_torch.models import DecoderLM
from repro_torch.train import sharding as shd
from repro_torch.train.optimizer import init_opt_state, local
from repro_torch.train.steps import make_train_step

case = pickle.loads(bytes.fromhex(sys.argv[2]))
dryrun.join_fake_world(4)
mesh = init_device_mesh("cpu", case["shape"], mesh_dim_names=case["names"])
cfg = dataclasses.replace(configs.get_smoke_config(case["arch"]),
                          **case["override"])
tcfg = dataclasses.replace(configs.get_train_config(case["arch"]),
                           optimizer=case["optimizer"])
mode = dryrun.fake_mode()
with mode:
    model = DecoderLM(cfg, device="cpu")
pspecs = shd.infer_param_specs(model, mesh)
shd.place(model, mesh, pspecs)
with mode:
    opt = init_opt_state(model, tcfg)
    batch = {n: torch.empty((case["batch"], case["seq"]), dtype=torch.int32)
             for n in ("tokens", "labels")}
    step = make_train_step(model, tcfg, n_microbatches=case["micro"],
                           mesh=mesh)
    with dryrun.StepMeter() as meter:
        step(opt, case["step"], batch)
weights = sum(local(p).numel() * local(p).element_size()
              for p in model.parameters())
state = sum(local(t).numel() * local(t).element_size()
            for d in opt.values() for t in d.values())
ospecs = {k: {n: shd.infer_param_specs(
    {f"{k}.{m}": t.shape for m, t in d.items()}, mesh)[f"{k}.{n}"]
    for n in d} for k, d in opt.items()}
with open(sys.argv[1], "wb") as f:
    pickle.dump(dict(collectives=meter.by_kind(), weights=weights,
                     state=state, rank_bytes=specs.rank_bytes(
                         model, opt, tcfg, mesh, pspecs, ospecs)), f)
'''


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               **extra)
    env.pop("WORLD_SIZE", None)
    return env


def _spawn(argv, **env):
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
    assert proc.returncode == 0, f"{what}:\n{err[-3000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    try:
        yield _launch_all(tmp_path_factory.mktemp("dryrun"))
    finally:
        for proc in _LAUNCHED:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        _LAUNCHED.clear()


def _launch_all(tmp):
    deadline = time.time() + TIMEOUT
    ref = _spawn([sys.executable, "-c", _REF_SCRIPT, str(tmp / "ref.pkl")],
                 JAX_PLATFORMS="cpu")
    port = {m: _spawn([sys.executable, "-c", _PORT_SCRIPT, m,
                       str(tmp / f"port_{m}.pkl")]) for m in MESHES}
    case = dict(ts._case("dense/2x2"), ref=False)
    fake = _spawn([sys.executable, "-c", _FAKE_STEP_SCRIPT,
                   str(tmp / "fake.pkl"), pickle.dumps(dict(
                       case, batch=ts.BATCH, seq=ts.SEQ, micro=ts.MICRO,
                       step=ts.STEP)).hex()])
    script = tmp / "world.py"
    script.write_text(ts._WORLD_SCRIPT)
    cfgs = pickle.dumps(dict(cases=[case], placement=(), batch=ts.BATCH,
                             seq=ts.SEQ, micro=ts.MICRO,
                             step=ts.STEP)).hex()
    world = _spawn([sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", str(ts.WORLD),
                    str(script), str(tmp), cfgs])
    cli_out = tmp / "cli.json"
    cli = _spawn([sys.executable, "-m", "repro_torch.launch.dryrun",
                  "--arch", "whisper-base", "--shape", "decode_32k",
                  "--mesh", "pod", "--out", str(cli_out)])
    got = {}
    got["cli_stdout"] = _wait(cli, "the dry-run CLI", deadline)
    got["cli"] = json.loads(cli_out.read_text())
    _wait(world, "the 4-rank world", deadline)
    with open(tmp / "rank0.pkl", "rb") as f:
        got["world"] = pickle.load(f)["dense/2x2"]
    _wait(fake, "the fake world of 4", deadline)
    with open(tmp / "fake.pkl", "rb") as f:
        got["fake"] = pickle.load(f)
    for m in MESHES:
        _wait(port[m], f"the port's {m} placement", deadline)
        with open(tmp / f"port_{m}.pkl", "rb") as f:
            for key, rec in pickle.load(f).items():
                got[(*key, m)] = rec
    _wait(ref, "the JAX reference", deadline)
    with open(tmp / "ref.pkl", "rb") as f:
        got["ref"] = pickle.load(f)
    return got


def _group(name: str) -> tuple:
    """A port name's reference leaf and whether it is a layer of a stack
    (``blocks.3.attn.wq`` -> ``("blocks.attn.wq", True)``)."""
    from repro_torch.train.optimizer import group_of
    return group_of(name)


def _held(port: dict, ref: dict, what: str) -> int:
    """Every port leaf's local shape is its reference leaf's shard shape
    (a stacked leaf's without its ``L`` entry); returns the count."""
    n = 0
    seen = set()
    for name, shape in port.items():
        prefix, dot, rest = name.partition(".")
        if what == "opt":     # master.blocks.0.attn.wq
            group, stacked = _group(rest)
            group = f"{prefix}.{group}"
        else:
            group, stacked = _group(name)
        want = ref[group]
        assert shape == (want[1:] if stacked else want), (what, name)
        seen.add(group)
        n += 1
    if what in ("params", "opt", "cache"):
        assert seen == set(ref), (what, set(ref) ^ seen)
    return n


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_local_shapes_are_the_reference_shard_shapes(runs, arch, shape,
                                                     mesh):
    port = runs[(arch, shape, mesh)]["local"]
    ref = runs["ref"][(arch, shape, mesh)]
    assert set(port) <= set(ref)
    for what, leaves in port.items():
        want = ref[what]
        if what == "batch":
            assert set(leaves) <= set(want)
            want = {k: want[k] for k in leaves}
        assert _held(leaves, want, what) > 0


def test_fake_world_counts_the_real_worlds_collectives(runs):
    """The dense config's train step at ``(2, 2)``: the fake world's
    collectives by kind, count and bytes are the 4-gloo-rank world's."""
    assert runs["fake"]["collectives"] == runs["world"]["collectives"]
    nbytes, counts = runs["fake"]["collectives"]
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0


def test_fake_world_argument_bytes_are_rank_bytes(runs):
    fake = runs["fake"]
    assert fake["weights"] == fake["rank_bytes"]["params"]
    assert fake["state"] == fake["rank_bytes"]["opt_state"]


def test_dry_run_cli_writes_the_record(runs):
    rec = runs["cli"]["whisper-base/decode_32k/pod"]
    assert rec["status"] == "ok"
    for key in ("flops", "collectives", "collective_counts",
                "argument_size_in_bytes", "temp_size_in_bytes", "wall_s"):
        assert key in rec, key
    assert rec["flops"] > 0 and rec["argument_size_in_bytes"] > 0
    assert set(rec["collectives"]) >= {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute"}
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert "done: 1/1 ok" in runs["cli_stdout"]


def test_dry_run_cli_refuses_the_mdp_suite():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--suite", "mdp"], env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 2
    assert "reference-only" in proc.stderr
