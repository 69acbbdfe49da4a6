"""The torch port's prefill and decode on a placed model, on 4 gloo ranks,
against the port's own one-device steps and, for the dense and MoE cases,
against the JAX reference on 4 forced host devices.

One module fixture runs everything once, each launch with a timeout:

* the reference's weights of the dense and MoE cases, drawn here
  (``init`` of the JAX package) and written as ``.npz`` files that both
  sides read (the port through ``repro_torch.models.convert``); the other
  cases draw the port's weights from a seed;
* a world of 4 gloo ranks (``torchrun --standalone``) that places each
  case's model on its mesh (``infer_param_specs``, ``place``), prefills a
  prompt of the global batch (``make_prefill_step``), extends the cache
  and puts it on the reference's ``cache_spec`` (``place_cache``), then
  runs ``GEN`` greedy decode steps (``make_decode_step``), recording
  every step's logits and tokens and the cache leaves' local shapes;
* the reference in a subprocess on 4 forced host devices: the weights on
  ``place`` by ``infer_param_specs``, the prompt on ``data_spec``, the
  jitted ``make_prefill_step``, the cache padded as
  ``examples/serve_lm.py`` pads it and placed on ``cache_spec``, then the
  jitted ``make_decode_step``;
* meanwhile, the port's one-device steps of every case, here.

The fixture took 24.8 s under the tier-1 run's ``-n 6`` (~25 s alone);
its launches together have ``TIMEOUT``.

Cases: the widened dense config (``DENSE`` of
``tests/test_torch_train_sharded.py``: the vocab and the FSDP'd weights
split) at ``(2, 2)`` and ``(4, 1)``; olmoe's smoke config at
``vocab_size=128`` at ``(2, 2)`` (EP, and a decode step's group of 4
tokens spans the 2 batch ranks); mamba2 at ``(2, 2)`` (heads over
``model``; the conv cache's channels over ``model`` in contiguous blocks);
llava at ``(1, 4)`` (2 KV heads do not split over 4: the cache holds them
whole); whisper at ``(2, 2)``; zamba2 at ``(2, 2)``, and at ``(4, 1)``
with B = 1, where the batch does not split and the shared attention's
cache lies with its sequence over ``data``: the sequence-parallel decode.

Tolerances are ``tests/test_torch_lm_families.py``'s: logits within
``TOL`` of the largest |logit| of the step, greedy tokens exact.
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
from repro_torch.models.convert import (lm_params_from_numpy,
                                        whisper_params_from_numpy)
from repro_torch.train.steps import make_decode_step, make_prefill_step
from test_torch_lm import assert_close

SRC = Path(__file__).resolve().parent.parent / "src"
TIMEOUT = 600           # seconds, the fixture's launches together
WORLD = 4
TOL = 1e-5              # tests/test_torch_lm_families.py's
BATCH, PROMPT, GEN = 4, 12, 4
DENSE = dict(d_model=512, d_ff=1024, vocab_size=2048)
MOE = dict(vocab_size=128)
DP2 = ((2, 2), ("data", "model"))
# tag -> (arch, override, mesh shape, mesh names, batch, reference)
CASES = {
    "dense/2x2": ("stablelm-3b", DENSE, *DP2, BATCH, True),
    "dense/4x1": ("stablelm-3b", DENSE, (4, 1), ("data", "model"), BATCH,
                  True),
    "moe/2x2": ("olmoe-1b-7b", MOE, *DP2, BATCH, True),
    "mamba2/2x2": ("mamba2-130m", {}, *DP2, BATCH, False),
    "llava/1x4": ("llava-next-34b", {}, (1, 4), ("data", "model"), BATCH,
                  False),
    "whisper/2x2": ("whisper-base", {}, *DP2, BATCH, False),
    "zamba2/2x2": ("zamba2-1.2b", {}, *DP2, BATCH, False),
    "zamba2/4x1/b1": ("zamba2-1.2b", {}, (4, 1), ("data", "model"), 1,
                      False),
}
_LAUNCHED = []

_WORLD_SCRIPT = r'''
import dataclasses, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.launch import mesh as lm
from repro_torch.models import DecoderLM, WhisperModel
from repro_torch.models.convert import (lm_params_from_numpy,
                                        whisper_params_from_numpy)
from repro_torch.train import sharding as shd
from repro_torch.train.steps import make_decode_step, make_prefill_step

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


for case in cfgs["cases"]:
    key = (case["shape"], case["names"])
    if key not in meshes:
        meshes[key] = lm.make_host_mesh(case["shape"], case["names"],
                                        device="cpu")
    mesh = meshes[key]
    cfg = dataclasses.replace(configs.get_smoke_config(case["arch"]),
                              **case["override"])
    enc = cfg.family == "encdec"
    model = (WhisperModel if enc else DecoderLM)(cfg, device="cpu")
    if case["ref"]:
        conv = whisper_params_from_numpy if enc else lm_params_from_numpy
        model.load_state_dict(conv(tree(f"{tmp}/{case['file']}.npz"), cfg))
    else:
        model.reset_parameters(torch.Generator().manual_seed(0))
    shd.place(model, mesh, shd.infer_param_specs(model, mesh))
    inputs = cfgs["inputs"][case["tag"]]
    toks = torch.from_numpy(inputs["tokens"])
    extra = None if inputs["extra"] is None else \
        torch.from_numpy(inputs["extra"])
    b = toks.shape[0]
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, cache = prefill(toks, extra)
    cache = shd.place_cache(model.extend_cache(cache, cfgs["gen"]), mesh,
                            cfg, b)
    shapes = {k: ({n: tuple(x.shape) for n, x in v.items()}
                  if isinstance(v, dict) else
                  tuple(v.shape) if torch.is_tensor(v) else v)
              for k, v in cache.items()}
    tok, steps, toks_out = torch.argmax(logits, -1), [logits], []
    for _ in range(cfgs["gen"]):
        toks_out.append(tok)
        tok, logits, cache = decode(tok, cache)
        steps.append(logits)
    toks_out.append(tok)
    out[case["tag"]] = dict(tokens=torch.cat(toks_out, 1).numpy(),
                            logits=[x.numpy() for x in steps],
                            cache_shapes=shapes, len=cache["len"])
with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
lm.shutdown()
'''

_JAX_SCRIPT = r'''
import os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import dataclasses
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.configs import get_smoke_config
from repro.launch.mesh import mesh_kwargs
from repro.models import build_model
from repro.train import sharding as shd
from repro.train.steps import make_decode_step, make_prefill_step

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
    model = build_model(cfg)
    mesh = jax.make_mesh(case["shape"], case["names"],
                         **mesh_kwargs(len(case["shape"])))
    params = tree(f"{tmp}/{case['file']}.npz")
    params = shd.place(params, mesh, shd.infer_param_specs(params, mesh))
    toks = jnp.asarray(cfgs["inputs"][case["tag"]]["tokens"])
    toks = shd.place(toks, mesh, shd.data_spec(mesh, 2))
    g = cfgs["gen"]
    logits, cache = jax.jit(make_prefill_step(model))(params, toks)

    def pad_kv(path, x):
        names = [str(getattr(p, "key", "")) for p in path]
        if names and names[-1] in ("k", "v"):
            return jnp.pad(x, ((0, 0), (0, 0), (0, g), (0, 0), (0, 0)))
        return x
    cache = jax.tree_util.tree_map_with_path(pad_kv, cache)
    cs = shd.cache_spec(cfg, mesh, toks.shape[0])
    kind = {"k": "attn", "v": "attn", "conv": "conv", "ssm": "ssm"}

    def put(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name not in kind:
            return x
        return jax.device_put(x, jax.sharding.NamedSharding(mesh,
                                                            cs[kind[name]]))
    cache = jax.tree_util.tree_map_with_path(put, cache)
    decode = jax.jit(make_decode_step(model))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    steps, toks_out = [np.asarray(logits)], []
    for _ in range(g):
        toks_out.append(np.asarray(tok))
        tok, logits, cache = decode(params, tok, cache)
        steps.append(np.asarray(logits))
    toks_out.append(np.asarray(tok))
    out[case["tag"]] = dict(tokens=np.concatenate(toks_out, 1),
                            logits=steps)
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
    arch, override, shape, names, batch, ref = CASES[tag]
    return dict(tag=tag, file=tag.replace("/", "_"), arch=arch,
                override=override, shape=shape, names=names, batch=batch,
                ref=ref)


def _cfg(case):
    return dataclasses.replace(tconfigs.get_smoke_config(case["arch"]),
                               **case["override"])


def _inputs(case):
    """The case's global prompt (and the vlm's patches or the encdec's
    frames), from a numpy generator of the case's seed."""
    cfg = _cfg(case)
    rng = np.random.default_rng(len(case["tag"]))
    tokens = rng.integers(0, cfg.vocab_size, (case["batch"], PROMPT),
                          dtype=np.int64)
    n = {"vlm": cfg.n_patches, "encdec": cfg.encoder_len}.get(cfg.family)
    extra = None if n is None else \
        rng.standard_normal((case["batch"], n, cfg.d_model)).astype(
            np.float32)
    return dict(tokens=tokens, extra=extra)


def _write_reference_weights(tmp, case):
    jcfg = dataclasses.replace(jget_smoke(case["arch"]), **case["override"])
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(tmp / f"{case['file']}.npz", **flat)
    return flat


def _unflatten(flat):
    nested = {}
    for k, a in flat.items():
        d = nested
        *head, leaf = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[leaf] = a
    return nested


def _one_device(case, flat, inputs):
    """The port's one-device prefill and greedy decode of the case."""
    cfg = _cfg(case)
    enc = cfg.family == "encdec"
    model = (WhisperModel if enc else DecoderLM)(cfg, device="cpu")
    if flat is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        conv = whisper_params_from_numpy if enc else lm_params_from_numpy
        model.load_state_dict(conv(_unflatten(flat), cfg))
    toks = torch.from_numpy(inputs["tokens"])
    extra = None if inputs["extra"] is None else \
        torch.from_numpy(inputs["extra"])
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, cache = prefill(toks, extra)
    cache = model.extend_cache(cache, GEN)
    tok, steps, toks_out = torch.argmax(logits, -1), [logits], []
    for _ in range(GEN):
        toks_out.append(tok)
        tok, logits, cache = decode(tok, cache)
        steps.append(logits)
    toks_out.append(tok)
    return dict(tokens=torch.cat(toks_out, 1).numpy(),
                logits=[x.numpy() for x in steps])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    try:
        yield _launch_all(tmp_path_factory.mktemp("lm_placed"))
    finally:
        for proc in _LAUNCHED:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        _LAUNCHED.clear()


def _launch_all(tmp):
    deadline = time.time() + TIMEOUT
    cases = [_case(t) for t in CASES]
    drawn = {}
    for c in cases:
        if c["ref"]:
            drawn[c["tag"]] = _write_reference_weights(tmp, c)
    inputs = {c["tag"]: _inputs(c) for c in cases}
    cfgs = pickle.dumps(dict(cases=cases, inputs=inputs, gen=GEN)).hex()
    ref = _spawn([sys.executable, "-c", _JAX_SCRIPT, str(tmp), cfgs],
                 JAX_PLATFORMS="cpu")
    script = tmp / "world.py"
    script.write_text(_WORLD_SCRIPT)
    world = _spawn([sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", str(WORLD),
                    str(script), str(tmp), cfgs])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {c["tag"]: _one_device(c, drawn.get(c["tag"]),
                                        inputs[c["tag"]]) for c in cases}
    finally:
        torch.set_num_threads(threads)
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


def _held(got, want):
    assert np.array_equal(got["tokens"], want["tokens"])
    assert len(got["logits"]) == len(want["logits"]) == GEN + 1
    for g, w in zip(got["logits"], want["logits"]):
        assert_close(g, w, TOL)


@pytest.mark.parametrize("tag", list(CASES))
def test_placed_serving_matches_one_device(runs, tag):
    """Greedy tokens exact, every step's logits (the whole batch's, the
    whole vocab) within ``TOL``."""
    _held(runs["ranks"][0][tag], runs["single"][tag])


@pytest.mark.parametrize("tag", [t for t, c in CASES.items() if c[5]])
def test_placed_serving_matches_reference(runs, tag):
    _held(runs["ranks"][0][tag], runs["ref"][tag])


@pytest.mark.parametrize("tag", list(CASES))
def test_every_rank_returns_the_whole_batch(runs, tag):
    first = runs["ranks"][0][tag]
    assert first["tokens"].shape == (CASES[tag][4], GEN + 1)
    for other in runs["ranks"][1:]:
        assert np.array_equal(other[tag]["tokens"], first["tokens"])
        for a, b in zip(other[tag]["logits"], first["logits"]):
            assert np.array_equal(a, b)
        assert other[tag]["len"] == PROMPT + _cfg(_case(tag)).n_patches \
            + GEN


def _local_shape(shape, spec, sizes):
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= sizes.get(a, 1)
    return tuple(out)


@pytest.mark.parametrize("tag", list(CASES))
def test_cache_leaves_lie_on_cache_spec(runs, tag):
    """Each rank's cache leaves after ``place_cache`` have the local shapes
    of the reference's ``cache_spec`` over the whole cache
    (``init_cache`` of the global batch and every slot)."""
    from repro_torch.train.sharding import cache_leaf_specs
    case = _case(tag)
    cfg = _cfg(case)
    sizes = dict(zip(case["names"], case["shape"]))
    model = (WhisperModel if cfg.family == "encdec" else DecoderLM)(
        cfg, device="meta")
    whole = model.init_cache(case["batch"],
                             PROMPT + cfg.n_patches + GEN)
    specs = cache_leaf_specs(cfg, sizes, case["batch"], whole)
    for rank in runs["ranks"]:
        got = rank[tag]["cache_shapes"]
        for key, val in whole.items():
            if isinstance(val, dict):
                for n, x in val.items():
                    assert got[key][n] == _local_shape(
                        x.shape, specs[key][n], sizes), (key, n)
            elif torch.is_tensor(val):
                assert got[key] == _local_shape(val.shape, specs[key],
                                                sizes), key
    if tag == "zamba2/4x1/b1":     # the sequence over data
        assert runs["ranks"][0][tag]["cache_shapes"]["shared"]["k"][2] == \
            (PROMPT + GEN) // 4
    if tag == "llava/1x4":         # 2 KV heads whole over 4 ranks
        assert runs["ranks"][0][tag]["cache_shapes"]["blocks"]["k"][3] == 2
