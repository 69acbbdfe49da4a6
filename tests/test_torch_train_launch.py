"""The torch port's data pipeline, sharding rules, abstract inputs and
training CLI against the JAX package, on the CPU.

* ``SyntheticSource``: tokens, labels and the stub patch / frame
  embeddings equal to the reference's bit for bit, for steps taken in any
  order; ``MemmapSource``'s windows too.
* The spec rules: every parameter's and optimizer leaf's spec equal to the
  reference's ``PartitionSpec`` for every arch at its full config on
  meshes ``(1, 1)``, ``(4, 1)``, ``(2, 2)`` and ``(16, 16)`` (a
  per-layer tensor's spec is the stacked one without its ``L`` entry),
  and the batch and cache specs.
* ``launch/specs.py``: every abstract input's shape and dtype equal to
  ``eval_shape``'s (a stacked leaf's shape is ``(L, *per-layer)``).
* ``launch/train.py`` on ``--device cpu --smoke``: 4 steps straight equal
  2 steps plus 2 resumed, bit for bit.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS, get_config as jget_config
from repro.configs import get_train_config as jget_train
from repro.configs.base import SHAPES
from repro.data.pipeline import MemmapSource as JMemmap
from repro.data.pipeline import SyntheticSource as JSource
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild_model
from repro.train import optimizer as joptimizer
from repro.train import sharding as jshd
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import MemmapSource, SyntheticSource
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.train import optimizer as toptimizer
from repro_torch.train import sharding as tshd

MESHES = [(1, 1), (4, 1), (2, 2), (16, 16)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------- #
# data pipeline                                                               #
# --------------------------------------------------------------------------- #

SOURCES = {
    "text": dict(vocab_size=97, seq_len=16, global_batch=3),
    "vlm": dict(vocab_size=64000, seq_len=40, global_batch=2, n_patches=7,
                d_model=64, seed=3),
    "encdec": dict(vocab_size=51865, seq_len=9, global_batch=2,
                   encoder_len=30, d_model=128, seed=5),
}


@pytest.mark.parametrize("kind", list(SOURCES))
def test_synthetic_source_is_the_reference_bit_for_bit(kind):
    kw = SOURCES[kind]
    ref, port = JSource(**kw), SyntheticSource(**kw, device="cpu")
    for step in (7, 0, 123_456, 7, 2**31 + 5):      # any order, stateless
        want, got = ref.next_batch(step), port.next_batch(step)
        assert sorted(want) == sorted(got)
        for key, w in want.items():
            w = np.asarray(w)
            g = got[key]
            if key == "patches":
                assert g.dtype == torch.bfloat16
                g, w = g.view(torch.int16).numpy(), w.view(np.int16)
            else:
                assert g.dtype == torch.int32
                g = g.numpy()
            assert g.shape == w.shape and np.array_equal(g, w), (step, key)
    if kind == "vlm":
        b = port.next_batch(1)
        assert not b["labels"][:, :kw["n_patches"]].any()


def test_memmap_source_reads_the_reference_windows(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 50_000, 1_000).astype(
        np.uint16).tofile(path)
    ref = JMemmap(str(path), seq_len=31, global_batch=4)
    port = MemmapSource(str(path), seq_len=31, global_batch=4, device="cpu")
    for step in (0, 3, 11):       # 11 * 4 wraps past the file's 31 windows
        want, got = ref.next_batch(step), port.next_batch(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            assert np.array_equal(got[key].numpy(), np.asarray(want[key]))


def test_sources_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="device"):
        SyntheticSource(97, 8, 2).next_batch(0)


# --------------------------------------------------------------------------- #
# sharding rules                                                              #
# --------------------------------------------------------------------------- #

def _duck_mesh(shape, names=("data", "model")):
    """What the reference's rules read of a mesh: its sizes and names."""
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=tuple(names))


def _ref_specs(tree, mesh):
    """``{"a/b/c": PartitionSpec}`` of the reference's rules."""
    specs = jshd.infer_param_specs(tree, mesh)
    return {"/".join(str(getattr(k, "key", k)) for k in path): s
            for path, s in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, P))}


def _assert_specs_equal(port: dict, ref: dict):
    """Every port tensor's spec against its reference leaf's: the stacked
    spec less its ``L`` entry for a tensor of a stack."""
    seen = set()
    for name, spec in port.items():
        group, stacked = toptimizer.group_of(name)
        want = ref[group.replace(".", "/")]
        seen.add(group.replace(".", "/"))
        want = tuple(want)[1:] if stacked and len(tuple(want)) else want
        assert P(*spec) == P(*want), (name, spec, want)
    assert seen == set(ref)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_and_opt_specs_equal_the_reference(arch):
    jm = jbuild_model(jget_config(arch))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(
        lambda p: joptimizer.init_opt_state(p, jget_train(arch)), shapes)
    model = tspecs.meta_model(tconfigs.get_config(arch))
    state = toptimizer.init_opt_state(model, tconfigs.get_train_config(arch))
    flat = {f"{k}.{n}": t for k, d in state.items() for n, t in d.items()}
    for mesh in MESHES:
        sizes = dict(zip(("data", "model"), mesh))
        _assert_specs_equal(tshd.infer_param_specs(model, sizes),
                            _ref_specs(shapes, _duck_mesh(mesh)))
        _assert_specs_equal(tshd.infer_param_specs(flat, sizes),
                            _ref_specs(opt, _duck_mesh(mesh)))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_and_cache_specs_equal_the_reference(arch):
    cfg = tconfigs.get_config(arch)
    meshes = [((d, m), ("data", "model")) for d, m in MESHES] + \
        [((2, 4, 2), ("pod", "data", "model"))]
    for shape, names in meshes:
        duck = _duck_mesh(shape, names)
        sizes = dict(zip(names, shape))
        assert tshd.batch_axes(sizes) == jshd.batch_axes(duck)
        for nd in (2, 3):
            assert P(*tshd.data_spec(sizes, nd)) == jshd.data_spec(duck, nd)
        for batch in (1, 4, 128):
            got = tshd.cache_spec(cfg, sizes, batch)
            want = jshd.cache_spec(jget_config(arch), duck, batch)
            for k in ("attn", "conv", "ssm"):
                assert P(*got[k]) == want[k], (shape, batch, k)
            assert bool(got["batch_sharded"]) == bool(want["batch_sharded"])


def test_specs_take_a_device_mesh():
    """A ``DeviceMesh`` is read by its dim names and shape."""
    from torch.distributed.device_mesh import init_device_mesh
    dist = torch.distributed
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        assert tshd.mesh_shape(mesh) == {"data": 1, "model": 1}
        assert tshd.data_spec(mesh, 2) == (("data",), None)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# abstract inputs                                                             #
# --------------------------------------------------------------------------- #

def _shape_dtype(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _assert_tree_matches(port: dict, ref_tree):
    """Port tensors (``{name: tensor}``) against the reference's stacked
    SDS leaves: stacked groups as ``(L, *per-layer)``."""
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): x
           for path, x in jax.tree_util.tree_leaves_with_path(ref_tree)}
    groups = toptimizer.layer_groups({n: t.shape for n, t in port.items()})
    assert {g.replace(".", "/") for g in groups} == set(ref)
    for group, (names, stacked_shape) in groups.items():
        want = ref[group.replace(".", "/")]
        dts = {str(port[n].dtype).replace("torch.", "") for n in names}
        assert dts == {str(want.dtype)}, group
        # a 0-d leaf of a stack (Adafactor's vc) is one scalar in both
        shape = () if not port[names[0]].dim() else stacked_shape
        assert shape == tuple(want.shape), group


@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_match_eval_shape(arch):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    sizes = {"data": 1, "model": 1}
    for shape_name in [s.name for s in tconfigs.cells(arch)]:
        want = jspecs.input_specs(arch, shape_name, mesh)
        got = tspecs.input_specs(arch, shape_name, sizes)
        _assert_tree_matches(got["params"], want["params"])
        if SHAPES[shape_name].kind == "train":
            assert sorted(got["opt"]) == sorted(want["opt"])
            for key in want["opt"]:
                _assert_tree_matches(got["opt"][key], want["opt"][key])
            assert got["n_micro"] == want["n_micro"]
        if SHAPES[shape_name].kind in ("train", "prefill"):
            assert {k: _shape_dtype(v) for k, v in got["batch"].items()} \
                == {k: _shape_dtype(v) for k, v in want["batch"].items()}
        if SHAPES[shape_name].kind == "decode":
            _assert_cache_matches(got["cache"], want["cache"])
            assert _shape_dtype(got["token"]) == _shape_dtype(want["token"])


def _assert_cache_matches(got: dict, want: dict):
    for key, val in want.items():
        if key == "len":
            assert got[key] == 0
        elif isinstance(val, dict):
            assert sorted(got[key]) == sorted(val)
            for n, x in val.items():
                assert _shape_dtype(got[key][n]) == _shape_dtype(x), (key, n)
        else:
            assert _shape_dtype(got[key]) == _shape_dtype(val), key


def test_state_bytes_reckon_stablelm_3b():
    """The trainer's resident bytes at stablelm-3b's full width, from the
    meta device: 2.80B weights at 2 B, Adam's f32 master, m and v, and
    bf16 gradients: 16 B a weight."""
    model, params, _ = tspecs.param_specs("stablelm-3b", {"data": 1})
    state, _ = tspecs.opt_specs("stablelm-3b", {"data": 1}, model)
    got = tspecs.state_bytes(model, state,
                             tconfigs.get_train_config("stablelm-3b"))
    n = sum(p.numel() for p in params.values())
    assert 2.79e9 < n < 2.80e9
    assert got == dict(params=2 * n, opt_state=12 * n, grads=2 * n,
                       total=16 * n)


# --------------------------------------------------------------------------- #
# the CLI                                                                     #
# --------------------------------------------------------------------------- #

def _train(capsys, *args) -> str:
    rc = ttrain.main(["--arch", "stablelm-3b", "--smoke", "--batch", "4",
                      "--seq", "16", "--device", "cpu", "--log-every", "1",
                      *args])
    assert rc == 0
    return capsys.readouterr().out


def _leaves(ckpt_dir, step):
    with np.load(os.path.join(ckpt_dir, f"step_{step:010d}.npz")) as z:
        return [z[k] for k in sorted(z.files) if k.startswith("leaf_")]


def test_cli_resume_is_bit_for_bit(tmp_path, capsys):
    straight = _train(capsys, "--steps", "4", "--ckpt-dir",
                      str(tmp_path / "a"))
    _train(capsys, "--steps", "2", "--ckpt-dir", str(tmp_path / "b"))
    resumed = _train(capsys, "--steps", "4", "--ckpt-dir",
                     str(tmp_path / "b"))
    assert "[train] resumed from step 2" in resumed
    lines = lambda out: [ln.split()[1:3] for ln in out.splitlines()
                         if ln.startswith("[train] step=")]
    assert lines(straight)[2:] == lines(resumed)     # step, loss
    assert "[train] done. loss" in straight
    a, b = _leaves(tmp_path / "a", 4), _leaves(tmp_path / "b", 4)
    assert len(a) == len(b) > 0
    assert all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def test_cli_refuses_a_multi_rank_world(monkeypatch):
    """Under ``WORLD_SIZE > 1`` (torchrun) the CLI trains sharded
    (``tests/test_torch_train_sharded_launch.py``); it refuses, before the
    process group comes up, a batch that does not split into the
    microbatches over the ranks, and a rank without a card."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="over 4 ranks"):
        ttrain.main(["--arch", "stablelm-3b", "--smoke", "--device", "cpu",
                     "--batch", "6"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--arch", "stablelm-3b", "--smoke"])


def test_cli_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "stablelm-3b", "--smoke", "--steps", "1"])


def test_train_lm_example_runs_on_the_host(capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_example_train_lm",
        os.path.join(ROOT, "examples", "torch", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[train] arch=olmoe-smoke" in out and "[train] done." in out
