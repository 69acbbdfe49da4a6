"""The torch port's training CLI under ``torchrun`` on gloo ranks, and the
sharding helpers that need no world, on the CPU.

* ``repro_torch.launch.train`` under ``torchrun --nproc-per-node 2
  --device cpu`` (smoke stablelm): exit 0 and the same losses on every
  rank; a run stopped after 2 steps and resumed equals the straight 4-step
  run bit for bit (its checkpoint leaves too); the world-2 checkpoint, of
  whole leaves in the one-device format, resumes at world 1.  The two
  pairs of launches run side by side, each with a timeout.
* ``placements`` of specs (axis tuples, the mesh's order), ``batch_rows``
  and ``rank_bytes`` on abstract meshes, ``kv_for_heads``, the MoE's
  whole-group rule and ``make_train_step``'s mesh check.
"""

import os
import re
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import specs as tspecs
from repro_torch.models import DecoderLM
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.parallel import Axis
from repro_torch.train import sharding as tshd
from repro_torch.train.steps import make_train_step

SRC = Path(__file__).resolve().parent.parent / "src"
TIMEOUT = 240            # seconds, each pair of launches
ARGS = ["--arch", "stablelm-3b", "--smoke", "--batch", "8", "--seq", "32",
        "--log-every", "1", "--device", "cpu"]
_LAUNCHED = []


def _env():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _start(ranks, *args):
    """The train CLI, under torchrun with ``ranks`` gloo ranks (0: no
    torchrun), started in a session of its own."""
    argv = [sys.executable, "-m", "repro_torch.launch.train", *ARGS, *args]
    if ranks:
        argv = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", str(ranks), "-m",
                "repro_torch.launch.train", "--", *ARGS, *args]
    proc = subprocess.Popen(argv, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    _LAUNCHED.append(proc)
    return proc


def _finish(procs, what):
    deadline = time.time() + TIMEOUT
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(
                timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise AssertionError(f"{what} timed out")
        assert proc.returncode == 0, err[-3000:]
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_cli")
    try:
        straight, first = _finish(
            [_start(2, "--steps", "4", "--ckpt-dir", str(tmp / "a")),
             _start(2, "--steps", "2", "--ckpt-dir", str(tmp / "b"))],
            "the straight and the stopped runs")
        (tmp / "c").mkdir()
        os.link(tmp / "b" / f"step_{2:010d}.npz",
                tmp / "c" / f"step_{2:010d}.npz")
        resumed, world1 = _finish(
            [_start(2, "--steps", "4", "--ckpt-dir", str(tmp / "b")),
             _start(0, "--steps", "4", "--ckpt-dir", str(tmp / "c"))],
            "the resumed runs")
    finally:
        for proc in _LAUNCHED:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        _LAUNCHED.clear()
    return dict(tmp=tmp, straight=straight, first=first, resumed=resumed,
                world1=world1)


def _steps(out: str) -> list:
    return [ln.split()[1:3] for ln in out.splitlines()
            if ln.startswith("[train] step=")]


def _rank_losses(out: str) -> dict:
    return {int(r): losses for r, losses in re.findall(
        r"\[train\] rank (\d+) of 2: losses (\[.*\])", out)}


def _leaves(path):
    """A checkpoint's leaves in their order."""
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(sum(
            k.startswith("leaf_") for k in z.files))]


def test_cli_under_torchrun_logs_from_rank_0_and_agrees_on_every_rank(cli):
    out = cli["straight"]
    assert "[train] arch=stablelm-smoke devices=2 mesh={'data': 2, " \
        "'model': 1} device=cpu" in out
    assert out.count("[train] arch=") == 1 and len(_steps(out)) == 4
    losses = _rank_losses(out)
    assert sorted(losses) == [0, 1] and losses[0] == losses[1]
    assert "[train] done. loss" in out


def test_cli_resume_at_world_2_is_bit_for_bit(cli):
    assert "[train] resumed from step 2" in cli["resumed"]
    assert _steps(cli["straight"])[2:] == _steps(cli["resumed"])
    straight = _rank_losses(cli["straight"])[0]
    assert _rank_losses(cli["resumed"])[0][1:-1] in straight
    a = _leaves(cli["tmp"] / "a" / f"step_{4:010d}.npz")
    b = _leaves(cli["tmp"] / "b" / f"step_{4:010d}.npz")
    assert len(a) == len(b) > 0
    assert all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def test_world2_checkpoint_holds_whole_leaves_and_resumes_at_world_1(cli):
    """The checkpoint is the one-device format (whole leaves, the same
    order and shapes as a one-device run's), and a one-device run resumes
    it to the same losses within the sharded sums' rounding."""
    model = DecoderLM(tconfigs.get_smoke_config("stablelm-3b"),
                      device="cpu")
    shapes = [tuple(p.shape) for p in model.parameters()]
    got = _leaves(cli["tmp"] / "b" / f"step_{2:010d}.npz")
    assert [a.shape for a in got[:len(shapes)]] == shapes
    assert "[train] resumed from step 2" in cli["world1"]
    want = [float(x) for _, x in (s[1].split("=") for s in
                                  _steps(cli["straight"])[2:])]
    got = [float(x) for _, x in (s[1].split("=") for s in
                                 _steps(cli["world1"]))]
    assert np.allclose(got, want, rtol=1e-5, atol=0)


# --------------------------------------------------------------------------- #
# helpers that need no world                                                  #
# --------------------------------------------------------------------------- #

def _duck(shape, names, coord=None):
    """What ``placements`` / ``batch_rows`` read of a ``DeviceMesh``."""
    coord = coord or (0,) * len(shape)
    return types.SimpleNamespace(
        mesh_dim_names=tuple(names), size=lambda i: shape[i],
        mesh=types.SimpleNamespace(shape=tuple(shape)),
        get_coordinate=lambda: list(coord))


@pytest.mark.parametrize("spec,names,want", [
    ((None, "model"), ("data", "model"), ["Replicate()", "Shard(dim=1)"]),
    (("data", "model"), ("data", "model"), ["Shard(dim=0)", "Shard(dim=1)"]),
    ((("pod", "data"), None), ("pod", "data", "model"),
     ["Shard(dim=0)", "Shard(dim=0)", "Replicate()"]),
    (("model", None), ("data",), ["Replicate()"]),
    ((), ("data", "model"), ["Replicate()", "Replicate()"]),
])
def test_placements_of_specs(spec, names, want):
    got = tshd.placements(spec, _duck((2,) * len(names), names))
    assert [repr(p) for p in got] == want


def test_placements_refuse_an_order_against_the_mesh():
    with pytest.raises(ValueError, match="order"):
        tshd.placements((("data", "pod"),), _duck((2, 2), ("pod", "data")))
    with pytest.raises(ValueError, match="twice"):
        tshd.placements(("data", "data"), _duck((2,), ("data",)))


def test_batch_rows_take_a_share_of_each_microbatch():
    x = torch.arange(16).reshape(8, 2)
    mesh = _duck((2, 2, 1), ("pod", "data", "model"), coord=(1, 0, 0))
    got = tshd.batch_rows({"tokens": x}, mesh, 2)["tokens"]
    # microbatch rows 0-3 and 4-7; batch rank 2 of 4 takes row 2 and 6
    assert torch.equal(got, x[[2, 6]])
    with pytest.raises(ValueError, match="microbatches"):
        tshd.batch_rows({"tokens": x}, mesh, 4)


def test_rank_bytes_at_full_width():
    """stablelm-3b's state on one rank of a 16 x 16 mesh: the whole
    state's 1/256 plus what stays replicated (the norms), and at ``(1,
    1)`` the whole state."""
    tcfg = tconfigs.get_train_config("stablelm-3b")
    whole = None
    for sizes in ({"data": 1, "model": 1}, {"data": 16, "model": 16}):
        model, _, specs = tspecs.param_specs("stablelm-3b", sizes)
        state, ospecs = tspecs.opt_specs("stablelm-3b", sizes, model)
        got = tspecs.rank_bytes(model, state, tcfg, sizes, specs, ospecs)
        if whole is None:
            whole = tspecs.state_bytes(model, state, tcfg)
            assert got == whole
    norms = sum(p.numel() for n, p in model.named_parameters()
                if p.dim() == 1) * 16     # replicated, 16 B a weight
    assert whole["total"] / 256 < got["total"] <= \
        whole["total"] / 256 + norms


def test_kv_for_heads_picks_the_heads_a_query_reads():
    cfg = types.SimpleNamespace(n_heads=12, n_kv_heads=3)    # groups of 4
    k = torch.arange(3).view(1, 1, 3, 1).expand(2, 5, 3, 1)
    assert tattn.kv_for_heads(k, cfg, 4, 4)[0, 0, :, 0].tolist() == \
        [1, 1, 1, 1]
    assert tattn.kv_for_heads(k, cfg, 3, 3)[0, 0, :, 0].tolist() == \
        [0, 1, 1]


@pytest.mark.parametrize("rank", [0, 1])
def test_moe_refuses_groups_across_batch_ranks(monkeypatch, rank):
    """A group across batch ranks (olmoe's groups of 32 over 2 ranks of 24
    tokens), which the MoE once refused, routes as on one device: each
    rank's outputs and aux losses are the one-device MoE's on the whole
    48 tokens (the other rank's experts come from the all-gather, here
    the one-device routing's)."""
    cfg = tconfigs.get_smoke_config("olmoe-1b-7b")     # groups of 32
    moe = tmoe.MoE(cfg, torch.float32, "cpu")
    moe.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    want, want_aux = moe(x.reshape(1, 48, -1))
    tokens = x.reshape(48, -1)
    probs = torch.softmax(tokens @ moe.router, dim=-1)
    experts = tmoe._top_k(probs, cfg.top_k)[1]
    gathered = []

    def all_gather(t, axis, dim=0):
        gathered.append(tuple(t.shape))
        return experts if t.dtype == torch.long else \
            torch.cat([t, t]) if axis is not None else t

    monkeypatch.setattr(tmoe, "all_gather", all_gather)
    monkeypatch.setattr(tmoe, "reduce_from",
                        lambda t, axis: t if axis is None else t * 2)
    moe.dp = Axis(None, 2, rank)
    got, aux = moe(x[rank:rank + 1])
    assert gathered == [(24, cfg.top_k)]
    assert torch.allclose(got[0], want[0, 24 * rank:24 * (rank + 1)],
                          rtol=0, atol=1e-6)
    # the aux losses' sums over the ranks stand in as twice this rank's
    assert torch.isfinite(aux["load_balance_loss"])
    assert want_aux["router_z_loss"] > 0


def test_train_step_checks_the_mesh():
    cfg = tconfigs.get_smoke_config("stablelm-3b")
    model = DecoderLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="placed"):
        make_train_step(model, tconfigs.get_train_config("stablelm-3b"),
                        mesh=_duck((1, 1), ("data", "model")))
