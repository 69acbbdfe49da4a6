"""The torch port's MDP files (``repro_torch.core.io``) against the JAX
package's: one format, read by either package.

A file written by each package is read by the other on all four
generator families: the arrays (idx int32, val and cost float32) and the
manifest are equal, for the whole MDP and for ``rows=(lo, hi)`` slices
that cross block boundaries.  ``MDP.from_file`` restores the stored
``mode``; the port's CLI ``--load`` solves a loaded file exactly as it
solves the generator instance (both are the same tables, so the solves
are bit for bit).
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.core import generators as jgen
from repro.core import io as jio
from repro_torch.api import MDP
from repro_torch.core import generators as tgen
from repro_torch.core import io as tio
from repro_torch.launch import solve as tcli

jax.config.update("jax_enable_x64", True)

INSTANCES = {
    "garnet": dict(n=97, m=5, k=3, gamma=0.95, seed=1),
    "maze2d": dict(size=9, gamma=0.99),
    "sis": dict(pop=50, n_actions=4, gamma=0.99),
    "chain_walk": dict(n=100, gamma=0.99),
}
N_BLOCKS = 4


def _arrays(mdp):
    out = []
    for x in (mdp.idx, mdp.val, mdp.cost):
        out.append(x.numpy() if isinstance(x, torch.Tensor) else
                   np.asarray(x))
    return out


def _assert_same(got, want):
    for g, w in zip(_arrays(got), _arrays(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert (got.n_global, got.m_global, got.gamma) == \
        (want.n_global, want.m_global, want.gamma)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("family", sorted(INSTANCES))
def test_each_package_reads_the_others_file(family, writer, tmp_path):
    kw = INSTANCES[family]
    jm, tm = jgen.REGISTRY[family](**kw), tgen.REGISTRY[family](**kw)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jio.save_mdp(str(jdir), jm, n_blocks=N_BLOCKS, mode="maxreward")
    tio.save_mdp(str(tdir), tm, n_blocks=N_BLOCKS, mode="maxreward")
    # the two writers produce the same manifest and the same blocks
    assert tio.load_manifest(str(tdir)) == jio.load_manifest(str(jdir))
    for b in range(N_BLOCKS):
        with np.load(jdir / f"block_{b:05d}.npz") as zj, \
                np.load(tdir / f"block_{b:05d}.npz") as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for key in zj.files:
                assert zj[key].dtype == zt[key].dtype
                np.testing.assert_array_equal(zj[key], zt[key])
    src = str(jdir if writer == "jax" else tdir)
    _assert_same(tio.load_mdp(src), jm)       # the port reads
    _assert_same(jio.load_mdp(src), jm)       # the reference reads
    # partial loads across block boundaries (blocks of ~n/4 rows)
    n = jm.n_global
    for lo, hi in ((0, 1), (n // 8, n // 2 + 3), (n // 3, n), (5, n - 5)):
        part_t = tio.load_mdp(src, rows=(lo, hi))
        part_j = jio.load_mdp(src, rows=(lo, hi))
        assert part_t.n_local == hi - lo and part_t.n_global == n
        for g, w, full in zip(_arrays(part_t), _arrays(part_j),
                              _arrays(jm)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, full[lo:hi])


def test_from_file_restores_mode_and_builds(tmp_path):
    jm = jgen.sis(**INSTANCES["sis"])
    jio.save_mdp(str(tmp_path / "a"), jm, n_blocks=2, mode="maxreward")
    jio.save_mdp(str(tmp_path / "b"), jm, n_blocks=1)
    a = MDP.from_file(str(tmp_path / "a"))
    assert a.mode == "maxreward" and (a.n, a.m) == (51, 4)   # pop + 1
    assert MDP.from_file(str(tmp_path / "a"), mode="mincost").mode == \
        "mincost"
    assert MDP.from_file(str(tmp_path / "b")).mode == "mincost"
    core = a.build("cpu")
    _assert_same(core, jm)
    head = MDP.from_file(str(tmp_path / "a"), rows=(0, 20))
    assert head.build("cpu").n_local == 20


def test_save_mdp_refuses_a_partial_mdp(tmp_path):
    part = tio.load_mdp(_write(tmp_path), rows=(0, 10))
    with pytest.raises(ValueError, match="expects the full MDP"):
        tio.save_mdp(str(tmp_path / "again"), part)


def _write(tmp_path) -> str:
    path = str(tmp_path / "g")
    tio.save_mdp(path, tgen.garnet(**INSTANCES["garnet"]), n_blocks=3)
    return path


@pytest.mark.parametrize("method", ["ipi_gmres", "ipi_bicgstab"])
def test_cli_load_solves_like_the_generator_instance(method, tmp_path,
                                                     capsys):
    kw = INSTANCES["garnet"]
    jio.save_mdp(str(tmp_path / "mdp"), jgen.garnet(**kw), n_blocks=3)
    common = ["--device", "cpu", "--method", method, "--atol", "1e-9"]
    rc_load = tcli.main(["--load", str(tmp_path / "mdp"), *common,
                         "--option", f"file_cost={tmp_path / 'v_load.npy'}",
                         "--option", f"file_stats={tmp_path / 's.json'}"])
    rc_gen = tcli.main(["--instance", "garnet", "--n", "97", "--m", "5",
                        "--k", "3", "--gamma", "0.95", "--seed", "1",
                        *common, "--option",
                        f"file_cost={tmp_path / 'v_gen.npy'}"])
    out = capsys.readouterr().out
    assert (rc_load, rc_gen) == (0, 0)
    assert out.count("converged=True") == 2
    np.testing.assert_array_equal(np.load(tmp_path / "v_load.npy"),
                                  np.load(tmp_path / "v_gen.npy"))
    stats = [json.loads(line) for line in open(tmp_path / "s.json")]
    assert stats[0]["solves"][0]["n"] == 97 and stats[0]["method"] == method


def test_new_entry_points_need_the_card_unless_asked(tmp_path):
    """``--load``, ``MDP.from_file``, the one-shot ``api.solve`` and a
    checkpointed, monitored, preconditioned solve all default to the card
    and raise where none is visible; nothing falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda is a legal device here")
    import repro_torch.api as tapi
    from repro_torch.core import driver as tdriver
    from repro_torch.core.ipi import IPIOptions

    path = _write(tmp_path)
    ck = str(tmp_path / "ck")
    no_card = pytest.raises(RuntimeError, match="no CUDA device is visible")
    with no_card:
        tcli.main(["--load", path, "--monitor", "--ckpt-dir", ck,
                   "--method", "ipi_bicgstab"])
    with no_card:
        MDP.from_file(path).build()
    with no_card:
        tapi.solve(MDP.from_file(path))
    with no_card:
        tdriver.solve(tio.load_mdp(path),
                      IPIOptions(method="ipi_gmres", pc_type="bjacobi",
                                 monitor=True), checkpoint_dir=ck)
    assert not (tmp_path / "ck").exists()
