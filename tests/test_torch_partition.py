"""The torch port's partitioning against the JAX reference's, in one process.

``pad_mdp``, ``padded_extents``, ``shard_block``, ``frontier_reach`` and
``overlap_margins`` of :mod:`repro_torch.core.partition` are held
array-equal (exact) to :mod:`repro.core.partition` on the instances of the
reference's own overlap tests (chain_walk 64 / 63, maze2d 32, garnet 64)
and on padded garnets.  The dense padding, which the reference does not
have, is held to the ELL padding's ``as_dense()``.  Then the placement
helpers that need no process group: the layouts' mesh dimensions, the
window coordinates of an ELL block, and :class:`Axes`' single-shard
window movement.  The multi-rank paths run in
``tests/test_torch_distributed.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.core import generators as jgen
from repro.core import partition as jpart
from repro_torch.core import bellman, generators as tgen
from repro_torch.core import partition as tpart
from repro_torch.core.comm import Axes


def _pair(family, **kw):
    """The same instance from both packages' generators."""
    return jgen.REGISTRY[family](**kw), tgen.REGISTRY[family](**kw)


def _poked(mdp, fill_idx):
    """``mdp`` with its zero-weight ELL slots (or the last slot of every
    row, zeroed) pointing at ``fill_idx``: remote columns of weight 0."""
    idx = np.asarray(mdp.idx).copy()
    val = np.asarray(mdp.val).copy()
    if fill_idx == "last":
        idx[:, :, -1] = 0
        val[:, :, -1] = 0.0
    else:
        idx[val == 0] = fill_idx
    return idx, val


def _fake_mesh(shape, names):
    """Mesh metadata only: the reference reads ``shape[name]`` and
    ``axis_names``, the port ``shape`` and ``mesh_dim_names``."""
    jm = types.SimpleNamespace(shape=dict(zip(names, shape)),
                               axis_names=names)
    tm = types.SimpleNamespace(shape=tuple(shape), mesh_dim_names=names)
    return jm, tm


# --------------------------------------------------------------------------- #
# Frontier reach and overlap margins (test_async.py's instances)              #
# --------------------------------------------------------------------------- #

FRONTIER_CASES = {
    "chain64/8": (dict(family="chain_walk", n=64, gamma=0.9), 8, None),
    "chain64/4": (dict(family="chain_walk", n=64, gamma=0.9), 4, None),
    "chain64/1": (dict(family="chain_walk", n=64, gamma=0.9), 1, None),
    "chain63/8": (dict(family="chain_walk", n=63, gamma=0.9), 8, None),
    "maze32/8": (dict(family="maze2d", size=32, gamma=0.9), 8, None),
    "maze32/4": (dict(family="maze2d", size=32, gamma=0.95), 4, None),
    "garnet64/8": (dict(family="garnet", n=64, m=3, k=4, gamma=0.9,
                        seed=0), 8, None),
    "chain64/8 zero-weight to 63": (dict(family="chain_walk", n=64,
                                         gamma=0.9), 8, 63),
    "chain64/8 last slot to 0": (dict(family="chain_walk", n=64, gamma=0.9),
                                 8, "last"),
}


@pytest.mark.parametrize("case", list(FRONTIER_CASES))
def test_frontier_and_margins_match_reference(case):
    kw, n_shards, poke = FRONTIER_CASES[case]
    kw = dict(kw)
    jm, tm = _pair(kw.pop("family"), **kw)
    if poke is not None:
        idx, val = _poked(jm, poke)
        jm = dataclasses.replace(jm, idx=idx, val=val)
        tm = dataclasses.replace(tm, idx=torch.from_numpy(idx),
                                 val=torch.from_numpy(val))
    assert tpart.frontier_reach(tm, n_shards) == \
        jpart.frontier_reach(jm, n_shards)
    assert tpart.overlap_margins(tm, n_shards) == \
        jpart.overlap_margins(jm, n_shards)


def test_frontier_of_dense_is_undefined():
    tm = tgen.chain_walk(64, gamma=0.9)
    assert tpart.frontier_reach(tm.as_dense(), 8) is None
    assert tpart.overlap_margins(tm.as_dense(), 8) is None


# --------------------------------------------------------------------------- #
# Padding and extents                                                         #
# --------------------------------------------------------------------------- #

PAD_CASES = [("chain_walk", dict(n=63, gamma=0.9), 8, 1, "mincost"),
             ("garnet", dict(n=97, m=5, k=3, gamma=0.95, seed=1), 4, 2,
              "mincost"),
             ("garnet", dict(n=97, m=5, k=3, gamma=0.95, seed=1), 4, 2,
              "maxreward"),
             ("maze2d", dict(size=9, gamma=0.99), 2, 4, "mincost"),
             ("garnet", dict(n=64, m=3, k=4, gamma=0.9, seed=0), 8, 3,
              "mincost")]


@pytest.mark.parametrize("family,kw,n_mult,m_mult,mode", PAD_CASES)
def test_pad_mdp_matches_reference(family, kw, n_mult, m_mult, mode):
    jm, tm = _pair(family, **kw)
    jp = jpart.pad_mdp(jm, n_mult, m_mult, mode=mode)
    tp = tpart.pad_mdp(tm, n_mult, m_mult, mode=mode)
    assert (tp.n_global, tp.m_global) == (jp.n_global, jp.m_global)
    for f in ("idx", "val", "cost"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    assert tp.gamma == jp.gamma


@pytest.mark.parametrize("family,kw,n_mult,m_mult,mode", PAD_CASES)
def test_dense_padding_is_the_ell_padding(family, kw, n_mult, m_mult, mode):
    tm = tgen.REGISTRY[family](**kw)
    dp = tpart.pad_mdp(tm.as_dense(), n_mult, m_mult, mode=mode)
    want = tpart.pad_mdp(tm, n_mult, m_mult, mode=mode).as_dense()
    assert (dp.n_global, dp.m_global) == (want.n_global, want.m_global)
    assert torch.equal(dp.p, want.p) and torch.equal(dp.cost, want.cost)


def test_pad_mdp_without_padding_is_the_mdp():
    tm = tgen.chain_walk(64, gamma=0.9)
    assert tpart.pad_mdp(tm, 8, 1) is tm


@pytest.mark.parametrize("shape,names,layout", [
    ((4, 2), ("data", "model"), "1d"), ((4, 2), ("data", "model"), "2d"),
    ((3,), ("data",), "1d"), ((2, 3), ("data", "model"), "2d"),
    ((2, 2, 2), ("pod", "data", "model"), "2d")])
@pytest.mark.parametrize("n,m", [(997, 11), (64, 3), (1, 1)])
def test_padded_extents_match_reference(shape, names, layout, n, m):
    jmesh, tmesh = _fake_mesh(shape, names)
    want = jpart.padded_extents(jmesh, jpart.mesh_axes(jmesh, layout), n, m)
    assert tpart.padded_extents(tmesh, layout, n, m) == want


@pytest.mark.parametrize("index,shape", [
    ((slice(0, 250), slice(None)), (1000, 11)),
    ((slice(250, 500), slice(6, 12)), (1000, 12)),
    ((slice(None, None, 1),), (7,))])
def test_shard_block_matches_reference(index, shape):
    assert tpart.shard_block(index, shape) == jpart.shard_block(index, shape)
    with pytest.raises(ValueError, match="contiguous"):
        tpart.shard_block((slice(0, 8, 2),), (8,))


def test_layouts_name_their_dims_and_fleet_raises():
    _, mesh = _fake_mesh((2, 2), ("data", "model"))
    assert tpart.layout_dims(mesh, "1d") == (("data", "model"), ())
    assert tpart.layout_dims(mesh, "2d") == (("data",), ("model",))
    # the fleet layouts are ported: the leading axis shards the lanes
    assert tpart.layout_dims(mesh, "fleet") == (("model",), ())
    assert tpart.fleet_dims(mesh, "fleet") == ("data",)
    assert tpart.fleet_dims(mesh, "2d") == ()
    with pytest.raises(ValueError, match="make_fleet_mesh"):
        tpart.layout_dims(mesh, "fleet2d")
    with pytest.raises(ValueError, match="unknown layout"):
        tpart.layout_dims(mesh, "3d")
    _, flat = _fake_mesh((4,), ("data",))
    with pytest.raises(ValueError, match="needs >= 2 mesh axes"):
        tpart.layout_dims(flat, "2d")


# --------------------------------------------------------------------------- #
# Window coordinates and single-shard window movement                         #
# --------------------------------------------------------------------------- #

def test_window_idx_is_the_reference_shift_on_one_shard():
    """The halo layout's ids, shifted once at placement, are the
    reference's per-backup ``_shift_idx`` (clamped into the window)."""
    from repro.core import bellman as jbell
    from repro.core.comm import Axes as JAxes
    jm, tm = _pair("maze2d", size=9, gamma=0.99)
    for halo in (9, 12):
        want = np.asarray(jbell._shift_idx(jm.idx, jm, JAxes(), halo))
        got = tpart.window_idx(tm.idx, Axes(), tm.n_local, halo)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
    assert tpart.window_idx(tm.idx, Axes(), tm.n_local, 0) is tm.idx


def test_place_block_overlap_ids_are_local():
    tm = tgen.chain_walk(64, gamma=0.9)
    placed = tpart.place_block(tm, Axes(), halo=3, plan=(1, 1))
    assert torch.equal(placed.own_idx,
                       torch.clamp(tm.idx[1:63], 0, 63))
    assert torch.equal(placed.idx, torch.clamp(tm.idx + 3, 0, 64 + 6 - 1))
    assert tpart.place_block(tm, Axes()) is tm


@pytest.mark.parametrize("halo", [0, 3])
@pytest.mark.parametrize("lead", [(), (1,), (2,)])
def test_single_shard_windows(halo, lead):
    x = torch.arange(10 * int(np.prod(lead or (1,))), dtype=torch.float64) \
        .reshape(*lead, 10)
    axes = Axes()
    want = torch.cat([x[..., -halo:], x, x[..., :halo]], -1) if halo else x
    assert torch.equal(bellman.gather_v(x, axes, halo=halo), want)
    assert torch.equal(axes.gather_finish(axes.gather_start(x, halo=halo)),
                       want)
    w32 = bellman.gather_v(x, axes, halo=halo, dtype=torch.float32)
    assert w32.dtype == torch.float32 and torch.equal(w32, want.float())
    assert axes.psum_ordered(x) is x and axes.state_size() == 1
    # no fleet axis: the fleet collectives are the identity
    assert axes.any_fleet(x) is x and axes.pmax_fleet(x) is x
    assert axes.allgather_fleet(x) is x
    assert (axes.fleet_index(), axes.fleet_size()) == (0, 1)
