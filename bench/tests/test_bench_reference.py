"""The plain reference, the input draw and the roofline counts, on the
CPU at small sizes."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import manifest as mf  # noqa: E402
from bench import roofline  # noqa: E402

GARNET = mf.module("inputs", "garnet_ell")
REF = mf.module("reference", "ell_mdp")
CPU = torch.device("cpu")
SMALL = {"n": 300, "m": 5, "k": 4, "gamma": 0.99}


def dense_q(idx, val, cost, gamma, v):
    n, m, k = idx.shape
    p = np.zeros((n, m, n))
    for s in range(n):
        for a in range(m):
            for j in range(k):
                p[s, a, idx[s, a, j]] += val[s, a, j]
    return cost + gamma * p @ v


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU solves run fastest, and steadiest beside other test
    workers, on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tables(cfg, lane):
    inst = GARNET.instance(cfg, lane, CPU)
    return inst["idx"], inst["val"]


def cost(cfg, lane, draw):
    return GARNET.problem(cfg, GARNET.instance(cfg, lane, CPU), lane, draw,
                          CPU)["cost"]


@pytest.mark.parametrize("lane", [0, 7])
def test_draw_is_seeded_and_stochastic(lane):
    idx, val = tables(SMALL, lane)
    idx2, val2 = tables(SMALL, lane)
    assert torch.equal(idx, idx2) and torch.equal(val, val2)
    assert not torch.equal(idx, tables(SMALL, lane + 1)[0])
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    assert int(idx.min()) >= 0 and int(idx.max()) < SMALL["n"]
    assert torch.allclose(val.sum(-1), torch.ones(()), atol=1e-6)
    c1 = cost(SMALL, lane, 0)
    assert torch.equal(c1, cost(SMALL, lane, 0))
    assert not torch.equal(c1, cost(SMALL, lane, 1))
    assert not torch.equal(c1, cost(SMALL, lane + 1, 0))
    assert c1.shape == (SMALL["n"], SMALL["m"]) and float(c1.min()) >= 0


@pytest.mark.parametrize("block_rows", [7, 1 << 18])
def test_reference_against_dense_numpy(block_rows):
    data = GARNET.problem(SMALL, GARNET.instance(SMALL, 11, CPU), 11, 3,
                          CPU)
    idx, val, cost = data["idx"], data["val"], data["cost"]
    rng = np.random.default_rng(5)
    v = rng.random(SMALL["n"]) * 50
    pi = rng.integers(0, SMALL["m"], SMALL["n"]).astype(np.int32)
    q = dense_q(idx.numpy(), val.numpy().astype(np.float64),
                cost.numpy().astype(np.float64), 0.99, v)
    got = REF.check({**data, "gamma": 0.99}, v, pi, block_rows=block_rows)
    best = q.min(-1)
    assert got["residual"] == pytest.approx(np.abs(best - v).max(),
                                            rel=1e-12)
    gap = (q[np.arange(SMALL["n"]), pi] - best).max()
    assert got["policy_gap"] == pytest.approx(gap, rel=1e-12)
    greedy = q.argmin(-1).astype(np.int32)
    assert REF.check({**data, "gamma": 0.99}, v, greedy,
                     block_rows=block_rows)["policy_gap"] == 0.0


def test_reference_refuses_malformed_answers():
    idx, val = tables(SMALL, 1)
    cost_ = cost(SMALL, 1, 0)
    v = np.zeros(SMALL["n"])
    short = REF.backup_check(idx, val, cost_, 0.99, v[:-1],
                             np.zeros(SMALL["n"] - 1))
    assert short["residual"] == math.inf
    bad_pi = np.full(SMALL["n"], SMALL["m"], np.int32)
    assert REF.backup_check(idx, val, cost_, 0.99, v, bad_pi)["policy_gap"] \
        == math.inf
    nan_v = v.copy()
    nan_v[3] = np.nan
    got = REF.backup_check(idx, val, cost_, 0.99, nan_v,
                           np.zeros(SMALL["n"]))
    assert not got["residual"] <= 1.0


def test_roofline_bytes_of_the_kernel_table():
    # PERF.md kernel rows 1 and 2 at n = 10^6, m = 16, K = 8, float64
    backup = roofline.backup_bytes(10**6, 16, 8, "float64")
    matvec = roofline.matvec_bytes(10**6, 8, "float64")
    assert backup == 1_108_000_000
    assert matvec == 80_000_000
    t_backup, by = roofline.bound_s(backup, 2.0 * 128e6, "float64")
    assert by == "bytes" and round(t_backup * 1e3, 3) == 0.331
    t_matvec, _ = roofline.bound_s(matvec, 2.0 * 8e6, "float64")
    assert round(t_matvec * 1e3, 4) == 0.0239


def test_needed_matvecs():
    # 6 outer steps, 66 useful inner steps, one restart cycle each
    trace = [14, 12, 11, 10, 10, 9]
    assert sum(trace) == 66
    assert roofline.gmres_matvecs(trace, 32) == 78
    assert roofline.needed_matvecs("ipi_gmres", trace, 32) == 78
    assert roofline.gmres_matvecs([0], 32) == 1
    assert roofline.gmres_matvecs([33], 32) == 1 + 2 + 33
    assert roofline.needed_matvecs("mpi", [49] * 6, 32) == 300
    assert roofline.backups(6) == 7


def _count_matvecs(monkeypatch, method):
    from repro_torch.api import Session
    from repro_torch.core import bellman
    from repro_torch.core.mdp import EllMDP

    calls = []
    real = bellman.a_pi_matvec

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(bellman, "a_pi_matvec", counted)
    cfg = {"n": 400, "m": 6, "k": 4, "gamma": 0.99}
    idx, val = tables(cfg, 3)
    mdp = EllMDP(idx=idx, val=val, cost=cost(cfg, 3, 0), gamma=0.99,
                 n_global=cfg["n"], m_global=cfg["m"])
    with Session({"-device": "cpu", "-method": method, "-atol": 1e-8,
                  "-dtype": "float64", "-restart": 8}) as s:
        r = s.solve(mdp)
    assert r.converged
    return r, len(calls)


def test_gmres_rule_against_the_port_matvec_calls(monkeypatch):
    """The port calls the matvec 2 + restart times a cycle (the warm
    start's residual twice, then every Arnoldi step, masked after
    convergence); the rule counts what the counts reported need, never
    more than that."""
    r, launched = _count_matvecs(monkeypatch, "ipi_gmres")
    cycles = [math.ceil(j / 8) for j in r.trace_inner]
    assert launched == sum(1 + c * (1 + 8) for c in cycles)
    needed = roofline.needed_matvecs("ipi_gmres", r.trace_inner, 8)
    assert needed == sum(1 + c + j for c, j in zip(cycles, r.trace_inner))
    assert needed <= launched


def test_richardson_rule_against_the_port_matvec_calls(monkeypatch):
    r, launched = _count_matvecs(monkeypatch, "mpi")
    assert launched == roofline.needed_matvecs("mpi", r.trace_inner, 8)
