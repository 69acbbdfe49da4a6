"""MDP instance generators (host numpy, tables bit-identical to the reference).

Counterpart of the host generators of :mod:`repro.core.generators`: the
same numpy draws in the same order, so every table equals the reference's
bit for bit.  Only :func:`_finish` differs — it builds host torch tensors;
:func:`repro_torch.core.driver.solve` moves them to the solve device.

  * ``garnet``     — random GARNET MDPs (branching factor ``k``);
  * ``maze2d``     — slippery grid-world navigation (sparse, structured);
  * ``sis``        — SIS epidemic birth–death chain with intervention levels;
  * ``chain_walk`` — slow-mixing random walk (gamma -> 1 stress case).

Every generator is deterministic in ``(seed, row_range)``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.mdp import EllMDP


def _rng(seed: int, start: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, start]))


def _finish(idx, val, cost, gamma, n, m) -> EllMDP:
    return EllMDP.from_numpy(idx, val, cost, gamma, n, m, device="cpu")


def garnet(n: int, m: int, k: int = 8, gamma: float = 0.95, seed: int = 0,
           rows: tuple[int, int] | None = None) -> EllMDP:
    """GARNET(n, m, k): k random successors with Dirichlet(1) probabilities."""
    start, stop = rows or (0, n)
    rng = _rng(seed, start)
    nr = stop - start
    idx = rng.integers(0, n, size=(nr, m, k), dtype=np.int64)
    raw = rng.random((nr, m, k)).astype(np.float64) + 1e-6
    val = raw / raw.sum(-1, keepdims=True)
    cost = rng.random((nr, m))
    return _finish(idx, val, cost, gamma, n, m)


def maze2d(size: int, gamma: float = 0.99, slip: float = 0.1, seed: int = 0,
           rows: tuple[int, int] | None = None) -> EllMDP:
    """size x size grid; actions (stay,N,S,E,W); goal = last cell, absorbing.

    Each move succeeds w.p. 1-slip and slips back to the current cell w.p.
    ``slip``; walls (boundary) bounce.  Unit cost per step, 0 at the goal.
    """
    n, m, k = size * size, 5, 2
    start, stop = rows or (0, n)
    s = np.arange(start, stop)
    r, c = s // size, s % size
    moves = np.array([[0, 0], [-1, 0], [1, 0], [0, 1], [0, -1]])
    idx = np.zeros((stop - start, m, k), np.int64)
    val = np.zeros((stop - start, m, k), np.float64)
    cost = np.ones((stop - start, m), np.float64)
    goal = n - 1
    for a in range(m):
        nr_ = np.clip(r + moves[a, 0], 0, size - 1)
        nc = np.clip(c + moves[a, 1], 0, size - 1)
        tgt = nr_ * size + nc
        idx[:, a, 0] = tgt
        idx[:, a, 1] = s
        val[:, a, 0] = 1.0 - slip
        val[:, a, 1] = slip
    at_goal = s == goal
    idx[at_goal] = goal            # absorbing
    val[at_goal, :, 0] = 1.0
    val[at_goal, :, 1] = 0.0
    cost[at_goal] = 0.0
    return _finish(idx, val, cost, gamma, n, m)


def sis(pop: int, n_actions: int = 4, gamma: float = 0.99, seed: int = 0,
        rows: tuple[int, int] | None = None) -> EllMDP:
    """SIS epidemic: state = #infected in [0, pop]; action = intervention level.

    Birth–death chain: infections up w.p. beta_a * i * (pop - i) / pop^2,
    recoveries down w.p. mu * i / pop.  Cost = infection load + intervention
    cost.  State 0 is absorbing (disease eradicated).
    """
    n, m, k = pop + 1, n_actions, 3
    start, stop = rows or (0, n)
    i = np.arange(start, stop, dtype=np.float64)
    beta = np.linspace(0.9, 0.05, m)         # stronger action -> lower spread
    act_cost = np.linspace(0.0, 0.15, m)     # intervention much cheaper than
    mu = 0.3                                 # a full-blown epidemic
    up = np.clip(beta[None, :] * (i[:, None] * (pop - i[:, None])) / pop**2,
                 0, 0.49)
    down = np.broadcast_to(np.clip(mu * i[:, None] / pop, 0, 0.49),
                           up.shape).copy()
    stay = 1.0 - up - down
    s = np.arange(start, stop)
    idx = np.stack([np.clip(s + 1, 0, n - 1)[:, None].repeat(m, 1),
                    np.clip(s - 1, 0, n - 1)[:, None].repeat(m, 1),
                    s[:, None].repeat(m, 1)], axis=-1)
    val = np.stack([up, down, stay], axis=-1)
    cost = 2.0 * i[:, None] / pop + act_cost[None, :]
    at_zero = s == 0
    val[at_zero] = np.array([0.0, 0.0, 1.0])
    cost[at_zero] = act_cost[None, :]
    return _finish(idx, val, cost, gamma, n, m)


def chain_walk(n: int, gamma: float = 0.9999, p_fwd: float = 0.7,
               seed: int = 0, rows: tuple[int, int] | None = None) -> EllMDP:
    """Slow-mixing 1-D chain; target = state 0.  Conditioning ~ 1/(1-gamma):
    the instance family where VI stalls and Krylov iPI shines."""
    m, k = 2, 2
    start, stop = rows or (0, n)
    s = np.arange(start, stop)
    left = np.clip(s - 1, 0, n - 1)
    right = np.clip(s + 1, 0, n - 1)
    # action 0: try left; action 1: try right
    idx = np.stack([np.stack([left, right], -1),
                    np.stack([right, left], -1)], axis=1)
    val = np.broadcast_to(np.array([p_fwd, 1 - p_fwd]), (stop - start, m, k))
    cost = np.where((s == 0)[:, None], 0.0, 1.0) * np.ones((1, m))
    return _finish(idx, val.copy(), np.broadcast_to(cost, (stop - start, m)).copy(),
                   gamma, n, m)


REGISTRY = {"garnet": garnet, "maze2d": maze2d, "sis": sis,
            "chain_walk": chain_walk}


def generate_many(kind: str, batch: int, *, sweep=None, **kw) -> list[EllMDP]:
    """Generate a fleet of ``batch`` related instances in one call.

    By default this is a *seed ensemble*: instance ``b`` gets
    ``seed = kw.get("seed", 0) + b``.  ``sweep`` maps parameter names to
    length-``batch`` value sequences and overrides the per-instance kwargs
    instead (the seed stays fixed unless swept), e.g. a gamma sweep::

        generate_many("chain_walk", 4, n=300,
                      sweep={"gamma": [0.9, 0.99, 0.999, 0.9999]})

    The result feeds :func:`repro_torch.core.mdp.stack_mdps` /
    :func:`repro_torch.core.driver.solve_many`.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    fn = REGISTRY[kind]
    for name, vals in (sweep or {}).items():
        if len(vals) != batch:
            raise ValueError(f"sweep[{name!r}] has {len(vals)} values for "
                             f"batch={batch}")
    out = []
    for b in range(batch):
        kwb = dict(kw)
        if sweep:
            for name, vals in sweep.items():
                kwb[name] = vals[b]
        else:
            kwb["seed"] = int(kw.get("seed", 0)) + b
        out.append(fn(**kwb))
    return out
