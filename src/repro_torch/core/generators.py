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


# --------------------------------------------------------------------------- #
# Function-backed constructor variants (torch, on the rows' device)            #
# --------------------------------------------------------------------------- #
#
# Each ``*_functions`` builder returns the keyword dict
# ``{"P_fn", "g_fn", "n", "m", "nnz", "gamma", "vectorized", "band"}`` for
# ``repro_torch.api.MDP.from_functions(**spec, device=True)``: the
# constructors are torch functions over an int32 row tensor (the action is
# a Python int) that compute on that tensor's device, so a function-backed
# MDP is built — or, matrix-free, rebuilt inside every backup — where it
# is solved.  They accept any int32 row id (shard-padding rows >= n are
# masked by the caller).
#
# The tables are the reference's FN_REGISTRY tables: maze2d / chain_walk
# bit for bit (and so the host generators'), garnet the reference's
# counter-based draws (below) bit for bit, sis its float32 arithmetic as
# XLA:CPU compiles it (bit for bit where XLA fuses it so; its fusion
# varies with the shape, and then a value is a ulp off).
#
# The closure helpers are memoized on everything except gamma, as the
# reference's lru_cache does: a sweep ``[from_generator(name,
# deferred=True, gamma=g) for g in gammas]`` hands every instance the same
# (P_fn, g_fn) pair, so the instances share one row spec and a fleet of
# them rebuilds each row chunk once for every lane.

from functools import lru_cache

import torch

from repro_torch.kernels import matrix_free

_U32 = 0xFFFFFFFF
# threefry-2x32's rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1) -> tuple:
    """The threefry-2x32 block cipher (20 rounds) of JAX's default PRNG
    on key words ``(k0, k1)`` and counter words ``(x0, x1)``: int64
    tensors (or ints) holding uint32 values, broadcast together.  Every
    add is reduced mod 2^32 and every shift stays inside the low 32 bits,
    so the two output words are exactly jax's ``threefry2x32_p`` outputs.
    The rounds run in place on two fresh tensors (about 170 elementwise
    ops a call)."""
    dev = next(w.device for w in (k0, k1, x0, x1)
               if isinstance(w, torch.Tensor))
    t = lambda w: torch.as_tensor(w, dtype=torch.int64, device=dev)
    k0, k1 = t(k0), t(k1)
    x0, x1 = torch.broadcast_tensors((t(x0) + k0) & _U32,
                                     (t(x1) + k1) & _U32)
    x0, x1 = x0.clone(), x1.clone()
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_U32)
            hi = (x1 << r).bitwise_and_(_U32)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_U32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_U32)
    return x0, x1


def fold_in(key: tuple, data) -> tuple:
    """``jax.random.fold_in`` of the raw key ``(k0, k1)``: the cipher of
    the counter ``(0, uint32(data))``, ``data`` ids (a tensor or an int)
    taken mod 2^32 as jax casts them.  Broadcasts key words against
    ``data``."""
    return threefry2x32(key[0], key[1], 0,
                        torch.as_tensor(data).to(torch.int64) & _U32)


def _bits64(key: tuple, k: int) -> tuple:
    """``jax.random``'s 64-bit random bits of shape ``(k,)`` under the
    partitionable threefry (jax's default since 0.5): element ``i`` is the
    cipher of the counter ``(0, i)``, high word first, so the key words
    gain a trailing axis of ``k``."""
    i = torch.arange(k, dtype=torch.int64, device=key[0].device)
    return threefry2x32(key[0][..., None], key[1][..., None], 0, i)


def _uniform64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform``'s float64 from one 64-bit draw ``(hi,
    lo)``: its top 52 bits as the mantissa under exponent 0, minus 1."""
    one = 0x3FF0000000000000
    mant = (hi << 20) | (lo >> 12)
    return (mant | one).view(torch.float64) - 1.0


def _randint64(hi: tuple, lo: tuple, n: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, 0, n)`` drawing int64 from the
    64-bit draws ``hi`` and ``lo`` of the key's split halves:
    ``((hi % n) * (2^64 % n) + lo % n) % n``, each uint64 remainder taken
    from its two 32-bit words (every product stays below 2^63)."""
    span = max(int(n), 1)
    c32 = (1 << 32) % span
    mult = (c32 * c32) % span
    mod64 = lambda w: ((w[0] % span) * c32 + w[1] % span) % span
    return (mod64(hi) * mult + mod64(lo)) % span


@lru_cache(maxsize=64)
def _garnet_fns(n: int, m: int, k: int, seed: int):
    base = (int(seed) >> 32 & _U32, int(seed) & _U32)   # PRNGKey(seed), x64
    pair = lambda key, j: (key[0][..., j], key[1][..., j])

    def _row_key(rows, a):
        # fold_in(fold_in(PRNGKey(seed), row), a).  Inside a chunk's build
        # the row key is computed once a chunk and the action's once an
        # action, in that build's own memo; any other call computes both.
        memo = matrix_free.chunk_memo(rows)
        if memo is None:
            return fold_in(fold_in(base, rows), a)
        if base not in memo:
            memo[base] = (fold_in(base, rows), None, None)
        key, last_a, key_a = memo[base]
        if last_a != a:
            key_a = fold_in(key, a)
            memo[base] = (key, a, key_a)
        return key_a

    def P_fn(rows, a):
        # the row's keys for its ids (fold 0) and its probabilities (fold
        # 1), then randint's split halves of the first: one cipher call
        # each, over a trailing axis
        two = torch.arange(2, device=rows.device)
        sub = fold_in(tuple(w[:, None] for w in _row_key(rows, a)), two)
        halves = fold_in(tuple(w[:, None] for w in pair(sub, 0)), two)
        hi, lo = _bits64(halves, k)                        # (R, 2, k)
        ids = _randint64((hi[:, 0], lo[:, 0]), (hi[:, 1], lo[:, 1]), n)
        raw = _uniform64(*_bits64(pair(sub, 1), k)) + 1e-6
        total = raw[:, 0]
        for j in range(1, k):      # left to right, as XLA:CPU sums 8 slots
            total = total + raw[:, j]
        return ids.to(torch.int32), (raw / total[:, None]).to(torch.float32)

    def g_fn(rows, a):
        # uniform(fold_in(row key, 2), ()): the counter (0, 0)
        return _uniform64(*threefry2x32(*fold_in(_row_key(rows, a), 2),
                                        0, 0))

    return P_fn, g_fn


def garnet_functions(n: int, m: int, k: int = 8, gamma: float = 0.95,
                     seed: int = 0) -> dict:
    """GARNET by a counter-based PRNG: any row block is drawn on its own,
    on the device that holds it.  The draws are the reference's under
    ``jax_enable_x64`` (int64 ids, float64 uniforms), bit for bit."""
    P_fn, g_fn = _garnet_fns(n, m, k, seed)
    # band=None: successors are drawn globally — no banded structure
    return dict(P_fn=P_fn, g_fn=g_fn, n=n, m=m, nnz=k, gamma=gamma,
                vectorized=True, band=None)


@lru_cache(maxsize=64)
def _maze2d_fns(size: int, slip: float):
    n, m = size * size, 5
    moves = ((0, 0), (-1, 0), (1, 0), (0, 1), (0, -1))
    goal = n - 1

    def P_fn(rows, a):
        r, c = rows // size, rows % size
        nr = torch.clamp(r + moves[a][0], 0, size - 1)
        nc = torch.clamp(c + moves[a][1], 0, size - 1)
        tgt = nr * size + nc
        at_goal = rows == goal
        f64 = lambda x: torch.tensor(x, dtype=torch.float64,
                                     device=rows.device)
        i0 = torch.where(at_goal, goal, tgt)
        i1 = torch.where(at_goal, goal, rows)
        v0 = torch.where(at_goal, f64(1.0), f64(1.0 - slip))
        v1 = torch.where(at_goal, f64(0.0), f64(slip))
        return (torch.stack([i0, i1], -1).to(torch.int32),
                torch.stack([v0, v1], -1).to(torch.float32))

    def g_fn(rows, a):
        return (rows != goal).to(torch.float32)

    return P_fn, g_fn


def maze2d_functions(size: int, gamma: float = 0.99, slip: float = 0.1,
                     seed: int = 0) -> dict:
    """maze2d by constructors; the tables of :func:`maze2d` bit for bit."""
    P_fn, g_fn = _maze2d_fns(size, slip)
    # band=size: a row move shifts the flat index by +-size (N/S moves)
    return dict(P_fn=P_fn, g_fn=g_fn, n=size * size, m=5, nnz=2,
                gamma=gamma, vectorized=True, band=size)


def _f32_div(a: float, b: float) -> float:
    """``float32(a) / float32(b)`` rounded to float32 (a Python float)."""
    return float(torch.tensor(a, dtype=torch.float32)
                 / torch.tensor(b, dtype=torch.float32))


@lru_cache(maxsize=64)
def _sis_fns(pop: int, n_actions: int):
    n, m = pop + 1, n_actions
    beta = np.linspace(0.9, 0.05, m)
    act_cost = np.linspace(0.0, 0.15, m)
    mu = 0.3
    # the reference's float32 arithmetic as XLA compiles it: a division
    # by a constant becomes a product with its float32 reciprocal, a
    # constant times x over a constant x times their float32 quotient, and
    # the cost's product and add one fused multiply-add
    inv_pop2 = _f32_div(1.0, float(pop**2))
    mu_pop, two_pop = _f32_div(mu, pop), _f32_div(2.0, pop)

    def P_fn(rows, a):
        i = rows.to(torch.float32)
        zero = torch.zeros((), dtype=torch.float32, device=rows.device)
        up = torch.clamp(float(beta[a]) * i * (pop - i) * inv_pop2, 0, 0.49)
        down = torch.clamp(i * mu_pop, 0, 0.49)
        at_zero = rows == 0
        up = torch.where(at_zero, zero, up)
        down = torch.where(at_zero, zero, down)
        stay = 1.0 - up - down
        ids = torch.stack([torch.clamp(rows + 1, 0, n - 1),
                           torch.clamp(rows - 1, 0, n - 1), rows], -1)
        return ids.to(torch.int32), torch.stack([up, down, stay], -1)

    def g_fn(rows, a):
        # 2 i / pop + cost_a, 0 load at i = 0: fma(i, 2/pop, cost_a)
        i = rows.to(torch.float32)
        scalar = lambda x: torch.tensor(x, dtype=torch.float32,
                                        device=rows.device)
        return torch.addcmul(scalar(float(act_cost[a])).expand_as(i), i,
                             scalar(two_pop))

    return P_fn, g_fn


def sis_functions(pop: int, n_actions: int = 4, gamma: float = 0.99,
                  seed: int = 0) -> dict:
    """The SIS chain by constructors, in float32 as the reference's
    compiled constructors compute it (so to rounding, not bitwise,
    :func:`sis`'s float64 tables)."""
    P_fn, g_fn = _sis_fns(pop, n_actions)
    # band=1: birth-death chain, transitions only to i-1 / i / i+1
    return dict(P_fn=P_fn, g_fn=g_fn, n=pop + 1, m=n_actions, nnz=3,
                gamma=gamma, vectorized=True, band=1)


@lru_cache(maxsize=64)
def _chain_walk_fns(n: int, p_fwd: float):

    def P_fn(rows, a):
        left = torch.clamp(rows - 1, 0, n - 1)
        right = torch.clamp(rows + 1, 0, n - 1)
        fwd, bwd = (left, right) if a == 0 else (right, left)
        probs = torch.tensor([p_fwd, 1 - p_fwd], dtype=torch.float32,
                             device=rows.device).expand(rows.shape[0], 2)
        return torch.stack([fwd, bwd], -1).to(torch.int32), probs

    def g_fn(rows, a):
        return (rows != 0).to(torch.float32)

    return P_fn, g_fn


def chain_walk_functions(n: int, gamma: float = 0.9999, p_fwd: float = 0.7,
                         seed: int = 0) -> dict:
    """chain_walk by constructors; the tables of :func:`chain_walk` bit
    for bit."""
    P_fn, g_fn = _chain_walk_fns(n, p_fwd)
    # band=1: random walk steps at most one state left/right
    return dict(P_fn=P_fn, g_fn=g_fn, n=n, m=2, nnz=2, gamma=gamma,
                vectorized=True, band=1)


FN_REGISTRY = {"garnet": garnet_functions, "maze2d": maze2d_functions,
               "sis": sis_functions, "chain_walk": chain_walk_functions}
