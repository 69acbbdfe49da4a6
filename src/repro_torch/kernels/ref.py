"""Plain PyTorch versions of the kernels — the semantic ground truth.

Counterpart of :mod:`repro.kernels.ref`.  The CPU path runs these, and on
the card each CUDA kernel must equal its plain version bit for bit, so the
rounding is pinned exactly as the reference's ``pin_rounding`` pins it:

* ``val * v[idx]`` is rounded (one multiply, one rounding) before the
  K-sum;
* the K-sum runs in explicit order ``k = 0 .. K-1`` from a ``+0``
  accumulator — the order XLA:CPU's ``jnp.sum`` takes for ``K <= 12``
  (every built-in family has ``K <= 8``);
* ``gamma * pv`` is rounded before ``+ cost``.

The dense backup (:func:`dense_backup`) fixes its own summation order,
the CUDA kernel's: lane ``l`` of 32 sums the columns ``c = l (mod 32)`` in
increasing order from ``+0``, each product rounded on its own; then a fixed
halving tree adds lane ``l + w`` into lane ``l`` for ``w = 16, 8, 4, 2,
1``.  ``gamma * pv`` is again rounded before ``+ cost``.  The reference's
``dense_qvalues`` leaves its dot product to XLA, whose order this cannot
reproduce, so the dense versions agree with it to a tolerance.

Products and adds are separate tensor ops, so no fused multiply-add can
merge two roundings.

Fleets: :func:`ell_backup`, :func:`ell_qvalues`, :func:`ell_matvec` and
:func:`dense_backup` also take a leading lane axis ``B`` on ``val`` /
``cost`` / ``p``, ``idx`` batched or shared, ``v`` / ``x`` batched or
shared, and ``gamma`` a float or a ``(B,)`` tensor.  Each then is the
unbatched plain version applied lane by lane, so lane ``b`` equals the
unbatched call on its operands bit for bit, as the kernels' lane axis does.
:func:`ell_backup` also takes every table shared with a batched ``v`` (a
matrix-free fleet's rebuilt chunk).

:func:`_blocked_rows` is the row-chunk loop of the matrix-free operator,
of the function-backed MDPs' device pipeline and of the blocked versions
(:func:`ell_backup_blocked`, :func:`ell_qvalues_blocked`,
:func:`ell_matvec_blocked`: ``-kernel_impl blocked``), which run the
plain versions over row chunks of ``block_rows`` rows.  The math is
row-independent, so they equal the unblocked versions bit for bit.

:func:`flash_attention` is the online-softmax scan over key chunks of the
reference's ``models.attention.chunked_attention``, in f32 whatever the
inputs.  Its CUDA kernel sums in another order, so the two agree to a
tolerance, not bit for bit.
"""

from __future__ import annotations

import torch

LANES = 32   # one warp: the dense dot's lane count
NEG_INF = -1e30   # attention mask value, the reference's


def acc_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """Accumulation dtype: at least f32, f64 if any operand is f64."""
    if any(t.dtype == torch.float64 for t in tensors):
        return torch.float64
    return torch.float32


def _lane(x: torch.Tensor, b: int, batched_dims: int) -> torch.Tensor:
    """Lane ``b`` of an operand that is batched (``batched_dims`` dims) or
    shared by every lane."""
    return x[b] if x.dim() == batched_dims else x


def _lane_gamma(gamma, b: int):
    return gamma[b] if isinstance(gamma, torch.Tensor) else gamma


def _by_lane(fn, lanes: int):
    """Stack ``fn(b)``'s outputs (a tensor or a tuple) over the lanes."""
    outs = [fn(b) for b in range(lanes)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def ell_gather_dot(idx: torch.Tensor, val: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """``sum_k val[..., k] * v[idx[..., k]]`` — the ELL row-gather dot.

    idx: (..., K) int32 global column ids; val: (..., K); v: (n_cols,).
    Returns (...,) accumulated in >= f32 (f64 when v is f64).
    """
    dt = acc_dtype(val, v)
    vv = v.to(dt)
    shape = idx.shape[:-1]
    acc = torch.zeros(shape, dtype=dt, device=v.device)
    for k in range(idx.shape[-1]):
        gathered = vv.index_select(0, idx[..., k].reshape(-1)).reshape(shape)
        acc = acc + val[..., k].to(dt) * gathered
    return acc


def ell_qvalues(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
                gamma, v: torch.Tensor) -> torch.Tensor:
    """Q(s, a) = g(s, a) + gamma * sum_{s'} P(s, a, s') v(s')."""
    if val.dim() == 4:
        return _by_lane(lambda b: ell_qvalues(
            _lane(idx, b, 4), val[b], cost[b], _lane_gamma(gamma, b),
            _lane(v, b, 2)), val.shape[0])
    pv = ell_gather_dot(idx, val, v)
    if isinstance(gamma, torch.Tensor):
        gamma = gamma.to(pv.dtype)
    return cost.to(pv.dtype) + gamma * pv


def rowmin_argmin(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(min, int32 argmin) over the trailing axis by a running strict-``<``
    minimum: the first minimum (smallest index) wins ties."""
    best = q[..., 0]
    arg = torch.zeros(q.shape[:-1], dtype=torch.int32, device=q.device)
    for a in range(1, q.shape[-1]):
        qa = q[..., a]
        hit = qa < best
        best = torch.where(hit, qa, best)
        arg = torch.where(hit, torch.full_like(arg, a), arg)
    return best, arg


def ell_backup(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
               gamma, v: torch.Tensor) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Bellman backup: (min_a Q, argmin_a Q) with smallest-index
    tie-break."""
    if val.dim() == 4 or v.dim() == 2:
        # per-lane tables, or shared ones under a batched v
        return _by_lane(lambda b: ell_backup(
            _lane(idx, b, 4), _lane(val, b, 4), _lane(cost, b, 3),
            _lane_gamma(gamma, b), _lane(v, b, 2)),
            val.shape[0] if val.dim() == 4 else v.shape[0])
    return rowmin_argmin(ell_qvalues(idx, val, cost, gamma, v))


def ell_matvec(idx: torch.Tensor, val: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y(s) = sum_{s'} P_pi(s, s') x(s') on policy-restricted ELL rows (n, K)."""
    if val.dim() == 3:
        return _by_lane(lambda b: ell_matvec(
            _lane(idx, b, 3), val[b], _lane(x, b, 2)), val.shape[0])
    return ell_gather_dot(idx, val, x)


def _blocked_rows(fn, n: int, block_rows: int, row_dims: tuple):
    """``fn(lo, hi)`` over the fixed row ranges ``[lo, hi)`` of at most
    ``block_rows`` rows covering ``[0, n)``, each chunk's outputs written
    into preallocated tensors: output ``j`` holds its rows on dim
    ``row_dims[j]``.  One chunk returns ``fn(0, n)`` as it is."""
    bn = max(1, min(int(block_rows), n))
    if bn >= n:
        return fn(0, n)
    outs = None
    for lo in range(0, n, bn):
        hi = min(lo + bn, n)
        part = fn(lo, hi)
        if outs is None:
            outs = []
            for t, d in zip(part, row_dims):
                shape = list(t.shape)
                shape[d] = n
                outs.append(torch.empty(shape, dtype=t.dtype,
                                        device=t.device))
        for out, t, d in zip(outs, part, row_dims):
            out.narrow(d, lo, hi - lo).copy_(t)
    return tuple(outs)


# Rows a chunk of the blocked versions (the reference's default): at the
# paper's widths (m*K between 16 and 128 slots a row) a chunk's table
# slice and its Q block stay within a last-level cache.
DEFAULT_BLOCK_ROWS = 125_000


def ell_backup_blocked(idx: torch.Tensor, val: torch.Tensor,
                       cost: torch.Tensor, gamma, v: torch.Tensor,
                       block_rows: int = DEFAULT_BLOCK_ROWS) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ell_backup` over row chunks; bit for bit the same."""
    return _blocked_rows(lambda lo, hi: ell_backup(
        idx.narrow(-3, lo, hi - lo), val.narrow(-3, lo, hi - lo),
        cost.narrow(-2, lo, hi - lo), gamma, v), val.shape[-3], block_rows,
        (-1, -1))


def ell_qvalues_blocked(idx: torch.Tensor, val: torch.Tensor,
                        cost: torch.Tensor, gamma, v: torch.Tensor,
                        block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """:func:`ell_qvalues` over row chunks; bit for bit the same."""
    return _blocked_rows(lambda lo, hi: (ell_qvalues(
        idx.narrow(-3, lo, hi - lo), val.narrow(-3, lo, hi - lo),
        cost.narrow(-2, lo, hi - lo), gamma, v),), val.shape[-3],
        block_rows, (-2,))[0]


def ell_matvec_blocked(idx: torch.Tensor, val: torch.Tensor,
                       x: torch.Tensor,
                       block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """:func:`ell_matvec` over row chunks; bit for bit the same."""
    return _blocked_rows(lambda lo, hi: (ell_matvec(
        idx.narrow(-2, lo, hi - lo), val.narrow(-2, lo, hi - lo), x),),
        val.shape[-2], block_rows, (-1,))[0]


def dense_dot(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``sum_c p[..., c] * v[c]`` in the dense kernel's order (module
    docstring): column chunks of :data:`LANES` accumulate into one partial
    sum per lane, which a halving tree then reduces.

    p: (..., n_cols) f32; v: (n_cols,).  Returns (...,) accumulated in
    >= f32 (f64 when v is f64).
    """
    dt = acc_dtype(p, v)
    vv = v.to(dt)
    n_cols = p.shape[-1]
    acc = torch.zeros((*p.shape[:-1], LANES), dtype=dt, device=v.device)
    for c0 in range(0, n_cols, LANES):
        w = min(LANES, n_cols - c0)
        acc[..., :w] += p[..., c0:c0 + w].to(dt) * vv[c0:c0 + w]
    width = LANES
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width:2 * width]
    return acc[..., 0]


def dense_qvalues(p: torch.Tensor, cost: torch.Tensor, gamma,
                  v: torch.Tensor) -> torch.Tensor:
    """Dense-P Q table: ``cost + gamma * P @ v``, >= f32 accumulation."""
    pv = dense_dot(p, v)
    if isinstance(gamma, torch.Tensor):
        gamma = gamma.to(pv.dtype)
    return cost.to(pv.dtype) + gamma * pv


def dense_backup(p: torch.Tensor, cost: torch.Tensor, gamma,
                 v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense Bellman backup: (min_a Q, argmin_a Q) with smallest-index
    tie-break."""
    if p.dim() == 4:
        return _by_lane(lambda b: dense_backup(
            p[b], cost[b], _lane_gamma(gamma, b), _lane(v, b, 2)),
            p.shape[0])
    return rowmin_argmin(dense_qvalues(p, cost, gamma, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, chunk: int = 128, q_offset: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """Online-softmax GQA attention over key chunks, f32 accumulation.

    q: (B, T, H, hd) at absolute positions ``[q_offset, q_offset + T)``;
    k, v: (B, S, KV, hd) with ``H % KV == 0`` (query head ``h`` reads KV
    head ``h // (H // KV)``).  Keys ``>= kv_len`` (default ``S``) are
    excluded, and with ``causal`` so is every key after the query's
    position.  Scores are ``(q . k) * hd ** -0.5``; masked scores are
    ``NEG_INF`` and ``l`` is clamped at ``1e-30``, as in the reference.
    Chunks wholly past the causal frontier are skipped: they would leave
    ``(m, l, o)`` exactly as they are.  Returns (B, T, H, hd) in q's dtype.
    """
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    n_keys = s if kv_len is None else min(kv_len, s)
    if causal:
        n_keys = min(n_keys, q_offset + t)
    dev = q.device
    q32 = q.float().reshape(b, t, kvh, g, hd)
    qpos = q_offset + torch.arange(t, device=dev)
    m = torch.full((b, kvh, g, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, t), dtype=torch.float32, device=dev)
    o = torch.zeros((b, kvh, g, t, hd), dtype=torch.float32, device=dev)
    for c0 in range(0, max(n_keys, 0), chunk):
        kc = k[:, c0:c0 + chunk].float()
        vc = v[:, c0:c0 + chunk].float()
        sc = torch.einsum("btkgh,bskh->bkgts", q32, kc) * (hd ** -0.5)
        kpos = c0 + torch.arange(kc.shape[1], device=dev)
        mask = (kpos < n_keys)[None, :]
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bkgtc,bckh->bkgth", p, vc)
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    # (B, KV, G, T, hd) -> (B, T, H, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)
