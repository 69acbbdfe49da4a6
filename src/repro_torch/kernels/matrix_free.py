"""Matrix-free Bellman operator: rows rebuilt from constructors, never stored.

Counterpart of :mod:`repro.kernels.matrix_free`.  A materialized MDP keeps
an ``O(n * m * nnz)`` ELL table and streams it through the backup kernels.
The matrix-free operator keeps only the function-backed MDP's row
constructors (``P_fn(rows, a) -> (ids, probs)``, ``g_fn(rows, a) ->
cost``, torch functions of an int32 row tensor) and **rebuilds** each row
chunk inside every backup and every policy-row extraction: the persistent
state of a solve is ``O(n)`` — value vectors and a 1-byte placement tag.

Parity contract: every function here gives the bits of the materialized
path.

* :func:`build_rows_block` is the builder the device pipeline of
  :class:`repro_torch.api.MDP` materializes tables with, so a rebuilt chunk
  equals the stored table's rows bit for bit;
* :func:`mf_backup` runs each chunk through
  :func:`repro_torch.kernels.ops.ell_backup_chunk` — the hand-written
  ``ell_backup`` on the card, its plain version on the CPU — whose math is
  row-independent, so any chunking gives the same bits;
* :func:`mf_policy_rows` replays :func:`repro_torch.core.bellman.
  policy_rows`'s gather and ownership mask on rebuilt chunks, so the inner
  solvers consume the same ``PolicyRows`` and need no change.

A fleet of function-backed MDPs shares one spec (only gamma differs
between its lanes), so each chunk is rebuilt once and one launch backs up
every lane against its own value vector.

Chunks are :func:`chunk_rows` rows, a fixed rule: as many rows as keep a
chunk's transient — its ``(bn, m, nnz)`` table plus the constructors'
temporaries (:data:`CONSTRUCTOR_SLOT_BYTES` a slot) — under
:data:`CHUNK_BYTES`.  Few
large chunks, because eager constructors cost host time a launch
(``chip_smoke.py`` phase 3n times one rebuild of garnet ``n = 10^6, m =
16, K = 8`` on the H100 in chunks of half the rule's rows, the rule's and
all rows: PERF.md).  The reference tunes its chunk by timing the blocked
backup; here a rebuild is almost all constructor time (ROADMAP queue 3
item 9), so that timing would choose for the wrong cost, and the chunk
waits for the fused constructor of that item.  Each chunk's backup runs
:func:`repro_torch.kernels.ops.ell_backup_chunk` with the solve's
``impl``, so on the card it launches at the tuner's shape.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import ops, ref

__all__ = ["RowSpec", "build_rows_block", "chunk_bytes", "chunk_memo",
           "chunk_rows", "mf_backup", "mf_policy_rows", "table_bytes",
           "operator_bytes"]

_BIG = 1e30

# the byte cap of one rebuilt chunk's transient (its table and the
# constructors' temporaries), and the constructors' temporaries a slot of
# one action's (bn, nnz) block: the built-in garnet's counter-based draws
# peak at about 110 bytes a slot (1.95 KB a row of m = 16, K = 8 with the
# chunk's table, measured on the H100: PERF.md)
CHUNK_BYTES = 512 << 20
CONSTRUCTOR_SLOT_BYTES = 128

# the rows tensor of the chunk that build_rows_block is building in this
# context, and the memo its constructors share (chunk_memo)
_CHUNK = contextvars.ContextVar("chunk", default=None)


@dataclasses.dataclass(frozen=True)
class RowSpec:
    """The static description of a function-backed MDP's rows — what a
    matrix-free container carries instead of tables.

    Hashable (callables compare by identity) and gamma-free on purpose: a
    gamma sweep over one constructor pair shares a single spec, so its
    fleet rebuilds each chunk once for every lane (the generator registry
    memoizes its closures, so constructor identity is stable across
    calls).

    ``band`` is the declared matrix bandwidth — ``|successor - row| <=
    band`` for every nonzero-weight successor — or ``None`` when the rows
    reach globally.  The partition planner derives the frontier margins
    and the halo width from it, since there are no tables to measure.
    """

    p_fn: Callable
    g_fn: Callable
    n: int
    m: int
    nnz: int
    vectorized: bool
    band: int | None = None


def _conform(what: str, a: int, arr, shape: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    if not isinstance(arr, torch.Tensor):
        raise TypeError(f"device {what}(rows, a={a}) must return torch "
                        f"tensors computed on the rows' device, got "
                        f"{type(arr).__name__}")
    if arr.device != device:
        raise ValueError(f"device {what}(rows, a={a}) returned a tensor on "
                         f"{arr.device} for rows on {device}: constructors "
                         f"compute where the rows are")
    if arr.dim() == 0 and len(shape) == 1:
        arr = arr.expand(shape)
    if tuple(arr.shape) != shape:
        raise ValueError(f"device {what}(rows, a={a}) must return shape "
                         f"{shape} (nnz={shape[-1] if shape else 1} slots "
                         f"per row — zero-pad unused slots), got "
                         f"{tuple(arr.shape)}")
    return arr.to(dtype)


def _construct(spec, rows: torch.Tensor, a: int) -> tuple:
    """``(ids (R, K) int32, probs (R, K) float32, cost (R,) float32)`` of
    action ``a`` from the constructors: one call on the rows, or, for
    per-state constructors, ``torch.func.vmap`` over them."""
    K, R, dev = spec.nnz, rows.shape[0], rows.device
    if spec.vectorized:
        ids, probs = spec.p_fn(rows, a)
        return (_conform("P_fn", a, ids, (R, K), torch.int32, dev),
                _conform("P_fn", a, probs, (R, K), torch.float32, dev),
                _conform("g_fn", a, spec.g_fn(rows, a), (R,), torch.float32,
                         dev))

    def one(r):
        i, p = spec.p_fn(r, a)
        return (_conform("P_fn", a, i, (K,), torch.int32, dev),
                _conform("P_fn", a, p, (K,), torch.float32, dev),
                _conform("g_fn", a, spec.g_fn(r, a), (), torch.float32, dev))

    return torch.func.vmap(one)(rows)


def chunk_memo(rows: torch.Tensor) -> dict | None:
    """The memo of the chunk :func:`build_rows_block` is building in this
    context, when ``rows`` is that chunk's rows tensor, else ``None``.  A
    constructor may keep there the work its calls share across one chunk's
    actions (garnet's per-row key).  The memo lives for one build and is
    held in a context variable, so no other build, thread or caller sees
    it."""
    chunk = _CHUNK.get()
    return chunk[1] if chunk is not None and chunk[0] is rows else None


def build_rows_block(spec, rows: torch.Tensor, acts: tuple, mode: str, *,
                     check: bool = True) -> tuple:
    """One ELL block: ``rows`` (int32 global ids, on the block's device) x
    ``acts`` (global action ids, padding included).

    ``spec`` needs ``p_fn`` / ``g_fn`` / ``n`` / ``m`` / ``nnz`` /
    ``vectorized`` (a :class:`RowSpec`, or the api layer's function spec).
    The padding is the host pipeline's: padded states (``rows >= n``) are
    zero-cost absorbing self-loops; padded action columns (``a >= m``)
    carry the never-greedy ``+-BIG`` cost of the solve ``mode`` and point
    at state 0.  Constructors see the raw row ids, shard padding included
    (their outputs there are masked), so they must take any int32 id.

    Returns ``(idx (R, A, K) int32, val (R, A, K) float32, cost (R, A)
    float32, bad)``; ``bad`` is the ``(2,)`` int64 count of validation
    failures over the real entries — successor ids outside ``[0, n)`` and
    probability rows not summing to ~1 — left on the device, so a caller
    reads every chunk's counts once; ``None`` without ``check``.
    """
    big = _BIG if mode == "mincost" else -_BIG
    K, R, dev = spec.nnz, rows.shape[0], rows.device
    n_acts = len(acts)
    idx = torch.zeros((R, n_acts, K), dtype=torch.int32, device=dev)
    val = torch.zeros((R, n_acts, K), dtype=torch.float32, device=dev)
    cost = torch.zeros((R, n_acts), dtype=torch.float32, device=dev)
    pad_row = (rows >= spec.n)[:, None]
    self_idx = torch.zeros((R, K), dtype=torch.int32, device=dev)
    self_idx[:, 0] = rows
    self_val = torch.zeros((R, K), dtype=torch.float32, device=dev)
    self_val[:, 0] = 1.0
    bad = torch.zeros((2,), dtype=torch.int64, device=dev) if check \
        else None
    token = _CHUNK.set((rows, {}))
    try:
        for j, a in enumerate(acts):
            if a >= spec.m:
                # never-greedy padded action: cost +-BIG, self-transition
                # to 0
                val[:, j] = self_val
                cost[:, j] = big
                continue
            ids, probs, g = _construct(spec, rows, int(a))
            if check:
                real = ~pad_row[:, 0]
                bad[0] += (((ids < 0) | (ids >= spec.n)).sum(-1)
                           * real).sum()
                bad[1] += ((torch.abs(probs.sum(-1) - 1.0) > 1e-4)
                           & real).sum()
            idx[:, j] = torch.where(pad_row, self_idx, ids)
            val[:, j] = torch.where(pad_row, self_val, probs)
            cost[:, j] = torch.where(pad_row[:, 0], 0.0, g)
    finally:
        _CHUNK.reset(token)
    return idx, val, cost, bad


def chunk_rows(spec, n_acts: int, block_rows: int | None = None) -> int:
    """Rows a rebuilt chunk takes: ``block_rows`` if given, else the
    fixed rule of the module docstring (not tuned: module docstring)."""
    if block_rows:
        return int(block_rows)
    return max(1, CHUNK_BYTES // chunk_bytes(spec, n_acts, 1))


def chunk_bytes(spec, n_acts: int, rows: int) -> int:
    """The transient bytes the rule of :func:`chunk_rows` allows for a
    chunk of ``rows`` rows."""
    return rows * (n_acts * (8 * spec.nnz + 4)
                   + CONSTRUCTOR_SLOT_BYTES * spec.nnz)


def _rows(row0: int, lo: int, hi: int, device) -> torch.Tensor:
    return row0 + torch.arange(lo, hi, dtype=torch.int32, device=device)


def mf_backup(spec, row0: int, n_rows: int, acts: tuple, gamma,
              v: torch.Tensor, *, mode: str = "mincost", idx_map=None,
              block_rows: int | None = None, impl: str | None = None) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """The matrix-free fused Bellman backup over ``n_rows`` rows from
    global row ``row0``: rebuild each row chunk from the constructors, back
    it up against the value window ``v``, drop it.

    ``idx_map`` maps the rebuilt *global* successor ids into ``v``'s
    coordinates (a halo window, an interior block's own rows); identity
    when ``None``.  ``mode="maxreward"`` negates inside, as the
    materialized backup does: the returned ``(vmin, amin)`` live in the
    negated min-space that :func:`repro_torch.core.bellman._finish_argmin`
    completes.  ``v`` ``(B, n_v)`` backs up a fleet's lanes (one spec,
    ``gamma`` a float or ``(B,)``) against one rebuild of each chunk.
    ``impl`` is the kernel implementation (:mod:`repro_torch.kernels.ops`).

    The transient is one chunk; the persistent footprint is the outputs.
    """
    neg = mode == "maxreward"
    if neg:
        v = -v

    def body(lo, hi):
        idx, val, cost, _ = build_rows_block(
            spec, _rows(row0, lo, hi, v.device), acts, mode, check=False)
        if neg:
            cost = -cost
        if idx_map is not None:
            idx = idx_map(idx)
        return ops.ell_backup_chunk(idx, val, cost, gamma, v, impl=impl)

    bn = chunk_rows(spec, len(acts), block_rows)
    return ref._blocked_rows(body, n_rows, bn, (-1, -1))


def mf_policy_rows(spec, row0: int, n_rows: int, acts: tuple,
                   a_sel: torch.Tensor, own: torch.Tensor | None, *,
                   mode: str = "mincost", idx_map=None,
                   block_rows: int | None = None) -> tuple:
    """Matrix-free ``P_pi`` / ``g_pi``: the rows of the actions ``a_sel``
    (``(B, n_rows)`` local ids), masked by ``own`` (``(B, n_rows, 1)``
    bool, or ``None`` for all-ones) exactly as :func:`repro_torch.core.
    bellman.policy_rows` selects and masks them from a stored table.
    ``idx_map`` as in :func:`mf_backup`.

    Each chunk rebuilds, action by action, only the rows some lane
    selects that action at (the constructors are row-independent, so a
    row comes out with the bits of a whole-chunk rebuild): one row's worth
    of constructor work a row and lane set, where selecting from rebuilt
    chunks would rebuild every action of every row.  Finding those rows
    reads the device once an action.

    Returns ``(idx_pi (B, n, K) int32, val_pi (B, n, K) float32, g_pi (B,
    n) float32)`` — the same ``O(n * nnz)`` rows the materialized
    selection produces; the ``O(n * m * nnz)`` table is never held.
    ``mode`` only fills padded action columns, which a greedy policy never
    selects.
    """
    lanes, K, dev = a_sel.shape[0], spec.nnz, a_sel.device

    def body(lo, hi):
        rows, a = _rows(row0, lo, hi, dev), a_sel[:, lo:hi]
        idx_pi = torch.zeros((lanes, hi - lo, K), dtype=torch.int32,
                             device=dev)
        val_pi = torch.zeros((lanes, hi - lo, K), dtype=torch.float32,
                             device=dev)
        g_pi = torch.zeros((lanes, hi - lo), dtype=torch.float32,
                           device=dev)
        for j, act in enumerate(acts):
            hit = a == j
            sel = torch.nonzero(hit.any(0))[:, 0]
            if not len(sel):
                continue
            idx, val, cost, _ = build_rows_block(spec, rows[sel], (act,),
                                                 mode, check=False)
            if idx_map is not None:
                idx = idx_map(idx)
            h = hit[:, sel]
            idx_pi[:, sel] = torch.where(h[..., None], idx[:, 0],
                                         idx_pi[:, sel])
            val_pi[:, sel] = torch.where(h[..., None], val[:, 0],
                                         val_pi[:, sel])
            g_pi[:, sel] = torch.where(h, cost[:, 0], g_pi[:, sel])
        if own is not None:
            o = own[:, lo:hi]
            val_pi = val_pi * o.to(val_pi.dtype)
            g_pi = g_pi * o[..., 0].to(g_pi.dtype)
        return idx_pi, val_pi, g_pi

    bn = chunk_rows(spec, 1, block_rows)
    return ref._blocked_rows(body, n_rows, bn, (-2, -2, -1))


# --------------------------------------------------------------------------- #
# Memory model (the reference's: serving admission, the dry-run cost model)   #
# --------------------------------------------------------------------------- #

# O(n) iteration state per state (f32): v, tv, window/staging, residual work
ITER_BYTES = 16


def table_bytes(n: int, m: int, nnz: int) -> int:
    """Materialized ELL container bytes: idx (int32) + val (float32) per
    slot, cost (float32) per (state, action) row."""
    return n * m * (8 * nnz + 4)


def operator_bytes(n: int, nnz: int, *, krylov: bool = True) -> int:
    """Peak per-solve device bytes of the matrix-free path: the 1-byte
    placement tag + O(n) value vectors, plus — for the policy-iteration
    methods (``krylov=True``) — the transient policy-restricted rows
    ``n * (8*nnz + 4)`` the inner solvers consume.  Pure VI never
    materializes policy rows; pass ``krylov=False`` for its footprint."""
    per = 1 + ITER_BYTES
    if krylov:
        per += 8 * nnz + 4
    return n * per
