"""Jacobi / block-Jacobi preconditioners for the policy-evaluation system.

Counterpart of :mod:`repro.core.solvers.precond`.  The Krylov inner
solvers attack ``A_pi x = g_pi`` with ``A_pi = I - gamma P_pi``; as gamma
nears 1 the system loses diagonal dominance and restarted GMRES stalls.
Two classic one-shot preconditioners need only the policy rows the matvec
already holds:

* ``jacobi`` — ``M = diag(A_pi)^-1``, applied elementwise;
* ``bjacobi`` — block Jacobi with block size ``-pc_block`` on the row
  order: entries of ``P_pi`` whose column falls in its row's block go
  into ``(b x b)`` tiles, the tiles ``I - gamma B_r`` are inverted once
  (``torch.linalg.inv`` over the batch) and applied as one batched tile
  matvec.  Rows past the last full block are padded with identity rows,
  so a trailing partial block is exact.  Couplings outside a block are
  dropped: that weakens the preconditioner, never the solve (the Krylov
  solvers iterate on the true operator).

Both are built in the tables' float32, as the reference builds them (a
dense solve in float64 holds its ``P_pi`` rows widened to float64, which
is exact to undo), and cast to the solve dtype once.  ``1 - gamma p`` is
one rounding (:func:`~repro_torch.core.bellman._fma`), as XLA:CPU
contracts the reference's expression.  The block strip of
an ELL table is accumulated one ``K`` slot at a time: within a slot each
row writes one cell, so no two writes collide and every cell sums in slot
order from ``+0`` on every device.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.bellman import _fma
from repro_torch.core.comm import Axes

_TINY = 1e-30

PC_TYPES = ("none", "jacobi", "bjacobi")

# the dtype the reference stores transition tables in
_TABLE_DTYPE = torch.float32


def _diag_p_pi(rows, axes: Axes, n_local: int, row0: int) -> torch.Tensor:
    """Local diagonal of ``P_pi`` (reduced over action shards); ``row0``
    is the position of the first local row among the rows' column ids."""
    if rows.idx is not None:
        dev = rows.idx.device
        gids = row0 + torch.arange(n_local, device=dev)
        hit = rows.idx.long() == gids[:, None]
        d = torch.sum(torch.where(hit, rows.val,
                                  torch.zeros_like(rows.val)), dim=-1)
    else:
        dev = rows.p.device
        gids = row0 + torch.arange(n_local, device=dev)
        cols = torch.clamp(gids, 0, rows.p.shape[-1] - 1)
        d = torch.gather(rows.p, -1, cols[:, None])[:, 0].to(_TABLE_DTYPE)
    return axes.psum_action(d)


def _block_rows_p_pi(rows, axes: Axes, n_local: int, block: int,
                     row0: int) -> torch.Tensor:
    """``(n_local, block)`` strip: column ``c`` of row ``i`` holds
    ``P_pi[i, (i // block) * block + c]`` in local ids (zeros elsewhere)."""
    if rows.idx is not None:
        dev = rows.idx.device
        li = torch.arange(n_local, device=dev)
        loc = rows.idx.long() - row0
        ok = (loc >= 0) & (loc < n_local) & \
            (torch.div(loc, block, rounding_mode="floor")
             == torch.div(li, block, rounding_mode="floor")[:, None])
        # masked slots land in a dump column, sliced off below
        pos = torch.where(ok, torch.remainder(loc, block),
                          torch.full_like(loc, block))
        add = torch.where(ok, rows.val, torch.zeros_like(rows.val))
        strip = torch.zeros((n_local, block + 1), dtype=rows.val.dtype,
                            device=dev)
        for j in range(rows.idx.shape[-1]):
            strip.index_put_((li, pos[:, j]), add[:, j], accumulate=True)
        strip = strip[:, :block]
    else:
        dev = rows.p.device
        li = torch.arange(n_local, device=dev)
        n_cols = rows.p.shape[-1]
        cols = row0 + torch.div(li, block, rounding_mode="floor") * block
        cols = cols[:, None] + torch.arange(block, device=dev)[None, :]
        ok = (cols < n_cols) & (cols - row0 < n_local)
        strip = torch.gather(rows.p, -1, torch.clamp(cols, 0, n_cols - 1))
        strip = torch.where(ok, strip, torch.zeros_like(strip)) \
            .to(_TABLE_DTYPE)
    return axes.psum_action(strip)


def build_precond(rows, *, axes: Axes, n_local: int, gamma: float,
                  pc_type: str, block: int = 32,
                  dtype: torch.dtype | None = None,
                  row0: int | None = None) \
        -> Callable[[torch.Tensor], torch.Tensor] | None:
    """An approximate inverse ``M ~= A_pi^-1`` for the current policy:
    an apply ``x -> M x`` (local rows in, local rows out), or ``None``
    for ``pc_type='none'``.  ``row0`` is where the local rows sit in the
    window the rows' ``idx`` address (default: the shard's first global
    row, for global ids; :func:`repro_torch.core.bellman.window_offset`)."""
    if pc_type == "none":
        return None
    if row0 is None:
        row0 = axes.state_index() * n_local
    if pc_type == "jacobi":
        diag = _diag_p_pi(rows, axes, n_local, row0)
        d = _fma(torch.ones_like(diag), diag, -gamma)
        inv_d = 1.0 / torch.where(torch.abs(d) > _TINY, d,
                                  torch.ones_like(d))
        if dtype is not None:
            inv_d = inv_d.to(dtype)
        return lambda x: x * inv_d.to(x.dtype)
    if pc_type == "bjacobi":
        b = int(block)
        strip = _block_rows_p_pi(rows, axes, n_local, b, row0)
        nb = -(-n_local // b)
        pad = nb * b - n_local
        if pad:
            strip = torch.nn.functional.pad(strip, (0, 0, 0, pad))
        eye = torch.eye(b, dtype=strip.dtype, device=strip.device)
        tiles = _fma(eye.expand(nb, b, b), strip.reshape(nb, b, b), -gamma)
        # padded rows are zero in `strip`, identity rows in `tiles`: the
        # trailing partial block stays invertible
        inv = torch.linalg.inv(tiles)
        if dtype is not None:
            inv = inv.to(dtype)

        def apply(x: torch.Tensor) -> torch.Tensor:
            xr = torch.nn.functional.pad(x, (0, pad)) if pad else x
            y = torch.bmm(inv.to(x.dtype), xr.reshape(nb, b, 1))
            y = y.reshape(nb * b)
            return y[:n_local] if pad else y

        return apply
    raise ValueError(
        f"unknown pc_type {pc_type!r}; expected one of {PC_TYPES}")
