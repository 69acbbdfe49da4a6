"""Offline MDP storage (madupite's load-from-file mode).

Counterpart of :mod:`repro.core.io`, in the same format, so either
package reads the other's files: one ``block_%05d.npz`` per state block
(``idx``, ``val``, ``cost``) and a ``manifest.json`` holding the global
shape, discount, block table and, optionally, the solve ``mode``.  Blocks
are written and read independently: a reader of ``rows=(lo, hi)`` opens
only the blocks that overlap it.
"""

from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.core.mdp import EllMDP


def save_mdp(path: str, mdp: EllMDP, n_blocks: int = 1,
             mode: str | None = None) -> None:
    """Write ``mdp`` (all its rows) in ``n_blocks`` row blocks.  ``mode``
    optionally records the solve semantics ("mincost" / "maxreward") in
    the manifest, so :meth:`repro_torch.api.MDP.from_file` restores it."""
    os.makedirs(path, exist_ok=True)
    n = mdp.n_global
    idx, val, cost = (t.cpu().numpy() for t in (mdp.idx, mdp.val, mdp.cost))
    if idx.shape[0] != n:
        raise ValueError(f"save_mdp expects the full MDP: {idx.shape[0]} "
                         f"rows of n_global = {n}")
    bounds = np.linspace(0, n, n_blocks + 1, dtype=int)
    blocks = []
    for b in range(n_blocks):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        np.savez(os.path.join(path, f"block_{b:05d}.npz"),
                 idx=idx[lo:hi], val=val[lo:hi], cost=cost[lo:hi])
        blocks.append(dict(block=b, row_lo=lo, row_hi=hi))
    manifest = dict(n=int(n), m=int(mdp.m_global), k=int(mdp.nnz_per_row),
                    gamma=float(mdp.gamma), n_blocks=n_blocks, blocks=blocks)
    if mode is not None:
        manifest["mode"] = mode
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_manifest(path: str) -> dict:
    """The manifest (global shape / gamma / mode / block table) alone."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def load_mdp(path: str, rows: tuple[int, int] | None = None) -> EllMDP:
    """The full MDP, or just its ``rows=(lo, hi)`` slice, as a host
    :class:`EllMDP` (place it with ``.to(device)``)."""
    man = load_manifest(path)
    lo, hi = rows or (0, man["n"])
    parts = []
    for blk in man["blocks"]:
        if blk["row_hi"] <= lo or blk["row_lo"] >= hi:
            continue
        with np.load(os.path.join(path, f"block_{blk['block']:05d}.npz")) \
                as z:
            s = slice(max(lo - blk["row_lo"], 0),
                      min(hi, blk["row_hi"]) - blk["row_lo"])
            parts.append((z["idx"][s], z["val"][s], z["cost"][s]))
    idx = np.concatenate([p[0] for p in parts])
    val = np.concatenate([p[1] for p in parts])
    cost = np.concatenate([p[2] for p in parts])
    return EllMDP.from_numpy(idx, val, cost, man["gamma"],
                             n_global=man["n"], m_global=man["m"],
                             device="cpu")
