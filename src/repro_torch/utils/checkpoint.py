"""Fault-tolerant checkpoints of a solver state, in the reference's format.

Counterpart of :mod:`repro.utils.checkpoint`.  A checkpoint is one
``step_%010d.npz`` holding the leaves as ``leaf_<i>`` arrays and a
``__manifest__`` JSON of ``{step, treedef, n_leaves, meta}``, so each
package resumes the other's files.  The reference flattens a pytree; the
port has none and saves a sequence of leaves in a fixed order (the
driver's is the reference ``SolveState`` field order).  Leaves are saved
whole and unpadded, as host arrays.

Writes are atomic (a temporary file, then ``os.replace``); the newest
complete step wins and a torn newest file is skipped.  A readable file
whose leaf count differs from the caller's raises ``ValueError``: it was
written by another solver version or problem, and silently restarting
from scratch would throw the run's progress away.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Sequence

import numpy as np


def save(ckpt_dir: str, step: int, leaves: Sequence, meta: dict | None = None,
         *, treedef: str | None = None) -> str:
    """Atomically persist ``leaves`` (host arrays or scalars) at ``step``;
    ``treedef`` is the structure's description kept in the manifest (the
    reference writes its pytree's)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    payload = dict(step=int(step),
                   treedef=treedef or f"list[{len(arrays)}]",
                   n_leaves=len(arrays), meta=meta or {})
    final = os.path.join(ckpt_dir, f"step_{step:010d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, __manifest__=json.dumps(payload), **arrays)
    os.replace(tmp, final)  # atomic on POSIX
    return final


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(f[len("step_"):-len(".npz")])
                  for f in os.listdir(ckpt_dir)
                  if f.startswith("step_") and f.endswith(".npz"))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, n_leaves: int, step: int | None = None):
    """The newest valid checkpoint (or ``step``) as ``(leaves, step,
    meta)``, or ``None`` if there is none.  ``n_leaves`` is the leaf count
    the caller's state has.  Walks backwards past corrupt files (torn
    writes)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    if step is not None:
        steps = [s for s in steps if s == step]
    for s in reversed(steps):
        path = os.path.join(ckpt_dir, f"step_{s:010d}.npz")
        try:
            with np.load(path, allow_pickle=False) as z:
                payload = json.loads(str(z["__manifest__"]))
                if payload["n_leaves"] != n_leaves:
                    raise _StructureMismatch(
                        f"checkpoint {path!r} holds {payload['n_leaves']} "
                        f"leaves but this run's state has "
                        f"{n_leaves}: it was written by a different "
                        f"solver version or problem; resume with the "
                        f"writing version, or point checkpoint_dir at a "
                        f"fresh directory to restart from scratch")
                leaves = [z[f"leaf_{i}"] for i in range(n_leaves)]
            return leaves, s, payload["meta"]
        except _StructureMismatch as e:
            raise ValueError(str(e)) from None
        except Exception:  # torn write -> try older
            continue
    return None


class _StructureMismatch(Exception):
    """Internal: a readable checkpoint with the wrong leaf count (must not
    be swallowed by the torn-write walk)."""
