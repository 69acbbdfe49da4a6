"""The plain reference for an ELL MDP: the Bellman backup in float64.

Given an instance's tables (``idx``, ``val``, ``cost``), its discount and
the values and policy a solve returned, it recomputes in plain torch

    Q(s, a) = cost(s, a) + gamma * sum_j val(s, a, j) * v[idx(s, a, j)]

in float64 blocks of rows, and returns two numbers:

* ``residual``: ``max_s |min_a Q(s, a) - v(s)|``, the sup-norm Bellman
  residual of the returned values, which certifies ``||v - v*||_inf <=
  residual / (1 - gamma)``;
* ``policy_gap``: ``max_s Q(s, pi(s)) - min_a Q(s, a)``, how far the
  returned policy is from greedy for the returned values (0 when it is
  greedy; ties cost nothing).

:func:`check` takes one solve's data as the inputs module made it
(``bench/inputs/garnet_ell.py::problem``: ``idx``, ``val``, ``cost``,
``gamma``).  It imports nothing of ``repro_torch`` and reads only the
tables the benchmark drew and the solve's returned ``v`` and ``pi``.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 18


def check(data: dict, v, pi, *, block_rows: int = BLOCK_ROWS) -> dict:
    """The two numbers of one answer, keyed as the configuration's
    ``limits``."""
    return backup_check(data["idx"], data["val"], data["cost"],
                        data["gamma"], v, pi, block_rows=block_rows)


def backup_check(idx: torch.Tensor, val: torch.Tensor, cost: torch.Tensor,
                 gamma: float, v, pi, *,
                 block_rows: int = BLOCK_ROWS) -> dict:
    dev = idx.device
    v = torch.as_tensor(v).to(device=dev, dtype=torch.float64)
    pi = torch.as_tensor(pi).to(device=dev, dtype=torch.int64)
    n = idx.shape[0]
    if v.shape != (n,) or pi.shape != (n,):
        return {"residual": float("inf"), "policy_gap": float("inf")}
    residual = torch.zeros((), dtype=torch.float64, device=dev)
    gap = torch.zeros((), dtype=torch.float64, device=dev)
    for lo in range(0, n, block_rows):
        hi = min(lo + block_rows, n)
        ids = idx[lo:hi].long()
        q = cost[lo:hi].double() + gamma * (
            val[lo:hi].double() * v[ids]).sum(-1)
        best = q.min(-1).values
        residual = torch.maximum(residual, (best - v[lo:hi]).abs().max())
        chosen = q.gather(-1, pi[lo:hi, None].clamp(0, q.shape[-1] - 1))
        off = (pi[lo:hi] < 0) | (pi[lo:hi] >= q.shape[-1])
        g = torch.where(off, torch.inf, chosen[:, 0] - best)
        gap = torch.maximum(gap, g.max())
    return {"residual": float(residual), "policy_gap": float(gap)}
