"""Ragged-fleet bucketing for :meth:`repro_torch.api.Session.solve_fleet`.

Counterpart of :mod:`repro.api.fleet` (the port keeps its own copy).  A
batched fleet pads every instance to the fleet's largest state count
(:func:`repro_torch.core.mdp.stack_mdps`): a fleet mixing a 100-state and
a 100k-state MDP would spend ~99.9% of its work on padding.  Bucketing
groups instances by state count into *pad-efficient* buckets and solves
one batched loop per bucket, exposed through the options database as
``-fleet_bucketing auto|off``.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["bucket_indices", "MAX_PAD_WASTE"]

# auto-bucketing splits whenever padding a bucket would waste more than
# this fraction of its (padded) state-row work
MAX_PAD_WASTE = 0.25


def bucket_indices(ns: Sequence[int], *, policy: str = "auto",
                   max_waste: float = MAX_PAD_WASTE) -> list[list[int]]:
    """Partition instance indices into pad-efficient buckets by state count.

    ``ns[i]`` is instance ``i``'s state count.  Returns a list of index
    buckets (every index exactly once).  ``policy="off"`` returns one
    bucket.  ``policy="auto"`` sorts by ``n`` and greedily extends the
    current bucket while its *pad waste* — the fraction of padded state
    rows that are padding, ``1 - sum(n_i) / (len * max_n)`` — stays at
    most ``max_waste``.

    Instances with equal ``n`` always land in one bucket, and a fleet of
    near-equal sizes stays one bucket, so the common homogeneous case is
    one batched loop.
    """
    if policy not in ("auto", "off"):
        raise ValueError(f"unknown bucketing policy {policy!r}; "
                         "pick 'auto' or 'off'")
    idx = list(range(len(ns)))
    if policy == "off" or len(idx) <= 1:
        return [idx] if idx else []
    order = sorted(idx, key=lambda i: (ns[i], i))
    buckets: list[list[int]] = [[order[0]]]
    total = ns[order[0]]                      # sum of n over current bucket
    for i in order[1:]:
        cand_total = total + ns[i]
        cand_len = len(buckets[-1]) + 1
        waste = 1.0 - cand_total / (cand_len * ns[i])   # ns[i] is the max
        if waste <= max_waste:
            buckets[-1].append(i)
            total = cand_total
        else:
            buckets.append([i])
            total = ns[i]
    return buckets
