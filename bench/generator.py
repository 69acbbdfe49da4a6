"""The general traffic generator: a traffic file's parameters as calls.

A traffic mix (``bench/traffic/<name>.json``) says which entry of the
program each call drives (``solve`` or ``solve_fleet``), how many
instances a call carries (``batch``), the solver options it adds to the
configuration's (``options``), how many distinct calls a run cycles
through (``pool``) and how many whole calls the traced run profiles
(``traced_calls``).  The loop is closed, with one caller: call ``i + 1``
is made when call ``i`` has returned.

Every run makes the same work, in its own order.  Lane ``b`` of every
call solves instance ``b`` of the configuration (its transition tables,
drawn once in set-up and fixed for the run), and a call is one of
``pool`` problems: problem ``p`` gives every lane the cost tables of draw
``p``.  The seed only shuffles the pool: call ``i`` makes problem
``order(seed)[i % pool]``.  How many outer steps a solve needs depends on
its tables and costs, and a fleet call lasts as long as its slowest lane,
so a run whose seed drew other problems would do other work; here two
seeds differ only in which problems the window's last, partial cycle
makes.  The warm-up call makes the problem ``-1``, outside the pool.
"""

from __future__ import annotations

import dataclasses
import random

ENTRIES = ("solve", "solve_fleet")
WARM_CALL = -1


@dataclasses.dataclass(frozen=True)
class Traffic:
    entry: str
    batch: int
    options: dict
    pool: int
    traced_calls: int

    @classmethod
    def from_dict(cls, d: dict) -> "Traffic":
        t = cls(entry=d["entry"], batch=int(d["batch"]),
                options=dict(d.get("options", {})), pool=int(d["pool"]),
                traced_calls=int(d["traced_calls"]))
        if t.entry not in ENTRIES:
            raise ValueError(f"entry must be one of {ENTRIES}, got "
                             f"{t.entry!r}")
        if t.entry == "solve" and t.batch != 1:
            raise ValueError("a 'solve' call carries one instance")
        if t.batch < 1 or t.pool < 1 or t.traced_calls < 1:
            raise ValueError(f"batch, pool and traced_calls must be >= 1: "
                             f"{d}")
        return t

    def order(self, seed: int) -> list[int]:
        """The pool's problems in the order a run with ``seed`` makes
        them."""
        order = list(range(self.pool))
        random.Random(f"bench-order/{seed}").shuffle(order)
        return order

    def problem(self, seed: int, call: int) -> int:
        """The problem that call ``call`` makes (``-1`` for the warm-up
        call)."""
        if call == WARM_CALL:
            return WARM_CALL
        return self.order(seed)[call % self.pool]
