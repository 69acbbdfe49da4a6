"""The program-slot cache, keyed by shape bucket.

Counterpart of :mod:`repro.serve.cache`, with its keys, counters and LRU
policy, so one request stream gives the same hit / miss / eviction counts
in both packages.  The scheduler dispatches every bucket as one batched
solve whose identity is its *shape slot*: the padded state count, the
fleet-slot size (request count padded per ``-serve_slot_policy``), and
the solver-option signature.  The reference compiles one XLA program per
slot, and this cache accounts which slots are warm.  The port runs its
loops eagerly and compiles nothing: here a "program" is a dispatch
signature — the same kernel launch shapes for every dispatch of a slot —
and a miss costs no compile, only a first dispatch of that shape.

Built on the session's LRU mechanism
(:class:`repro_torch.utils.lru.LRUCache`); hits / misses / evictions
surface in ``Server.stats()["program_cache"]``.
"""

from __future__ import annotations

import threading

from repro_torch.utils.lru import LRUCache

__all__ = ["ProgramCache", "program_key"]


def program_key(sig: tuple, n_pad: int, slot: int) -> tuple:
    """The shape-bucket identity of one dispatch: compatibility signature
    (options + mode + container family + m + nnz) x padded state count x
    fleet-slot size."""
    return (sig, int(n_pad), int(slot))


class ProgramCache:
    """Thread-safe LRU of warm program slots with per-slot dispatch counts."""

    def __init__(self, capacity: int):
        self._lru = LRUCache(capacity)
        self._lock = threading.Lock()

    def touch(self, key: tuple) -> bool:
        """Record a dispatch against ``key``; True on a warm hit, False
        when the slot was cold (compile expected)."""
        with self._lock:
            entry = self._lru.get(key)
            if entry is None:
                self._lru.put(key, {"dispatches": 1})
                return False
            entry["dispatches"] += 1
            return True

    def stats(self) -> dict:
        with self._lock:
            out = self._lru.stats()
            out["slots"] = [
                {"n_pad": k[1], "fleet_slot": k[2],
                 "dispatches": v["dispatches"]}
                for k, v in self._lru.items()]
            return out
