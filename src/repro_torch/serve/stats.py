"""Thread-safe server telemetry: counters, batch shapes, latency quantiles.

Counterpart of :mod:`repro.serve.stats` (the same counters and
nearest-rank quantiles).

One :class:`Telemetry` instance per server.  Client threads bump the
submit/reject counters, the scheduler thread the dispatch/completion ones;
``snapshot()`` renders the consistent dict ``Server.stats()`` returns.
"""

from __future__ import annotations

import threading
from collections import Counter, deque

__all__ = ["Telemetry", "percentile"]

# completed-request latencies kept for the quantile estimates (a rolling
# window so a long-lived server's stats call stays O(window))
_LATENCY_WINDOW = 4096


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty sequence."""
    xs = sorted(xs)
    if not xs:
        return float("nan")
    rank = max(0, min(len(xs) - 1, round(q / 100.0 * (len(xs) - 1))))
    return float(xs[rank])


class Telemetry:
    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected: Counter = Counter()
        self.dispatches = 0            # bucket dispatches (one batched solve)
        self.dispatched_requests = 0   # real requests across all dispatches
        self.padded_lanes = 0          # slot-padding duplicates solved
        self._batch_sizes: deque = deque(maxlen=_LATENCY_WINDOW)
        self._latencies: deque = deque(maxlen=_LATENCY_WINDOW)

    # ---- recording ---------------------------------------------------------
    def on_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def on_reject(self, reason: str) -> None:
        with self._lock:
            self.rejected[reason] += 1

    def on_dispatch(self, n_requests: int, n_padded: int) -> None:
        with self._lock:
            self.dispatches += 1
            self.dispatched_requests += n_requests
            self.padded_lanes += n_padded
            self._batch_sizes.append(n_requests)

    def on_complete(self, latency: float) -> None:
        with self._lock:
            self.completed += 1
            self._latencies.append(latency)

    def on_fail(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    # ---- reporting ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            lat = list(self._latencies)
            sizes = list(self._batch_sizes)
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "rejected": dict(self.rejected),
                "dispatches": self.dispatches,
                "dispatched_requests": self.dispatched_requests,
                "padded_lanes": self.padded_lanes,
            }
        out["batch"] = {
            "count": len(sizes),
            "mean_size": (sum(sizes) / len(sizes)) if sizes else 0.0,
            "max_size": max(sizes) if sizes else 0,
        }
        out["latency_s"] = {
            "count": len(lat),
            "mean": (sum(lat) / len(lat)) if lat else float("nan"),
            "p50": percentile(lat, 50) if lat else float("nan"),
            "p95": percentile(lat, 95) if lat else float("nan"),
        }
        return out
