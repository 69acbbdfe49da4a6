"""Request objects and the admission-controlled request queue.

Counterpart of :mod:`repro.serve.queue`, with its admission rules, reasons
and messages.

A :class:`Request` is the server-side handle for one submitted solve: its
compatibility signature (what may batch with what), the completion event
clients block on, and — when the client asked for monitoring — the stream
queue per-iteration convergence records are demultiplexed into.

The :class:`RequestQueue` is the single pending-work structure shared by
client threads (``push``) and the scheduler thread (``take_group``).
Admission control happens at ``push``: a full queue or an over-limit state
count raises :class:`AdmissionError` with an actionable message and a
machine-readable ``reason`` (``queue_full`` / ``too_large`` / ``draining``
/ ``closed``) so clients can back off, shrink, or fail over.
"""

from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
from collections import deque
from typing import Any, Iterator

from repro_torch.kernels import matrix_free

__all__ = ["AdmissionError", "Request", "RequestQueue"]

# end-of-stream sentinel pushed into a request's record queue at completion
_DONE = object()


class AdmissionError(RuntimeError):
    """A submit the server refused to accept.  ``reason`` is one of
    ``queue_full`` / ``too_large`` / ``draining`` / ``closed``."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


_REQUEST_IDS = itertools.count()


class Request:
    """One submitted solve: a future-like handle plus its batching identity.

    ``sig`` is the compatibility signature — two requests may share a
    dispatched bucket only when their signatures match (same solver-option
    overrides, mode, container family, action count and nnz/row).
    """

    def __init__(self, mdp, sig: tuple, overrides: dict, *,
                 monitor: bool = False, materialization: str | None = None,
                 deadline_ms: float | None = None):
        self.id = next(_REQUEST_IDS)
        self.mdp = mdp
        self.sig = sig
        self.overrides = overrides
        # the resolved pipeline ("device"/"host"/"matrix_free"; None for
        # array-backed MDPs) — admission charges the *actual* footprint
        self.materialization = materialization
        self.monitor = bool(monitor)
        self.submitted = time.monotonic()
        # absolute dispatch deadline (-serve_deadline_ms): the scheduler
        # closes the batching window early rather than let this request's
        # queue wait exceed the bound.  None = the full window applies.
        self.deadline: float | None = \
            self.submitted + deadline_ms / 1e3 \
            if deadline_ms is not None else None
        self.dispatched: float | None = None
        self.completed: float | None = None
        # the index of the dispatch that solved it (None while queued):
        # its record in the scheduler's dispatch log
        self.dispatch: int | None = None
        self._event = threading.Event()
        self._result: Any = None
        self._error: BaseException | None = None
        self._records: _queue.Queue | None = \
            _queue.Queue() if monitor else None

    # ---- completion (scheduler side) ---------------------------------------
    def _complete(self, result) -> None:
        self._result = result
        self.completed = time.monotonic()
        self._event.set()
        self._end_stream()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self.completed = time.monotonic()
        self._event.set()
        self._end_stream()

    def _push_record(self, record: dict) -> None:
        if self._records is not None:
            self._records.put(record)

    def _end_stream(self) -> None:
        if self._records is not None:
            self._records.put(_DONE)

    # ---- client side -------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency(self) -> float | None:
        """Submit-to-completion seconds (None while pending)."""
        if self.completed is None:
            return None
        return self.completed - self.submitted

    def result(self, timeout: float | None = None):
        """Block for the :class:`repro_torch.core.driver.SolveResult`
        (re-raises a dispatch failure)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.id} still pending after {timeout}s "
                f"(queued or its bucket is solving)")
        if self._error is not None:
            raise self._error
        return self._result

    def records(self) -> Iterator[dict]:
        """Yield monitor records as they stream in; ends at completion."""
        if self._records is None:
            raise ValueError(
                f"request {self.id} was submitted without monitor=True; "
                f"no stream to read")
        while True:
            rec = self._records.get()
            if rec is _DONE:
                return
            yield rec


class RequestQueue:
    """Admission-controlled FIFO shared by clients and the scheduler.

    ``cv`` is the queue's condition variable; the scheduler also uses it
    as the server-wide quiescence signal (drain waits on it until the
    queue is empty and nothing is in flight).
    """

    def __init__(self, max_depth: int, max_states: int | None):
        self.cv = threading.Condition()
        self.max_depth = int(max_depth)
        self.max_states = max_states
        self._items: deque[Request] = deque()

    def __len__(self) -> int:
        with self.cv:
            return len(self._items)

    def push(self, req: Request) -> None:
        """Admit one request or raise :class:`AdmissionError`.

        ``-serve_max_states`` names a *materialized-table byte budget*
        (the ELL table of ``max_states`` states at the request's shape):
        materialized requests are limited by state count exactly as
        before, while matrix-free requests — whose per-solve footprint is
        O(n), not O(n*m*nnz) — are admitted up to the same bytes, i.e.
        one to two orders of magnitude more states for typical shapes.
        """
        n = req.mdp.n
        if self.max_states is not None:
            if req.materialization == "matrix_free":
                spec = req.mdp._spec
                per = matrix_free.operator_bytes(1, spec.nnz)
                est = matrix_free.operator_bytes(n, spec.nnz)
                budget = matrix_free.table_bytes(
                    self.max_states, spec.m, spec.nnz)
                if est > budget:
                    raise AdmissionError(
                        "too_large",
                        f"request rejected: matrix-free solve needs "
                        f"~{est} bytes ({n} states x {per} B/state), over "
                        f"the -serve_max_states={self.max_states} byte "
                        f"budget ({budget} B — the materialized table of "
                        f"{self.max_states} states at m={spec.m}, "
                        f"nnz={spec.nnz}); this family admits up to "
                        f"{budget // per} matrix-free states — split the "
                        f"problem or raise the limit")
            elif n > self.max_states:
                raise AdmissionError(
                    "too_large",
                    f"request rejected: {n} states exceeds the per-request "
                    f"limit -serve_max_states={self.max_states}; split the "
                    f"problem, raise the limit, or — for a function-backed "
                    f"MDP — submit with -mdp_materialize matrix_free, "
                    f"whose O(n) footprint admits far more states under "
                    f"the same byte budget")
        with self.cv:
            if len(self._items) >= self.max_depth:
                raise AdmissionError(
                    "queue_full",
                    f"request rejected: queue depth {len(self._items)} is "
                    f"at -serve_max_queue={self.max_depth}; retry with "
                    f"backoff or raise the limit")
            self._items.append(req)
            self.cv.notify_all()

    # scheduler side — callers hold ``self.cv``
    def peek_oldest(self) -> Request | None:
        return self._items[0] if self._items else None

    def count_sig(self, sig: tuple) -> int:
        return sum(1 for r in self._items if r.sig == sig)

    def min_deadline(self, sig: tuple) -> float | None:
        """Tightest dispatch deadline over queued requests that would join
        a ``sig`` group (None when none carries one) — the linger early-out
        bound for deadline-aware batching."""
        ds = [r.deadline for r in self._items
              if r.sig == sig and r.deadline is not None]
        return min(ds) if ds else None

    def take_group(self, max_batch: int) -> list[Request]:
        """Pop the oldest request plus every queued request sharing its
        signature (arrival order, up to ``max_batch``).  Incompatible
        requests stay queued for the next cycle."""
        if not self._items:
            return []
        sig = self._items[0].sig
        group: list[Request] = []
        keep: deque[Request] = deque()
        for r in self._items:
            if r.sig == sig and len(group) < max_batch:
                group.append(r)
            else:
                keep.append(r)
        self._items = keep
        return group

    def drain_all(self) -> list[Request]:
        """Remove every queued request (abandoning close)."""
        with self.cv:
            out = list(self._items)
            self._items.clear()
            return out
