"""The batching scheduler: one background thread turning queued requests
into batched fleet dispatches.

Counterpart of :mod:`repro.serve.scheduler`, with its loop, slot grid and
bucketing, so one request stream gives the same buckets and slot sizes in
both packages.  Loop shape (continuous batching over shape buckets):

1. **Linger** — when the queue is non-empty, wait until the oldest request
   has aged ``-serve_batch_window`` seconds (or a full batch of compatible
   requests is queued, the group's tightest ``-serve_deadline_ms``
   arrives, or the server is draining) so concurrent arrivals coalesce.
2. **Group** — pop the oldest request plus every queued request sharing
   its compatibility signature (solver-option overrides + mode +
   container family + action count + nnz/row), up to ``-serve_max_batch``.
3. **Bucket** — split the group by state count with the pad-waste rule
   ``Session.solve_fleet`` uses (:func:`repro_torch.api.fleet.
   bucket_indices`), then pad each bucket's request count up to its fleet
   slot (``-serve_slot_policy``) with duplicate lanes.  In the reference
   the slot grid makes compiled program shapes repeat; here the padded
   lanes cost lanes of kernel work on the card (one launch still serves
   the whole bucket through the kernels' lane axis).
4. **Dispatch** — one ``solve_fleet`` per bucket through the owning
   :class:`repro_torch.api.Session`, on the session's device (resolved
   when the session opened and passed to every solve, so nothing depends
   on this thread's current CUDA device), demultiplexing per-request
   results and per-iteration monitor records back to the submitting
   clients in input order.

Every device-facing call runs on this one thread; clients only build
their MDPs, submit, and wait on their request handles (events and record
queues).  Under a mesh the thread runs on rank 0 and relays each dispatch
to the other ranks first (:class:`repro_torch.serve.server.Server`), so
every rank runs the same ``solve_fleet`` calls in the same order.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from repro_torch.api.fleet import bucket_indices
from repro_torch.kernels import ops
from repro_torch.serve.cache import ProgramCache, program_key
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.serve.stats import Telemetry

__all__ = ["Scheduler", "slot_size"]

# granularity of the linger poll: arrivals notify the condition variable,
# so this only bounds how late a max-batch early-dispatch can trigger
_POLL_S = 0.005
# dispatches kept in the dispatch log (a rolling window)
_LOG_WINDOW = 4096


def slot_size(n_requests: int, policy: str, cap: int) -> int:
    """Fleet-slot size for a bucket of ``n_requests`` requests.

    ``mid2`` (default) rounds up on the power-of-two-with-midpoints grid
    ``1, 2, 3, 4, 6, 8, 12, 16, 24, ...`` — two slot shapes per octave,
    duplicate-lane waste capped at 1/3 of the slot (plain pow2 wastes up
    to 1/2).  ``pow2`` is the classic grid; ``exact`` dispatches each
    request count as it is (no padded lanes).  Capped at ``-serve_max_batch``."""
    if policy == "exact":
        return n_requests
    s = 1
    while s < n_requests:
        mid = s + s // 2
        if policy == "mid2" and mid >= n_requests:
            s = mid
            break
        s *= 2
    return min(s, max(cap, n_requests))


class Scheduler:
    """Owns the scheduler thread; the server delegates drain/stop to it."""

    def __init__(self, session, queue: RequestQueue, cache: ProgramCache,
                 telemetry: Telemetry, *, window: float, max_batch: int,
                 slot_policy: str, bucketing: str, relay=None):
        self._session = session
        # under a mesh: relay(mdps, overrides, monitored) hands each
        # dispatch to the other ranks before this one solves it
        self._relay = relay
        self._queue = queue
        self._cache = cache
        self._telemetry = telemetry
        self._window = float(window)
        self._max_batch = int(max_batch)
        self._slot_policy = slot_policy
        self._bucketing = bucketing
        self._stop = False
        self._draining = False
        self._in_flight = 0                  # guarded by queue.cv
        # one record a dispatch: its requests, shape slot, solve seconds
        # and, on the card, the kernel launches it made (the counters are
        # global; only this thread launches kernels while serving)
        self._log: deque = deque(maxlen=_LOG_WINDOW)
        self._n_dispatched = 0
        self._thread = threading.Thread(
            target=self._run, name="madupite-serve-scheduler", daemon=True)

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread.start()

    @property
    def draining(self) -> bool:
        return self._draining

    def dispatch_log(self) -> list[dict]:
        """The recent dispatches, oldest first (see ``_dispatch_bucket``)."""
        with self._queue.cv:
            return list(self._log)

    def in_flight_count(self) -> int:
        with self._queue.cv:
            return self._in_flight

    def drain(self, timeout: float | None = None) -> bool:
        """Reject new work (server-side), finish queued + in-flight
        buckets.  True when the server went quiescent within ``timeout``."""
        self._draining = True
        with self._queue.cv:
            self._queue.cv.notify_all()
            return self._queue.cv.wait_for(
                lambda: not self._queue.peek_oldest()
                and self._in_flight == 0,
                timeout)

    def stop(self, timeout: float | None = None) -> None:
        """Stop the thread (no new dispatches; an in-flight bucket
        finishes).  Call :meth:`drain` first for a graceful shutdown."""
        self._draining = True
        self._stop = True
        with self._queue.cv:
            self._queue.cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout)

    # ---- the scheduler loop ------------------------------------------------
    def _run(self) -> None:
        q = self._queue
        while True:
            with q.cv:
                while q.peek_oldest() is None and not self._stop:
                    q.cv.wait(0.1)
                if self._stop:
                    return
                oldest = q.peek_oldest()
                sig, deadline = oldest.sig, oldest.submitted + self._window
            self._linger(sig, deadline)
            if self._stop:
                return                     # leftovers fail at close()
            with q.cv:
                group = q.take_group(self._max_batch)
                self._in_flight += len(group)
            if not group:
                continue
            try:
                self._dispatch_group(group)
            finally:
                with q.cv:
                    self._in_flight -= len(group)
                    q.cv.notify_all()

    def _linger(self, sig: tuple, deadline: float) -> None:
        """The batching window: hold dispatch until the window closes, a
        full compatible batch is queued, the group's tightest per-request
        deadline (``-serve_deadline_ms``) arrives, or the server is
        draining.  The deadline is re-read every poll: a later arrival
        with a tighter bound shortens the wait for the whole group."""
        q = self._queue
        while not (self._stop or self._draining):
            with q.cv:
                if q.count_sig(sig) >= self._max_batch:
                    return
                dl = q.min_deadline(sig)
                eff = deadline if dl is None else min(deadline, dl)
                remaining = eff - time.monotonic()
                if remaining <= 0:
                    return
                q.cv.wait(min(remaining, _POLL_S))

    # ---- dispatch ----------------------------------------------------------
    def _dispatch_group(self, group: list[Request]) -> None:
        try:
            buckets = bucket_indices([r.mdp.n for r in group],
                                     policy=self._bucketing)
        except Exception as e:  # noqa: BLE001 — fail the group, not the loop
            self._fail(group, e)
            return
        for idx in buckets:
            batch = [group[i] for i in idx]
            try:
                self._dispatch_bucket(batch)
            except Exception as e:  # noqa: BLE001
                self._fail(batch, e)

    def _dispatch_bucket(self, batch: list[Request]) -> None:
        now = time.monotonic()
        n_pad = max(r.mdp.n for r in batch)
        slot = slot_size(len(batch), self._slot_policy, self._max_batch)
        n_dup = slot - len(batch)
        number = self._n_dispatched
        self._n_dispatched += 1
        for r in batch:
            r.dispatched = now
            r.dispatch = number
        # duplicate lanes keep the dispatch shape at the slot size; their
        # results are dropped (they re-solve batch[0]'s MDP)
        mdps = [r.mdp for r in batch] + [batch[0].mdp] * n_dup
        self._cache.touch(program_key(batch[0].sig, n_pad, slot))
        self._telemetry.on_dispatch(len(batch), n_dup)
        overrides = {k.lstrip("-"): v for k, v in batch[0].overrides.items()}
        # grouping/bucketing already happened here; the session must treat
        # the dispatched slot as ONE batched solve
        overrides["fleet_bucketing"] = "off"
        on_card = self._session.device.type == "cuda"
        before = ops.launch_counts() if on_card else None
        monitor = self._demux(batch)
        if self._relay is not None:
            self._relay(mdps, overrides, monitor is not None)
        t0 = time.perf_counter()
        results = self._session.solve_fleet(mdps, monitor=monitor,
                                            **overrides)
        seconds = time.perf_counter() - t0
        launches = None if before is None else {
            k: v - before[k] for k, v in ops.launch_counts().items()}
        # the method the bucket ran (-method auto: its per-bucket choice)
        entry = self._session.stats[-1]
        auto = entry["fleet"].get("auto")
        with self._queue.cv:
            self._log.append(dict(
                dispatch=number, n_pad=n_pad, slot=slot,
                requests=[r.id for r in batch], seconds=seconds,
                method=auto[0]["method"] if auto else entry["method"],
                launches=launches))
        for req, res in zip(batch, results):
            req._complete(res)
            self._telemetry.on_complete(req.latency)

    def _demux(self, batch: list[Request]):
        """Per-bucket monitor callback forwarding each lane's row of the
        fleet record to its request's stream, tagged with the request id.
        None when nobody in the bucket asked for monitoring."""
        lanes = [(i, r) for i, r in enumerate(batch) if r.monitor]
        if not lanes:
            return None

        def forward(rec: dict) -> None:
            res, inner = rec["res"], rec["inner"]
            if not isinstance(res, list):
                res, inner = [res], [inner]
            for lane, req in lanes:
                if lane < len(res):
                    req._push_record({
                        "request": req.id, "k": rec["k"],
                        "res": res[lane], "inner": inner[lane],
                        "elapsed": rec["elapsed"]})

        return forward

    def _fail(self, requests: list[Request], exc: Exception) -> None:
        self._telemetry.on_fail(len(requests))
        for r in requests:
            r._fail(exc)
