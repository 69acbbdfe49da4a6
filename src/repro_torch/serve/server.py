"""The in-process MDP solve server: ``submit / result / stream / stats /
drain`` over an owning :class:`repro_torch.api.Session`.

Counterpart of :mod:`repro.serve.server`:

    from repro_torch.api import MDP
    from repro_torch.serve import Server

    with Server({"-method": "vi", "-atol": 1e-8,
                 "-serve_batch_window": 0.02}) as srv:   # on the card
        reqs = [srv.submit(MDP.from_generator("garnet", n=n, m=8, seed=i))
                for i, n in enumerate([500, 700, 500, 680])]
        values = [r.result().v for r in reqs]
        print(srv.stats()["program_cache"])

Many client threads submit concurrently; one scheduler thread batches
compatible arrivals into fleet dispatches (see
:mod:`repro_torch.serve.scheduler`).  Admission control rejects — with
actionable errors — rather than queueing unboundedly.  A server over a
mesh (the fleet-sharded layouts) is not ported yet (ROADMAP queue 1 item
10): it raises when it opens.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Iterator, Mapping

from repro_torch.api.mdp import MDP
from repro_torch.api.options import Options
from repro_torch.api.session import Session
from repro_torch.core.mdp import DenseMDP, EllMDP
from repro_torch.serve.cache import ProgramCache
from repro_torch.serve.queue import AdmissionError, Request, RequestQueue
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.stats import Telemetry

__all__ = ["Server"]


def _mdp_family(mdp: MDP) -> tuple:
    """The container part of the compatibility signature: what
    :func:`repro_torch.core.mdp.stack_mdps` can stack into one batch.  ELL
    instances batch across state counts (padded); dense ones only at
    equal ``n`` (so ``n`` joins the dense signature)."""
    if mdp.deferred:
        return ("ell", mdp._spec.m, mdp._spec.nnz)
    core = mdp._core
    if isinstance(core, EllMDP):
        return ("ell", core.m_global, core.nnz_per_row)
    return ("dense", core.m_global, core.n_global)


class Server:
    """A persistent batched solve service over one :class:`Session`.

    ``options`` seeds a server-owned session (closed with the server);
    alternatively pass an existing ``session`` whose options — including
    the ``-serve_*`` keys — configure the server (the caller keeps
    ownership and closes it).  The scheduler thread starts immediately.
    """

    def __init__(self, options: Options | Mapping[str, Any] | None = None,
                 *, session: Session | None = None):
        if session is not None and options is not None:
            raise ValueError("pass options OR an existing session, not "
                             "both (a provided session's options already "
                             "configure the server)")
        self._own_session = session is None
        self._session = session if session is not None else Session(options)
        if self._session.placement()[0] is not None:
            if self._own_session:
                self._session.close()
            raise NotImplementedError(
                "a Server over a mesh (fleet-sharded buckets, the fleet "
                "layouts) is not yet ported to repro_torch (ROADMAP queue 1 "
                "item 10); serve on one device (-layout single, or no "
                "torch.distributed world)")
        opts = self._session.options
        self._queue = RequestQueue(opts.get("-serve_max_queue"),
                                   opts.get("-serve_max_states"))
        self._cache = ProgramCache(opts.get("-serve_program_cache"))
        self._telemetry = Telemetry()
        self._scheduler = Scheduler(
            self._session, self._queue, self._cache, self._telemetry,
            window=opts.get("-serve_batch_window"),
            max_batch=opts.get("-serve_max_batch"),
            slot_policy=opts.get("-serve_slot_policy"),
            bucketing=opts.get("-fleet_bucketing"))
        self._requests: weakref.WeakValueDictionary = \
            weakref.WeakValueDictionary()
        self._closed = False
        self._scheduler.start()

    # ---- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def session(self) -> Session:
        return self._session

    def drain(self, timeout: float | None = None) -> bool:
        """Graceful wind-down: reject new submits, finish every queued and
        in-flight bucket.  True when the server went quiescent within
        ``timeout`` (None = wait indefinitely)."""
        return self._scheduler.drain(timeout)

    def close(self, timeout: float | None = None) -> None:
        """Drain, stop the scheduler thread, release the owned session.
        Requests still queued after a ``timeout``-bounded drain fail with
        ``AdmissionError('closed')``."""
        if self._closed:
            return
        self._closed = True
        self._scheduler.drain(timeout)
        self._scheduler.stop()
        leftovers = self._queue.drain_all()
        if leftovers:
            self._telemetry.on_fail(len(leftovers))
            for r in leftovers:
                r._fail(AdmissionError(
                    "closed", f"server closed before request {r.id} was "
                              f"dispatched"))
        if self._own_session:
            self._session.close()

    # ---- the client surface ------------------------------------------------
    def submit(self, mdp, *, monitor: bool = False,
               **overrides) -> Request:
        """Enqueue one solve; returns the :class:`Request` handle.

        ``overrides`` are per-request option overrides (validated against
        the options registry; keys with or without the leading dash) —
        requests batch together only when their overrides, mode and
        container family match.  ``monitor=True`` opens the per-request
        convergence-record stream read by :meth:`stream`.

        Raises :class:`AdmissionError` (``reason`` of ``queue_full`` /
        ``too_large`` / ``draining`` / ``closed``) instead of queueing
        unboundedly.
        """
        if self._closed:
            self._reject("closed", "server is closed; create a new one")
        if self._scheduler.draining:
            self._reject("draining", "server is draining: in-flight work "
                                     "finishes, new work is rejected")
        req = self._make_request(mdp, monitor, overrides)
        try:
            self._queue.push(req)
        except AdmissionError as e:
            self._telemetry.on_reject(e.reason)
            raise
        self._telemetry.on_submit()
        self._requests[req.id] = req
        return req

    def result(self, request: Request | int,
               timeout: float | None = None):
        """Block for one request's :class:`repro_torch.core.driver.
        SolveResult` (accepts the handle or its ``id``)."""
        return self._as_request(request).result(timeout)

    def stream(self, request: Request | int) -> Iterator[dict]:
        """Yield the request's per-iteration convergence records —
        ``{"request", "k", "res", "inner", "elapsed"}`` — as its bucket
        solves; ends when the request completes.  The stream spans the
        whole bucket's run: a lane that converges early plateaus at its
        final residual while bucket-mates finish.  The request must have
        been submitted with ``monitor=True``."""
        return self._as_request(request).records()

    def dispatch_log(self) -> list[dict]:
        """One record a recent dispatch, oldest first: ``{"dispatch",
        "n_pad", "slot", "requests" (ids), "seconds" (its solve_fleet),
        "method" (the one it ran: ``-method auto``'s choice for the
        bucket), "launches" (kernel launches by name on the card, else
        None)}``."""
        return self._scheduler.dispatch_log()

    def stats(self) -> dict:
        """Server telemetry: submit/reject/dispatch counters, batch sizes,
        latency quantiles, program-cache hit/miss/eviction counters, and
        the owning session's cache counters."""
        out = self._telemetry.snapshot()
        out["queue_depth"] = len(self._queue)
        out["in_flight"] = self._scheduler.in_flight_count()
        out["draining"] = self._scheduler.draining
        out["program_cache"] = self._cache.stats()
        out["session_caches"] = self._session.cache_stats
        return out

    # ---- internals ---------------------------------------------------------
    def _reject(self, reason: str, message: str) -> None:
        self._telemetry.on_reject(reason)
        raise AdmissionError(reason, message)

    def _wrap(self, mdp) -> MDP:
        if isinstance(mdp, MDP):
            pass
        elif isinstance(mdp, (EllMDP, DenseMDP)):
            mdp = MDP(mdp, mode=self._session.options.get("-mode"))
        else:
            raise TypeError(f"submit wants a repro_torch.api.MDP (or a core "
                            f"EllMDP/DenseMDP), got {type(mdp).__name__}")
        core = mdp._core
        if core is not None and core.batch is not None:
            raise ValueError("submit takes one MDP per request (got a "
                             "batched container); the server does the "
                             "batching")
        return mdp

    def _make_request(self, mdp, monitor: bool, overrides: dict) -> Request:
        mdp = self._wrap(mdp)
        # normalize + validate the overrides now (actionable rejection at
        # submit, not a scheduler-thread failure mid-bucket)
        ov = Options(overrides).as_dict(explicit_only=True) \
            if overrides else {}
        # the dispatch deadline is serve-side QoS, not a solver option:
        # pop it BEFORE the signature is built so requests with different
        # deadlines still share a batch (the tightest one wins the linger)
        deadline_ms = ov.pop("-serve_deadline_ms",
                             self._session.options.get("-serve_deadline_ms"))
        mat = None
        if mdp.deferred:
            # resolve the pipeline at submit (per-request override, else
            # the session option): admission charges matrix-free requests
            # their O(n) footprint, and matrix-free batches only with
            # matrix-free over the identical constructor pair
            mat = mdp.materialization(
                ov.get("-mdp_materialize",
                       self._session.options.get("-mdp_materialize")))
        if mat == "matrix_free":
            # gamma-free spec: a gamma sweep batches into one fleet, while
            # different constructors/shapes (stack_mdps requires one shared
            # RowSpec) never share a bucket
            fam = ("matrix_free",
                   dataclasses.replace(mdp._spec, gamma=0.0))
        else:
            fam = _mdp_family(mdp)
        sig = (tuple(sorted(ov.items())), mdp.mode) + fam
        return Request(mdp, sig, ov, monitor=monitor, materialization=mat,
                       deadline_ms=deadline_ms)

    def _as_request(self, request: Request | int) -> Request:
        if isinstance(request, Request):
            return request
        req = self._requests.get(request)
        if req is None:
            raise KeyError(f"unknown (or garbage-collected) request id "
                           f"{request!r}; keep the Request handle submit "
                           f"returned")
        return req
