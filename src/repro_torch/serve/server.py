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
actionable errors — rather than queueing unboundedly.

Under a mesh (a ``torch.distributed`` world whose session places on a
mesh: ``torchrun``, or a session given a mesh) every rank opens the
server with the same options.  Rank 0 owns the queue, admission and the
scheduler; each of its dispatches — the bucket's MDPs, its options and
whether it is monitored — is broadcast to the other ranks over a gloo
group, and a follower thread on each of them runs the same
``Session.solve_fleet`` call, so every bucket is solved by the whole mesh
(the fleet layouts for ``B > 1``).  Clients submit on rank 0 only; on
another rank :meth:`Server.submit` raises, and :meth:`Server.close` /
:meth:`Server.drain` wait for rank 0 to end the stream.
"""

from __future__ import annotations

import dataclasses
import threading
import traceback
import weakref
from typing import Any, Iterator, Mapping

import torch.distributed as dist

from repro_torch.api.mdp import MDP
from repro_torch.api.options import Options
from repro_torch.api.session import Session
from repro_torch.core.mdp import DenseMDP, EllMDP
from repro_torch.serve.cache import ProgramCache
from repro_torch.serve.queue import AdmissionError, Request, RequestQueue
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.stats import Telemetry

__all__ = ["Server"]


def _sharded(session: Session) -> bool:
    """Whether ``session``'s fleet solves run on a mesh (so every rank of
    the world must run them): a mesh given to it, or a process group and a
    layout other than ``single`` that is not ``auto`` on a world of one
    (:meth:`Session.placement`)."""
    layout = session.options.get("-layout")
    if layout == "single":
        return False
    if session._mesh_override is not None:
        return True
    if not (dist.is_available() and dist.is_initialized()):
        return False
    return layout != "auto" or dist.get_world_size() > 1


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
        opts = self._session.options
        self._queue = RequestQueue(opts.get("-serve_max_queue"),
                                   opts.get("-serve_max_states"))
        self._cache = ProgramCache(opts.get("-serve_program_cache"))
        self._telemetry = Telemetry()
        self._requests: weakref.WeakValueDictionary = \
            weakref.WeakValueDictionary()
        self._closed = False
        # under a mesh: a gloo group for the dispatch broadcasts, built on
        # every rank in the same order; rank 0 schedules, the others follow
        self._group = dist.new_group(backend="gloo") \
            if _sharded(self._session) else None
        self._rank = 0 if self._group is None else dist.get_rank()
        self._ended = self._group is None or dist.get_world_size() == 1
        self._follower = None
        if self._rank != 0:
            self._follower = threading.Thread(
                target=self._follow, name="madupite-serve-follower",
                daemon=True)
            self._follower.start()
            return
        self._scheduler = Scheduler(
            self._session, self._queue, self._cache, self._telemetry,
            window=opts.get("-serve_batch_window"),
            max_batch=opts.get("-serve_max_batch"),
            slot_policy=opts.get("-serve_slot_policy"),
            bucketing=opts.get("-fleet_bucketing"),
            relay=None if self._ended else self._relay)
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
        ``timeout`` (None = wait indefinitely).  Under a mesh a quiescent
        rank 0 ends the other ranks' follower loops, and on those ranks
        this waits for that."""
        if self._rank != 0:
            self._follower.join(timeout)
            return not self._follower.is_alive()
        done = self._scheduler.drain(timeout)
        if done:
            self._end_followers()
        return done

    def close(self, timeout: float | None = None) -> None:
        """Drain, stop the scheduler thread, release the owned session.
        Requests still queued after a ``timeout``-bounded drain fail with
        ``AdmissionError('closed')``.  Under a mesh rank 0 then ends the
        follower loops, which the other ranks' ``close`` waits for."""
        if self._closed:
            return
        self._closed = True
        if self._rank != 0:
            self._follower.join()
        else:
            self._scheduler.drain(timeout)
            self._scheduler.stop()
            self._end_followers()
            leftovers = self._queue.drain_all()
            if leftovers:
                self._telemetry.on_fail(len(leftovers))
                for r in leftovers:
                    r._fail(AdmissionError(
                        "closed", f"server closed before request {r.id} "
                                  f"was dispatched"))
        if self._own_session:
            self._session.close()

    # ---- the mesh: rank 0 relays, the other ranks follow -------------------
    def _relay(self, mdps: list, overrides: dict, monitored: bool) -> None:
        """Broadcast one dispatch to the follower ranks (the scheduler
        thread, before it solves the bucket itself).  Each distinct MDP
        travels once, as its host tables or its function spec."""
        seen: dict = {}
        items, order = [], []
        for m in mdps:
            if id(m) not in seen:
                seen[id(m)] = len(items)
                core = None if m._core is None else m._core.to("cpu")
                items.append((core, m._spec, m.mode))
            order.append(seen[id(m)])
        dist.broadcast_object_list(
            [("solve", items, order, overrides, monitored)], src=0,
            group=self._group)

    def _end_followers(self) -> None:
        if not self._ended:
            self._ended = True
            dist.broadcast_object_list([("stop",)], src=0,
                                       group=self._group)

    def _follow(self) -> None:
        """A follower rank's loop: run every dispatch rank 0 relays, until
        it ends the stream.  A failed dispatch fails on rank 0 too (the
        same solve), where its requests report it; here it is printed and
        counted, and the loop goes on to the next."""
        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0, group=self._group)
            if msg[0][0] == "stop":
                return
            _, items, order, overrides, monitored = msg[0]
            made = [MDP(core, mode=mode, spec=spec)
                    for core, spec, mode in items]
            try:
                self._session.solve_fleet(
                    [made[i] for i in order],
                    monitor=(lambda rec: None) if monitored else None,
                    **overrides)
            except Exception:   # noqa: BLE001 — the loop must go on
                traceback.print_exc()
                self._telemetry.on_fail(len(order))

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
        if self._rank != 0:
            raise RuntimeError(
                f"submit on rank {self._rank}: under a mesh clients submit "
                f"on rank 0 only (it owns the queue and the scheduler; this "
                f"rank follows its dispatches)")
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
        if self._rank != 0:
            return []
        return self._scheduler.dispatch_log()

    def stats(self) -> dict:
        """Server telemetry: submit/reject/dispatch counters, batch sizes,
        latency quantiles, program-cache hit/miss/eviction counters, and
        the owning session's cache counters."""
        out = self._telemetry.snapshot()
        out["queue_depth"] = len(self._queue)
        lead = self._rank == 0
        out["in_flight"] = self._scheduler.in_flight_count() if lead else 0
        out["draining"] = self._scheduler.draining if lead \
            else self._follower is not None and not self._follower.is_alive()
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
