"""Solve-as-a-service: a batched MDP serving subsystem over ``Session``.

Counterpart of :mod:`repro.serve` on one device (the card unless the
session's ``-device`` says ``cpu``).

A :class:`Server` is a persistent in-process service accepting solve
requests from many concurrent clients.  Requests pass admission control
(queue depth, per-request state-count limits), coalesce in a background
scheduler that dynamically batches compatible arrivals — same solver
options, same container family, state counts grouped by the fleet
pad-waste rule — inside a ``-serve_batch_window`` linger, and dispatch as
one batched ``solve_many`` per shape bucket through the owning
:class:`repro_torch.api.Session`.  Per-request results and per-iteration
``-monitor`` records are demultiplexed back to the submitting clients in
input order; a program-slot cache keyed by shape bucket reports
hit/miss/eviction counters in ``Server.stats()``.

    from repro_torch.serve import Server
    with Server({"-method": "vi", "-serve_batch_window": 0.02}) as srv:
        req = srv.submit(mdp, monitor=True)
        for rec in srv.stream(req):
            print(rec)
        result = req.result()

The CLI entry point is ``python -m repro_torch.launch.serve``.
"""

from repro_torch.serve.cache import ProgramCache, program_key
from repro_torch.serve.queue import AdmissionError, Request, RequestQueue
from repro_torch.serve.scheduler import Scheduler, slot_size
from repro_torch.serve.server import Server
from repro_torch.serve.stats import Telemetry, percentile

__all__ = [
    "AdmissionError",
    "ProgramCache",
    "Request",
    "RequestQueue",
    "Scheduler",
    "Server",
    "Telemetry",
    "percentile",
    "program_key",
    "slot_size",
]
