"""Spans and counters of the solve path, kept in memory while someone is
looking.

Recording is on while a ``torch.profiler`` session is active, or inside
:func:`recording` (the explicit switch for operators and tests).  While
it is off, :func:`span` hands back one shared do-nothing context after a
single flag check and :func:`to_host` is a plain ``tensor.cpu()``: no
record is made, nothing is allocated, no CUDA event is recorded and no
read or sync is added, so a solve gives the same bits either way.

A **span** records its name, its start and end, its parent and the call
it belongs to.  The outermost span open on a thread begins a new
:class:`Call` (``Session.solve`` / ``Session.solve_fleet`` open
``session.solve`` / ``session.solve_fleet`` around everything they do);
every span opened under it joins that call.  Each thread keeps its own
ring of the :data:`RING` most recent calls (:func:`calls`), because
solves also run from the solve server's threads.  Times are
``time.time_ns()``, the clock of ``torch.profiler``'s host records, so a
span and the profiler's records of the work it issued lie on one
timeline.  Spans are not profiler annotations: they add nothing to the
profile.  ``span(name, device=...)`` on a CUDA device also records a
pair of timing events on the device's current stream, read only when the
record is read (:meth:`Span.device_ms`), never inside the call.

Every device-to-host read of the solve path goes through
:func:`to_host` (or :func:`reading`, for a read that is no copy): while
recording, each read is a ``read.<site>`` span,
so a call counts its reads and the host's wait on them by site.  A call
also keeps the kernel launches it issued
(:func:`repro_torch.kernels.ops.launch_counts` at its end less at its
start).

The spans of the solve path, outermost first: ``session.solve`` /
``session.solve_fleet``; ``driver.stack`` (the lanes' tables stacked and
placed), ``driver.init`` (the initial state), ``driver.loop`` (the outer
loop), ``driver.results`` (the lanes' results read back); ``ipi.step`` (one
outer step), within it ``ipi.backup`` (each Bellman backup) and
``ipi.inner`` (the inner solve); ``gmres.cycle`` (one restart cycle),
within it ``gmres.orthogonalize`` (the two CGS2 passes of one Arnoldi
step, timed on the device too) and ``gmres.givens`` (the rotations and
masked updates of the step).  :meth:`Call.summary` is what a session's
run statistics carry under ``"trace"`` while recording.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["RING", "Call", "Span", "calls", "clear", "enabled", "find",
           "reading", "recording", "span", "to_host"]

# recorded calls kept per thread
RING = 64

_forced = 0
_forced_lock = threading.Lock()
_ids = itertools.count(1)


def enabled() -> bool:
    """Whether spans and reads are being recorded now."""
    return bool(_forced) or _profiler._is_profiler_enabled


@contextlib.contextmanager
def recording():
    """Record spans and reads, in every thread, while inside."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield
    finally:
        with _forced_lock:
            _forced -= 1


class Span:
    """One recorded interval: ``start_ns`` / ``end_ns`` on the profiler's
    host clock (``end_ns`` is ``None`` while open), its ``parent`` span
    (``None`` for a call's root) and its ``call``'s id."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "_events")

    def __init__(self, name: str, parent: "Span | None", call: int):
        self.name = name
        self.parent = parent
        self.call = call
        self.start_ns = self.end_ns = None
        self._events = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def device_ms(self) -> float | None:
        """Milliseconds between the span's two events on its stream, or
        ``None`` if it recorded none (no CUDA device)."""
        if self._events is None:
            return None
        begin, end = self._events
        end.synchronize()
        return begin.elapsed_time(end)


class Call:
    """Every span of one outermost span on one thread, in opening order
    (``spans[0]`` is the root), and the kernel launches it issued."""

    __slots__ = ("id", "spans", "launches", "_launches0")

    def __init__(self, call_id: int):
        self.id = call_id
        self.spans: list[Span] = []
        self.launches: dict[str, int] = {}
        self._launches0 = _launch_counts()

    @property
    def root(self) -> Span:
        return self.spans[0]

    def summary(self) -> dict:
        """Milliseconds by span name (``total_ms``; ``self_ms``, less the
        spans opened directly under each; ``device_ms`` of the spans timed
        on the device), reads and the host's wait on them by site, and
        launches by kernel."""
        closed = [s for s in self.spans if s.end_ns is not None]
        children = collections.Counter()
        for s in closed:
            if s.parent is not None:
                children[id(s.parent)] += s.duration_ns
        total, own = collections.Counter(), collections.Counter()
        device = collections.Counter()
        reads, wait = collections.Counter(), collections.Counter()
        for s in closed:
            total[s.name] += s.duration_ns
            own[s.name] += s.duration_ns - children[id(s)]
            ms = s.device_ms()
            if ms is not None:
                device[s.name] += ms
            if s.name.startswith("read."):
                reads[s.name[5:]] += 1
                wait[s.name[5:]] += s.duration_ns
        ms = lambda c: {k: round(v / 1e6, 6) for k, v in sorted(c.items())}
        return {"total_ms": ms(total), "self_ms": ms(own),
                "device_ms": {k: round(v, 6) for k, v in
                              sorted(device.items())},
                "reads": dict(sorted(reads.items())),
                "read_wait_ms": ms(wait),
                "launches": {k: v for k, v in self.launches.items() if v}}


class _State(threading.local):
    def __init__(self):
        self.stack: list[Span] = []
        self.call: Call | None = None
        self.ring: collections.deque = collections.deque(maxlen=RING)


_state = _State()


def _launch_counts() -> dict[str, int]:
    from repro_torch.kernels import ops
    return ops.launch_counts()


class _Null:
    """The context :func:`span` hands back while nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NULL = _Null()


class _Open:
    __slots__ = ("name", "device", "span")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self) -> Span:
        st = _state
        parent = st.stack[-1] if st.stack else None
        if parent is None:
            st.call = Call(next(_ids))
            st.ring.append(st.call)
        sp = self.span = Span(self.name, parent, st.call.id)
        st.call.spans.append(sp)
        st.stack.append(sp)
        if self.device is not None and self.device.type == "cuda":
            sp._events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            sp._events[0].record(torch.cuda.current_stream(self.device))
        sp.start_ns = time.time_ns()
        return sp

    def __exit__(self, *exc) -> None:
        sp, st = self.span, _state
        sp.end_ns = time.time_ns()
        if sp._events is not None:
            sp._events[1].record(torch.cuda.current_stream(self.device))
        st.stack.pop()
        if not st.stack:
            now = _launch_counts()
            call = st.call
            call.launches = {k: v - call._launches0.get(k, 0)
                             for k, v in now.items()}
            st.call = None


def span(name: str, *, device: torch.device | None = None):
    """A context recording one span named ``name`` while recording is on
    (it enters as the :class:`Span`), else one shared context that does
    nothing (it enters as ``None``).  A CUDA ``device`` also times the
    span on the device's current stream."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _NULL
    return _Open(name, device)


def reading(site: str):
    """The context of one device-to-host read at ``site``: while
    recording, a ``read.<site>`` span of the open call.  For a read that
    is not a copy (``torch.equal`` on the card); copies use
    :func:`to_host`."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _NULL
    return _Open("read." + site, None)


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t.cpu()``: the way the solve path reads the device, counted and
    timed by :func:`reading`."""
    with reading(site):
        return t.cpu()


def calls() -> list[Call]:
    """This thread's recorded calls, oldest first (at most :data:`RING`)."""
    return list(_state.ring)


def find(call_id: int) -> Call | None:
    """This thread's recorded call of id ``call_id``, if still kept."""
    return next((c for c in reversed(_state.ring) if c.id == call_id), None)


def clear() -> None:
    """Forget this thread's recorded calls."""
    _state.ring.clear()
