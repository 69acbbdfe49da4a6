"""The program's own records of the traced calls.

While ``torch.profiler`` runs, ``repro_torch.utils.trace`` records the
spans and device reads of every ``Session`` call (``session.solve`` /
``session.solve_fleet`` and everything under it), on the thread that
made the call.  A traced run makes its ``traced_calls`` whole calls under
a profile of the device alone, then one more call under a profile with
host records, and the warm call before any profile: so the traced calls
are the last ``traced_calls + 1`` recorded session calls less the last.
A program without the module, or with no records, gives ``None``, and
its readers read nothing.
"""

from __future__ import annotations

SESSION_ROOTS = ("session.solve", "session.solve_fleet")


def traced_calls(run) -> list | None:
    """The ``repro_torch.utils.trace.Call`` of each traced call, or
    ``None``."""
    if run.trace is None or not run.calls:
        return None
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    calls = [c for c in trace.calls() if c.root.name in SESSION_ROOTS]
    count = len(run.calls)
    if len(calls) < count + 1:
        return None
    return calls[-count - 1:-1]
