"""``surface_ms_per_call``: the host time of the user surface in each
traced call, in milliseconds (user surface: ``api/session.py``): each
call's root span (``session.solve`` / ``session.solve_fleet``) less the
time covered by the ``driver.*`` spans directly under it
(``driver.stack``, ``driver.init``, ``driver.loop``, ``driver.results``:
``core/driver.py``).  What is left is option resolution, wrapping the
MDPs, the fleet cache, the placement and the run statistics, read from
the program's own spans (``repro_torch.utils.trace``)."""

from bench.spans import traced_calls


def read(run):
    calls = traced_calls(run)
    if not calls:
        return None
    own = 0
    for c in calls:
        root = c.root
        if root.end_ns is None:
            return None
        driver = sum(s.duration_ns for s in c.spans
                     if s.parent is root and s.name.startswith("driver."))
        own += root.duration_ns - driver
    return own / 1e6 / len(calls)
