"""``device_idle_pct``: the share of the traced window in which no
kernel, copy or set ran on the card (the union of the profiler's device
records against the host clock over the traced calls).  Profiling adds
host time, so this reads at or above the untraced run's idle share."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
