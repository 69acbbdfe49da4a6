"""``host_reads_per_instance``: device-to-host reads in the traced calls
over the instances asked for (outer loop: ``core/ipi.py``'s flags and
safeguard, the inner solvers' loop conditions, ``core/driver.py``'s
results).  Every read of the solve path goes through the program's one
funnel, ``repro_torch.utils.trace.to_host``, which records each as a
``read.<site>`` span while the profiler runs; this counts them.  Each
read waits for the device's queue to drain, so fewer reads let the host
run further ahead of the card."""

from bench.spans import traced_calls


def read(run):
    calls = traced_calls(run)
    if calls is None or not run.lanes:
        return None
    reads = sum(s.name.startswith("read.") for c in calls for s in c.spans)
    return reads / len(run.lanes)
