"""``arnoldi_roofline_pct``: the least time of the CGS2 work GMRES needs,
over the device time of the program's ``gmres.orthogonalize`` spans in
the traced calls (inner KSP: ``core/solvers/gmres.py``, the two
classical Gram-Schmidt passes of each Arnoldi step).  The spans are the
program's own (``repro_torch.utils.trace``), timed by a pair of CUDA
events around the passes, so the metric reads whatever kernels implement
them.

Needed work, per lane, for each outer step's Arnoldi steps that counted
(the results' ``trace_inner``, split into restart cycles of
``-restart``): the step at position ``p`` of its cycle projects ``w`` on
the ``p + 1`` basis rows in use and subtracts the projection, twice.  A
pass reads the ``p + 1`` rows and ``w`` for the projection, then the rows
and ``w`` again and writes ``w`` for the update: ``(4 (p + 1) + 6) n``
values for the two passes, and ``8 (p + 1) n + 2 n`` operations.  Steps
masked after convergence, and the basis rows not yet in use, are not
needed, so the share falls as a cycle runs steps or reads rows that its
result never uses.  Bound by bytes (``bench/roofline.py``'s HBM rate and
value sizes)."""

from bench import roofline
from bench.spans import traced_calls


def needed(trace_inner, restart: int, n: int, dtype: str) -> tuple:
    """``(bytes, operations)`` of the CGS2 passes one lane needs."""
    nbytes = flops = 0
    for steps in trace_inner:
        steps = int(steps)
        while steps > 0:
            cycle = min(steps, restart)
            for p in range(cycle):
                nbytes += (4 * (p + 1) + 6) * n * roofline.VALUE_BYTES[dtype]
                flops += (8 * (p + 1) + 2) * n
            steps -= cycle
    return nbytes, flops


def read(run):
    if run.method != "ipi_gmres":
        return None
    calls = traced_calls(run)
    if not calls:
        return None
    device_ms = 0.0
    for c in calls:
        for s in c.spans:
            if s.name == "gmres.orthogonalize":
                ms = s.device_ms()
                if ms is None:
                    return None
                device_ms += ms
    if device_ms <= 0:
        return None
    nbytes = flops = 0
    for lane in run.lanes:
        b, f = needed(lane.trace_inner, run.options["-restart"],
                      run.cfg["n"], run.dtype)
        nbytes += b
        flops += f
    least, _ = roofline.bound_s(nbytes, flops, run.dtype)
    return 100.0 * least / (device_ms / 1e3)
