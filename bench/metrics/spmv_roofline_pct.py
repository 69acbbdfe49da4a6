"""``spmv_roofline_pct``: the least time of the policy matvecs the method
needs, over the device time of the matvec kernel (``ell_spmv_kernel``)
in the traced calls (policy matvec: ``core/bellman.py::a_pi_matvec``,
``kernels/spmv_ell.py``, ``csrc/ell_spmv.cu``).

Needed matvecs come from each result's ``trace_inner`` by
``bench/roofline.py``: restarted GMRES needs, at each outer step, the warm
start's residual, which decides whether to iterate, one residual opening
each restart cycle, and one matvec an Arnoldi step that counted;
Richardson (``mpi``) the warm start's residual and one a sweep that
counted.  At 6 outer steps of 66 inner steps, one cycle each, that is 78,
where the port launches 204 (``PERF.md``): it runs all 32 steps of every
cycle and masks those after convergence.  (A GMRES that opened its first
cycle from the warm start's residual would need one fewer a step; the
rule counts it, so it never counts more than the port launches.)  The
launch counters are never the count, so unused work reads as a lower
share.  Bytes: ``P_pi``'s ``idx`` and ``val`` and ``x`` read once, ``y``
written once, over 3.35 TB/s; the kernel is bound by bytes."""

from bench import roofline


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_s("ell_spmv_kernel")
    if kernel_s <= 0:
        return None
    cfg = run.cfg
    count = sum(roofline.needed_matvecs(run.method, lane.trace_inner,
                                        run.options["-restart"])
                for lane in run.lanes)
    nbytes = count * roofline.matvec_bytes(cfg["n"], cfg["k"], run.dtype)
    least, _ = roofline.bound_s(nbytes, 2.0 * count * cfg["n"] * cfg["k"],
                                run.dtype)
    return 100.0 * least / kernel_s
