"""``inner_per_instance``: the results' ``inner_iterations`` (GMRES's
Arnoldi steps that counted, or Richardson's sweeps), the mean over the
traced run's instances (inner KSP: ``core/solvers/``)."""


def read(run):
    lanes = run.lanes
    return sum(lane.inner for lane in lanes) / len(lanes) if lanes else None
