"""``outer_per_instance``: the results' ``outer_iterations``, the mean
over the traced run's instances (outer loop: ``core/driver.py``,
``core/ipi.py``)."""


def read(run):
    lanes = run.lanes
    return sum(lane.outer for lane in lanes) / len(lanes) if lanes else None
