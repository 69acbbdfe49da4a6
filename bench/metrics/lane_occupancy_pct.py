"""``lane_occupancy_pct``: the share of lane-steps that still did work in
the fleet's lockstep loop, ``sum_b k_b / (B * max_b k_b)`` over each
traced call's per-lane outer counts, summed over the calls before the
ratio (fleet driver: ``core/driver.py::solve_many``).  A lane that has
converged waits, masked, for the slowest lane of its call."""


def read(run):
    if run.traffic.batch < 2:
        return None
    done = sum(lane.outer for c in run.calls for lane in c.lanes)
    slots = sum(len(c.lanes) * max(lane.outer for lane in c.lanes)
                for c in run.calls)
    return 100.0 * done / slots if slots else None
