"""``solve_mfu_pct``: the whole solve's share of the card's peak: the
least time of the backups and matvecs the method needs (the bytes of
``backup_roofline_pct`` and ``spmv_roofline_pct`` over 3.35 TB/s; an MDP
solve runs no model and is bound by bytes, not FLOPs) over the traced
calls' host-clock time.  It bounds what the per-kernel shares can claim
once a kernel leaves the path."""

from bench import roofline


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    cfg, dt = run.cfg, run.dtype
    nbytes = 0
    for lane in run.lanes:
        nbytes += roofline.backups(lane.outer) * roofline.backup_bytes(
            cfg["n"], cfg["m"], cfg["k"], dt)
        nbytes += roofline.needed_matvecs(
            run.method, lane.trace_inner, run.options["-restart"]) \
            * roofline.matvec_bytes(cfg["n"], cfg["k"], dt)
    least, _ = roofline.bound_s(nbytes, 0.0, dt)
    return 100.0 * least / run.trace.window_s
