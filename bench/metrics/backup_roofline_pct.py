"""``backup_roofline_pct``: the least time of the Bellman backups a solve
needs, over the device time of the backup kernel (``ell_backup_kernel``)
in the traced calls (Bellman backup: ``kernels/bellman_ell.py``,
``csrc/ell_backup.cu``).

A solve needs one backup to start and one an outer step; a step the
monotone safeguard rejects costs a second backup, which the results do not
report, and so reads as a lower share.  Bytes: ``idx``, ``val``, ``cost``
and ``v`` read once, ``min_a Q`` and the policy written once, over 3.35
TB/s; the kernel is bound by bytes."""

from bench import roofline


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_s("ell_backup_kernel")
    if kernel_s <= 0:
        return None
    cfg = run.cfg
    count = sum(roofline.backups(lane.outer) for lane in run.lanes)
    nbytes = count * roofline.backup_bytes(cfg["n"], cfg["m"], cfg["k"],
                                           run.dtype)
    flops = 2.0 * count * cfg["n"] * cfg["m"] * cfg["k"]
    least, _ = roofline.bound_s(nbytes, flops, run.dtype)
    return 100.0 * least / kernel_s
