"""``peak_device_gb``: ``torch.cuda.max_memory_allocated()`` over the
window, after a reset at its start, in 10^9 bytes: the tables, the
program's copies of them and its solver state.  It decides the largest
MDP a user fits on the card."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 1e9
