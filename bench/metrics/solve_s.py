"""``solve_s``: seconds of the window an instance certified in it.

The window runs from the first call's start to the last call's end on the
host clock (every call returns host results, so it has synchronised);
an instance is certified when its solve returned ``converged``.  This is
the accelerator time a user pays for each solved instance."""


def read(run):
    if run.trace is not None or not run.certified:
        return None
    return run.window_s / run.certified
