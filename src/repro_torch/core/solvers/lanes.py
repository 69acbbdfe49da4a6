"""What the batched KSP bodies share: the host-side lane bookkeeping of
``vmap`` semantics, and the adapters between a fleet of one and an
unbatched body (:func:`one_lane`, :func:`run_unbatched`).

A batched body iterates while any lane runs.  A lane that has stopped
(converged, broken down, or out of iterations) never runs again, so the
host keeps the lanes' running mask and iteration counts from the one read
a step that the loop condition needs anyway, and the device masks a
lane's update only while some lanes run and others do not.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.utils import trace


def one_lane(fleet):
    """The unbatched form of the batched KSP body ``fleet``: its B = 1
    case, on ``(n,)`` vectors with an unbatched ``matvec`` (and
    ``precond``), returning ``(x (n,), iters int, resnorm 0-d)``."""

    @functools.wraps(fleet)
    def solve(matvec, b, x0, *, precond=None, **kw):
        lift = lambda f: (lambda x: f(x[0])[None])
        if precond is not None:
            kw["precond"] = lift(precond)
        x, it, res = fleet(lift(matvec), b[None], x0[None], **kw)
        return x[0], int(it[0]), res[0]

    solve.__doc__ = f"The B = 1 case of :func:`{fleet.__name__}`."
    return solve


def run_unbatched(single, matvec, b, x0, *, tol, precond=None, **kw):
    """The unbatched body ``single`` on a fleet of one: ``(1, n)``
    operands with a batched ``matvec`` (and ``precond``), returning what a
    batched body returns, ``(x (1, n), iters (1,) int32, resnorm
    (1,))``."""
    down = lambda f: (lambda x: f(x[None])[0])
    if precond is not None:
        kw["precond"] = down(precond)
    if isinstance(tol, torch.Tensor) and tol.dim():
        tol = tol[0]
    x, it, res = single(down(matvec), b[0], x0[0], tol=tol, **kw)
    return x[None], counts([it], x0.device), res[None]


def start(run: torch.Tensor, live: torch.Tensor | None):
    """``(run, run on the host, iteration counts)`` at the loop's entry:
    lanes outside ``live`` start stopped.  The host keeps both as lists,
    one entry a lane."""
    if live is not None:
        run = run & live
    run_h = trace.to_host(run, "lanes.start").tolist()
    return run, run_h, [0] * len(run_h)


def advance(it: list, run_h: list, steps=None) -> list:
    """The counts after one step of the running lanes (``steps`` each, a
    list, or 1)."""
    steps = steps or [1] * len(it)
    return [i + s if r else i for i, r, s in zip(it, run_h, steps)]


def keep(run: torch.Tensor, all_run: bool, new: torch.Tensor,
         old: torch.Tensor) -> torch.Tensor:
    """``new`` in the running lanes, ``old`` in the stopped ones."""
    if all_run:
        return new
    return torch.where(run.view(-1, *[1] * (new.dim() - 1)), new, old)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array of per-lane values on the solve device, copied without
    waiting for the device's queue."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                        non_blocking=True)


def counts(it: list, device: torch.device) -> torch.Tensor:
    """The lanes' iteration counts as the ``(B,)`` int32 device tensor
    the batched bodies return."""
    return to_device(np.asarray(it, np.int32), device)
