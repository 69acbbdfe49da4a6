"""Chebyshev semi-iteration — an inner solver with no inner products.

Counterpart of :mod:`repro.core.solvers.chebyshev`.  For ``A = I - gamma
P_pi`` the spectrum lies in the disk of radius ``gamma`` about 1; on
reversible policy chains it is real and inside ``[1 - gamma, 1 +
gamma]``, where the Chebyshev recursion (Saad, *Iterative Methods for
Sparse Linear Systems*, Alg. 12.1) is the optimal polynomial iteration.
The only reduction per iteration is the sup-norm residual.  On spectra
with large imaginary parts the iteration may stall; the outer monotone
safeguard keeps iPI convergent regardless.

The reference's ``lax.while_loop`` becomes a host loop that reads the
residual once per iteration.
"""

from __future__ import annotations

import torch

from repro_torch.core.comm import Axes

_TINY = 1e-30


def chebyshev(matvec, b: torch.Tensor, x0: torch.Tensor, *, tol,
              maxiter: int, axes: Axes, lo, hi, divtol: float = 1e4):
    """Returns ``(x, iters, ||b - A x||_inf)``.

    ``lo`` / ``hi`` bound the (real part of the) spectrum of ``A``.  The
    iteration also stops once the residual exceeds ``divtol`` times the
    initial one, handing the outer safeguard a cheap rejection.
    """
    dt, dev = x0.dtype, x0.device
    theta = torch.tensor((hi + lo) * 0.5, dtype=dt, device=dev)
    delta = torch.maximum(torch.tensor((hi - lo) * 0.5, dtype=dt,
                                       device=dev),
                          torch.tensor(_TINY, dtype=dt, device=dev))
    sigma1 = theta / delta

    x = x0
    r = b - matvec(x0)
    n0 = axes.norm_inf(r)
    d = r / theta
    rho = delta / theta
    res = n0
    bound = divtol * n0 + _TINY
    it = 0
    while it < maxiter and bool((res > tol) & (res <= bound)):
        x = x + d
        r = r - matvec(d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        rho = rho_new
        res = axes.norm_inf(r)
        it += 1
    return x, it, res
