"""1D heat equation by the method of lines (counterpart of
``diffsol_tpu.models.heat1d``; reference test_models/heat1d.rs).

u_t = d u_xx on (0, 1) with u = 0 at both ends, grid x_i = (i+1) h,
h = 1/(mgrid+2), n = mgrid+1 interior points, and the triangle-wave
initial condition u0(x) = 2x (x < 1/2) else 2(1-x).  The analytic solution
is the Fourier sine series u(x, t) = (8/pi^2) sum_{odd m=2k-1} (-1)^(k-1)
sin(m pi x) exp(-m^2 pi^2 d t) / m^2.  The Jacobian is the tridiagonal
Laplacian, the banded tier's natural test problem; ``p = [d]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.banded import make_banded_solver
from ..problem import OdeBuilder

F64 = torch.float64


def make(mgrid: int = 20, rtol=1e-6, atol=1e-6, banded: bool = False, dtype=None):
    """Return (problem, soln) for an mgrid+1-point MOL discretization;
    ``banded`` routes Newton through the tridiagonal band tier
    (ml = mu = 1), ``dtype=torch.float32`` builds the float32 problem."""
    n = mgrid + 1
    h = 1.0 / (mgrid + 2)

    def rhs(t, y, p):
        d = p[0]
        left = torch.cat([torch.zeros_like(y[:1]), y[:-1]])
        right = torch.cat([y[1:], torch.zeros_like(y[:1])])
        return d * (left - 2.0 * y + right) / (h * h)

    def init(t, p):
        x = (torch.arange(n, dtype=F64, device=p.device) + 1.0) * h
        return torch.where(x < 0.5, 2.0 * x, 2.0 * (1.0 - x))

    b = OdeBuilder().rhs(rhs).init(init).p([1.0]).rtol(rtol).atol(atol)
    if banded:
        b = b.linear_solver(make_banded_solver(1, 1))
    if dtype is not None:
        b = b.dtype(dtype)
    problem = b.build()

    def soln(t, d: float = 1.0):
        """Fourier series solution at the grid points (heat1d.rs:77-92),
        (len(t), n), for diffusivity ``d``."""
        x = (np.arange(n) + 1.0) * h
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        u = np.zeros((t.shape[0], n))
        for k in range(1, 200):
            m = 2 * k - 1
            # the odd harmonics of the triangle wave alternate in sign
            u += ((-1.0) ** (k - 1) * np.sin(m * np.pi * x)[None, :]
                  * np.exp(-(m**2) * np.pi**2 * d * t)[:, None] / m**2)
        return 8.0 / np.pi**2 * u

    return problem, soln
