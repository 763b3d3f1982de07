"""2-D heat equation DAE (IDA's idaHeat2D example) by the method of lines
(counterpart of ``diffsol_tpu.models.heat2d``; reference
test_models/heat2d.rs).

u_t = u_xx + u_yy on the unit square, an mgrid x mgrid grid (row-major),
with the Dirichlet boundary written as ALGEBRAIC constraints: the mass
diagonal is 1 at interior points and 0 on the boundary, where the residual
is u itself (heat2d.rs:102-199).  u0 = 16 x (1-x) y (1-y), and the output
is g = (dx ||u||_2)^2.  The Jacobian is the 5-point Laplacian, bandwidth
(mgrid, mgrid): the banded tier's first 2-D problem.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.banded import make_banded_solver
from ..problem import OdeBuilder, OdeProblem
from ._consts import DeviceConsts


def callables(mgrid: int, mass_diag=None, u0=None) -> dict:
    """The member callables ``rhs``, ``init``, ``mass`` and ``out`` for an
    mgrid x mgrid grid.  ``mass_diag`` and ``u0`` (numpy, (n,)) replace the
    constants computed here, so a problem built by the JAX package carries
    its own across (``interop.problem_from_jax(..., model="heat2d")``); the
    interior mask is where the mass diagonal is not zero."""
    n = mgrid * mgrid
    dx = 1.0 / (mgrid - 1)
    coeff = 1.0 / (dx * dx)
    idx = np.arange(n)
    ii = idx % mgrid
    jj = idx // mgrid
    if mass_diag is None:
        interior = (ii > 0) & (ii < mgrid - 1) & (jj > 0) & (jj < mgrid - 1)
        mass_diag = np.where(interior, 1.0, 0.0)
    mass_diag = np.asarray(mass_diag, np.float64).reshape(n)
    interior = mass_diag != 0.0
    if u0 is None:
        x = (ii * dx).astype(np.float64)
        yv = (jj * dx).astype(np.float64)
        u0 = np.where(interior, 16.0 * x * (1.0 - x) * yv * (1.0 - yv), 0.0)
    consts = DeviceConsts(interior=interior, mass_diag=mass_diag,
                          u0=np.asarray(u0, np.float64).reshape(n))

    def rhs(t, y, p):
        u = y.reshape(mgrid, mgrid)
        lap = (
            torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
            + torch.roll(u, 1, 1) + torch.roll(u, -1, 1)
            - 4.0 * u
        ).reshape(-1) * coeff
        return torch.where(consts(y)["interior"], lap, y)

    def mass(t, p):
        return torch.diag(consts(p)["mass_diag"])

    def init(t, p):
        return consts(p)["u0"].clone()

    def out(t, y, p):
        return (torch.sum(y * y) * dx * dx).reshape(1)

    return dict(rhs=rhs, init=init, mass=mass, out=out)


def make(mgrid: int = 10, rtol=1e-5, atol=1e-5, banded: bool = True,
         dtype=None) -> OdeProblem:
    """The heat2d DAE problem (n = mgrid^2 states); ``dtype=torch.float32``
    builds the float32 problem."""
    fns = callables(mgrid)
    b = (
        OdeBuilder()
        .rhs(fns["rhs"])
        .init(fns["init"])
        .mass(fns["mass"])
        .out(fns["out"])
        .p([1.0])
        .rtol(rtol)
        .atol(atol)
    )
    if banded:
        b = b.linear_solver(make_banded_solver(mgrid, mgrid))
    if dtype is not None:
        b = b.dtype(dtype)
    return b.build()
