"""Food web: a 2-species predator-prey reaction-diffusion DAE (IDA's
idaFoodWeb; counterpart of ``diffsol_tpu.models.foodweb``, reference
test_models/foodweb.rs with NPREY = 1).

On the unit square with an nx x nx grid the prey concentration c1 is
differential and the predator c2 ALGEBRAIC (quasi-steady, mass diagonal
0):

    dc1/dt = d1 (c1_xx + c1_yy) + c1 (b fac(x,y) - a c1 - g c2)
    0      = d2 (c2_xx + c2_yy) + c2 (-b fac(x,y) + e c1 - a c2)

with fac = 1 + alpha x y + beta sin(4 pi x) sin(4 pi y), reflective
boundaries, a = 1, e = 1e4, g = 0.5e-6, b = 1, d1 = 1, d2 = 0.05,
alpha = 50, beta = 1000.  Init: c1 = 10 + (16 x (1-x) y (1-y))^2,
c2 = 1e5, which is inconsistent: the consistent-IC solve adjusts it.
``SOLN`` holds IDA's corner values (c1 and c2 at the top-left and the
bottom-right, foodweb.rs:996-1052).  The state is the flattened
(jy, jx, species) array, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.banded import make_banded_solver
from ..problem import OdeBuilder, OdeProblem
from ._consts import DeviceConsts

AA, EE, GG, BB = 1.0, 1.0e4, 0.5e-6, 1.0
DPREY, DPRED = 1.0, 0.05
ALPHA, BETA = 50.0, 1000.0

# (t, c1_tl, c1_br, c2_tl, c2_br) from IDA (foodweb.rs:996-1052)
SOLN = np.array(
    [
        (0.0, 10.0, 10.0, 99999.0, 99949.0),
        (0.001, 9.997887753650794, 10.498336872161198, 99979.21262678975, 104933.61130371751),
        (0.01, 116.7394053543608, 141.3349347208864, 1167406.222331898, 1413309.7156706247),
        (0.1, 169.50991588474182, 196.55298551613117, 1695106.6267256583, 1965486.1821950572),
        (0.4, 169.50991230736778, 196.55298216342456, 1695106.5909521726, 1965486.1486681814),
        (0.7, 169.5099123071205, 196.55298216319915, 1695106.5909496995, 1965486.1486659276),
        (1.0, 169.50991230687316, 196.55298216297376, 1695106.5909472264, 1965486.1486636735),
    ]
)


def callables(nx: int, mass_diag=None, u0=None) -> dict:
    """The member callables ``rhs``, ``init`` and ``mass`` for an nx x nx
    grid.  ``mass_diag`` and ``u0`` (numpy, (n,)) replace the constants
    computed here, so a problem built by the JAX package carries its own
    across (``interop.problem_from_jax(..., model="foodweb")``)."""
    dx = 1.0 / (nx - 1)
    dy = 1.0 / (nx - 1)
    xv = np.arange(nx) * dx
    yv = np.arange(nx) * dy
    xx, yy = np.meshgrid(xv, yv)  # [jy, jx]
    fac = 1.0 + ALPHA * xx * yy + BETA * np.sin(4 * np.pi * xx) * np.sin(
        4 * np.pi * yy
    )
    if u0 is None:
        xyf = (16.0 * xx * (1.0 - xx) * yy * (1.0 - yy)) ** 2
        c1 = 10.0 + xyf
        u0 = np.stack([c1, np.full_like(c1, 1.0e5)], axis=-1)
    if mass_diag is None:
        mass_diag = np.tile(np.array([1.0, 0.0]), nx * nx)
    consts = DeviceConsts(
        fac=fac[..., None],
        cox=np.array([DPREY / dx**2, DPRED / dx**2]),
        coy=np.array([DPREY / dy**2, DPRED / dy**2]),
        acoef=np.array([[-AA, -GG], [EE, -AA]]),
        bcoef=np.array([BB, -BB]),
        mass_diag=np.asarray(mass_diag, np.float64).reshape(-1),
        u0=np.asarray(u0, np.float64).reshape(-1),
    )

    def rhs(t, y, p):
        c = consts(y)
        u = y.reshape(nx, nx, 2)  # [jy, jx, is]
        up = F.pad(u.permute(2, 0, 1), (1, 1, 1, 1), mode="reflect").permute(1, 2, 0)
        lap = (
            c["coy"] * (up[:-2, 1:-1] - 2.0 * u + up[2:, 1:-1])
            + c["cox"] * (up[1:-1, :-2] - 2.0 * u + up[1:-1, 2:])
        )
        inter = torch.einsum("ij,xyj->xyi", c["acoef"], u)
        rates = u * (c["bcoef"] * c["fac"] + inter)
        return (lap + rates).reshape(-1)

    def mass(t, p):
        return torch.diag(consts(p)["mass_diag"])

    def init(t, p):
        return consts(p)["u0"].clone()

    return dict(rhs=rhs, init=init, mass=mass)


def make(nx: int = 10, rtol=1e-5, atol=1e-5, banded: bool = True) -> OdeProblem:
    fns = callables(nx)
    b = (
        OdeBuilder()
        .rhs(fns["rhs"])
        .init(fns["init"])
        .mass(fns["mass"])
        .p([1.0])
        .rtol(rtol)
        .atol(atol)
    )
    if banded:
        b = b.linear_solver(make_banded_solver(2 * nx, 2 * nx))
    return b.build()


def corner_values(ys, nx: int):
    """(c1_tl, c1_br, c2_tl, c2_br) of flattened solutions."""
    u = np.asarray(ys).reshape(ys.shape[:-1] + (nx, nx, 2))
    return np.stack(
        [u[..., 0, 0, 0], u[..., -1, -1, 0], u[..., 0, 0, 1], u[..., -1, -1, 1]],
        axis=-1,
    )
