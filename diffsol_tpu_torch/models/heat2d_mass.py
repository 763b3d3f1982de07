"""2-D heat equation on an mgrid x mgrid grid of cells whose edge cells are
algebraic (y = 0 there), written with a mass matrix and a constant
Jacobian D: M dy/dt = D y.  It is the closure-built twin of the DiffSL
model in ``tests/test_diffsl.py`` (its ``Mass_ij`` and ``D_ij``), the
JAX package's test of a mass given as a matrix.

With ``consistent=False`` the mass is that model's: one on the interior
diagonal, zero on the edge rows (structurally diagonal, so the builder
takes the elementwise path).  With ``consistent=True`` each interior row
is the finite-element consistent mass, 2/3 on the diagonal and 1/12 on
its four neighbours, so the mass is dense (non-diagonal) and singular.
The Jacobian is D, handed to the builder through ``rhs_implicit``.
"""

from __future__ import annotations

import numpy as np

from ..problem import OdeBuilder, OdeProblem
from ._consts import DeviceConsts

NEIGHBOURS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def matrices(mgrid: int = 4, consistent: bool = False):
    """``(D, M, y0)`` as numpy arrays: the stencil with the edge rows as
    constraints y = 0, the mass and the initial state (one inside, zero
    on the edge)."""
    n = mgrid * mgrid
    dx2 = (1.0 / (mgrid - 1)) ** 2
    D = np.zeros((n, n))
    M = np.zeros((n, n))
    y0 = np.zeros(n)
    for jy in range(mgrid):
        for jx in range(mgrid):
            i = jy * mgrid + jx
            if jy in (0, mgrid - 1) or jx in (0, mgrid - 1):
                D[i, i] = 1.0  # the algebraic constraint y = 0 on the edge
                continue
            y0[i] = 1.0
            M[i, i] = 2.0 / 3.0 if consistent else 1.0
            D[i, i] = -4.0 / dx2
            for dyy, dxx in NEIGHBOURS:
                j = (jy + dyy) * mgrid + (jx + dxx)
                D[i, j] += 1.0 / dx2
                if consistent:
                    M[i, j] = 1.0 / 12.0
    return D, M, y0


def problem(mgrid: int = 4, consistent: bool = False, rtol=1e-7,
            atol=1e-7) -> OdeProblem:
    D, M, y0 = matrices(mgrid, consistent)
    consts = DeviceConsts(D=D, M=M, y0=y0)

    def rhs(t, y, p):
        return consts(y)["D"] @ y

    def jac(t, y, p):
        return consts(y)["D"]

    return (
        OdeBuilder()
        .rhs_implicit(rhs, jac)
        .init(lambda t, p: consts(p)["y0"].clone())
        .mass(lambda t, p: consts(p)["M"])
        .p([1.0])
        .rtol(rtol)
        .atol(atol)
        .build()
    )
