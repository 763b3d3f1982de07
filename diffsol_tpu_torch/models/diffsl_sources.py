"""DiffSL text of the hand-written models, generated from their own
constants: Robertson as ODE and as DAE (reference test_models/
robertson_ode.rs and robertson.rs), heat1d (test_models/heat1d.rs) and
heat2d in the reference's matrix form (test_models/heat2d.rs: a Laplacian
``D_ij``, a mass action ``M_i { Mass_ij * dydt_j }`` and the boundary as
algebraic rows).  Each returns the text ``compile_diffsl`` and
``OdeBuilder.build_from_diffsl`` take; the tests and ``chip_smoke.py``
hold a model built from it against its hand-written twin.

Every number is written with ``repr``, which round-trips a float64
exactly, so the literals are the hand-written models' constants bit for
bit.
"""

from __future__ import annotations

import numpy as np

from .robertson import P_DEFAULT


def _lit(v) -> str:
    return repr(float(v))


def _params() -> str:
    k1, k2, k3 = (_lit(v) for v in P_DEFAULT)
    return f"in_i {{ k1 = {k1}, k2 = {k2}, k3 = {k3} }}"


def robertson_ode() -> str:
    """Robertson as an ODE, the rows written operation for operation as
    ``models.robertson.rhs_ode``."""
    return f"""
{_params()}
u_i {{ x = 1, y = 0, z = 0 }}
F_i {{
    -k1 * x + k2 * y * z,
    k1 * x - k2 * y * z - k3 * y * y,
    k3 * y * y,
}}
"""


def robertson_dae() -> str:
    """Robertson as a semi-explicit DAE (reference robertson.rs:16-42):
    mass diag(1, 1, 0) from the dudt labels, the conservation row
    algebraic."""
    return f"""
{_params()}
u_i {{ x = 1, y = 0, z = 0 }}
dudt_i {{ dxdt = 1, dydt = 0, dzdt = 0 }}
M_i {{ dxdt, dydt, 0 }}
F_i {{
    -k1 * x + k2 * y * z,
    k1 * x - k2 * y * z - k3 * y * y,
    1 - x - y - z,
}}
out_i {{ x, y, z }}
"""


def heat1d(mgrid: int) -> str:
    """heat1d with mgrid+1 interior points and the diffusivity ``D`` as its
    one input (``models.heat1d.make``'s ``p = [d]``): the tridiagonal
    ``A_ij`` by diagonal runs, the triangle-wave initial state of the
    hand-written model, ``F_i { D * A_ij * u_j / (h * h) }``."""
    n = mgrid + 1
    h = 1.0 / (mgrid + 2)
    x = (np.arange(n, dtype=np.float64) + 1.0) * h
    u0 = np.where(x < 0.5, 2.0 * x, 2.0 * (1.0 - x))
    init = ", ".join(f"({i}): {_lit(v)}" for i, v in enumerate(u0))
    return f"""
in_i {{ D = 1.0 }}
h {{ {_lit(h)} }}
A_ij {{
    (0..{mgrid}, 1..{n}): 1.0,
    (0..{n}, 0..{n}): -2.0,
    (1..{n}, 0..{mgrid}): 1.0,
}}
u_i {{ {init} }}
F_i {{ D * A_ij * u_j / (h * h) }}
"""


def heat2d_matrices(mgrid: int):
    """``(D, Mass, u0, dx2)`` of heat2d on an mgrid x mgrid grid
    (row-major): the 5-point Laplacian on interior rows and 1 on the
    diagonal of boundary rows (their residual is u itself), the mass 1 at
    interior points and 0 on the boundary, ``models.heat2d``'s initial
    state 16 x (1-x) y (1-y), and the cell area."""
    n = mgrid * mgrid
    dx = 1.0 / (mgrid - 1)
    dx2 = dx * dx
    D = np.zeros((n, n))
    mass = np.zeros((n, n))
    u0 = np.zeros(n)
    for jy in range(mgrid):
        for jx in range(mgrid):
            i = jy * mgrid + jx
            if jy in (0, mgrid - 1) or jx in (0, mgrid - 1):
                D[i, i] = 1.0
                continue
            mass[i, i] = 1.0
            D[i, i] = -4.0 / dx2
            for dyy, dxx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                D[i, (jy + dyy) * mgrid + (jx + dxx)] += 1.0 / dx2
            x, y = jx * dx, jy * dx
            u0[i] = 16.0 * x * (1.0 - x) * y * (1.0 - y)
    return D, mass, u0, dx2


def _keyed(m) -> str:
    n = m.shape[0]
    rows, cols = np.nonzero(m)
    entries = [f"({i},{j}): {_lit(m[i, j])}" for i, j in zip(rows, cols)]
    # a keyed tensor's shape is its highest key: anchor the corner
    if m[n - 1, n - 1] == 0.0:
        entries.append(f"({n - 1},{n - 1}): 0.0")
    return ",\n    ".join(entries)


def heat2d(mgrid: int) -> str:
    """heat2d in the reference's matrix form (heat2d.rs:60-85) on an
    mgrid x mgrid grid: ``F_i { D_ij * y_j }``, ``M_i { Mass_ij * dydt_j }``
    and the output (dx ||u||_2)^2 of ``models.heat2d``."""
    D, mass, u0, dx2 = heat2d_matrices(mgrid)
    n = mgrid * mgrid
    init = ", ".join(f"({i}): {_lit(v)}" for i, v in enumerate(u0))
    return f"""
D_ij {{
    {_keyed(D)}
}}
Mass_ij {{
    {_keyed(mass)}
}}
init_i {{ {init} }}
u_i {{ y = init_i }}
dudt_i {{ (0:{n}): dydt = 0 }}
M_i {{ Mass_ij * dydt_j }}
F_i {{ D_ij * y_j }}
out_i {{ {_lit(dx2)} * y_j * y_j }}
"""
