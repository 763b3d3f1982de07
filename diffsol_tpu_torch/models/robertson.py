"""Robertson chemical kinetics, DAE and ODE forms (counterpart of
``diffsol_tpu.models.robertson``; reference test_models/robertson.rs, the
semi-explicit DAE with the conservation constraint x + y + z = 1 and mass
diag(1, 1, 0), and test_models/robertson_ode.rs).

p = [k1, k2, k3] = [0.04, 1e4, 3e7], init [1, 0, 0], reference tolerances
rtol=1e-4, atol=[1e-8, 1e-6, 1e-6].  ``SOLN`` holds the CVODE/IDA reference
points of the reference's tests (robertson.rs:117-148).
``problem_ode_groups(ngroups)`` stacks ngroups copies of the ODE in one
state (robertson_ode.rs:48-100), the reference's sparse-Jacobian benchmark.  The rhs rows are
written operation for operation as in the JAX model, so both packages
evaluate the same expression tree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import OdeBuilder, OdeProblem

P_DEFAULT = (0.04, 1.0e4, 3.0e7)

# (t, [x, y, z]) reference values (robertson.rs:119-133)
SOLN = np.array(
    [
        (0.0, 1.0, 0.0, 0.0),
        (0.4, 9.8517e-01, 3.3864e-05, 1.4794e-02),
        (4.0, 9.0553e-01, 2.2406e-05, 9.4452e-02),
        (40.0, 7.1579e-01, 9.1838e-06, 2.8420e-01),
        (400.0, 4.5044e-01, 3.2218e-06, 5.4956e-01),
        (4000.0, 1.8320e-01, 8.9444e-07, 8.1680e-01),
        (40000.0, 3.8992e-02, 1.6221e-07, 9.6101e-01),
        (400000.0, 4.9369e-03, 1.9842e-08, 9.9506e-01),
        (4000000.0, 5.1674e-04, 2.0684e-09, 9.9948e-01),
        (4.0e7, 5.2009e-05, 2.0805e-10, 9.9995e-01),
        (4.0e8, 5.2012e-06, 2.0805e-11, 9.9999e-01),
        (4.0e9, 5.1850e-07, 2.0740e-12, 1.0e00),
        (4.0e10, 4.8641e-08, 1.9456e-13, 1.0e00),
    ]
)

# the output grid of the reference's t=4e10 benchmark: 0.4, 4, ..., 4e10
T_EVAL_4E10 = [4.0 * 10.0**k for k in range(-1, 11)]


def rhs_dae(t, y, p):
    return torch.stack(
        [
            -p[0] * y[0] + p[1] * y[1] * y[2],
            p[0] * y[0] - p[1] * y[1] * y[2] - p[2] * y[1] * y[1],
            y[0] + y[1] + y[2] - 1.0,
        ]
    )


def mass(t, p):
    return torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64,
                                   device=p.device))


def rhs_ode(t, y, p):
    return torch.stack(
        [
            -p[0] * y[0] + p[1] * y[1] * y[2],
            p[0] * y[0] - p[1] * y[1] * y[2] - p[2] * y[1] * y[1],
            p[2] * y[1] * y[1],
        ]
    )


def init(t, p):
    return torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64, device=p.device)


def problem_dae(rtol=1e-4, atol=(1e-8, 1e-6, 1e-6), p=P_DEFAULT) -> OdeProblem:
    return (
        OdeBuilder()
        .rhs(rhs_dae)
        .init(init)
        .mass(mass)
        .p(list(p))
        .rtol(rtol)
        .atol(np.asarray(atol, np.float64))
        .build()
    )


def problem_ode(rtol=1e-4, atol=(1e-8, 1e-6, 1e-6), p=P_DEFAULT,
                dtype=None) -> OdeProblem:
    """``dtype=torch.float32`` builds the float32 problem (JAX
    robertson.py:84-96)."""
    b = (
        OdeBuilder()
        .rhs(rhs_ode)
        .init(init)
        .p(list(p))
        .rtol(rtol)
        .atol(np.asarray(atol, np.float64))
    )
    if dtype is not None:
        b = b.dtype(dtype)
    return b.build()


def _groups_rhs(ngroups: int):
    def rhs(t, y, pv):
        u = y.reshape(ngroups, 3)
        r0 = -pv[0] * u[:, 0] + pv[1] * u[:, 1] * u[:, 2]
        r1 = (
            pv[0] * u[:, 0] - pv[1] * u[:, 1] * u[:, 2]
            - pv[2] * u[:, 1] * u[:, 1]
        )
        r2 = pv[2] * u[:, 1] * u[:, 1]
        return torch.stack([r0, r1, r2], dim=1).reshape(-1)

    return rhs


def problem_ode_groups(ngroups: int, rtol=1e-4, atol=(1e-8, 1e-6, 1e-6),
                       p=P_DEFAULT, use_coloring=True, dtype=None) -> OdeProblem:
    """robertson_ode with ``ngroups`` duplicated groups sharing one
    parameter set (states group-major [x_g, y_g, z_g], nstates =
    3 ngroups).  With ``use_coloring`` the builder finds the 3x3 blocks
    and routes the problem to the block-diagonal tier,
    ``blockdiag(3, ngroups)``; without it the Jacobian is dense.
    ``dtype`` as in :func:`problem_ode`."""

    def init(t, pv):
        return torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64,
                            device=pv.device).repeat(ngroups)

    b = (
        OdeBuilder()
        .rhs(_groups_rhs(ngroups))
        .init(init)
        .p(list(p))
        .rtol(rtol)
        .atol(np.tile(np.asarray(atol, np.float64), ngroups))
    )
    if use_coloring:
        b = b.use_coloring()
    if dtype is not None:
        b = b.dtype(dtype)
    return b.build()
