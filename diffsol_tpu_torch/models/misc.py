"""Small fixture problems (counterpart of ``diffsol_tpu.models.misc``):
gaussian decay, dy/dt = y^2, Lorenz and robertson_ode groups (reference
test_models/gaussian_decay.rs, dydt_y2.rs, robertson_ode.rs; Lorenz from
examples/lorenz-attractor), with the JAX package's defaults and rhs
expressions."""

from __future__ import annotations

import numpy as np
import torch

from ..problem import OdeBuilder, OdeProblem

F64 = torch.float64


def gaussian_decay_problem(size: int = 10, rtol=1e-6, atol=1e-6) -> OdeProblem:
    """dy_i/dt = -p_i t y_i; y(t) = exp(-p t^2 / 2) (gaussian_decay.rs)."""
    return (
        OdeBuilder()
        .rhs(lambda t, y, p: -p * t * y)
        .init(lambda t, p: torch.ones(size, dtype=F64, device=p.device))
        .p([0.1] * size)
        .rtol(rtol)
        .atol(atol)
        .build()
    )


def gaussian_decay_soln(t, p):
    """Analytic solution as numpy, shape (len(t), size)."""
    t = np.asarray(t, np.float64)
    p = np.asarray(p, np.float64)
    return np.exp(-p[None, :] * (t ** 2 / 2.0)[:, None])


def dydt_y2_problem(size: int = 10, rtol=1e-4, atol=1e-6) -> OdeProblem:
    """dy/dt = y^2, y0 = -200; y = y0 / (1 - y0 t) (dydt_y2.rs)."""
    return (
        OdeBuilder()
        .rhs(lambda t, y, p: y * y)
        .init(lambda t, p: torch.full((size,), -200.0, dtype=F64, device=p.device))
        .p([0.0])
        .rtol(rtol)
        .atol(atol)
        .build()
    )


def dydt_y2_soln(t, size: int = 10):
    t = np.asarray(t, np.float64)
    y = -200.0 / (1.0 + 200.0 * t)
    return np.tile(y[:, None], (1, size))


def lorenz_rhs(t, y, p):
    s, r, b = p[0], p[1], p[2]
    return torch.stack(
        [s * (y[1] - y[0]), y[0] * (r - y[2]) - y[1], y[0] * y[1] - b * y[2]])


def lorenz_problem(rtol=1e-6, atol=1e-8, p=(10.0, 28.0, 8.0 / 3.0)) -> OdeProblem:
    """The Lorenz attractor (examples/lorenz-attractor-diffsl-llvm)."""
    return (
        OdeBuilder()
        .rhs(lorenz_rhs)
        .init(lambda t, p: torch.ones(3, dtype=F64, device=p.device))
        .p(list(p))
        .rtol(rtol)
        .atol(atol)
        .build()
    )


def robertson_ode_groups(ngroups: int = 4, rtol=1e-4) -> OdeProblem:
    """ngroups duplicated Robertson systems in one state vector
    (robertson_ode.rs:46-100), with the dense Jacobian: the block tier is
    ``robertson.problem_ode_groups``."""

    def rhs(t, y, p):
        u = y.reshape(ngroups, 3)
        r0 = -p[0] * u[:, 0] + p[1] * u[:, 1] * u[:, 2]
        r1 = p[0] * u[:, 0] - p[1] * u[:, 1] * u[:, 2] - p[2] * u[:, 1] ** 2
        r2 = p[2] * u[:, 1] ** 2
        return torch.stack([r0, r1, r2], dim=1).reshape(-1)

    def init(t, p):
        return torch.tensor([1.0, 0.0, 0.0], dtype=F64, device=p.device).repeat(ngroups)

    return (
        OdeBuilder()
        .rhs(rhs)
        .init(init)
        .p([0.04, 1.0e4, 3.0e7])
        .rtol(rtol)
        .atol(np.tile([1.0e-8, 1.0e-14, 1.0e-6], ngroups))
        .build()
    )
