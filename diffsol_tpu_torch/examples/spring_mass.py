"""Damped spring-mass system with an event at maximum compression
(counterpart of the JAX package's ``examples/spring_mass.py``).

Equivalent of reference examples/spring-mass-system: integrate
m x'' + c x' + k x = 0 as a first-order system, find the first zero of the
velocity (a root-finding event) and report the first oscillation extremum.

Run: python -m diffsol_tpu_torch.examples.spring_mass [--cpu]
"""

import numpy as np
import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device


def main(device=None):
    dev = resolve_device(device, "spring_mass")
    m, c, k = 1.0, 0.3, 4.0

    def rhs(t, y, p):
        x, v = y[0], y[1]
        return torch.stack([v, -(p[2] * x + p[1] * v) / p[0]])

    problem = (
        dt.OdeBuilder()
        .rhs(rhs)
        .init(lambda t, p: torch.tensor([1.0, 0.0], dtype=torch.float64, device=p.device))
        .root(lambda t, y, p: y[1:2])  # velocity zero crossing
        .p([m, c, k])
        .rtol(1e-10)
        .atol(1e-12)
        .build()
    )
    solver = dt.solver(problem, "tsit45")
    sol = dt.solve(solver, 10.0, device=dev)
    assert sol.stop_reason == dt.errors.ROOT_FOUND, sol.stop_reason
    t_ext, x_ext = float(sol.state.t), float(sol.state.y[0])
    # analytic: underdamped, extremum at t = pi/omega_d
    wd = np.sqrt(k / m - (c / (2 * m)) ** 2)
    t_exact = np.pi / wd
    print(f"first extremum at t={t_ext:.6f} (exact {t_exact:.6f}), "
          f"x={x_ext:.6f}")
    np.testing.assert_allclose(t_ext, t_exact, rtol=1e-6)
    return {"t_extremum": t_ext, "t_exact": float(t_exact), "x_extremum": x_ext}


if __name__ == "__main__":
    main(cli_device())
