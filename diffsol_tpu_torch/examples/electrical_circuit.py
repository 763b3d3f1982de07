"""RC circuit as a linear DAE with a singular mass matrix (counterpart of
the JAX package's ``examples/electrical_circuit.py``).

Equivalent of reference examples/electrical-circuits: a driven RC network
where Kirchhoff's current law is an algebraic constraint.  States:
[v_c (capacitor voltage), i_r (resistor current)], with

    C dv_c/dt = i_c = i_in(t) - i_r        (differential)
    0         = v_c - i_r R                (algebraic: Ohm's law)

The solver makes the initial conditions consistent before the first step.

Run: python -m diffsol_tpu_torch.examples.electrical_circuit [--cpu]
"""

import numpy as np
import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device


def main(device=None):
    dev = resolve_device(device, "electrical_circuit")
    R, C, I0 = 2.0, 0.5, 1.0  # ohms, farads, amps (DC source)

    def rhs(t, y, p):
        v_c, i_r = y[0], y[1]
        return torch.stack([(p[2] - i_r) / p[1], v_c - i_r * p[0]])

    def mass(t, p):
        return torch.diag(torch.tensor([1.0, 0.0], dtype=torch.float64, device=p.device))

    problem = (
        dt.OdeBuilder()
        .rhs(rhs)
        .init(lambda t, p: torch.zeros(2, dtype=torch.float64, device=p.device))
        .mass(mass)
        .p([R, C, I0])
        .rtol(1e-8)
        .atol(1e-10)
        .build()
    )
    solver = dt.BdfSolver(problem)
    t = np.linspace(0.0, 5.0, 11)
    sol = dt.solve_dense(solver, t, device=dev)
    ys = sol.ys.cpu().numpy()
    # analytic: v_c = I0 R (1 - exp(-t/(RC))), i_r = v_c / R
    v_exact = I0 * R * (1.0 - np.exp(-t / (R * C)))
    np.testing.assert_allclose(ys[:, 0], v_exact, rtol=1e-6)
    np.testing.assert_allclose(ys[:, 1], v_exact / R, rtol=1e-6)
    print(f"capacitor charges to {ys[-1, 0]:.4f} V "
          f"(asymptote {I0 * R} V); KCL constraint satisfied throughout")
    return {"v_final": float(ys[-1, 0]), "asymptote": I0 * R}


if __name__ == "__main__":
    main(cli_device())
