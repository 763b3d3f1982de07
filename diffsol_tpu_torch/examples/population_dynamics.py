"""Lotka-Volterra predator-prey population dynamics (counterpart of the
JAX package's ``examples/population_dynamics.py``).

Equivalent of reference examples/population-dynamics: the same model built
two ways (DiffSL text and plain closures), solved adaptively, plus a
phase-plane sweep over initial conditions -- here the sweep is a lockstep
ensemble instead of a loop over solves.

Run: python -m diffsol_tpu_torch.examples.population_dynamics [--cpu]
"""

import numpy as np
import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device

DIFFSL = """
in_i { y0 = 1.0 }
a { 2.0/3.0 } b { 4.0/3.0 } c { 1.0 } d { 1.0 }
u_i {
    y1 = y0,
    y2 = y0,
}
F_i {
    a * y1 - b * y1 * y2,
    c * y1 * y2 - d * y2,
}
"""


def main(device=None):
    dev = resolve_device(device, "population_dynamics")
    # --- DiffSL build (reference problem_diffsl) ---
    problem = dt.OdeBuilder().rtol(1e-6).atol(1e-8).build_from_diffsl(DIFFSL)
    sol = dt.solve(dt.BdfSolver(problem), 40.0, device=dev)
    n = sol.n_points
    final = sol.ys[n - 1].tolist()
    print(f"DiffSL build: {n} steps to t=40, "
          f"final (prey, predator) = {np.asarray(final)}")

    # --- closure build (reference problem_rust_closures) ---
    def rhs(t, y, p):
        return torch.stack([2.0 / 3.0 * y[0] - 4.0 / 3.0 * y[0] * y[1],
                            y[0] * y[1] - y[1]])

    problem2 = (
        dt.OdeBuilder()
        .rhs(rhs)
        .init(lambda t, p: torch.stack([p[0], p[0]]))
        .p([1.0])
        .rtol(1e-6)
        .atol(1e-8)
        .build()
    )
    sol2 = dt.solve(dt.ErkSolver(problem2), 40.0, device=dev)  # explicit variant
    n2 = sol2.n_points
    final2 = sol2.ys[n2 - 1].tolist()
    print(f"closure build (tsit45): {n2} steps, final = {np.asarray(final2)}")

    # --- phase plane: ensemble over initial conditions (reference loops) ---
    y0s = torch.tensor(np.linspace(0.4, 1.6, 8)[:, None], dtype=torch.float64)
    t_eval = np.linspace(0.0, 12.0, 60)
    ens = dt.solve_dense_ensemble(dt.BdfSolver, problem2, t_eval, y0s, mode="lockstep",
                                  device=dev)
    prey = ens.ys[..., 0]  # ys: (neval, B, 2)
    prey_min, prey_max = float(prey.min()), float(prey.max())
    print(f"phase-plane ensemble: {y0s.shape[0]} orbits, "
          f"prey range [{prey_min:.3f}, {prey_max:.3f}]")
    # orbits are closed: each member returns near its starting point
    assert ens.stop_reason >= 0
    return {"diffsl_steps": n, "diffsl_final": final, "closure_steps": n2,
            "closure_final": final2, "orbits": y0s.shape[0], "prey_min": prey_min,
            "prey_max": prey_max}


if __name__ == "__main__":
    main(cli_device())
