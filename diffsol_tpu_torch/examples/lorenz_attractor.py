"""Lorenz attractor from DiffSL text (counterpart of the JAX package's
``examples/lorenz_attractor.py``).

Equivalent of reference examples/lorenz-attractor-diffsl-llvm
(src/lorenz.rs): the classic chaotic system built from the same DSL text,
solved with adaptive BDF.  Here the DSL evaluates through PyTorch.  The
system is chaotic: runs on the card, on the CPU and in the JAX package
part ways after a few Lyapunov times, so only the attractor's own
properties are checked.

Run: python -m diffsol_tpu_torch.examples.lorenz_attractor [--cpu]
"""

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device

LORENZ = """
    a { 14.0 } b { 10.0 } c { 8.0 / 3.0 }
    u_i {
        x = 1.0,
        y = 0.0,
        z = 0.0,
    }
    F_i {
        b * (y - x);
        x * (a - z) - y;
        x * y - c * z;
    }
"""


def main(device=None):
    dev = resolve_device(device, "lorenz_attractor")
    problem = dt.OdeBuilder().rtol(1e-8).atol(1e-10).build_from_diffsl(LORENZ)
    solver = dt.BdfSolver(problem)
    sol = dt.solve(solver, 20.0, device=dev)
    n = sol.n_points
    assert sol.stop_reason >= 0
    ys = sol.ys[:n]
    x_min, x_max = float(ys[:, 0].min()), float(ys[:, 0].max())
    z_min, z_max = float(ys[:, 2].min()), float(ys[:, 2].max())
    # the trajectory should visit both wings of the attractor (x changes
    # sign) and stay bounded
    assert x_min < -1.0 < 1.0 < x_max
    assert float(ys.abs().max()) < 60.0
    print(f"lorenz: {n} points to t=20, x range [{x_min:.2f}, {x_max:.2f}], "
          f"z range [{z_min:.2f}, {z_max:.2f}]")
    return {"n_points": n, "x_min": x_min, "x_max": x_max, "z_min": z_min,
            "z_max": z_max}


if __name__ == "__main__":
    main(cli_device())
