"""Bouncing ball: event root-finding + state reset (counterpart of the JAX
package's ``examples/bouncing_ball.py``).

Equivalent of reference examples/bouncing-ball: a ball under gravity with
a root function at ground contact (y = 0) and a reset that reverses the
velocity with a restitution coefficient.  The solve auto-continues through
each bounce (reference root/reset protocol, lib.rs:194-213).

Run: python -m diffsol_tpu_torch.examples.bouncing_ball [--cpu]
"""

import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device


def main(device=None):
    dev = resolve_device(device, "bouncing_ball")
    g, e = 9.81, 0.8  # gravity, restitution

    problem = (
        dt.OdeBuilder()
        .rhs(lambda t, y, p: torch.stack([y[1], -p[0]]))
        .init(lambda t, p: torch.tensor([10.0, 0.0], dtype=torch.float64,
                                        device=p.device))  # height 10, at rest
        .root(lambda t, y, p: y[0:1])  # ground contact
        .reset(lambda t, y, p: torch.stack([torch.full_like(y[0], 1e-9),
                                            -p[1] * y[1]]))  # bounce
        .p([g, e])
        .rtol(1e-8)
        .atol(1e-10)
        .build()
    )
    solver = dt.ErkSolver(problem)
    sol = dt.solve(solver, 8.0, device=dev)
    n = sol.n_points
    ts, ys = sol.ts[:n], sol.ys[:n]
    bounces = int(((ys[1:, 1] > 0) & (ys[:-1, 1] < 0)).sum())
    print(f"integrated to t={float(ts[-1]):.3f} with {n} points, "
          f"{bounces} bounces, final height {float(ys[-1, 0]):.4f}")
    # first bounce at t = sqrt(2 h0 / g)
    t1 = (2 * 10.0 / g) ** 0.5
    assert float(ys[:, 0].min()) > -1e-6, "ball went through the floor"
    print(f"first impact expected at t={t1:.4f}")
    return {"t_final": float(ts[-1]), "n_points": n, "bounces": bounces,
            "final_height": float(ys[-1, 0]), "first_impact": t1}


if __name__ == "__main__":
    main(cli_device())
