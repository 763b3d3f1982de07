"""Fit Lotka-Volterra parameters with forward sensitivities (Gauss-Newton)
(counterpart of the JAX package's ``examples/predator_prey_fitting.py``).

Equivalent of reference examples/predator-prey-fitting-forward (argmin
with forward sensitivities): here ``solve_dense_fwd_sens`` (forward mode
through the solver) supplies the residual Jacobian for a Gauss-Newton
loop.

Run: python -m diffsol_tpu_torch.examples.predator_prey_fitting [--cpu]
"""

import numpy as np
import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device

F64 = torch.float64
ITERATIONS = 8


def rhs(t, y, p):
    a, b, c, d = p[0], p[1], p[2], p[3]
    return torch.stack([a * y[0] - b * y[0] * y[1], c * y[0] * y[1] - d * y[1]])


def init(t, p):
    return torch.tensor([1.0, 0.5], dtype=F64, device=p.device)


def make(p):
    return dt.OdeBuilder().rhs(rhs).init(init).p(p).rtol(1e-8).atol(1e-10).build()


def main(device=None, iterations: int = ITERATIONS):
    dev = resolve_device(device, "predator_prey_fitting")
    t_eval = np.linspace(0.0, 12.0, 30)
    true_p = [1.1, 0.9, 0.8, 1.05]
    data = dt.solve_dense(dt.BdfSolver(make(true_p)), t_eval, device=dev).ys

    p = torch.ones(4, dtype=F64, device=dev)
    solver = dt.BdfSolver(make(p.tolist()))
    residuals = []
    for it in range(iterations):
        ys, sens = dt.solve_dense_fwd_sens(solver, t_eval, params=p, device=dev)
        r = (ys - data).reshape(-1)
        J = sens.movedim(0, -1).reshape(-1, 4)  # (neval*n, nparams)
        # Gauss-Newton with Levenberg damping
        jtj = J.T @ J + 1e-8 * torch.eye(4, dtype=F64, device=dev)
        step = torch.linalg.solve(jtj, J.T @ r)
        p = p - step
        residuals.append(float(torch.linalg.norm(r)))
        print(f"iter {it} |r| {residuals[-1]:.3e} p {p.cpu().numpy()}")
    err = float((p - torch.tensor(true_p, dtype=F64, device=dev)).abs().max())
    if iterations == ITERATIONS:
        assert err < 1e-5, err
    print(f"recovered p = {p.cpu().numpy()}")
    # the residual at the recovered p: one plain solve
    final = dt.solve_dense(solver, t_eval, params=p, device=dev).ys
    residuals.append(float(torch.linalg.norm(final - data)))
    print(f"final |r| {residuals[-1]:.3e}")
    # residuals: one an iteration, then that of the recovered parameters
    return {"residuals": residuals, "p": p.tolist(), "max_err": err}


if __name__ == "__main__":
    main(cli_device())
