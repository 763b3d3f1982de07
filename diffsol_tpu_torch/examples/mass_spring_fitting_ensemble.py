"""Fit a 1000-member mass-spring parameter ensemble with Adam (counterpart
of the JAX package's ``examples/mass_spring_fitting_ensemble.py``).

The gradient goes THROUGH a lockstep ensemble solve: one batched adjoint
backward pass produces per-member gradients (B, nparams), so 1000
independent (k, c) fits advance in every Adam step.  The reference cannot
do this: its adjoint is single-context (reference crates/diffsol/src/
ode_solver/adjoint.rs:13-159; the nbatch context batches forward solves
only), and each fit would be a separate argmin run
(examples/mass-spring-fitting-adjoint).  Each iteration is one eager
forward and one eager backward lockstep solve, seconds on the card.

Run: python -m diffsol_tpu_torch.examples.mass_spring_fitting_ensemble [--cpu]
"""

import numpy as np
import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device

F64 = torch.float64
ITERATIONS = 120


def rhs(t, y, p):
    k, c = p[0], p[1]
    return torch.stack([y[1], -k * y[0] - c * y[1]])


def init(t, p):
    return torch.tensor([1.0, 0.0], dtype=F64, device=p.device)


def main(device=None, nbatch: int = 1000, iterations: int = ITERATIONS):
    dev = resolve_device(device, "mass_spring_fitting_ensemble")
    B = nbatch
    problem = (
        dt.OdeBuilder()
        .rhs(rhs)
        .init(init)
        .p([2.0, 0.4])
        .rtol(1e-6)
        .atol(1e-8)
        .build()
    )
    t_eval = torch.linspace(0.5, 8.0, 16, dtype=F64)
    ys_of = dt.make_differentiable_solve_ensemble(problem, t_eval, B, max_steps=2048,
                                                  device=dev)

    # per-member ground truth: k in [2.5, 3.5], c in [0.15, 0.35]
    rng = np.random.default_rng(0)
    true_p = torch.tensor(np.stack([rng.uniform(2.5, 3.5, B), rng.uniform(0.15, 0.35, B)],
                                   axis=1), dtype=F64, device=dev)
    with torch.no_grad():
        data = ys_of(true_p)  # (neval, B, 2)

    def loss(p):
        return ((ys_of(p) - data) ** 2).mean()

    p = torch.tensor([2.0, 0.4], dtype=F64, device=dev).expand(B, 2).clone()
    p.requires_grad_(True)
    opt = torch.optim.Adam([p], lr=5e-2)
    losses, first_grad = [], None
    for it in range(iterations):
        opt.zero_grad()
        value = loss(p)
        value.backward()
        if first_grad is None:
            first_grad = p.grad.detach().clone()
        losses.append(float(value.detach()))
        opt.step()
        if it % 20 == 0:
            err = float((p.detach() - true_p).abs().max())
            print(f"iter {it:3d} loss {losses[-1]:.3e} max|p-p*| {err:.3f}")
    err = float((p.detach() - true_p).abs().max())
    with torch.no_grad():
        final = float(loss(p))
    print(f"final: loss {final:.3e}, max member error {err:.3f}")
    if iterations == ITERATIONS:
        assert err < 0.05, err
    print(f"fitted all {B} members")
    return {"losses": losses + [final], "first_grad": first_grad, "max_err": err}


if __name__ == "__main__":
    main(cli_device())
