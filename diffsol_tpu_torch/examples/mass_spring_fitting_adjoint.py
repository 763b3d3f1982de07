"""Fit a damped mass-spring system to data with adjoint gradients
(counterpart of the JAX package's ``examples/mass_spring_fitting_adjoint.py``).

Equivalent of reference examples/mass-spring-fitting-adjoint (argmin +
adjoint sensitivities): the fit is plain gradient descent on
``loss.backward()`` through the adjoint backward pass of
``make_differentiable_solve``.

Run: python -m diffsol_tpu_torch.examples.mass_spring_fitting_adjoint [--cpu]
"""

import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device

F64 = torch.float64
ITERATIONS = 60


def rhs(t, y, p):
    k, c = p[0], p[1]
    return torch.stack([y[1], -k * y[0] - c * y[1]])


def init(t, p):
    return torch.tensor([1.0, 0.0], dtype=F64, device=p.device)


def main(device=None, iterations: int = ITERATIONS):
    dev = resolve_device(device, "mass_spring_fitting_adjoint")
    problem = (
        dt.OdeBuilder().rhs(rhs).init(init).p([2.0, 0.4]).rtol(1e-8).atol(1e-10).build()
    )
    t_eval = torch.linspace(0.0, 10.0, 40, dtype=F64)
    ys_of = dt.make_differentiable_solve(problem, t_eval, device=dev)

    # synthetic data from the true parameters
    true_p = torch.tensor([3.0, 0.25], dtype=F64, device=dev)
    with torch.no_grad():
        data = ys_of(true_p)

    p = torch.tensor([2.0, 0.4], dtype=F64, device=dev)
    lr = 0.5
    losses, first_grad = [], None
    for it in range(iterations):
        p.requires_grad_(True)
        loss = ((ys_of(p) - data) ** 2).mean()
        loss.backward()
        g = p.grad
        if first_grad is None:
            first_grad = g.tolist()
        losses.append(float(loss.detach()))
        p = (p - lr * g).detach()
        if it % 15 == 0:
            print(f"iter {it:3d} loss {losses[-1]:.3e} p {p.cpu().numpy()}")
    with torch.no_grad():
        losses.append(float(((ys_of(p) - data) ** 2).mean()))
    err = float((p - true_p).abs().max())
    print(f"fitted p = {p.cpu().numpy()}, true p = {true_p.cpu().numpy()}")
    if iterations == ITERATIONS:
        assert err < 0.02, err
    # losses: one an iteration, then that of the fitted parameters
    return {"losses": losses, "first_grad": first_grad, "p": p.tolist(), "max_err": err}


if __name__ == "__main__":
    main(cli_device())
