"""DiffSL end-to-end: specify a model as DSL text, solve it, and fit its
parameters by the adjoint (counterpart of the JAX package's
``examples/diffsl_logistic_fit.py``).

The reference needs LLVM + Enzyme for this workflow
(reference examples/intro-logistic-diffsl/src/main.rs + build_from_diffsl,
diffsl.rs:239-330); here the DSL evaluates through PyTorch, the gradient
comes from ``make_differentiable_solve``'s adjoint and ``torch.optim.Adam``
takes the JAX example's ``optax.adam(0.1)`` steps (bias-corrected moments,
eps outside the square root).

Run: python -m diffsol_tpu_torch.examples.diffsl_logistic_fit [--cpu]
"""

import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device

F64 = torch.float64
ITERATIONS = 200

CODE = """
in_i { r = 0.5, k = 5.0 }
u { 0.1 }
F { r * u * (1.0 - u / k) }
"""


def main(device=None, iterations: int = ITERATIONS):
    dev = resolve_device(device, "diffsl_logistic_fit")
    problem = dt.OdeBuilder().rtol(1e-8).atol(1e-10).build_from_diffsl(CODE)
    t_eval = torch.linspace(0.0, 8.0, 15, dtype=F64)

    # synthetic data from the "true" parameters
    true_p = torch.tensor([1.0, 10.0], dtype=F64, device=dev)
    ys_of = dt.make_differentiable_solve(problem, t_eval, device=dev)
    with torch.no_grad():
        data = ys_of(true_p)

    def loss(p):
        return ((ys_of(p) - data) ** 2).sum()

    # DiffSL in_i defaults: [0.5, 5.0]
    p = problem.params.clone().to(dev).requires_grad_(True)
    opt = torch.optim.Adam([p], lr=0.1)
    losses, first_grad = [], None
    for _ in range(iterations):
        opt.zero_grad()
        value = loss(p)
        value.backward()
        if first_grad is None:
            first_grad = p.grad.tolist()
        losses.append(float(value.detach()))
        opt.step()
    with torch.no_grad():
        final = float(loss(p))
    print(f"fitted p = {p.detach().cpu().numpy()} (true {true_p.cpu().numpy()}), "
          f"loss = {final:.3e}")
    if iterations == ITERATIONS:
        assert final < 1e-4
    print("OK")
    return {"losses": losses + [final], "first_grad": first_grad, "p": p.tolist()}


if __name__ == "__main__":
    main(cli_device())
