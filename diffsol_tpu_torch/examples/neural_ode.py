"""Neural ODE trained with adjoint gradients through the BDF solver
(counterpart of the JAX package's ``examples/neural_ode.py``).

Equivalent of reference examples/neural-ode-weather-prediction (ONNX MLP
+ adjoint training): a small MLP vector field whose flattened weights ARE
the ODE parameters; ``loss.backward()`` through the solver (the adjoint's
``torch.autograd.Function``) trains it to reproduce a spiral trajectory,
with the JAX example's own hand-written Adam, so that both take the same
steps.

Run: python -m diffsol_tpu_torch.examples.neural_ode [--cpu]
"""

import numpy as np
import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device

F64 = torch.float64
HIDDEN = 16
ITERATIONS = 150


def unpack(p):
    i = 0
    w1 = p[i : i + 2 * HIDDEN].reshape(2, HIDDEN); i += 2 * HIDDEN
    b1 = p[i : i + HIDDEN]; i += HIDDEN
    w2 = p[i : i + HIDDEN * 2].reshape(HIDDEN, 2); i += HIDDEN * 2
    b2 = p[i : i + 2]
    return w1, b1, w2, b2


N_PARAMS = 2 * HIDDEN + HIDDEN + HIDDEN * 2 + 2


def vector_field(t, y, p):
    w1, b1, w2, b2 = unpack(p)
    h = torch.tanh(y @ w1 + b1)
    return h @ w2 + b2


def main(device=None, iterations: int = ITERATIONS):
    dev = resolve_device(device, "neural_ode")
    rng = np.random.default_rng(0)
    p0 = rng.normal(scale=0.1, size=(N_PARAMS,))

    problem = (
        dt.OdeBuilder()
        .rhs(vector_field)
        .init(lambda t, p: torch.tensor([1.0, 0.0], dtype=F64, device=p.device))
        .p(p0.tolist())
        .rtol(1e-6)
        .atol(1e-8)
        .build()
    )
    t_eval = torch.linspace(0.0, 2.0, 16, dtype=F64)
    ys_of = dt.make_differentiable_solve(problem, t_eval, max_steps=4096, device=dev)

    # target: a decaying spiral, expm(A t) y0 at every output time
    a_true = torch.tensor([[-0.1, 2.0], [-2.0, -0.1]], dtype=F64)
    target = (torch.linalg.matrix_exp(a_true * t_eval[:, None, None])
              @ torch.tensor([1.0, 0.0], dtype=F64)).to(dev)

    p = torch.tensor(p0, dtype=F64, device=dev)
    # simple Adam
    m = torch.zeros_like(p); v = torch.zeros_like(p)
    lr, b1m, b2m, eps = 0.05, 0.9, 0.999, 1e-8
    losses, first_grad = [], None
    for it in range(iterations):
        p.requires_grad_(True)
        loss = ((ys_of(p) - target) ** 2).mean()
        loss.backward()
        g = p.grad
        p = p.detach()
        if first_grad is None:
            first_grad = g.tolist()
        losses.append(float(loss.detach()))
        m = b1m * m + (1 - b1m) * g
        v = b2m * v + (1 - b2m) * g * g
        mh = m / (1 - b1m ** (it + 1))
        vh = v / (1 - b2m ** (it + 1))
        p = p - lr * mh / (torch.sqrt(vh) + eps)
        if it % 30 == 0:
            print(f"iter {it:3d} loss {losses[-1]:.4e}")
    print(f"loss: {losses[0]:.3e} -> {losses[-1]:.3e}")
    if iterations == ITERATIONS:
        assert losses[-1] < 0.02 * losses[0], "neural ODE failed to train"
    with torch.no_grad():
        losses.append(float(((ys_of(p) - target) ** 2).mean()))
    # losses: one an iteration, then that of the trained parameters
    return {"losses": losses, "first_grad": first_grad}


if __name__ == "__main__":
    main(cli_device())
