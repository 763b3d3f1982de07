"""Lid-driven cavity Stokes flow via the ODE solver (method of lines)
(counterpart of the JAX package's ``examples/lid_driven_cavity_stokes.py``).

Equivalent in role to reference examples/lid-driven-cavity-stokes (a FEM
Stokes system time-stepped with TSIT45 over precomputed operator data): a
vorticity-streamfunction formulation on a uniform grid, with the Poisson
solve for the streamfunction folded into the RHS as a precomputed dense
inverse (setup-time numpy, like the reference's presolved L factor), and
Thom's formula driving the lid.  Integrated to steady state with the
explicit solver; the primary-vortex strength converges.

Run: python -m diffsol_tpu_torch.examples.lid_driven_cavity_stokes [--cpu]
"""

import numpy as np
import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device


def laplacian(mi: int, h: float) -> np.ndarray:
    """The interior 5-point Laplacian, dense (mi^2, mi^2)."""
    n = mi * mi
    L = np.zeros((n, n))
    for j in range(mi):
        for i in range(mi):
            k = j * mi + i
            L[k, k] = -4.0
            for dj, di in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                jj, ii = j + dj, i + di
                if 0 <= jj < mi and 0 <= ii < mi:
                    L[k, jj * mi + ii] = 1.0
    return L / (h * h)


def main(device=None, m: int = 17):
    dev = resolve_device(device, "lid_driven_cavity_stokes")
    nu = 0.1
    h = 1.0 / (m - 1)
    mi = m - 2  # grid points per side m; interior (m-2)^2 vorticity states
    n = mi * mi
    # presolved inverse: plays the role of the reference's factored L
    Linv = torch.tensor(np.linalg.inv(laplacian(mi, h)), dtype=torch.float64, device=dev)

    def rhs(t, w, p):
        # psi solves lap(psi) = -w (psi = 0 on all walls)
        psi = (Linv @ (-w)).reshape(mi, mi)
        W = w.reshape(mi, mi)
        # boundary vorticity (Thom): w_wall = -2 psi_1 / h^2 (+ lid term),
        # on each wall's interior points (the stencil reads no corner)
        lid = p[0]
        top = -2.0 * psi[0, :] / h**2
        bottom = -2.0 * psi[-1, :] / h**2 - 2.0 * lid / h
        left = -2.0 * psi[:, 0] / h**2
        right = -2.0 * psi[:, -1] / h**2
        # Stokes: dw/dt = nu * lap(w) (no advection)
        lap = (
            torch.cat([top[None, :], W[:-1]]) + torch.cat([W[1:], bottom[None, :]])
            + torch.cat([left[:, None], W[:, :-1]], 1)
            + torch.cat([W[:, 1:], right[:, None]], 1)
            - 4.0 * W
        ) / h**2
        return (nu * lap).reshape(-1)

    problem = (
        dt.OdeBuilder()
        .rhs(rhs)
        .init(lambda t, p: torch.zeros(n, dtype=torch.float64, device=p.device))
        .p([1.0])  # lid velocity
        .rtol(1e-6)
        .atol(1e-8)
        .build()
    )
    t_eval = [0.5, 1.0, 2.0, 4.0]
    sol = dt.solve_dense(dt.ErkSolver(problem), t_eval, max_steps=20_000, device=dev)
    sol.raise_for_status()
    strengths = [float((Linv @ (-sol.ys[k])).abs().max()) for k in range(len(t_eval))]
    for t, s in zip(t_eval, strengths):
        print(f"t = {t:4.1f}: primary vortex |psi|_max = {s:.5f}")
    # steady state: last two outputs agree
    p3, p4 = strengths[2], strengths[3]
    assert abs(p4 - p3) / p4 < 1e-3, "not converged to steady cavity flow"
    print(f"steady-state Stokes cavity vortex strength: {p4:.5f}")
    return {"n": n, "strengths": strengths}


if __name__ == "__main__":
    main(cli_device())
