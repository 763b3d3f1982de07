"""Epidemic SIR model with policy switching at an infection threshold
(counterpart of the JAX package's ``examples/sir_policy_switching.py``).

Equivalent of reference examples/epidemic-sir-policy-switching: integrate
an SIR model; when infections cross a threshold, an event fires and the
reset operator toggles a lockdown flag carried as an extra state,
changing the transmission rate.

Run: python -m diffsol_tpu_torch.examples.sir_policy_switching [--cpu]
"""

import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device


def main(device=None):
    dev = resolve_device(device, "sir_policy_switching")
    beta_hi, beta_lo, gamma = 0.5, 0.05, 0.1
    thresh_on, thresh_off = 0.15, 0.05  # hysteresis avoids chattering

    def rhs(t, y, p):
        s, i, lockdown = y[0], y[1], y[3]
        beta = torch.where(lockdown > 0.5, p[1], p[0])
        ds = -beta * s * i
        di = beta * s * i - p[2] * i
        return torch.stack([ds, di, p[2] * i, torch.zeros_like(s)])

    def root(t, y, p):
        # lockdown OFF: fire when i rises to thresh_on;
        # lockdown ON: fire when i falls to thresh_off
        return torch.where(y[3] > 0.5, y[1] - p[4], y[1] - p[3]).reshape(1)

    def reset(t, y, p):
        y = y.clone()
        y[3] = 1.0 - y[3]  # toggle policy
        return y

    problem = (
        dt.OdeBuilder()
        .rhs(rhs)
        .init(lambda t, p: torch.tensor([0.99, 0.01, 0.0, 0.0], dtype=torch.float64,
                                        device=p.device))
        .root(root)
        .reset(reset)
        .p([beta_hi, beta_lo, gamma, thresh_on, thresh_off])
        .rtol(1e-8)
        .atol(1e-10)
        .build()
    )
    solver = dt.BdfSolver(problem)
    sol = dt.solve(solver, 120.0, device=dev)
    n = sol.n_points
    ys = sol.ys[:n]
    peak = float(ys[:, 1].max())
    switches = int((ys[:, 3].diff().abs() > 0.5).sum())
    recovered = float(ys[-1, 2])
    print(f"peak infections {peak:.4f} (on-threshold {thresh_on}), "
          f"{switches} policy switches, final recovered {recovered:.4f}")
    assert peak < 0.2, "lockdown policy failed to cap the peak"
    assert switches >= 2
    return {"peak": peak, "switches": switches, "recovered": recovered, "n_points": n}


if __name__ == "__main__":
    main(cli_device())
