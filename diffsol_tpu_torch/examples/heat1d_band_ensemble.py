"""A medium-n method-of-lines ensemble through the fused banded tier
(counterpart of the JAX package's ``examples/heat1d_band_ensemble.py``).

A 1-D heat equation (n = 128 interior points, tridiagonal Jacobian)
solved for 256 diffusivities in one call.  ``mode="auto"`` takes the
fused banded BDF kernel on the card (``csrc/fused_band_bdf.cuh``: the
whole adaptive solve of a member tile in one launch) and its plain
PyTorch version on the CPU.

Reference analog: heat1d MOL class, reference crates/diffsol/src/
ode_solver/test_models/heat1d.rs; the ensemble axis is this framework's
extension.

Run: python -m diffsol_tpu_torch.examples.heat1d_band_ensemble [nbatch] [--cpu]
"""

import numpy as np
import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device, cli_int, timed
from diffsol_tpu_torch.ops.banded import make_banded_solver

N = 128
H = 1.0 / (N + 1)
T_EVAL = [0.001, 0.01, 0.05, 0.1, 0.2]


def rhs(t, y, p):
    d = p[0]
    left = torch.cat([torch.zeros_like(y[:1]), y[:-1]])
    right = torch.cat([y[1:], torch.zeros_like(y[:1])])
    return d * (left - 2.0 * y + right) / (H * H)


def init(t, p):
    x = (torch.arange(N, dtype=torch.float64, device=p.device) + 1.0) * H
    return torch.where(x < 0.5, 2.0 * x, 2.0 * (1.0 - x))


def make_problem():
    return (
        dt.OdeBuilder()
        .rhs(rhs)
        .init(init)
        .p([1.0])
        .rtol(1e-6)
        .atol(1e-8)
        .linear_solver(make_banded_solver(1, 1))  # tridiagonal: ml = mu = 1
        .build()
    )


def analytic(t_eval, d: float) -> np.ndarray:
    """The Fourier sine series of the triangle wave, (len(t_eval), N)."""
    x = (np.arange(N) + 1.0) * H
    t64 = np.asarray(t_eval, np.float64)
    u = np.zeros((len(t64), N))
    for k in range(1, 200):
        m = 2 * k - 1
        # sin(m*pi/2) = (-1)^(k-1): the triangle wave's odd harmonics alternate
        u += ((-1.0) ** (k - 1) * np.sin(m * np.pi * x)[None, :]
              * np.exp(-(m * np.pi) ** 2 * d * t64)[:, None] / m**2)
    return u * 8.0 / np.pi**2


def main(device=None, nbatch: int = 256):
    dev = resolve_device(device, "heat1d_band_ensemble")
    problem = make_problem()
    diffusivities = np.linspace(0.5, 2.0, nbatch)
    params = torch.tensor(diffusivities[:, None], dtype=torch.float64, device=dev)
    sol, seconds = timed(lambda: dt.solve_dense_ensemble(
        dt.BdfSolver, problem, T_EVAL, params, mode="auto", device=dev), dev)
    if dev.type == "cuda":
        assert sol.tier == "fused_band", sol.tier
    ys = sol.ys.cpu().numpy()  # (neval, B, n)
    assert np.all(np.isfinite(ys))

    # the d=1.0 member must track the analytic Fourier sine series
    member = int(np.argmin(np.abs(diffusivities - 1.0)))
    err = float(np.max(np.abs(ys[:, member, :] - analytic(T_EVAL, diffusivities[member]))))
    print(f"device={dev} tier={sol.tier} B={nbatch} n={N} ({seconds:.3f} s)")
    print(f"member d={diffusivities[member]:.3f}: max|err| vs analytic = {err:.2e}")
    assert err < 1e-4, err

    # faster diffusion decays the midpoint temperature faster, monotonically
    mid = ys[-1, :, N // 2]
    assert np.all(np.diff(mid) < 0), "midpoint decay not monotone in d"
    print(f"u(x=0.5, t=0.2): d=0.5 -> {mid[0]:.4f}, d=2.0 -> {mid[-1]:.4f}")
    print("ok")
    return {"nbatch": nbatch, "tier": sol.tier, "seconds": seconds, "member_d":
            float(diffusivities[member]), "analytic_err": err, "mid_first": float(mid[0]),
            "mid_last": float(mid[-1]), "ys": sol.ys, "tile_steps": sol.tile_steps}


if __name__ == "__main__":
    main(cli_device(), cli_int(256))
