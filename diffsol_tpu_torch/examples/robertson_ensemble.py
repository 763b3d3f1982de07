"""Flagship workload: a 10,000-member stiff Robertson parameter sweep
(counterpart of the JAX package's ``examples/robertson_ensemble_tpu.py``).

One BDF solve of every member at once.  ``mode="auto"`` takes the fused
small-n kernel on the card (``csrc/fused_bdf.cuh``: the whole adaptive
solve of a member tile in one launch) and its plain PyTorch version on
the CPU.  The first call builds the kernel with nvcc (once a model; the
library is kept under ``build/diffsol_tpu_torch/``), so it is timed apart
from the steady state.

Run: python -m diffsol_tpu_torch.examples.robertson_ensemble [nbatch] [--cpu]
"""

import numpy as np
import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device, cli_int, timed
from diffsol_tpu_torch.models import robertson

T_EVAL = [0.4, 4.0, 400.0, 4.0e4, 4.0e5]


def make_params(nbatch: int) -> torch.Tensor:
    """k1 = 0.04 (1 + 0.1 linspace(-1, 1)), k2 = 1e4, k3 = 3e7; (B, 3)."""
    k1 = 0.04 * (1.0 + 0.1 * np.linspace(-1.0, 1.0, nbatch))
    return torch.tensor(np.stack([k1, np.full(nbatch, 1.0e4), np.full(nbatch, 3.0e7)],
                                 axis=1), dtype=torch.float64)


def main(device=None, nbatch: int = 10_000):
    dev = resolve_device(device, "robertson_ensemble")
    problem = robertson.problem_ode()
    params = make_params(nbatch).to(dev)

    def run():
        return dt.solve_dense_ensemble(dt.BdfSolver, problem, T_EVAL, params,
                                       mode="auto", max_steps=5000, device=dev)

    sol, first = timed(run, dev)
    sol, steady = timed(run, dev)
    if dev.type == "cuda":
        assert sol.tier == "fused_small", sol.tier
    assert sol.stop_reason == dt.errors.TSTOP_REACHED, sol.stop_reason
    assert bool(torch.isfinite(sol.ys).all())
    cons = float((sol.ys.sum(-1) - 1.0).abs().max())
    print(f"device: {dev}, tier {sol.tier}")
    print(f"{nbatch} members x {len(T_EVAL)} outputs: first call {first:.2f}s, "
          f"steady state {steady:.3f}s ({steady / nbatch * 1e6:.1f} us/instance)")
    print(f"max conservation error across ensemble: {cons:.2e}")
    return {"nbatch": nbatch, "tier": sol.tier, "first_call_s": first, "steady_s": steady,
            "us_per_instance": steady / nbatch * 1e6, "conservation_error": cons,
            "ys": sol.ys, "tile_steps": sol.tile_steps}


if __name__ == "__main__":
    main(cli_device(), cli_int(10_000))
