"""The JAX package's examples (``examples/*.py``), ported one module an
example, with the same file names (``robertson_ensemble`` is the JAX
``robertson_ensemble_tpu``).  Each has a ``main(device=None, ...)`` that
runs on the card unless it is given ``device="cpu"``, takes the JAX
example's sizes and iteration counts as its defaults, makes the JAX
example's assertions and returns a dict of the numbers it prints:

    python -m diffsol_tpu_torch.examples.bouncing_ball
    python -m diffsol_tpu_torch.examples.bouncing_ball --cpu

``battery_spm`` is not ported: it needs the pybamm model files, which
the repository does not hold.
"""

from __future__ import annotations

import sys
import time

import torch

NAMES = (
    "robertson_ensemble", "heat1d_band_ensemble", "pde_heat",
    "electrical_circuit", "custom_ode_equations", "bouncing_ball",
    "spring_mass", "sir_policy_switching", "lorenz_attractor",
    "population_dynamics", "drug_delivery", "solver_comparison",
    "solver_events_performance", "lid_driven_cavity_stokes",
    "predator_prey_fitting", "mass_spring_fitting_adjoint", "neural_ode",
    "diffsl_logistic_fit", "mass_spring_fitting_ensemble",
)


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queue (a no-op on the CPU), before a clock read."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev: torch.device):
    """(fn(), its wall time in seconds), the card's queue drained on both
    sides."""
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t0


def cli_device():
    """``--cpu`` on the command line runs an example on the CPU; else the
    card."""
    return "cpu" if "--cpu" in sys.argv[1:] else None


def cli_int(default: int) -> int:
    """The first integer on the command line, else ``default``."""
    for a in sys.argv[1:]:
        if a.lstrip("-").isdigit():
            return int(a)
    return default
