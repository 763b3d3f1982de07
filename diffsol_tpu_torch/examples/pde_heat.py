"""1D heat equation by the method of lines on the banded linear-solver
tier (counterpart of the JAX package's ``examples/pde_heat.py``).

Equivalent of reference examples/pde-heat: the tridiagonal MOL Jacobian
comes from a 3-probe cyclic coloring and Newton's matrix is factored by
the band LU, on the card the band LU kernels (``csrc/band_lu.cuh``).

Run: python -m diffsol_tpu_torch.examples.pde_heat [--cpu]
"""

import dataclasses

import numpy as np

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device
from diffsol_tpu_torch.models import heat1d
from diffsol_tpu_torch.ops import band_lu
from diffsol_tpu_torch.ops.banded import make_banded_jac, make_banded_solver


def make_problem(mgrid: int = 50):
    """(problem, soln): heat1d with the colored band Jacobian and the band
    LU (ml = mu = 1)."""
    problem, soln = heat1d.make(mgrid=mgrid)
    eqn = dataclasses.replace(
        problem.eqn, rhs_jac=make_banded_jac(problem.eqn.rhs, 1, 1)
    )
    problem = dataclasses.replace(
        problem, eqn=eqn, linear_solver=make_banded_solver(1, 1)
    )
    return problem, soln


def main(device=None, mgrid: int = 50):
    dev = resolve_device(device, "pde_heat")
    problem, soln = make_problem(mgrid)
    solver = dt.BdfSolver(problem)
    t_eval = [0.5, 0.52, 0.54]
    factor0 = band_lu.launch_band_lu_factor.launches
    solve0 = band_lu.launch_band_lu_solve.launches
    sol = dt.solve_dense(solver, t_eval, device=dev)
    factors = band_lu.launch_band_lu_factor.launches - factor0
    solves = band_lu.launch_band_lu_solve.launches - solve0
    if dev.type == "cuda":
        # the band LU kernels count their launches on the card only
        assert factors > 0 and solves > 0, (factors, solves)
    expected = soln(np.asarray(t_eval))
    err = float(np.max(np.abs(sol.ys.cpu().numpy() - expected)))
    steps = int(sol.state.stats.steps)
    print(f"{mgrid + 1}-point MOL heat solve on the banded tier: "
          f"{steps} steps, max error {err:.2e}")
    assert err < 1e-4
    return {"n": mgrid + 1, "steps": steps, "max_error": err,
            "band_lu_factor_launches": factors, "band_lu_solve_launches": solves}


if __name__ == "__main__":
    main(cli_device())
