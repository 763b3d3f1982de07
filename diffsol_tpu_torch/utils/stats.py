"""Solver statistics as plain data (counterpart of
``diffsol_tpu.utils.stats``; reference ode_solver/mod.rs:28-77, which
serializes `OdeSolverStatistics` as JSON).

The counters ride the solver state as Python ints
(:class:`~diffsol_tpu_torch.solvers.rk_common.Stats`), in the JAX
package's key order:

  steps                  <- number_of_steps
  error_test_failures    <- number_of_error_test_failures
  newton_iterations      <- number_of_nonlinear_solver_iterations
  newton_fails           <- number_of_nonlinear_solver_fails
  linear_solver_setups   <- number_of_linear_solver_setups (all causes)
  jacobian_evals         <- number_of_jac_evals
  lu_from_*              <- the LU setups by cause (mod.rs:53-70)
  worst_member           <- the lockstep member that dominated the latest
                            error test
  rhs_evals, jac_mul_evals, mass_evals <- the op-call counters
"""

from __future__ import annotations

import dataclasses
import json


def stats_dict(state_or_solution) -> dict:
    """The statistics counters of a solver state (its ``.stats``) or of a
    :class:`~diffsol_tpu_torch.drivers.Solution` (``.state.stats``), as a
    dict of ints."""
    obj = state_or_solution
    if hasattr(obj, "state"):
        obj = obj.state
    return {k: int(v) for k, v in dataclasses.asdict(obj.stats).items()}


def stats_json(state_or_solution) -> str:
    """:func:`stats_dict` as a JSON string."""
    return json.dumps(stats_dict(state_or_solution))
