"""Solver statistics (counterpart of ``Stats`` in
``diffsol_tpu.solvers.rk_common``; the rest of that module belongs to the
SDIRK/ERK steppers, which are not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Stats:
    """Solver counters (reference `OdeSolverStatistics`,
    ode_solver/mod.rs:28-77).  The five ``lu_from_*`` counters break
    ``linear_solver_setups`` down by cause; ``worst_member`` names the
    lockstep member that dominated the latest error test."""

    steps: int = 0
    error_test_failures: int = 0
    newton_iterations: int = 0
    newton_fails: int = 0
    linear_solver_setups: int = 0
    jacobian_evals: int = 0
    lu_from_checkpoint: int = 0
    lu_from_first_fail: int = 0
    lu_from_second_fail: int = 0
    lu_from_error_test: int = 0
    lu_from_step_success: int = 0
    worst_member: int = 0
    rhs_evals: int = 0
    jac_mul_evals: int = 0
    mass_evals: int = 0
