"""Status codes and error taxonomy (counterpart of ``diffsol_tpu.errors``).

Solvers carry an integer status; drivers stop on a negative one and the
Python API raises the matching :class:`DiffsolError`.  The codes are the
JAX package's, so a status read from either package means the same thing.
"""

from __future__ import annotations

# Stop reasons (>= 0), as the reference's OdeSolverStopReason.
INTERNAL_TIMESTEP = 0
ROOT_FOUND = 1
TSTOP_REACHED = 2

# Error codes (< 0), as the reference's OdeSolverError variants.
STEP_SIZE_TOO_SMALL = -1
TOO_MANY_ERROR_TEST_FAILURES = -2
TOO_MANY_NONLINEAR_SOLVER_FAILURES = -3
SENSITIVITY_SOLVE_FAILED = -4
INITIAL_CONDITION_DID_NOT_CONVERGE = -5
STOP_TIME_BEFORE_CURRENT_TIME = -6
MAX_STEPS_REACHED = -7
EVENT_CAPACITY_EXCEEDED = -8
ROOT_BATCH_INCONSISTENT = -9

_MESSAGES = {
    STEP_SIZE_TOO_SMALL: "step size became too small",
    TOO_MANY_ERROR_TEST_FAILURES: "too many error test failures",
    TOO_MANY_NONLINEAR_SOLVER_FAILURES: "too many nonlinear solver failures",
    SENSITIVITY_SOLVE_FAILED: "sensitivity solve failed",
    INITIAL_CONDITION_DID_NOT_CONVERGE: "initial condition solve did not converge",
    STOP_TIME_BEFORE_CURRENT_TIME: "stop time is before current time",
    MAX_STEPS_REACHED: "maximum number of steps reached",
    EVENT_CAPACITY_EXCEEDED: "reset-event record overflowed",
    ROOT_BATCH_INCONSISTENT: "lockstep members disagree on a root crossing",
}


class DiffsolError(RuntimeError):
    """Raised at the Python API boundary when a solve fails."""

    def __init__(self, code: int, t: float | None = None,
                 member: int | None = None):
        self.code = code
        self.t = t
        self.member = member
        msg = _MESSAGES.get(code, f"solver error code {code}")
        where = [] if member is None else [f"member {member}"]
        if t is not None:
            where.append(f"at t = {t}")
        if where:
            msg = f"{msg} ({', '.join(where)})"
        super().__init__(msg)


def check_status(code: int, t: float | None = None, member: int | None = None) -> None:
    """Raise :class:`DiffsolError` if ``code`` (a concrete int) is an
    error; ``member`` names the ensemble member that failed."""
    if code < 0:
        raise DiffsolError(int(code), t, member)
