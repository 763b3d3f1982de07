"""Time steppers (counterparts of ``diffsol_tpu.solvers``)."""

from .bdf import BdfSolver  # noqa: F401
