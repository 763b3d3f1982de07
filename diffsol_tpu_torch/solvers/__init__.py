"""Time steppers (counterparts of ``diffsol_tpu.solvers``)."""

from . import sde  # noqa: F401
from .bdf import BdfSolver  # noqa: F401
from .erk import ErkSolver  # noqa: F401
from .sdirk import SdirkSolver  # noqa: F401
from .tableau import Tableau, esdirk34, tr_bdf2, tsit45  # noqa: F401
