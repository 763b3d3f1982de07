"""Solver factory by method name (counterpart of ``diffsol_tpu.factory``;
reference crates/diffsol-c/src/ode_solver_type.rs `OdeSolverType`
{Bdf, Esdirk34, TrBdf2, Tsit45} and its dispatch)."""

from __future__ import annotations

from .problem import OdeProblem
from .solvers.bdf import BdfSolver
from .solvers.erk import ErkSolver
from .solvers.sdirk import SdirkSolver
from .solvers.tableau import esdirk34, tr_bdf2, tsit45

METHODS = ("bdf", "tr_bdf2", "esdirk34", "tsit45")


def solver(problem: OdeProblem, method: str = "bdf", **kwargs):
    """A solver by method name: ``bdf`` the variable-order NDF/BDF,
    ``tr_bdf2`` and ``esdirk34`` SDIRK, ``tsit45`` explicit RK.  Extra
    keyword arguments go to the solver class (``config=...``,
    ``sens=True``, ``augmented=...``)."""
    m = method.lower()
    if m == "bdf":
        return BdfSolver(problem, **kwargs)
    if m == "tr_bdf2":
        return SdirkSolver(problem, tableau=tr_bdf2(), **kwargs)
    if m == "esdirk34":
        return SdirkSolver(problem, tableau=esdirk34(), **kwargs)
    if m == "tsit45":
        return ErkSolver(problem, tableau=tsit45(), **kwargs)
    raise ValueError(f"unknown method {method!r}; available: {METHODS}")
