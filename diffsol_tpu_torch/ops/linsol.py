"""Linear-solver tiers (counterpart of ``diffsol_tpu.ops.linsol``).

* ``dense`` factors the iteration matrix ``A = M - c*J`` with
  ``torch.linalg.lu_factor`` and solves with ``torch.linalg.lu_solve``;
  both run in the problem's dtype (float64, or float32) on the CPU and on
  CUDA and take a member-major (B, n, n) stack as readily as one (n, n)
  matrix.  A right-hand side's
  extra leading axis (the augmented rows, (naug, n) or (naug, B, n))
  broadcasts over the factorization in the same ``lu_solve`` call.  (The JAX package's
  hand-unrolled ``smalllu`` exists only because TPU XLA has no f64 LU, so
  it has no counterpart here.)
* ``banded`` is the no-pivot band LU of :mod:`.banded`, made by
  ``make_banded_solver(ml, mu)``; ``meta`` carries its ``(ml, mu)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..equations import DiagMass


@dataclass(frozen=True)
class LinearSolverSpec:
    """Static vtable for one linear-solver tier: ``assemble(mass, jac, c)``
    builds ``M - c*J`` (``mass=None`` means identity), ``factor`` and
    ``solve`` are the two-phase LU interface, ``meta`` holds the tier's
    parameters (``(ml, mu)`` for banded)."""

    name: str
    assemble: Callable[[Any, Any, Any], Any]
    factor: Callable[[Any], Any]
    solve: Callable[[Any, Any], Any]
    meta: tuple = ()


def _dense_assemble(mass, jac, c):
    n = jac.shape[-1]
    if mass is None:
        m = torch.eye(n, dtype=jac.dtype, device=jac.device)
    elif isinstance(mass, DiagMass):
        m = torch.diag_embed(mass.d)
    else:
        m = mass
    return m - c * jac


def _dense_factor(a):
    return torch.linalg.lu_factor_ex(a)[:2]


def _dense_solve(factors, b):
    lu, piv = factors
    return torch.linalg.lu_solve(lu, piv, b.unsqueeze(-1)).squeeze(-1)


DENSE = LinearSolverSpec(
    name="dense",
    assemble=_dense_assemble,
    factor=_dense_factor,
    solve=_dense_solve,
)
