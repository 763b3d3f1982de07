"""ODE equation container (counterpart of ``diffsol_tpu.equations``).

A problem is a set of plain torch callables with the argument order
``(t, y, p)``:

    M(t, p) dy/dt = f(t, y, p),    y(t0) = y0(t0, p)

The Jacobian comes from ``torch.func.jacfwd`` where the JAX package uses
``jax.jacfwd``.  A structurally diagonal mass keeps the elementwise fast
path: ``mass_diag_fn`` returns the (n,) diagonal and the dense (n, n) mass
is never built on the hot path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

F64 = torch.float64


class DiagMass(NamedTuple):
    """Diagonal-mass representation handed to ``assemble``: the (..., n)
    diagonal values."""

    d: torch.Tensor


@dataclass(frozen=True, eq=False)
class OdeEquations:
    """Problem callables and dimensions."""

    rhs: Callable  # f(t, y, p) -> (n,)
    init: Callable  # y0(t, p) -> (n,)
    mass: Optional[Callable] = None  # M(t, p) -> (n, n); None => identity
    mass_diag_fn: Optional[Callable] = None  # (t, p) -> (n,) diagonal
    root: Optional[Callable] = None  # g(t, y, p) -> (nroots,)
    out: Optional[Callable] = None  # g(t, y, p) -> (nout,)
    reset: Optional[Callable] = None  # R(t, y, p) -> (n,)
    # the index-aware reset R(t, y, p, root_idx) -> (n,) (the DiffSL
    # model-index protocol, diffsol-c ode_solver_type.rs:66): where set, the
    # drivers apply it at an event with the index of the root that fired
    reset_n: Optional[Callable] = None
    # (t, y, p) -> the linear-solver tier's Jacobian: dense (n, n) by
    # default (jacfwd), the (nb, n) band under the banded tier
    rhs_jac: Optional[Callable] = None
    nstates: int = 0
    nout: int = 0
    nroots: int = 0
    nparams: int = 0

    def jac(self, t, y, p):
        """Jacobian df/dy in the tier's representation (``rhs_jac``), else
        dense."""
        if self.rhs_jac is not None:
            return self.rhs_jac(t, y, p)
        return torch.func.jacfwd(self.rhs, argnums=1)(t, y, p)

    def sens_mul(self, t, y, p, v):
        """(df/dp) @ v by forward mode (the forward sensitivities)."""
        return torch.func.jvp(lambda pp: self.rhs(t, y, pp), (p,), (v,))[1]

    def sens_transpose_mul(self, t, y, p, v):
        """(df/dp)^T @ v by reverse mode (the adjoint's gradient
        quadrature)."""
        _, vjp = torch.func.vjp(lambda pp: self.rhs(t, y, pp), p)
        return vjp(v)[0]

    def mass_repr(self, t, p):
        """None (identity), :class:`DiagMass`, or the dense matrix."""
        if self.mass is None:
            return None
        if self.mass_diag_fn is not None:
            return DiagMass(self.mass_diag_fn(t, p))
        return self.mass(t, p)

    def mass_mul(self, t, p, v):
        if self.mass is None:
            return v
        if self.mass_diag_fn is not None:
            return v * self.mass_diag_fn(t, p)
        return (self.mass(t, p) @ v.unsqueeze(-1)).squeeze(-1)


def make_equations(rhs, init, params, t0=0.0, *, mass=None, mass_diag=None,
                   rhs_jac=None, root=None, out=None, reset=None,
                   reset_n=None) -> OdeEquations:
    """Build an :class:`OdeEquations`, inferring ``nstates`` from one
    evaluation of ``init`` at (t0, params), and ``nroots`` and ``nout``
    from one evaluation of ``root`` and ``out`` on that state."""
    params = torch.as_tensor(params)
    if not params.is_floating_point():
        params = params.to(F64)
    t0 = torch.as_tensor(t0, dtype=params.dtype, device=params.device)
    y0 = init(t0, params)
    nstates = int(y0.shape[-1]) if y0.ndim else 1

    def size(fn):
        if fn is None:
            return 0
        v = fn(t0, y0, params)
        return int(v.shape[-1]) if v.ndim else 1

    return OdeEquations(
        rhs=rhs, init=init, mass=mass, mass_diag_fn=mass_diag,
        root=root, out=out, reset=reset, reset_n=reset_n,
        rhs_jac=rhs_jac, nstates=nstates, nout=size(out), nroots=size(root),
        nparams=int(params.numel()),
    )
