"""Carry problems and results across from the JAX package.

``problem_from_jax`` copies every numeric field of a ``diffsol_tpu``
``OdeProblem`` (params, t0, h0, rtol, atol, the output, sensitivity and
adjoint parameter-row tolerances, the quadrature flag, all solver options
and the consistent-IC options) into
this package's problem as float64 tensors, a banded linear-solver tier as
``make_banded_solver(ml, mu)`` and a block-diagonal one as
``make_blockdiag_solver(perm, nb, K)`` from the spec's ``meta``; a JAX
problem built with ``use_coloring`` whose Jacobian stayed dense and
colored gets ``use_coloring`` here too.  The user's callables are passed
in torch, since a jnp body cannot be converted (a Jacobian given through
``rhs_implicit`` as ``rhs_jac``); for the 2-D models,
``model="heat2d"`` or ``"foodweb"`` builds them from this package's model
with the JAX problem's own arrays (the mass diagonal, hence the interior
mask, and the initial state) as their constants.
``solution_to_numpy`` turns a :class:`~.drivers.Solution` into numpy
arrays in the JAX package's layouts, so tests compare like with like.

Neither function imports JAX: they read the JAX objects' fields through
``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .problem import (InitialConditionOptions, OdeBuilder, OdeProblem,
                      OdeSolverOptions)

F64 = torch.float64


def _model_callables(model: str, jax_problem) -> dict:
    """The torch callables of a 2-D model, with the JAX problem's mass
    diagonal and initial state (read through numpy) as constants."""
    eqn = jax_problem.eqn
    n = int(eqn.nstates)
    mass_diag = np.asarray(eqn.mass_diag_fn(jax_problem.t0, jax_problem.params), np.float64)
    u0 = np.asarray(eqn.init(jax_problem.t0, jax_problem.params), np.float64)
    if model == "heat2d":
        from .models import heat2d

        mgrid = int(round(n ** 0.5))
        if mgrid * mgrid != n:
            raise ValueError(f"{n} states are no square grid")
        return heat2d.callables(mgrid, mass_diag=mass_diag, u0=u0)
    if model == "foodweb":
        from .models import foodweb

        nx = int(round((n // 2) ** 0.5))
        if 2 * nx * nx != n:
            raise ValueError(f"{n} states are no two-species square grid")
        return foodweb.callables(nx, mass_diag=mass_diag, u0=u0)
    raise ValueError(f"unknown model {model!r}")


def problem_from_jax(jax_problem, rhs=None, init=None, mass=None, root=None,
                     reset=None, out=None, model=None, rhs_jac=None) -> OdeProblem:
    """This package's problem with the numbers of ``jax_problem`` and the
    torch callables ``rhs(t, y, p)``, ``init(t, p)`` and the optional
    ``mass(t, p)``, ``root``, ``reset`` and ``out`` ``(t, y, p)`` and
    ``rhs_jac(t, y, p)`` (the user Jacobian of ``rhs_implicit``); or, with
    ``model="heat2d"`` / ``"foodweb"``, the callables of that model built
    on the JAX problem's arrays."""
    if model is not None:
        fns = _model_callables(model, jax_problem)
        rhs, init, mass = fns["rhs"], fns["init"], fns["mass"]
        out = fns.get("out") if jax_problem.eqn.out is not None else None

    def copied(cls, src):
        return cls(**{f.name: getattr(src, f.name) for f in dataclasses.fields(cls)})

    options = copied(OdeSolverOptions, jax_problem.options)
    b = OdeBuilder().rhs(rhs) if rhs_jac is None else OdeBuilder().rhs_implicit(rhs, rhs_jac)
    b = (
        b
        .init(init)
        .p(np.asarray(jax_problem.params, np.float64))
        .t0(float(np.asarray(jax_problem.t0)))
        .h0(float(np.asarray(jax_problem.h0)))
        .rtol(float(np.asarray(jax_problem.rtol)))
        .atol(np.asarray(jax_problem.atol, np.float64).reshape(-1))
        .options(options)
        .ic_options(copied(InitialConditionOptions, jax_problem.ic_options))
        .integrate_out(bool(jax_problem.integrate_out))
    )
    for name, fn in (("mass", mass), ("root", root), ("reset", reset), ("out", out)):
        if fn is not None:
            b = getattr(b, name)(fn)
    if jax_problem.out_rtol is not None:
        b = b.out_rtol(float(np.asarray(jax_problem.out_rtol)))
    if jax_problem.out_atol is not None:
        b = b.out_atol(np.asarray(jax_problem.out_atol, np.float64).reshape(-1))
    if jax_problem.sens_rtol is not None:
        b = b.sens_rtol(float(np.asarray(jax_problem.sens_rtol)))
    if jax_problem.sens_atol is not None:
        b = b.sens_atol(np.asarray(jax_problem.sens_atol, np.float64).reshape(-1))
    if jax_problem.param_rtol is not None:
        b = b.param_rtol(float(np.asarray(jax_problem.param_rtol)))
    for name in ("param_atol", "param_scales"):
        v = getattr(jax_problem, name)
        if v is not None:
            b = getattr(b, name)(np.asarray(v, np.float64).reshape(-1))
    spec = jax_problem.linear_solver
    if spec.name.startswith("banded"):
        from .ops.banded import make_banded_solver

        b = b.linear_solver(make_banded_solver(*spec.meta[:2]))
    elif spec.name.startswith("blockdiag"):
        from .ops.blockdiag import make_blockdiag_solver

        nb, K, perm = spec.meta[:3]
        b = b.linear_solver(make_blockdiag_solver(np.asarray(perm), int(nb), int(K)))
    elif spec.name == "dense" and hasattr(jax_problem.eqn.rhs_jac, "jvp_probes"):
        b = b.use_coloring()  # the JAX OdeBuilder kept a colored dense Jacobian
    if str(np.asarray(jax_problem.t0).dtype) == "float32":
        b = b.dtype(torch.float32)  # its numbers are float32's, exactly
    return b.build()


def solution_to_numpy(sol) -> dict:
    """``ts``, ``ys``, ``gs``, ``sens``, ``stop_reason``, ``n_points``,
    ``root_t``, ``root_idx``, ``tile_steps`` and ``tier`` of a solution, as
    numpy arrays (``tier`` as is, ``gs``, ``sens`` and ``tile_steps`` None
    when unset).  ``sens`` takes the JAX package's layout: (neval, naug, n),
    and (neval, naug, n, B) for a lockstep ensemble."""

    def arr(v):
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    sens = arr(sol.sens)
    if sens is not None and sens.ndim == 4:  # lockstep (neval, naug, B, n)
        sens = np.swapaxes(sens, -1, -2)
    return dict(
        ts=arr(sol.ts), ys=arr(sol.ys), sens=sens, stop_reason=arr(sol.stop_reason),
        n_points=int(sol.n_points), tile_steps=arr(sol.tile_steps),
        tier=sol.tier, gs=arr(sol.gs), root_t=arr(sol.root_t),
        root_idx=arr(sol.root_idx),
    )
