"""Ensemble solving (counterpart of ``diffsol_tpu.ensemble``).

* **lockstep** (the reference's ``nbatch`` semantics): ONE solve whose
  state is the member-major (B, n) tensor.  The member rhs and Jacobian are
  lifted with ``torch.func.vmap``, the WRMS norms reduce the mean over
  states and then the max over members, and the dense LU runs on (B, n, n).
  (The JAX package keeps (n, B) for the TPU's (8, 128) tiling; the
  semantics, ``tier`` and ``stats`` are the same.)
* **independent**: one solve per member, each with its own step sequence.
* **fused**: the whole-solve kernel tier (:mod:`.ops.fused_stepper`).  On
  CUDA tensors it launches the hand-written kernel; on CPU tensors it runs
  the kernel's plain PyTorch version (the counterpart of Pallas
  ``interpret=True``) and ``Solution.tier`` says so.
* **auto**: fused when the problem is in the kernel's scope and
  ``params_batch`` is a CUDA tensor, lockstep otherwise.

Every solve runs on the device of ``params_batch``; nothing is moved to
another device.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from . import errors
from .drivers import Solution, solve_dense
from .equations import OdeEquations
from .ops.eqn_codegen import UnsupportedForKernel
from .problem import OdeProblem

F64 = torch.float64


def make_lockstep_problem(problem: OdeProblem, nbatch: int) -> OdeProblem:
    """Lift a problem to member-major (B, n) lockstep form: ``params``
    gains a leading (nbatch,) axis and the callables act on all members at
    once."""
    eqn = problem.eqn
    vmap = torch.func.vmap
    member_jac = torch.func.jacfwd(eqn.rhs, argnums=1)
    b_mass = b_mass_diag = None
    if eqn.mass is not None:
        b_mass = vmap(eqn.mass, in_dims=(None, 0))
        if eqn.mass_diag_fn is not None:
            b_mass_diag = vmap(eqn.mass_diag_fn, in_dims=(None, 0))
    new_eqn = OdeEquations(
        rhs=vmap(eqn.rhs, in_dims=(None, 0, 0)),
        init=vmap(eqn.init, in_dims=(None, 0)),
        mass=b_mass,
        mass_diag_fn=b_mass_diag,
        rhs_jac=vmap(member_jac, in_dims=(None, 0, 0)),
        nstates=eqn.nstates,
        nparams=eqn.nparams,
    )
    params_b = problem.params.expand(nbatch, -1).clone()
    return dataclasses.replace(
        problem, eqn=new_eqn, params=params_b, lockstep_nbatch=nbatch,
    )


# the last fused solve built for each live problem, with its static
# arguments; an entry goes when its problem does
_fused_cache: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _fused_solve_cached(problem, t_eval, nbatch, max_steps, tile):
    from .ops.fused_stepper import make_fused_bdf_solve

    te_key = tuple(float(v) for v in torch.as_tensor(t_eval).reshape(-1))
    key = (te_key, nbatch, max_steps, tile)
    hit = _fused_cache.get(problem)
    if hit is not None and hit[0] == key:
        return hit[1]
    fsolve = make_fused_bdf_solve(problem, t_eval, nbatch, tile=tile,
                                  max_steps=max_steps)
    _fused_cache[problem] = (key, fsolve)
    return fsolve


def _fused_solution(fsolve, params_batch, t_eval) -> Solution:
    """Run a fused solve and wrap it as a :class:`Solution`; the worst tile
    status is the batch's (shared fate, as in lockstep)."""
    from .ops import fused_stepper as fs

    ys, status, steps = fsolve(params_batch)
    worst = int(status.min())
    stop = {
        fs.FAIL_STEP_TOO_SMALL: errors.STEP_SIZE_TOO_SMALL,
        fs.FAIL_MAX_STEPS: errors.MAX_STEPS_REACHED,
        fs.FAIL_NEWTON: errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES,
        fs.FAIL_ERRTEST: errors.TOO_MANY_ERROR_TEST_FAILURES,
    }.get(worst, errors.TSTOP_REACHED)
    te = torch.as_tensor(t_eval, dtype=F64).reshape(-1).to(ys.device)
    tier = "fused_small" if params_batch.is_cuda else "fused_small_reference"
    return Solution(
        ts=te, ys=ys.movedim(-1, 1), stop_reason=stop,
        n_points=int(te.numel()), state=None, tile_steps=steps, tier=tier,
    )


def solve_dense_ensemble(
    make_solver,
    problem: OdeProblem,
    t_eval,
    params_batch,
    mode: str = "lockstep",
    max_steps: int = 100_000,
    tile=None,
) -> Solution:
    """Solve an ensemble over ``params_batch`` (B, nparams) float64.

    ``make_solver`` is a problem -> solver factory (``BdfSolver``).
    Returns a :class:`Solution` whose ``ys`` is (neval, B, nstates).
    ``tile`` sets the fused tiers' member tile (default
    :data:`.ops.fused_stepper.DEFAULT_TILE`); it is part of the result,
    since each tile takes its own step sequence.
    """
    params_batch = torch.as_tensor(params_batch)
    if params_batch.dtype != F64:
        raise TypeError(f"params_batch must be float64, got {params_batch.dtype}")
    nbatch = params_batch.shape[0]

    if mode in ("fused", "auto"):
        try:
            if mode == "fused" or params_batch.is_cuda:
                fsolve = _fused_solve_cached(problem, t_eval, nbatch,
                                             max_steps, tile)
                return _fused_solution(fsolve, params_batch, t_eval)
        except UnsupportedForKernel:
            if mode == "fused":
                raise
        mode = "lockstep"

    problem = problem.to(params_batch.device)
    if mode == "lockstep":
        lp = make_lockstep_problem(problem, nbatch)
        sol = solve_dense(make_solver(lp), t_eval, params=params_batch,
                          max_steps=max_steps)
        return sol.replace(tier="lockstep")

    if mode == "independent":
        solver = make_solver(problem)
        sols = [
            solve_dense(solver, t_eval, params=params_batch[i],
                        max_steps=max_steps)
            for i in range(nbatch)
        ]
        return Solution(
            ts=sols[0].ts,
            ys=torch.stack([s.ys for s in sols], dim=1),
            stop_reason=torch.tensor([s.stop_reason for s in sols]),
            n_points=sols[0].n_points,
            state=[s.state for s in sols],
            tier="independent",
        )

    raise ValueError(f"unknown ensemble mode: {mode!r}")
