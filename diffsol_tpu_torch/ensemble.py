"""Ensemble solving (counterpart of ``diffsol_tpu.ensemble``).

* **lockstep** (the reference's ``nbatch`` semantics): ONE solve whose
  state is the member-major (B, n) tensor.  The member rhs and Jacobian are
  lifted with ``torch.func.vmap``, the WRMS norms reduce the mean over
  states and then the max over members, and the dense LU runs on (B, n, n).
  (The JAX package keeps (n, B) for the TPU's (8, 128) tiling; the
  semantics, ``tier`` and ``stats`` are the same.)
* **independent**: one solve per member, each with its own step sequence.
* **fused**: the whole-solve kernel tiers, the small-n stepper first
  (:mod:`.ops.fused_stepper`, n <= 8, tier ``"fused_small"``), then the
  banded stepper (:mod:`.ops.fused_band_stepper`, tier ``"fused_band"``).
  On the card they launch the hand-written kernels; on the CPU they run
  the kernels' plain PyTorch versions (the counterpart of Pallas
  ``interpret=True``) and ``Solution.tier`` ends in ``"_reference"``.
* **auto**: fused when the problem is in a kernel's scope, lockstep
  otherwise, and lockstep whenever the solver integrates augmented rows
  (``sens=True``), which the fused kernels do not carry.

A float32 problem (``OdeBuilder.dtype``) solves in float32 in lockstep and
independent modes; the fused tiers run their float64 kernels on it and
return float64, as the JAX package's fused tier does.

A solve runs on ``device``, the card unless the caller passes
``device="cpu"``; ``params_batch`` (numpy, list or tensor) is placed
there.  Without a card the default raises rather than run on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch

from . import errors
from .drivers import Solution, resolve_device, solve_dense
from .equations import OdeEquations
from .ops.eqn_codegen import UnsupportedForKernel
from .problem import OdeProblem

F64 = torch.float64


def make_lockstep_problem(problem: OdeProblem, nbatch: int) -> OdeProblem:
    """Lift a problem to member-major (B, n) lockstep form: ``params``
    gains a leading (nbatch,) axis and the callables act on all members at
    once.  The member Jacobian (dense (n, n), the (nb, n) band of the
    banded tier or the (K, nb, nb) blocks of the block tier) stacks to
    (B, n, n), (B, nb, n) or (B, K, nb, nb); the dense and banded tiers
    take member-major batches as they are, and the block tier's member and
    block axes fuse into one (B K, nb, nb) LU stack
    (``blockdiag_lockstep(nb,K,B)``)."""
    eqn = problem.eqn
    vmap = torch.func.vmap
    member_jac = eqn.rhs_jac or torch.func.jacfwd(eqn.rhs, argnums=1)
    b_jac = vmap(member_jac, in_dims=(None, 0, 0))
    if hasattr(member_jac, "jvp_probes"):
        b_jac.jvp_probes = member_jac.jvp_probes
    b_mass = b_mass_diag = None
    if eqn.mass is not None:
        b_mass = vmap(eqn.mass, in_dims=(None, 0))
        if eqn.mass_diag_fn is not None:
            b_mass_diag = vmap(eqn.mass_diag_fn, in_dims=(None, 0))
    def over_members(f):
        return None if f is None else vmap(f, in_dims=(None, 0, 0))

    new_eqn = OdeEquations(
        rhs=over_members(eqn.rhs),
        # an init that ignores p comes back from vmap as a stride-0
        # expansion; the state must own its memory (jvp seeds it)
        init=lambda t, pb: vmap(eqn.init, in_dims=(None, 0))(t, pb).contiguous(),
        mass=b_mass,
        mass_diag_fn=b_mass_diag,
        # (B, nroots), (B, nout), (B, n): every member must agree on a
        # root's sign pattern, and the event fires at ONE shared time,
        # member 0's polished crossing (ops/rootfind.check_root)
        root=over_members(eqn.root),
        out=over_members(eqn.out),
        reset=over_members(eqn.reset),
        # the fired root's index is one for all members (member 0's
        # crossing); the JAX lockstep problem drops reset_n (ROADMAP.md
        # queue 3), so its N models reset with the current index
        reset_n=(None if eqn.reset_n is None
                 else vmap(eqn.reset_n, in_dims=(None, 0, 0, None))),
        rhs_jac=b_jac,
        nstates=eqn.nstates,
        nout=eqn.nout,
        nroots=eqn.nroots,
        nparams=eqn.nparams,
    )
    params_b = problem.params.expand(nbatch, -1).clone()
    spec = problem.linear_solver
    if spec.name.startswith("blockdiag"):
        # the (B, K, nb, nb) Jacobian stack factors as one (B K, nb, nb) LU
        from .ops.blockdiag import make_blockdiag_solver_lockstep

        nb, K, perm = spec.meta[:3]
        spec = make_blockdiag_solver_lockstep(perm, nb, K, nbatch)
    return dataclasses.replace(
        problem, eqn=new_eqn, params=params_b, lockstep_nbatch=nbatch,
        linear_solver=spec,
    )


# the last fused solve built for each live problem, with its static
# arguments and its output times on each device; an entry goes when its
# problem does
_fused_cache: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _te_key(t_eval) -> tuple:
    """The output times as a tuple of floats (a list or array without a
    tensor round trip)."""
    if isinstance(t_eval, torch.Tensor):
        return tuple(t_eval.detach().reshape(-1).cpu().tolist())
    return tuple(np.asarray(t_eval, dtype=np.float64).reshape(-1).tolist())


def _make_fused_solve(problem, t_eval, nbatch, max_steps, tile, precision="df"):
    """The small-n kernel first, then the banded one (JAX
    ensemble.py:239-272); returns ``(solve, tier)``."""
    from .ops.fused_band_stepper import make_fused_band_bdf_solve
    from .ops.fused_stepper import make_fused_bdf_solve

    try:
        tier = "fused_small" if precision == "df" else f"fused_small_{precision}"
        return make_fused_bdf_solve(problem, t_eval, nbatch, tile=tile,
                                    max_steps=max_steps, precision=precision), tier
    except UnsupportedForKernel as e_small:
        if precision != "df":
            raise UnsupportedForKernel(
                f"precision={precision!r} is a small-n-tier option and the "
                f"small-n tier rejected this problem: {e_small}") from None
        try:
            return make_fused_band_bdf_solve(problem, t_eval, nbatch, tile=tile,
                                             max_steps=max_steps), "fused_band"
        except UnsupportedForKernel as e_band:
            raise UnsupportedForKernel(
                f"small-n tier: {e_small}; banded tier: {e_band}") from None


def _fused_solve_cached(problem, t_eval, nbatch, max_steps, tile, precision="df"):
    """``(solve, tier, ts_on)``: the fused solve of these static arguments,
    built at first use, and a dict device -> the output times there, filled
    by :func:`_fused_solution`."""
    key = (_te_key(t_eval), nbatch, max_steps, tile, precision)
    hit = _fused_cache.get(problem)
    if hit is not None and hit[0] == key:
        return hit[1]
    made = _make_fused_solve(problem, t_eval, nbatch, max_steps, tile, precision) + ({},)
    _fused_cache[problem] = (key, made)
    return made


def _fused_solution(fsolve, tier, ts_on, params_batch, t_eval, problem) -> Solution:
    """Run a fused solve and wrap it as a :class:`Solution`; the worst tile
    status is the batch's (shared fate, as in lockstep).  A solve with
    roots or quadrature returns a dict, and the semantics are
    ``drivers.solve_dense``'s: a reset-and-continue solve ends
    TSTOP_REACHED with no root reported, a root without a reset ends
    ROOT_FOUND at member 0's polished crossing, and a crossing that a
    tile's members, or the tiles among themselves, disagree on is
    ROOT_BATCH_INCONSISTENT.  The kernels are float64 builds: a float32
    problem's params are cast up and ``ys`` comes back float64, as from
    the JAX package's fused tier (pallas_stepper.py:2036).  Its callables'
    casts to float32 round each rhs there as in the plain version, which
    runs them (the generated model keeps each cast, eqn_codegen's
    ``f32``)."""
    from .ops import fused_stepper as fs

    raw = fsolve(params_batch.to(torch.float64))
    gs = root_t = root_idx = None
    if isinstance(raw, dict):
        ys, status, steps = raw["ys"], raw["status"], raw["steps"]
        gs, root_t, root_idx = raw.get("gs"), raw.get("root_t"), raw.get("root_idx")
    else:
        ys, status, steps = raw
    worst = int(status.min())
    stop = {
        fs.FAIL_STEP_TOO_SMALL: errors.STEP_SIZE_TOO_SMALL,
        fs.FAIL_MAX_STEPS: errors.MAX_STEPS_REACHED,
        fs.FAIL_NEWTON: errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES,
        fs.FAIL_ERRTEST: errors.TOO_MANY_ERROR_TEST_FAILURES,
        fs.FAIL_ROOT_INCONS: errors.ROOT_BATCH_INCONSISTENT,
        # no-pivot LU growth surfaces as the lockstep band tier's failure
        # does, through the Newton ladder (JAX ensemble.py:369-374)
        fs.FAIL_LU_GROWTH: errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES,
    }.get(worst, errors.TSTOP_REACHED)
    sol_root_t, sol_root_idx = math.nan, -1
    if root_t is not None and problem.eqn.reset is None:
        # stop-at-root: every tile must stop at a root, or none may (the
        # lockstep batch crosses together)
        stopped = status == fs.ROOT_STOP
        if worst >= 0 and bool(stopped.any()):
            if bool(stopped.all()):
                stop = errors.ROOT_FOUND
                sol_root_t, sol_root_idx = float(root_t[0]), int(root_idx[0])
            else:
                stop = errors.ROOT_BATCH_INCONSISTENT
    # the output times, copied to the device once per solve and cloned on
    # the device for each Solution
    te = ts_on.get(ys.device)
    if te is None:
        te = ts_on[ys.device] = torch.as_tensor(t_eval, dtype=F64).reshape(-1).to(ys.device)
    te = te.clone()
    if not params_batch.is_cuda:
        tier += "_reference"
    # n_points is len(t_eval) whatever happened: the points past a root
    # stop are zeros, as solve_dense's
    return Solution(
        ts=te, ys=ys.movedim(-1, 1), stop_reason=stop,
        n_points=int(te.numel()), state=None, tile_steps=steps, tier=tier,
        gs=None if gs is None else gs.movedim(-1, 1),
        root_t=sol_root_t, root_idx=sol_root_idx,
    )


def solve_dense_ensemble(
    make_solver,
    problem: OdeProblem,
    t_eval,
    params_batch,
    mode: str = "lockstep",
    max_steps: int = 100_000,
    tile=None,
    device=None,
    precision: str = "df",
) -> Solution:
    """Solve an ensemble over ``params_batch`` (B, nparams) in the
    problem's dtype (float64, or float32 for ``OdeBuilder.dtype``).

    ``make_solver`` is a problem -> solver factory (``BdfSolver``, or
    ``lambda pr: solver(pr, "tr_bdf2")``); the lockstep and independent
    modes use it.  The fused and auto modes run the BDF kernels whenever
    one takes the problem, whatever the method, as the JAX package does
    (its ensemble.py:441-476), so an SDIRK or ERK ensemble asks for
    ``mode="lockstep"``.  A factory whose solver carries sensitivities
    (``lambda pr: BdfSolver(pr, sens=True)``) is the exception: the
    kernels carry no augmented rows, so ``mode="auto"`` goes lockstep and
    ``mode="fused"`` raises :class:`UnsupportedForKernel` (where the JAX
    package's fused tier returns ``sens=None`` without a word).
    Returns a :class:`Solution` whose ``ys`` is (neval, B, nstates), and
    with sensitivities ``sens`` (neval, naug, B, nstates).
    ``tile`` sets the fused tiers' member tile (each tier has its default);
    it is part of the result, since each tile takes its own step sequence.
    ``device`` is where the solve runs: None means ``"cuda"``, and raises
    without a card; pass ``device="cpu"`` for the CPU.
    ``precision`` is the fused small-n tier's: ``"df"`` (all float64),
    ``"mixed"`` (the Newton matrix path in float32; trajectories agree with
    ``"df"`` at the error test's tolerance) or ``"fast"`` (runs the ``"df"``
    build); see :func:`.ops.fused_stepper.make_fused_bdf_solve`.
    """
    if precision not in ("df", "mixed", "fast"):
        raise ValueError(f"precision must be 'df', 'mixed' or 'fast': {precision!r}")
    dev = resolve_device(device, "solve_dense_ensemble")
    if isinstance(params_batch, torch.Tensor):
        if params_batch.dtype != problem.dtype:
            raise TypeError(f"params_batch must be {problem.dtype} as the problem, "
                            f"got {params_batch.dtype}")
    else:
        params_batch = torch.as_tensor(params_batch, dtype=F64).to(problem.dtype)
    params_batch = params_batch.to(dev)
    nbatch = params_batch.shape[0]

    if mode in ("fused", "auto") and getattr(make_solver(problem), "has_sens", False):
        if mode == "fused":
            raise UnsupportedForKernel(
                "the fused kernels carry no sensitivity rows: use mode='lockstep' "
                "(mode='auto' takes it) for a solver with sens=True")
        mode = "lockstep"
    if mode in ("fused", "auto"):
        try:
            fsolve, tier, ts_on = _fused_solve_cached(problem, t_eval, nbatch,
                                                      max_steps, tile, precision)
        except UnsupportedForKernel:
            if mode == "fused":
                raise
        else:
            return _fused_solution(fsolve, tier, ts_on, params_batch, t_eval, problem)
        mode = "lockstep"

    problem = problem.to(dev)
    if mode == "lockstep":
        lp = make_lockstep_problem(problem, nbatch)
        sol = solve_dense(make_solver(lp), t_eval, params=params_batch,
                          max_steps=max_steps, device=dev)
        return sol.replace(tier="lockstep")

    if mode == "independent":
        solver = make_solver(problem)
        sols = [
            solve_dense(solver, t_eval, params=params_batch[i],
                        max_steps=max_steps, device=dev)
            for i in range(nbatch)
        ]
        return Solution(
            ts=sols[0].ts,
            ys=torch.stack([s.ys for s in sols], dim=1),
            gs=(None if sols[0].gs is None
                else torch.stack([s.gs for s in sols], dim=1)),
            sens=(None if sols[0].sens is None
                  else torch.stack([s.sens for s in sols], dim=2)),
            stop_reason=torch.tensor([s.stop_reason for s in sols]),
            n_points=sols[0].n_points,
            state=[s.state for s in sols],
            tier="independent",
        )

    raise ValueError(f"unknown ensemble mode: {mode!r}")
