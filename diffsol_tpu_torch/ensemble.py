"""Ensemble solving (counterpart of ``diffsol_tpu.ensemble``).

* **lockstep** (the reference's ``nbatch`` semantics): ONE solve whose
  state is the member-major (B, n) tensor.  The member rhs and Jacobian are
  lifted with ``torch.func.vmap``, the WRMS norms reduce the mean over
  states and then the max over members, and the dense LU runs on (B, n, n).
  (The JAX package keeps (n, B) for the TPU's (8, 128) tiling; the
  semantics, ``tier`` and ``stats`` are the same.)
* **independent**: each member with its own step sequence, events and
  stop.  A ``BdfSolver``, ``SdirkSolver`` or ``ErkSolver``, with or
  without ``sens=True``, over the dense tier (any mass), the banded, the
  block-diagonal or the matrix-free Krylov tier (each member its own
  GMRES) runs all members in one batched loop
  (:mod:`.solvers.bdf_independent`, :mod:`.solvers.rk_independent`, the
  counterpart of the JAX package's ``vmap``).  Another solver class, or
  augmented equations other than the forward sensitivities, loops over
  the members, one eager solve each.  Either way ``stop_reason``,
  ``root_t`` and ``root_idx`` are (B,) tensors and ``state`` is one
  batched state.
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


def make_lockstep_problem(problem: OdeProblem, nbatch: int,
                          member_t: bool = False, axis=None, state_axis=None) -> OdeProblem:
    """Lift a problem to member-major (B, n) lockstep form: ``params``
    gains a leading (nbatch,) axis and the callables act on all members at
    once.  With ``member_t`` the callables take a (B,) time, each member at
    its own (the batched independent mode, :mod:`.solvers.independent`),
    on the dense, banded and block-diagonal tiers alike.  The member
    Jacobian (dense (n, n), the (nb, n) band of the
    banded tier or the (K, nb, nb) blocks of the block tier) stacks to
    (B, n, n), (B, nb, n) or (B, K, nb, nb); the dense and banded tiers
    take member-major batches as they are, and the block tier's member and
    block axes fuse into one (B K, nb, nb) LU stack
    (``blockdiag_lockstep(nb,K,B)``).  The matrix-free tier's Jacobian
    stays the frozen point, now of the batch, and its GMRES runs over the
    joint B n system (``krylov_lockstep``; JAX ensemble.py:108-136,
    200-215); with ``member_t`` each member keeps its own frozen point,
    preconditioner and GMRES (``krylov_independent``, as JAX's ``vmap`` of
    the single solve gives them).

    ``axis`` (a :class:`~.sharding.MemberAxis`) makes it one rank's block of
    a lockstep ensemble sharded over a mesh: ``nbatch`` is the block's size,
    and every reduction over members in the solve runs over the whole mesh
    axis, so that all ranks take the unsharded solve's step sequence (on the
    Krylov tier one GMRES over all members, its sums over the axis).

    ``state_axis`` (a :class:`~.sharding.StateAxis` of the problem's n
    states) shards every member's states too, as the JAX package's
    ``P("sp", ...)`` on a large method-of-lines problem: the state and
    ``atol`` are the rank's block of columns; every callable gathers each
    member's whole state over the axis (one all-gather a call) and runs the
    user's unchanged (:func:`~.sharding.shard_states`): the rhs and a reset
    keep their block, the root function, ``out`` and the quadrature's
    integrand are whole on every rank, and the Jacobian and the mass are
    the whole members', so the Newton matrix is built and factored whole
    and every linear solve gathers its right-hand side and keeps its block
    (:meth:`~.sharding.StateAxis.whole_solve`).  The norms gather their
    terms (:mod:`.norms`).  ``BdfSolver``, ``SdirkSolver`` and
    ``ErkSolver`` on the dense and banded tiers, with a mass, consistent
    initial conditions, roots and resets, ``out`` and a quadrature, then
    take the unsharded solve's steps bit for bit.  ``sens=True``, the
    Krylov and block-diagonal tiers and the member-time lift raise
    ``NotImplementedError`` (ROADMAP 20f)."""
    eqn = problem.eqn
    vmap = torch.func.vmap
    spec = problem.linear_solver
    krylov = spec.name.startswith("krylov")
    if state_axis is not None:
        from .sharding import not_on_sharded_state

        for what, there in (("a member-time lift (mode='independent')", member_t),
                            ("the matrix-free Krylov tier", krylov),
                            ("the block-diagonal tier", spec.name.startswith("blockdiag"))):
            if there:
                raise not_on_sharded_state(what)
    td = 0 if member_t else None
    if krylov and member_t:
        from .ops.krylov import MemberPoint

        def b_jac(t, Y, Pb):
            # the points are the batch's own, written member by member
            return MemberPoint(t.clone(), Y.clone(), Pb.clone())

        b_jac.jvp_probes = 0
    elif krylov:
        def b_jac(t, Y, Pb):
            return (t, Y, Pb)

        b_jac.jvp_probes = 0
    else:
        member_jac = eqn.rhs_jac or torch.func.jacfwd(eqn.rhs, argnums=1)
        b_jac = vmap(member_jac, in_dims=(td, 0, 0))
        if hasattr(member_jac, "jvp_probes"):
            b_jac.jvp_probes = member_jac.jvp_probes
    b_mass = b_mass_diag = None
    if eqn.mass is not None:
        b_mass = vmap(eqn.mass, in_dims=(td, 0))
        if eqn.mass_diag_fn is not None:
            b_mass_diag = vmap(eqn.mass_diag_fn, in_dims=(td, 0))

    def over_members(f):
        return None if f is None else vmap(f, in_dims=(td, 0, 0))

    rhs_b = over_members(eqn.rhs)
    init_b = vmap(eqn.init, in_dims=(None, 0))
    new_eqn = OdeEquations(
        rhs=rhs_b,
        # an init that ignores p comes back from vmap as a stride-0
        # expansion; the state must own its memory (jvp seeds it)
        init=lambda t, pb: init_b(t, pb).contiguous(),
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
        # queue 3), so its N models reset with the current index.  With
        # member_t each member resets with its own (B,) index.
        reset_n=(None if eqn.reset_n is None
                 else vmap(eqn.reset_n, in_dims=(td, 0, 0, td))),
        rhs_jac=b_jac,
        nstates=eqn.nstates,
        nout=eqn.nout,
        nroots=eqn.nroots,
        nparams=eqn.nparams,
    )
    if state_axis is not None:
        from .sharding import shard_states

        new_eqn = shard_states(new_eqn, state_axis)
        spec = dataclasses.replace(spec, solve=state_axis.whole_solve(spec.solve))
    params_b = problem.params.expand(nbatch, -1).clone()
    if krylov and member_t:
        from .ops.krylov import make_krylov_solver_independent

        gmres_tol, restart, maxiter, precond, member_jac_fn = spec.meta[:5]
        spec = make_krylov_solver_independent(
            new_eqn.rhs, eqn.rhs, nbatch, gmres_tol=gmres_tol, restart=restart,
            maxiter=maxiter, precond=precond, member_jac_fn=member_jac_fn)
    elif krylov:
        from .ops.krylov import make_krylov_solver_lockstep

        gmres_tol, restart, maxiter, precond, member_jac_fn = spec.meta[:5]
        spec = make_krylov_solver_lockstep(
            new_eqn.rhs, nbatch, gmres_tol=gmres_tol, restart=restart,
            maxiter=maxiter, precond="none" if precond == "none" else "lu32",
            member_jac_fn=member_jac_fn, axis=axis)
    elif spec.name.startswith("blockdiag"):
        # the (B, K, nb, nb) Jacobian stack factors as one (B K, nb, nb) LU
        from .ops.blockdiag import make_blockdiag_solver_lockstep

        nb, K, perm = spec.meta[:3]
        spec = make_blockdiag_solver_lockstep(perm, nb, K, nbatch)
    atol = problem.atol
    if state_axis is not None and atol.numel() == eqn.nstates:
        atol = state_axis.split(atol.reshape(-1)).clone()
    return dataclasses.replace(
        problem, eqn=new_eqn, params=params_b, lockstep_nbatch=nbatch,
        linear_solver=spec, member_axis=axis, state_axis=state_axis, atol=atol,
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


def _sharded_fused(fsolve, maxis):
    """The fused solve of the rank's block, its raw outputs gathered into
    the whole batch's: ys and gs along their member axis (the last), the
    per-tile status, steps and roots in rank order (each rank's tiles are
    tiles of its block, as under JAX's ``shard_map``)."""
    def gathered(k, v):
        return None if v is None else maxis.gather(v, -1 if k in ("ys", "gs") else 0)

    def run(params_batch):
        raw = fsolve(maxis.split(params_batch))
        if isinstance(raw, dict):
            return {k: gathered(k, v) for k, v in raw.items()}
        ys, status, steps = raw
        return gathered("ys", ys), gathered("status", status), gathered("steps", steps)

    return run


def _gather_state(maxis, state, dim=0):
    """The whole batch's state from every rank's block of it: a tensor
    along ``dim``; a dataclass field by field, each along the member
    dimension its class declares in ``MEMBER_DIMS`` (a batched independent
    state: bdf_independent, rk_independent) or else ``dim``, a field
    declared None (the Newton matrices, whose layout is the tier's) as
    None, the loop's own counts (ints) as their largest over the ranks.  A
    tensor whose member dimension is not the block's size raises."""
    if isinstance(state, torch.Tensor):
        if state.dim() <= dim or state.shape[dim] != maxis.local:
            raise ValueError(f"a state tensor of shape {tuple(state.shape)} has no member "
                             f"dimension {dim} of the block's {maxis.local}")
        return maxis.gather(state, dim)
    if isinstance(state, tuple):
        parts = [_gather_state(maxis, v, dim) for v in state]
        return type(state)(*parts) if hasattr(state, "_fields") else tuple(parts)
    if not (dataclasses.is_dataclass(state) and not isinstance(state, type)):
        return state
    dims = getattr(type(state), "MEMBER_DIMS", {})
    upd = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name in dims and dims[f.name] is None:
            upd[f.name] = None
        elif isinstance(v, int) and not isinstance(v, bool):
            upd[f.name] = int(maxis.partials([v]).amax())
        else:
            upd[f.name] = _gather_state(maxis, v, dims.get(f.name, dim))
    return dataclasses.replace(state, **upd)


def _gather_solution(maxis, sol, with_state=False) -> Solution:
    """An ensemble Solution of the rank's block as the whole batch's: ys and
    gs (neval, B, ...), sens (neval, naug, B, n) and, ``with_state`` (an
    independent ensemble), its (B,) stop_reason, root_t and root_idx and
    its state; a lockstep solve's state stays the rank's block's."""
    def g(v, dim):
        return None if v is None else maxis.gather(v, dim)

    upd = dict(ys=g(sol.ys, 1), gs=g(sol.gs, 1), sens=g(sol.sens, 2))
    if with_state:
        upd.update(stop_reason=g(sol.stop_reason, 0), root_t=g(sol.root_t, 0),
                   root_idx=g(sol.root_idx, 0), state=_gather_state(maxis, sol.state))
    return sol.replace(**upd)


def stack_states(states):
    """The member loop's final states as one batched state of their class:
    tensors stacked on a new leading member axis, numbers as (B,) tensors,
    tuples, named tuples and dataclasses (``Stats`` among them) field by
    field; what is equal in every member (None) is kept once."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        if all(s.shape == first.shape for s in states):
            return torch.stack(states)
        return list(states)
    if isinstance(first, bool) or isinstance(first, (int, float)):
        return torch.tensor(states)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: stack_states([getattr(s, f.name) for s in states])
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        parts = [stack_states(list(col)) for col in zip(*states)]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    if all(s is first for s in states):
        return first
    return list(states)


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
    mesh=None,
    axis: str = "dp",
) -> Solution:
    """Solve an ensemble over ``params_batch`` (B, nparams) in the
    problem's dtype (float64, or float32 for ``OdeBuilder.dtype``).

    ``make_solver`` is a problem -> solver factory (``BdfSolver``, or
    ``lambda pr: solver(pr, "tr_bdf2")``); the lockstep and independent
    modes use it.  ``mode="independent"`` gives every member its own step
    control: one batched loop for a ``BdfSolver``, ``SdirkSolver`` or
    ``ErkSolver`` (sensitivities or not) over the dense, banded,
    block-diagonal or Krylov tier
    (:func:`.solvers.independent.solve_dense_independent`), one eager
    solve a member for any other solver; ``stop_reason``, ``root_t`` and
    ``root_idx`` come back as (B,) tensors and ``state`` as one batched
    state.  The fused and auto modes run the BDF kernels whenever
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

    ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh``) shards the
    members over its dimension ``axis``, as the JAX package's ``mesh=`` and
    ``axis=`` do (:mod:`.sharding`): every rank of an SPMD program (one
    process a device, ``torchrun``) calls with the same global
    ``params_batch``, solves its contiguous block of B / k members on its
    device (the current card for a CUDA mesh, the CPU for a CPU mesh; a
    ``device`` that says otherwise raises) and gets the whole Solution
    back.  ``mode="fused"`` runs the kernels on each rank's block, with no
    collective in the solve; lockstep is ONE joint solve whose every
    reduction over members (error, Newton and order norms, the root scan,
    the initial step) runs over the whole axis, so every rank takes the
    unsharded solve's steps and ``Stats`` (on the Krylov tier one GMRES
    over all members, whose sums reorder: ys agree to roundoff), and its
    ``state`` is the rank's block's; independent gathers each member's
    result and its batched state (the Newton matrices ``jac`` and
    ``factors`` stay with their rank and come back None).  A B that the axis does not divide raises
    ``ValueError``, as in JAX.
    """
    if precision not in ("df", "mixed", "fast"):
        raise ValueError(f"precision must be 'df', 'mixed' or 'fast': {precision!r}")
    if mesh is not None:
        from .sharding import mesh_device

        device = mesh_device(mesh, device)
    dev = resolve_device(device, "solve_dense_ensemble")
    if isinstance(params_batch, torch.Tensor):
        if params_batch.dtype != problem.dtype:
            raise TypeError(f"params_batch must be {problem.dtype} as the problem, "
                            f"got {params_batch.dtype}")
    else:
        params_batch = torch.as_tensor(params_batch, dtype=F64).to(problem.dtype)
    params_batch = params_batch.to(dev)
    nbatch = params_batch.shape[0]

    def member_axis():
        from .sharding import MemberAxis

        return None if mesh is None else MemberAxis.of(mesh, axis, nbatch)

    if mode in ("fused", "auto") and getattr(make_solver(problem), "has_sens", False):
        if mode == "fused":
            raise UnsupportedForKernel(
                "the fused kernels carry no sensitivity rows: use mode='lockstep' "
                "(mode='auto' takes it) for a solver with sens=True")
        mode = "lockstep"
    if mode in ("fused", "auto"):
        if mesh is not None:
            from .sharding import axis_size

            if nbatch % axis_size(mesh, axis):
                raise ValueError(
                    f"fused+mesh needs nbatch divisible by mesh axis {axis!r} "
                    f"({nbatch} % {axis_size(mesh, axis)})")
        maxis = member_axis()
        try:
            fsolve, tier, ts_on = _fused_solve_cached(
                problem, t_eval, nbatch if maxis is None else maxis.local, max_steps,
                tile, precision)
        except UnsupportedForKernel:
            if mode == "fused":
                raise
        else:
            if maxis is not None:
                fsolve = _sharded_fused(fsolve, maxis)
            return _fused_solution(fsolve, tier, ts_on, params_batch, t_eval, problem)
        mode = "lockstep"

    problem = problem.to(dev)
    maxis = member_axis()
    if maxis is not None:
        params_batch = maxis.split(params_batch)
    if mode == "lockstep":
        lp = make_lockstep_problem(problem, params_batch.shape[0], axis=maxis)
        sol = solve_dense(make_solver(lp), t_eval, params=params_batch,
                          max_steps=max_steps, device=dev)
        if maxis is not None:
            sol = _gather_solution(maxis, sol)
        return sol.replace(tier="lockstep")

    if mode == "independent":
        from .solvers import independent

        solver = make_solver(problem)
        if independent.takes(solver):
            sol = independent.solve_dense_independent(
                solver, t_eval, params_batch, max_steps=max_steps)
            return sol if maxis is None else _gather_solution(maxis, sol, with_state=True)
        # only a solver class other than BdfSolver, SdirkSolver or
        # ErkSolver, or augmented equations other than SensEquations, come
        # here: one eager solve a member
        sols = [
            solve_dense(solver, t_eval, params=params_batch[i],
                        max_steps=max_steps, device=dev)
            for i in range(params_batch.shape[0])
        ]
        sol = Solution(
            ts=sols[0].ts,
            ys=torch.stack([s.ys for s in sols], dim=1),
            gs=(None if sols[0].gs is None
                else torch.stack([s.gs for s in sols], dim=1)),
            sens=(None if sols[0].sens is None
                  else torch.stack([s.sens for s in sols], dim=2)),
            stop_reason=torch.tensor([s.stop_reason for s in sols], device=dev),
            n_points=sols[0].n_points,
            state=stack_states([s.state for s in sols]),
            root_t=torch.tensor([s.root_t for s in sols], dtype=F64, device=dev),
            root_idx=torch.tensor([s.root_idx for s in sols], device=dev),
            tier="independent",
        )
        # the stacked states' member axis is their leading one
        return sol if maxis is None else _gather_solution(maxis, sol, with_state=True)

    raise ValueError(f"unknown ensemble mode: {mode!r}")
