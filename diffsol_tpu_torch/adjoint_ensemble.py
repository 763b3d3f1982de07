"""Differentiable ensembles: gradients through lockstep and independent
solves (counterpart of ``diffsol_tpu.adjoint_ensemble``).

The reference's adjoint runs over its ``nbatch`` batched context
(crates/diffsol/src/ode_solver/adjoint.rs:13-159 with
crates/diffsol-la/src/context/mod.rs:20-51); the lockstep lift of
:mod:`diffsol_tpu_torch.adjoint`:

* the forward pass records a member-major (rows, B, n) step table; the
  members share one step sequence, so one host list of knot times serves
  every member's Hermite interpolant.  A banded forward problem runs its
  Newton solves through the band LU kernels on the card;
* the backward pass integrates the batched augmented adjoint system z =
  [lambda, g_p], (B, n + nparams), with the lockstep BDF machinery on a
  dense (B, N, N) Jacobian whatever the forward tier: the rhs is one
  ``torch.func.vjp`` of the lockstep rhs, the Jacobian the member
  [[J^T, 0], [f_p^T, 0]] vmapped over the members (the JAX package's
  ``_adjoint_problem_lockstep`` is ``adjoint._adjoint_problem`` on the
  lockstep problem here);
* the output jumps, the mass-transpose solves, the singular-mass partition,
  the reset-event corrections (with the forward's reset, ``reset_n``
  included) and the initial-condition correction are the single-member
  operators of :mod:`diffsol_tpu_torch.adjoint` vmapped over the members;
* gradients come out per member, (B, nparams).

The reference has no such capability: its adjoint is single-context.
``mode="independent"`` runs one batched forward and one batched backward
pass, each member with its own step sequences
(:mod:`diffsol_tpu_torch.adjoint_independent`).
"""

from __future__ import annotations

from typing import Optional

import torch

from .adjoint import (
    MAX_EVENTS,
    _backward,
    _bounded_segments,
    _dense_segments,
    _differentiable,
    _event_correction_core,
    _init_correction,
    _make_jump,
    _out_fn,
    _params_on,
    _passes,
    make_differentiable_solve,
)
from .drivers import resolve_device
from .ensemble import make_lockstep_problem
from .problem import OdeProblem
from .solvers.bdf import BdfSolver


def _make_event_correction_lockstep(base_problem, events, params_b, ct_g, out_fn):
    """``(lam, gp, slot) -> (lam, gp)``: the member correction
    (``adjoint._event_correction_core``) vmapped over the members.  A
    lockstep event has one time t* and one root index for all members
    (ops/rootfind: member 0's crossing); the states, params and cotangents
    are each member's."""
    core = _event_correction_core(base_problem.eqn, out_fn, ct_g is not None)
    ct_b = params_b.new_zeros((params_b.shape[0], 0)) if ct_g is None else ct_g

    def correct(lam, gp_rows, slot):
        t_star, k = events["t"][slot], events["idx"][slot]

        def member(lam1, gp1, y_m, dy_m, y_p, dy_p, p, cg):
            return core(lam1, gp1, t_star, y_m, dy_m, y_p, dy_p, k, p, cg)

        return torch.func.vmap(member)(
            lam, gp_rows, events["y_minus"][slot], events["dy_minus"][slot],
            events["y_plus"][slot], events["dy_plus"][slot], params_b, ct_b)

    return correct


def _lockstep_backward(base_problem, lockstep_problem, solver_cls, segments, events,
                       t_eval, ct_ys, params_b, max_steps, ct_g, info):
    jump_b = torch.func.vmap(_make_jump(base_problem), in_dims=(0, 0, 0, None, 0, 0))
    correct_b = _make_event_correction_lockstep(base_problem, events, params_b, ct_g,
                                                _out_fn(base_problem.eqn))
    lam0, gp = _backward(lockstep_problem, base_problem, solver_cls, segments, events,
                         t_eval, ct_ys, params_b, max_steps, ct_g, jump_b, correct_b,
                         {} if info is None else info)
    return torch.func.vmap(lambda p, l, g: _init_correction(base_problem, p, l, g))(
        params_b, lam0, gp)


def backward_pass_lockstep(base_problem, lockstep_problem, solver_cls, table, events,
                           t_eval, ct_ys, params_b, max_steps, ct_g=None, info=None):
    """The batched backward pass over all output times and reset events
    (dense-table mode).  ``ct_ys``: (neval, B, n); ``ct_g``: optional (B,
    nout) quadrature cotangent.  Returns the per-member gradients (B,
    nparams)."""
    return _lockstep_backward(base_problem, lockstep_problem, solver_cls,
                              _dense_segments(lockstep_problem, table), events, t_eval,
                              ct_ys, params_b, max_steps, ct_g, info)


def backward_pass_bounded_lockstep(base_problem, lockstep_problem, solver_cls,
                                   fwd_solver, ckpts, events, t_eval, ct_ys, params_b,
                                   max_steps, interval, ct_g=None, info=None):
    """The bounded-memory batched backward pass: the checkpoints top down,
    each segment re-solved by the lockstep forward solver (through the band
    LU kernels for a banded problem on the card) to rebuild its (rows, B,
    n) table; events re-found and corrected inside their segment."""
    info = {} if info is None else info
    return _lockstep_backward(
        base_problem, lockstep_problem, solver_cls,
        _bounded_segments(fwd_solver, ckpts, params_b, interval, MAX_EVENTS, info),
        events, t_eval, ct_ys, params_b, max_steps, ct_g, info)


def _sharded_passes(forward, backward, maxis, output):
    """The passes of a rank's block as the whole batch's: the forward pass
    takes the global params and returns the global output, the backward
    pass takes its global cotangent and returns the global gradient (the
    members on ys' axis 1, on the quadrature's and the params' axis 0)."""
    dim = 1 if output == "ys" else 0

    def forward_all(params, info):
        out, saved = forward(maxis.split(params), info)
        return maxis.gather(out, dim), saved

    def backward_all(saved, ct, info):
        return maxis.gather(backward(saved, maxis.split(ct, dim), info))

    return forward_all, backward_all


def _lockstep(problem, t_eval, nbatch, output, solver_cls, max_steps, bwd_solver_cls,
              bwd_max_steps, checkpoint_interval, device, who, mesh=None, axis="dp"):
    from .solvers.bdf import BdfSolver

    maxis = None
    if mesh is not None:
        from .sharding import MemberAxis, mesh_device

        device = mesh_device(mesh, device)
        maxis = MemberAxis.of(mesh, axis, nbatch)
    dev = resolve_device(device, who)
    base = problem.to(dev)
    # under a mesh the lockstep problem is the rank's block, and the
    # backward pass's adjoint problem (a replace of it) keeps its member axis
    lp = make_lockstep_problem(base, nbatch if maxis is None else maxis.local, axis=maxis)
    solver_cls = solver_cls or BdfSolver
    solver = solver_cls(lp)
    bwd_cls = bwd_solver_cls or solver_cls
    bwd_steps = bwd_max_steps or max_steps
    K = None if checkpoint_interval is None else int(checkpoint_interval)

    def backward_pass_of(store, ev, te, ct_ys, params_b, ct_g, info):
        if K is None:
            return backward_pass_lockstep(base, lp, bwd_cls, store, ev, te, ct_ys,
                                          params_b, bwd_steps, ct_g=ct_g, info=info)
        return backward_pass_bounded_lockstep(base, lp, bwd_cls, solver, store, ev, te,
                                              ct_ys, params_b, bwd_steps, K, ct_g=ct_g,
                                              info=info)

    forward, backward = _passes(solver, t_eval, output, base.eqn.nstates, max_steps,
                                MAX_EVENTS, K, backward_pass_of)
    if maxis is not None:
        forward, backward = _sharded_passes(forward, backward, maxis, output)
    return _differentiable(forward, backward, dev, who, nbatch=nbatch)


def make_differentiable_solve_ensemble(
    problem: OdeProblem,
    t_eval,
    nbatch: int,
    mode: str = "lockstep",
    solver_cls=None,
    max_steps: int = 16_384,
    bwd_solver_cls=None,
    bwd_max_steps: Optional[int] = None,
    checkpoint_interval: Optional[int] = None,
    device=None,
    mesh=None,
    axis: str = "dp",
):
    """Return ``ys_of(params_b) -> (neval, B, n)``, differentiable per member:
    the gradient of any scalar of the output is (B, nparams), from one
    batched adjoint solve (``mode="lockstep"``).  ``checkpoint_interval``
    selects the bounded-memory mode, as in
    :func:`~diffsol_tpu_torch.adjoint.make_differentiable_solve`.

    ``mode="independent"`` gives each member its own forward and backward
    step sequences in one batched forward and one batched backward pass
    (:func:`~diffsol_tpu_torch.adjoint_independent.make_independent`; as in
    the JAX package, this mode keeps the dense table whatever
    ``checkpoint_interval`` says).  Its ``ys_of.info`` is per member: the
    forward and backward ``Stats`` as (B,) counters, ``status`` and
    ``backward_status`` as (B,) tensors; a member whose backward solve
    fails has a NaN gradient, the others keep theirs.  A solver class
    other than ``BdfSolver`` calls the single-instance function once a
    member (its ``info`` the last member's).  ``device`` as in
    ``make_differentiable_solve``: the card unless the caller asks for the
    CPU; ``params_b`` (B, nparams) must lie there.

    ``mesh`` and ``axis`` shard the gradient's members over a
    ``DeviceMesh`` dimension, as :func:`~.ensemble.solve_dense_ensemble`'s
    do: every rank calls ``ys_of`` with the global params and gets the
    global ys, and ``.backward()`` gives it the global gradient.  In
    lockstep the forward and the backward adjoint solve are each one joint
    lockstep solve over the whole axis; ``mode="independent"`` runs both
    batched passes on the rank's block with no collective and gathers ys,
    the gradient and ``info``'s per-member entries (a BdfSolver only).
    """
    who = "make_differentiable_solve_ensemble"
    bdf_only = (solver_cls or BdfSolver) is BdfSolver and (
        bwd_solver_cls or solver_cls or BdfSolver) is BdfSolver
    if mesh is not None and not (mode == "lockstep" or (mode == "independent" and bdf_only)):
        raise NotImplementedError(
            f"{who}: mode={mode!r} with solver_cls={solver_cls!r} over a mesh is not "
            "ported; mode='lockstep', and mode='independent' with BdfSolver, are")
    if mode == "independent" and bdf_only:
        from .adjoint_independent import make_independent

        maxis = None
        if mesh is not None:
            from .sharding import MemberAxis, mesh_device

            device = mesh_device(mesh, device)
            maxis = MemberAxis.of(mesh, axis, nbatch)
        return make_independent(problem, t_eval, nbatch, max_steps, bwd_max_steps,
                                resolve_device(device, who), who, maxis)
    if mode == "independent":
        # another solver class: its single-instance function once a member
        dev = resolve_device(device, who)
        one = make_differentiable_solve(problem, t_eval, solver_cls=solver_cls,
                                        max_steps=max_steps, bwd_solver_cls=bwd_solver_cls,
                                        bwd_max_steps=bwd_max_steps, device=dev)

        def ys_of(params_b):
            params_b = _params_on(params_b, dev, who, nbatch)
            return torch.stack([one(params_b[i]) for i in range(nbatch)], dim=1)

        ys_of.info = one.info
        return ys_of
    if mode != "lockstep":
        raise ValueError(f"unknown ensemble mode: {mode!r}")
    return _lockstep(problem, t_eval, nbatch, "ys", solver_cls, max_steps, bwd_solver_cls,
                     bwd_max_steps, checkpoint_interval, device, who, mesh, axis)


def make_differentiable_quadrature_ensemble(
    problem: OdeProblem,
    t_final,
    nbatch: int,
    solver_cls=None,
    max_steps: int = 16_384,
    bwd_solver_cls=None,
    bwd_max_steps: Optional[int] = None,
    checkpoint_interval: Optional[int] = None,
    device=None,
):
    """Return ``g_of(params_b) -> (B, nout)``: each member's quadrature G_b
    = int u(t, y_b, p_b) dt, differentiable through the batched continuous
    adjoint with the u_y^T forcing (the lockstep lift of
    :func:`~diffsol_tpu_torch.adjoint.make_differentiable_quadrature`)."""
    if not problem.integrate_out:
        raise ValueError("make_differentiable_quadrature_ensemble needs a problem built "
                         "with .integrate_out()")
    return _lockstep(problem, [float(t_final)], nbatch, "g", solver_cls, max_steps,
                     bwd_solver_cls, bwd_max_steps, checkpoint_interval, device,
                     "make_differentiable_quadrature_ensemble")
