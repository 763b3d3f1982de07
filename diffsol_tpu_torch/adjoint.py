"""Adjoint sensitivities: the backward pass and ``torch.autograd`` support
(counterpart of ``diffsol_tpu.adjoint``; reference
crates/diffsol/src/ode_solver/adjoint.rs:13-260
`solve_adjoint_backwards_pass`, adjoint_equations.rs, checkpointing.rs).

After a forward solve, the adjoint system

    lambda' = -J(x(t), t)^T lambda,      lambda(T) = 0,
    discrete jumps  lambda += dG/dy_i    at each output time t_i,
    gradient        dG/dp = int lambda^T f_p dt + lambda(t0)^T dy0/dp

is integrated backward in sigma = T - t, interpolating the forward
trajectory x(t) with a cubic Hermite interpolant.  Two storage modes, as in
the JAX package:

* **dense table** (default): (t, y, dy) at every accepted forward step, two
  knots at each reset event (the pre- and post-event states).  Where the
  JAX package preallocates ``max_steps + 2 max_events + 1`` rows, the port
  records only the steps taken and stacks them once; the knots' times stay
  a host list of floats, so the interval lookup of every adjoint rhs call
  is a ``bisect``.
* **bounded memory** (``checkpoint_interval=K``): the full solver state
  every K accepted steps; the backward pass re-solves each segment from its
  checkpoint to rebuild that segment's table (reference checkpointing.rs:
  91-250, method.rs:620-705).  A banded forward problem re-solves through
  its band LU kernels on the card.

The backward integration runs the BDF solver on the time-reversed augmented
system z = [lambda, g_p] (n + nparams states, always on the dense tier),
one segment per boundary, with the output jump or the reset-event
correction applied between segments and the solver restarted at order 1.
Its time axis lives on the host: the adjoint problem's ``t0`` is a CPU
scalar, so the solver hands the adjoint callables CPU scalars and reading
one costs no device sync.  The adjoint Jacobian [[J^T, 0], [f_p^T, 0]] comes
from one ``torch.func.jacfwd`` of the rhs in y and p, the rhs from one
``torch.func.vjp``.

:func:`make_differentiable_solve` and :func:`make_differentiable_quadrature`
wrap a forward and a backward pass in a ``torch.autograd.Function``, so
``loss.backward()`` or ``torch.autograd.grad`` of any scalar of the solution
runs the adjoint (the JAX package's ``jax.custom_vjp``).  A fatal forward
status turns the outputs and the gradient into NaN, and so does a fatal
status of the backward solve (which the JAX package steps past).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from . import errors
from .drivers import _apply_reset, _pin_to, resolve_device
from .equations import OdeEquations
from .ops.linsol import DENSE
from .problem import OdeProblem
from .solvers.consistent_ic import algebraic_mask

F64 = torch.float64
MAX_EVENTS = 32  # default capacity of the reset-event record


class Table(NamedTuple):
    """The forward trajectory's Hermite knots: ``ts`` a host list of floats,
    ``ys`` and ``dys`` (rows, *y.shape)."""

    ts: list
    ys: torch.Tensor
    dys: torch.Tensor

    def nbytes(self) -> int:
        return self.ys.numel() * self.ys.element_size() * 2 + 8 * len(self.ts)


# --------------------------------------------------------------------------
# forward pass with step-table or checkpoint recording
# --------------------------------------------------------------------------


def _empty_events():
    """The reset-event record: per event its time t*, the pre- and
    post-event states and derivatives, and the fired root's index."""
    return dict(t=[], y_minus=[], dy_minus=[], y_plus=[], dy_plus=[], idx=[],
                count=0)


@dataclasses.dataclass
class _Forward:
    state: object  # the final solver state
    ys: Optional[torch.Tensor]
    table: Optional[Table]
    events: dict
    ck_ts: list
    ck_states: list


def _forward(solver, state, params, final_time, max_steps, max_events,
             t_eval=None, table=True, interval=None) -> _Forward:
    """Step ``state`` to ``final_time`` under the reset protocol (JAX
    adjoint.py:105-189), recording what the caller asks for: ``ys`` at
    ``t_eval``, the table's knots (two at each event) and every
    ``interval``-th accepted state (post-reset at an event, so that a
    re-solve continues from exactly the state the forward continued from).
    Overflowing ``max_events`` is the typed failure EVENT_CAPACITY_EXCEEDED:
    a dropped event would make the backward pass skip its correction."""
    p = solver.problem
    has_reset = p.eqn.root is not None and p.eqn.reset is not None
    max_ev = max_events if has_reset else 0
    state = solver.set_stop_time(state, final_time)
    te = [] if t_eval is None else t_eval
    ys = None if t_eval is None else state.y.new_zeros((len(te),) + tuple(state.y.shape))
    knots = [(state.t, state.y, state.dy)] if table else None
    ev = _empty_events()
    ck_ts, ck_states = [state.t], [state]
    written = 0
    k = 0
    done = state.status < 0
    while not done and k < max_steps:
        new = solver.step(state, params)
        status = new.status
        fatal = status < 0
        is_tstop = status == errors.TSTOP_REACHED
        is_root = has_reset and status == errors.ROOT_FOUND
        if not fatal:
            t_upper = new.root_t if is_root else new.t
            if is_tstop:
                t_upper = max(new.t, final_time)
            while written < len(te) and te[written] <= t_upper:
                ys[written] = solver.interpolate(new, te[written])
                written += 1
        if is_root:
            pinned = _pin_to(solver, new, new.root_t)
            after = _apply_reset(solver, pinned, params)
            if ev["count"] < max_ev:
                for key, v in (("t", pinned.t), ("y_minus", pinned.y),
                               ("dy_minus", pinned.dy), ("y_plus", after.y),
                               ("dy_plus", after.dy), ("idx", new.root_idx)):
                    ev[key].append(v)
                ev["count"] += 1
                if table:
                    knots += [(pinned.t, pinned.y, pinned.dy), (after.t, after.y, after.dy)]
            else:
                after = dataclasses.replace(after, status=errors.EVENT_CAPACITY_EXCEEDED)
            new = after
            fatal = fatal or new.status < 0
            done = fatal or is_tstop or new.t >= final_time
        else:
            if table and not fatal:
                knots.append((new.t, new.y, new.dy))
            done = fatal or is_tstop
        if interval and not fatal and not done and (k + 1) % interval == 0:
            ck_ts.append(new.t)
            ck_states.append(new)
        # a failed step returns the old state with its status
        state = new
        k += 1
    if interval:
        # the end state closes the last segment
        ck_ts.append(state.t)
        ck_states.append(state)
    tab = None
    if table:
        tab = Table([kn[0] for kn in knots], torch.stack([kn[1] for kn in knots]),
                    torch.stack([kn[2] for kn in knots]))
    return _Forward(state=state, ys=ys, table=tab, events=ev, ck_ts=ck_ts,
                    ck_states=ck_states)


def _poisoned(fw: _Forward):
    """(ys, g) with NaN for a fatal status, so that it can never flow
    silently into gradients."""
    bad = fw.state.status < 0
    ys, g = fw.ys, fw.state.g
    if bad:
        ys = torch.full_like(ys, math.nan)
        g = torch.full_like(g, math.nan)
    return ys, g


def forward_with_table(solver, t_eval, params, max_steps: int,
                       max_events: int = MAX_EVENTS):
    """``solve_dense`` that records (t, y, dy) at every accepted step (the
    dense-storage analog of the reference's CheckpointingRecorder,
    method.rs:620-705).

    Returns ``(ys, g, table, events, state)``: ``table`` a :class:`Table`
    of accepted steps + 1 + 2 per event rows, ``events`` the reset-event
    record (``t`` and ``idx`` host lists, the states lists of tensors,
    ``count``), ``state`` the final solver state (its ``status`` is the
    JAX package's fifth result).  The state is (n,) for one instance and
    member-major (B, n) for a lockstep ensemble, and the table's rows
    follow it."""
    fw = _forward(solver, solver.init_state(params), params, float(t_eval[-1]),
                  max_steps, max_events, t_eval=list(t_eval))
    ys, g = _poisoned(fw)
    return ys, g, fw.table, fw.events, fw.state


def forward_with_checkpoints(solver, t_eval, params, max_steps: int,
                             interval: int, max_events: int = MAX_EVENTS):
    """The bounded-memory forward pass: the full solver state every
    ``interval`` accepted steps instead of the step table (reference
    Checkpointing, checkpointing.rs:91-250).

    Returns ``(ys, g, (ck_ts, ck_states, n_ck), events, state)``; segment s
    spans [ck_ts[s], ck_ts[s+1]] for s < n_ck - 1."""
    fw = _forward(solver, solver.init_state(params), params, float(t_eval[-1]),
                  max_steps, max_events, t_eval=list(t_eval), table=False,
                  interval=int(interval))
    ys, g = _poisoned(fw)
    return ys, g, (fw.ck_ts, fw.ck_states, len(fw.ck_ts)), fw.events, fw.state


def _record_segment(solver, state0, t_end, params, seg_steps: int,
                    max_events: int = MAX_EVENTS) -> Table:
    """Re-solve [state0.t, t_end] from a checkpoint, recording its table
    (reference checkpointing.rs:91-119).  Events inside the segment are
    re-found and re-applied, with double knots as in
    :func:`forward_with_table`."""
    state0 = dataclasses.replace(state0, status=errors.INTERNAL_TIMESTEP)
    return _forward(solver, state0, params, float(t_end), seg_steps, max_events).table


def hermite_interp(table: Table, t: float):
    """Cubic Hermite interpolation of the forward trajectory at the host time
    ``t`` (reference HermiteInterpolator, checkpointing.rs:16-90).  At a
    double knot (an event) and past the last knot it returns the left knot,
    as the JAX package's padded table does."""
    ts, ys, dys = table
    k = bisect.bisect_right(ts, t)
    if k >= len(ts):
        return ys[-1]
    k = max(k, 1)
    t0 = ts[k - 1]
    dt = ts[k] - t0
    if dt == 0.0:
        return ys[k - 1]
    theta = (t - t0) / dt
    h00 = (1.0 + 2.0 * theta) * (1.0 - theta) ** 2
    h10 = theta * (1.0 - theta) ** 2
    h01 = theta**2 * (3.0 - 2.0 * theta)
    h11 = theta**2 * (theta - 1.0)
    return (h00 * ys[k - 1] + h10 * dt * dys[k - 1] + h01 * ys[k]
            + h11 * dt * dys[k])


# --------------------------------------------------------------------------
# backward pass
# --------------------------------------------------------------------------


def _out_fn(eqn):
    """The quadrature's integrand u(t, y, p): ``out``, or the state."""
    return eqn.out if eqn.out is not None else (lambda tt, yy, pp: yy)


def _adjoint_problem(problem: OdeProblem, t_top: float, nparams: int,
                     table_ref: list, ct_g=None, base: OdeProblem = None):
    """The time-reversed augmented adjoint problem in sigma = t_top - t.

    State z = [lambda (n), g_p (nparams)], (N,) or member-major (B, N):
        M^T dlambda/dsigma = +J(x(t))^T lambda [+ u_y(x)^T ct_g]
        dg_p/dsigma        = +f_p(x(t))^T lambda [+ u_p(x)^T ct_g]
    (adjoint_equations.rs:330-360 AdjointRhs, :377-460 AdjointOut).  x(t)
    is interpolated from ``table_ref[0]``, which the bounded mode swaps
    for each segment's table (where the JAX package packs it into the
    params vector).  ``problem`` is the forward solve's (a lockstep problem
    for an ensemble, whose callables act on all members); ``base`` its
    single-member problem, whose rhs the Jacobian probes.  The mass becomes
    blockdiag(M^T, I) (AdjointMass, adjoint_equations.rs:142-200); a
    singular M makes lambda's algebraic rows algebraic, made consistent by
    the solver as on the forward problem.
    """
    base = problem if base is None else base
    eqn = problem.eqn
    n = base.eqn.nstates
    N = n + nparams
    batched = problem.params.ndim == 2
    out_fn = _out_fn(eqn)
    member_jac = torch.func.jacfwd(base.eqn.rhs, argnums=(1, 2))
    if batched:
        member_jac = torch.func.vmap(member_jac, in_dims=(None, 0, 0))

    def at(sigma, like):
        """(t as a device scalar, x(t))."""
        t = t_top - float(sigma)
        x = hermite_interp(table_ref[0], t)
        return like.new_tensor(t), x

    # the last point's pullbacks: Newton evaluates the rhs several times at
    # one time and table, and a vjp function may be applied again
    last = [None]

    def pullbacks(sigma, z, params):
        key = (float(sigma), table_ref[0], params)
        hit = last[0]
        if hit is not None and hit[0][0] == key[0] and all(
                a is b for a, b in zip(hit[0][1:], key[1:])):
            return hit[1]
        tt, x = at(sigma, z)
        _, vjp = torch.func.vjp(lambda yy, pp: eqn.rhs(tt, yy, pp), x, params)
        vjp_u = None
        if ct_g is not None and eqn.out is not None:
            _, vjp_u = torch.func.vjp(lambda yy, pp: out_fn(tt, yy, pp), x, params)
        last[0] = (key, (vjp, vjp_u))
        return vjp, vjp_u

    def rhs(sigma, z, params):
        vjp, vjp_u = pullbacks(sigma, z, params)
        dlam, dgp = vjp(z[..., :n].contiguous())
        if ct_g is not None:
            if eqn.out is None:  # u = y
                dlam = dlam + ct_g
            else:
                du, dup = vjp_u(ct_g)
                dlam, dgp = dlam + du, dgp + dup
        return torch.cat([dlam, dgp], dim=-1)

    def rhs_jac(sigma, z, params):
        # [[J^T, 0], [f_p^T, 0]]: the ct_g terms do not depend on z
        tt, x = at(sigma, z)
        jy, jp = member_jac(tt, x, params)
        out = z.new_zeros(z.shape[:-1] + (N, N))
        out[..., :n, :n] = jy.transpose(-1, -2)
        out[..., n:, :n] = jp.transpose(-1, -2)
        return out

    def init(sigma, params):
        return params.new_zeros(params.shape[:-1] + (N,))

    adj_mass = None
    if eqn.mass is not None:
        last_mass = [None]

        def adj_mass(sigma, params):
            hit = last_mass[0]
            if hit is not None and hit[0] == float(sigma) and hit[1] is params:
                return hit[2]
            m_t = eqn.mass(params.new_tensor(t_top - float(sigma)), params)
            out = torch.eye(N, dtype=F64, device=params.device).expand(
                params.shape[:-1] + (N, N)).clone()
            out[..., :n, :n] = m_t.transpose(-1, -2)
            last_mass[0] = (float(sigma), params, out)
            return out

    adj_eqn = OdeEquations(rhs=rhs, init=init, mass=adj_mass, rhs_jac=rhs_jac,
                           nstates=N, nparams=nparams)
    # the g_p rows' absolute tolerance: param_atol (scaled by param_scales)
    # when set (reference adjoint_equations.rs:580-581), else the mean
    # state atol
    if base.param_atol is not None:
        gp_atol = base.param_atol
        if base.param_scales is not None:
            gp_atol = gp_atol * base.param_scales
    else:
        gp_atol = base.atol.mean().expand(nparams)
    # the adjoint's Jacobian is dense whatever the forward problem's tier
    # (its band or block spec is shaped for n, not n + nparams)
    return dataclasses.replace(
        problem,
        eqn=adj_eqn,
        atol=torch.cat([base.atol, gp_atol.to(base.atol.device)]),
        t0=torch.tensor(0.0, dtype=F64),
        h0=torch.tensor(0.0, dtype=F64),
        integrate_out=False,
        linear_solver=DENSE,
    )


def _time_like(x, t):
    """A host time as a scalar tensor beside ``x``; a tensor (a member's
    time under ``vmap``) as it is."""
    return t if isinstance(t, torch.Tensor) else x.new_tensor(t)


def _make_jump(problem):
    """Discrete output-jump operator ``(lam, gp, v, t, x, params) -> (lam,
    gp)`` of one member.

    Identity mass: lam += v.  Regular mass: lam += M^{-T} v.  Singular-mass
    DAE: the differential/algebraic partition lambda_d += M_dd^{-1}(v_d -
    A_da A_aa^{-1} v_a), A = f_y^T, plus the parameter term -f_{p,a}^T
    A_aa^{-1} v_a (reference adjoint.rs:292-366
    apply_delta_g_out_mass_alg).  ``x`` is the forward state at t.  A
    lockstep ensemble vmaps it over the members.
    """
    eqn = problem.eqn
    alg = algebraic_mask(problem) if eqn.mass is not None else None

    if eqn.mass is None:
        def jump(lam, gp_rows, v, t, x, params):
            return lam + v, gp_rows
    elif alg is None:
        def jump(lam, gp_rows, v, t, x, params):
            m_t = eqn.mass(_time_like(x, t), params).transpose(-1, -2)
            return lam + torch.linalg.solve(m_t, v), gp_rows
    else:
        diff = ~alg
        eye_d = torch.diag(diff.to(F64))
        eye_a = torch.diag(alg.to(F64))

        def jump(lam, gp_rows, v, t, x, params):
            tt = _time_like(x, t)
            A = torch.func.jacfwd(lambda yy: eqn.rhs(tt, yy, params))(x).T
            Ap = torch.where(alg[:, None] & alg[None, :], A, 0.0) + eye_d
            va = torch.linalg.solve(Ap, torch.where(alg, v, 0.0))
            va = torch.where(alg, va, 0.0)
            w = torch.where(alg, 0.0, v - A @ va)
            m_t = eqn.mass(tt, params).T
            Mp = torch.where(diff[:, None] & diff[None, :], m_t, 0.0) + eye_a
            lam = lam + torch.where(alg, 0.0, torch.linalg.solve(Mp, w))
            # the parameter contribution of the algebraic constraint
            _, vjp_p = torch.func.vjp(lambda pp: eqn.rhs(tt, x, pp), params)
            return lam, gp_rows - vjp_p(va)[0]

    return jump


def _event_correction_core(eqn, out_fn, with_ct_g: bool):
    """The reset-event adjoint boundary correction of one member:

        lambda- = R_y^T lambda+ - alpha r_{y,k}^T,
        gp     += R_p^T lambda+ - alpha r_{p,k}^T,
        alpha   = (lambda+ . c + (u- - u+) . ct_g) / d,
        c = R_y f- + R_t - f+,   d = (r_y f- + r_t)_k

    (reference adjoint.rs:106-148, state.rs:560-692
    apply_reset_with_adjoint).  The root index ``k`` (a host int) is one
    for all the members corrected together, and ``t_star`` too in a
    lockstep event (a host float); the rest is one member's, so an ensemble
    vmaps it (the independent one over ``t_star`` as well, a tensor)."""

    def correct1(lam, gp_rows, t_star, y_m, dy_m, y_p, dy_p, k, params, ct_g_m):
        ts = _time_like(y_m, t_star)
        if eqn.reset_n is not None:
            def reset(tt, yy, pp):
                return eqn.reset_n(tt, yy, pp, k)
        else:
            reset = eqn.reset
        one = torch.ones_like(ts)
        R_t = torch.func.jvp(lambda tt: reset(tt, y_m, params), (ts,), (one,))[1]
        r_t = torch.func.jvp(lambda tt: eqn.root(tt, y_m, params), (ts,), (one,))[1]
        c_dir = (torch.func.jvp(lambda yy: reset(ts, yy, params), (y_m,), (dy_m,))[1]
                 + R_t - dy_p)
        d = (torch.func.jvp(lambda yy: eqn.root(ts, yy, params), (y_m,), (dy_m,))[1]
             + r_t)[k]
        alpha_num = torch.sum(lam * c_dir)
        if with_ct_g:
            alpha_num = alpha_num + torch.sum(
                (out_fn(ts, y_m, params) - out_fn(ts, y_p, params)) * ct_g_m)
        alpha = alpha_num / d
        onehot = torch.zeros(eqn.nroots, dtype=F64, device=y_m.device)
        onehot[k] = 1.0
        e_k = alpha * onehot
        _, vjp_R = torch.func.vjp(lambda yy, pp: reset(ts, yy, pp), y_m, params)
        _, vjp_r = torch.func.vjp(lambda yy, pp: eqn.root(ts, yy, pp), y_m, params)
        R_y, R_p = vjp_R(lam)
        r_y, r_p = vjp_r(e_k)
        return R_y - r_y, gp_rows + R_p - r_p

    return correct1


def _make_event_correction(problem, events, params, ct_g, out_fn):
    """``(lam, gp, slot) -> (lam, gp)``: :func:`_event_correction_core`
    bound to the recorded events of a single-instance solve."""
    core = _event_correction_core(problem.eqn, out_fn, ct_g is not None)

    def correct(lam, gp_rows, slot):
        return core(lam, gp_rows, events["t"][slot], events["y_minus"][slot],
                    events["dy_minus"][slot], events["y_plus"][slot],
                    events["dy_plus"][slot], events["idx"][slot], params, ct_g)

    return correct


def _make_reinit(solver, adj_problem):
    """Mark the state modified (the next step restarts at order 1) and
    restore a DAE's consistency of the lambda rows."""

    def reinit(state, params):
        state = dataclasses.replace(state, state_modified=True)
        if hasattr(solver, "reinit_after_reset"):
            return solver.reinit_after_reset(state, params)
        return dataclasses.replace(state, dy=adj_problem.eqn.rhs(
            adj_problem.t0.new_tensor(state.t), state.y, params))

    return reinit


def _integrate_to(solver, state, target_sigma: float, params, max_steps: int):
    """Advance the adjoint solver to ``target_sigma`` (no-op if it is there
    already)."""
    if not target_sigma > state.t:
        return state
    state = solver.set_stop_time(
        dataclasses.replace(state, status=errors.INTERNAL_TIMESTEP), target_sigma)
    k = 0
    while state.status == errors.INTERNAL_TIMESTEP and k < max_steps:
        state = solver.step(state, params)
        k += 1
    return state


def _boundary_schedule(t_eval, events):
    """The output times and the recorded reset events merged, descending in
    t: ``[(t, kind, slot)]``, kind 0 an output jump (slot into t_eval), 1
    an event correction (slot into events).  The sort is stable, so at a
    shared time the output jump comes first, as in the JAX package."""
    bt = [(float(t), 0, i) for i, t in enumerate(t_eval)]
    bt += [(float(t), 1, i) for i, t in enumerate(events["t"])]
    return sorted(bt, key=lambda b: -b[0])


def _backward(problem, base, solver_cls, segments, events, t_eval, ct_ys,
              params, max_steps, ct_g, jump, correct, info):
    """The backward pass over ``segments``, top down: each ``(lower, upper,
    t_start, make_table)`` installs its table, integrates through the
    boundaries in (lower, upper] with their jumps and corrections, then to
    its start time.  Returns the final adjoint state (lambda(t0), g_p); the
    dense mode is one segment, the bounded mode one a checkpoint interval.

    A fatal status of the backward solve ends the pass with a NaN state and
    the status in ``info["backward_status"]``.  (The JAX package's
    ``_integrate_to`` resets the status and steps on from the failed state,
    so its gradient comes out finite and wrong: ROADMAP.md queue 3.)"""
    n = base.eqn.nstates
    nparams = base.eqn.nparams
    t_top = float(t_eval[-1])
    table_ref = [None]
    adj = _adjoint_problem(problem, t_top, nparams, table_ref, ct_g=ct_g, base=base)
    solver = solver_cls(adj)
    reinit = _make_reinit(solver, adj)
    schedule = _boundary_schedule(t_eval, events)
    state = None
    failed = None

    def integrate(state, target):
        nonlocal failed
        state = _integrate_to(solver, state, target, params, max_steps)
        if state.status < 0 and failed is None:
            failed = state.status
        return state

    for lower, upper, t_start, make_table in segments:
        table_ref[0] = make_table()
        if state is None:
            # the initial step-size probe reads the top segment's table
            state = solver.init_state(params)
        for t_b, kind, slot in schedule:
            if failed is not None or not lower < t_b <= upper:
                continue
            state = integrate(state, t_top - t_b)
            lam, gp_rows = state.y[..., :n], state.y[..., n:]
            if kind == 0:
                x = hermite_interp(table_ref[0], t_top - state.t)
                lam, gp_rows = jump(lam, gp_rows, ct_ys[slot], t_top - state.t, x, params)
            else:
                lam, gp_rows = correct(lam, gp_rows, slot)
            state = reinit(dataclasses.replace(
                state, y=torch.cat([lam, gp_rows], dim=-1)), params)
        if failed is not None:
            break
        state = integrate(state, t_top - t_start)
    info["backward"] = dataclasses.replace(state.stats)
    info["backward_status"] = state.status if failed is None else failed
    y = state.y if failed is None else torch.full_like(state.y, math.nan)
    return y[..., :n], y[..., n:]


def _dense_segments(problem, table):
    return [(-math.inf, math.inf, float(problem.t0), lambda: table)]


def _bounded_segments(fwd_solver, ckpts, params, interval, max_events, info):
    """One segment a checkpoint interval, top down; each re-solves its
    table when the backward pass reaches it (``info["resolve_steps"]``
    counts the re-solves' steps)."""
    ck_ts, ck_states, n_ck = ckpts
    seg_steps = interval + 4  # margin for the tstop-truncated last step
    info["resolve_steps"] = 0

    def table(s):
        tab = _record_segment(fwd_solver, ck_states[s], ck_ts[s + 1], params, seg_steps,
                              max_events)
        # a step adds one knot time (an event's two knots share theirs)
        info["resolve_steps"] += sum(a != b for a, b in zip(tab.ts, tab.ts[1:]))
        return tab

    return [(-math.inf if s == 0 else ck_ts[s], math.inf if s == n_ck - 2 else ck_ts[s + 1],
             ck_ts[s], lambda s=s: table(s)) for s in range(n_ck - 2, -1, -1)]


def _init_correction(problem, params, lam0, gp):
    """Initial-condition correction (adjoint.rs:151-156 correct_sg_for_init):
    dG/dp += (dy0/dp)^T M^T lambda(t0) (M from the Lagrangian term
    lambda^T (M y' - f); identity without a mass; a singular M zeroes the
    algebraic rows)."""
    eqn = problem.eqn
    if eqn.mass is not None:
        lam0 = eqn.mass(problem.t0, params).T @ lam0
    y0_p = torch.func.jacfwd(lambda pp: eqn.init(problem.t0, pp))(params)  # (n, np)
    return gp + y0_p.T @ lam0


def backward_pass(problem, solver_cls, table, events, t_eval, ct_ys, params,
                  max_steps, ct_g=None, info=None):
    """Integrate the adjoint backward through all output times and reset
    events (dense-table mode).  ``ct_ys``: (neval, n) cotangents dG/dy(t_i);
    ``ct_g``: optional (nout,) cotangent of the quadrature G = int u dt.
    Returns dG/dp (nparams,)."""
    eqn = problem.eqn
    lam0, gp = _backward(
        problem, problem, solver_cls, _dense_segments(problem, table), events, t_eval,
        ct_ys, params, max_steps, ct_g, _make_jump(problem),
        _make_event_correction(problem, events, params, ct_g, _out_fn(eqn)),
        {} if info is None else info)
    return _init_correction(problem, params, lam0, gp)


def backward_pass_bounded(problem, solver_cls, fwd_solver, ckpts, events,
                          t_eval, ct_ys, params, max_steps, interval,
                          ct_g=None, max_events=MAX_EVENTS, info=None):
    """The bounded-memory backward pass (reference checkpointing.rs:91-250,
    method.rs:620-705 segment re-solve): the checkpoints top down, each
    segment re-solved forward from its state to rebuild its table; output
    jumps and event corrections fire in the segment that holds them."""
    eqn = problem.eqn
    info = {} if info is None else info
    lam0, gp = _backward(
        problem, problem, solver_cls,
        _bounded_segments(fwd_solver, ckpts, params, interval, max_events, info), events,
        t_eval, ct_ys, params, max_steps, ct_g, _make_jump(problem),
        _make_event_correction(problem, events, params, ct_g, _out_fn(eqn)), info)
    return _init_correction(problem, params, lam0, gp)


# --------------------------------------------------------------------------
# torch.autograd.Function wrappers
# --------------------------------------------------------------------------


def _params_on(params, dev, who, nbatch=None):
    """The caller's params as float64 on the solve's device, (nbatch,
    nparams) for an ensemble; a tensor on another device raises, as a state
    does in ``drivers._prepare``."""
    if not isinstance(params, torch.Tensor):
        params = torch.as_tensor(params, dtype=F64, device=dev)
    if params.dtype != F64:
        raise TypeError(f"{who}: params must be float64, got {params.dtype}")
    if params.device != dev:
        raise ValueError(f"{who}: params lie on {params.device}, the solve on {dev}")
    if nbatch is not None and (params.ndim != 2 or params.shape[0] != nbatch):
        raise ValueError(f"{who}: params of shape {tuple(params.shape)} for "
                         f"nbatch={nbatch}")
    return params


def _differentiable(forward, backward, dev, who, nbatch=None):
    """The callable ``params -> output`` of a ``torch.autograd.Function``:
    ``forward(params, info) -> (output, saved)`` keeps the table or the
    checkpoints and the event record, ``backward(saved, ct, info)`` returns
    dL/dp.  ``info`` (the callable's ``info`` attribute) holds the last
    call's forward and backward ``Stats``, status and table bytes."""
    info = {}

    class Adjoint(torch.autograd.Function):
        @staticmethod
        def forward(ctx, params):
            out, ctx.saved = forward(params.detach(), info)
            return out

        @staticmethod
        @once_differentiable
        def backward(ctx, ct):
            return backward(ctx.saved, ct.contiguous(), info)

    def call(params):
        return Adjoint.apply(_params_on(params, dev, who, nbatch))

    call.info = info
    return call


def _passes(solver, t_eval, output, nstates, max_steps, max_events, interval,
            backward_pass_of):
    """The forward and backward of a ``make_differentiable_*``: ``output``
    "ys" returns ys (and takes their cotangent), "g" the quadrature (whose
    cotangent forces the adjoint, with zero output jumps).
    ``backward_pass_of(store, events, t_eval, ct_ys, params, ct_g, info)``
    runs the backward pass on the table or checkpoints.  A fatal forward
    status gives a NaN gradient without a backward solve."""
    te = [float(t) for t in t_eval]

    def forward(params, info):
        if interval is None:
            ys, g, store, ev, state = forward_with_table(solver, te, params, max_steps,
                                                         max_events)
            info["table_bytes"] = store.nbytes()
        else:
            ys, g, store, ev, state = forward_with_checkpoints(
                solver, te, params, max_steps, interval, max_events)
            info["checkpoints"] = store[2]
        info["forward"] = dataclasses.replace(state.stats)
        info["status"] = state.status
        return (ys if output == "ys" else g), (params, store, ev, state.status)

    def backward(saved, ct, info):
        params, store, ev, status = saved
        if status < 0:
            return torch.full_like(params, math.nan)
        if output == "ys":
            ct_ys, ct_g = ct, None
        else:
            ct_ys = params.new_zeros((1,) + tuple(params.shape[:-1]) + (nstates,))
            ct_g = ct
        return backward_pass_of(store, ev, te, ct_ys, params, ct_g, info)

    return forward, backward


def _single(problem, t_eval, output, solver_cls, max_steps, bwd_solver_cls,
            bwd_max_steps, checkpoint_interval, max_events, device, who):
    from .solvers.bdf import BdfSolver

    dev = resolve_device(device, who)
    problem = problem.to(dev)
    solver_cls = solver_cls or BdfSolver
    solver = solver_cls(problem)
    bwd_cls = bwd_solver_cls or solver_cls
    bwd_steps = bwd_max_steps or max_steps
    K = None if checkpoint_interval is None else int(checkpoint_interval)

    def backward_pass_of(store, ev, te, ct_ys, params, ct_g, info):
        if K is None:
            return backward_pass(problem, bwd_cls, store, ev, te, ct_ys, params,
                                 bwd_steps, ct_g=ct_g, info=info)
        return backward_pass_bounded(problem, bwd_cls, solver, store, ev, te, ct_ys,
                                     params, bwd_steps, K, ct_g=ct_g,
                                     max_events=max_events, info=info)

    forward, backward = _passes(solver, t_eval, output, problem.eqn.nstates, max_steps,
                                max_events, K, backward_pass_of)
    return _differentiable(forward, backward, dev, who)


def make_differentiable_solve(
    problem: OdeProblem,
    t_eval,
    solver_cls=None,
    max_steps: int = 16_384,
    bwd_solver_cls=None,
    bwd_max_steps: Optional[int] = None,
    checkpoint_interval: Optional[int] = None,
    max_events: int = MAX_EVENTS,
    device=None,
):
    """Return ``ys_of(params) -> (neval, n)``, differentiable by the adjoint:
    ``loss(ys_of(p)).backward()`` or ``torch.autograd.grad`` runs the
    backward pass and gives dL/dp (nparams,).

    ``checkpoint_interval=K`` selects the bounded-memory mode: the forward
    pass keeps the full solver state every K accepted steps instead of the
    step table, and the backward pass re-solves each segment (reference
    Checkpointing, checkpointing.rs:91-250).  ``max_events`` bounds the
    reset-event record; overflowing it fails loudly (NaN outputs and
    gradient, status errors.EVENT_CAPACITY_EXCEEDED in ``ys_of.info``).
    ``device``: None means the card, and raises without one; pass
    ``device="cpu"`` for the CPU.  ``params`` must lie there.
    """
    return _single(problem, t_eval, "ys", solver_cls, max_steps, bwd_solver_cls,
                   bwd_max_steps, checkpoint_interval, max_events, device,
                   "make_differentiable_solve")


def make_differentiable_quadrature(
    problem: OdeProblem,
    t_final,
    solver_cls=None,
    max_steps: int = 16_384,
    bwd_solver_cls=None,
    bwd_max_steps: Optional[int] = None,
    checkpoint_interval: Optional[int] = None,
    max_events: int = MAX_EVENTS,
    device=None,
):
    """Return ``g_of(params) -> (nout,)``: the quadrature output G =
    int_{t0}^{t_final} u(t, y, p) dt, differentiable through the continuous
    adjoint with the u_y^T forcing term (reference AdjointRhs ``with_out``,
    adjoint_equations.rs:330-360, and AdjointOut :377-460).  The problem
    must be built with ``integrate_out``; ``u`` is the state itself without
    an ``out`` function.  The other arguments as in
    :func:`make_differentiable_solve`."""
    if not problem.integrate_out:
        raise ValueError("make_differentiable_quadrature needs a problem built with "
                         ".integrate_out()")
    return _single(problem, [float(t_final)], "g", solver_cls, max_steps,
                   bwd_solver_cls, bwd_max_steps, checkpoint_interval, max_events,
                   device, "make_differentiable_quadrature")
