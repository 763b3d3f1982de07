"""The independent ensemble's adjoint: one batched forward pass and one
batched backward pass, each member with its own step sequences
(counterpart of ``diffsol_tpu.adjoint_ensemble``'s ``mode="independent"``,
the ``vmap`` of ``diffsol_tpu.adjoint.make_differentiable_solve``).

* **The forward pass** is the batched BDF loop
  (:mod:`.solvers.bdf_independent`, through the band LU kernels on the
  card for a banded problem) with a recorder: every member's Hermite knots
  (t, y, dy) at its accepted steps, two at each reset event, go into (K, B,
  n) device buffers at that member's own count (:class:`Knots`); the knot
  times are a (K, B) tensor padded with +inf past each count, and the
  buffers grow in chunks whose need the host bounds from the rounds, so no
  step reads the device.  Each member's reset events are recorded to
  ``max_events`` (EVENT_CAPACITY_EXCEEDED past it, for that member).  As in
  the JAX package, this mode keeps the dense table.
* **The Hermite interpolant** (:func:`hermite_members`) is
  ``adjoint.hermite_interp`` per member on the device: a ``searchsorted``
  of each member's time in its own row of knot times, the left knot at a
  double knot and past the last one.
* **The backward pass** integrates every member's adjoint system z =
  [lambda, g_p] with the batched BDF loop over the member-time lift of the
  adjoint problem (:func:`_adjoint_members`: each member reads its own
  table at t_top - sigma_b).  Each member walks its own schedule of
  boundaries (``adjoint._boundary_schedule``: the shared output times and
  its own event times, an output jump first at a tie), integrating to each
  with its own stop time (``_Batched.integrate_schedule``); the output
  jumps and the reinitialisation apply masked to the members at a
  boundary, and the event corrections vmapped over such members, one call
  for each root index among them.  The Newton-failure limit counts over
  each member's whole backward solve, as the single solve counts it; a
  member whose backward solve fails gets a NaN gradient and its own
  status, and the others keep theirs.

Each member's arithmetic is its single solve's, so each gradient is its
single ``make_differentiable_solve``'s with equal forward and backward
``Stats``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import fields

import torch

from . import errors
from .adjoint import (
    MAX_EVENTS,
    _adjoint_problem,
    _boundary_schedule,
    _event_correction_core,
    _init_correction,
    _make_jump,
    _out_fn,
)
from .equations import OdeEquations
from .ops.linsol import DENSE
from .solvers.rk_common import Stats

F64 = torch.float64
I64 = torch.int64
KNOT_CHUNK = 256  # the knot buffers grow by at least this many rows


class Knots:
    """The forward pass's recorder: each member's Hermite knots and reset
    events on the device (see the module docstring).  ``ts`` (K, B), ``ys``
    and ``dys`` (K, B, n), ``count`` (B,); the events' ``ev_t`` and
    ``ev_idx`` (E, B), their states (E, B, n) and ``ev_count`` (B,)."""

    def __init__(self, B: int, n: int, like: torch.Tensor, max_events: int):
        self.B, self.n, self.max_events = B, n, max_events
        dev = like.device
        self.ar = torch.arange(B, device=dev)
        self.ts = torch.full((KNOT_CHUNK, B), math.inf, dtype=like.dtype, device=dev)
        self.ys = like.new_zeros((KNOT_CHUNK, B, n))
        self.dys = like.new_zeros((KNOT_CHUNK, B, n))
        self.count = torch.zeros(B, dtype=I64, device=dev)
        self.bound = 0  # the host's bound on the largest count
        E = max(max_events, 1)
        self.ev_t = torch.full((E, B), math.nan, dtype=like.dtype, device=dev)
        self.ev_idx = torch.zeros((E, B), dtype=I64, device=dev)
        self.ev = {k: like.new_zeros((E, B, n))
                   for k in ("y_minus", "dy_minus", "y_plus", "dy_plus")}
        self.ev_count = torch.zeros(B, dtype=I64, device=dev)

    def _put(self, mask, t, y, dy):
        """One knot for each member of ``mask``, at its own count."""
        if self.bound + 1 > self.ts.shape[0]:
            grow = max(self.ts.shape[0], KNOT_CHUNK)
            self.ts = torch.cat([self.ts, self.ts.new_full((grow, self.B), math.inf)])
            self.ys = torch.cat([self.ys, self.ys.new_zeros((grow, self.B, self.n))])
            self.dys = torch.cat([self.dys, self.dys.new_zeros((grow, self.B, self.n))])
        pos, ar = self.count, self.ar
        m = mask[:, None]
        self.ts[pos, ar] = torch.where(mask, t.to(self.ts.dtype), self.ts[pos, ar])
        self.ys[pos, ar] = torch.where(m, y, self.ys[pos, ar])
        self.dys[pos, ar] = torch.where(m, dy, self.dys[pos, ar])
        self.count = self.count + mask.to(I64)
        self.bound += 1

    def start(self, st):
        self._put(torch.ones(self.B, dtype=torch.bool, device=self.ar.device), st.t, st.y,
                  st.dy)

    def step(self, mask, st):
        self._put(mask, st.t, st.y, st.dy)

    def event(self, rf, pinned, st):
        """The reset events of the members of ``rf`` (pinned: the (t, y, dy)
        before the reset; ``st`` after it): the event's record and two
        knots where the member's record has room; returns the members
        without room."""
        room = rf & (self.ev_count < self.max_events)
        pos = self.ev_count.clamp(max=self.ev_t.shape[0] - 1)
        ar, m = self.ar, room[:, None]
        t, y_m, dy_m = pinned
        self.ev_t[pos, ar] = torch.where(room, t.to(self.ev_t.dtype), self.ev_t[pos, ar])
        self.ev_idx[pos, ar] = torch.where(room, st.root_idx, self.ev_idx[pos, ar])
        for key, v in (("y_minus", y_m), ("dy_minus", dy_m), ("y_plus", st.y),
                       ("dy_plus", st.dy)):
            self.ev[key][pos, ar] = torch.where(m, v, self.ev[key][pos, ar])
        self.ev_count = self.ev_count + room.to(I64)
        self._put(room, t, y_m, dy_m)
        self._put(room, st.t, st.y, st.dy)
        return rf & ~room

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in (self.ts, self.ys, self.dys))


def hermite_members(tab: Knots, t: torch.Tensor, members=None) -> torch.Tensor:
    """Each member's cubic Hermite interpolant at its own time ``t`` (S,)
    -> (S, n), for the ``members`` (S,) (default all B):
    ``adjoint.hermite_interp`` row by row (bisect_right on the member's
    knot times; the left knot at a double knot and past the last knot), the
    same arithmetic in the same order."""
    ar = tab.ar if members is None else members
    ts_b = tab.ts.transpose(0, 1)[ar].contiguous()  # (S, K)
    count = tab.count[ar]
    k = torch.searchsorted(ts_b, t.to(ts_b.dtype)[:, None], right=True)[:, 0]
    last = count - 1
    past = k >= count
    rows = torch.arange(ar.shape[0], device=ar.device)
    k = torch.minimum(k.clamp(min=1), last.clamp(min=1))
    km = k - 1
    t0 = ts_b[rows, km]
    dt = ts_b[rows, k] - t0
    y0, y1 = tab.ys[km, ar], tab.ys[k, ar]
    d0, d1 = tab.dys[km, ar], tab.dys[k, ar]
    theta = (t - t0) / dt
    u = 1.0 - theta
    th2 = theta * theta
    h00 = (1.0 + 2.0 * theta) * (u * u)
    h10 = theta * (u * u)
    h01 = th2 * (3.0 - 2.0 * theta)
    h11 = th2 * (theta - 1.0)
    c = lambda v: v[:, None]  # noqa: E731
    val = c(h00) * y0 + c(h10 * dt) * d0 + c(h01) * y1 + c(h11 * dt) * d1
    val = torch.where(c(dt == 0.0), y0, val)
    return torch.where(c(past), tab.ys[last.clamp(min=0), ar], val)


def _adjoint_members(base, member_adj, t_top: float, nparams: int, tab: Knots,
                     params_x: torch.Tensor):
    """The member-time lift of ``adjoint._adjoint_problem``: every callable
    takes each member's sigma (S,) and reads that member's table at t_top -
    sigma_b.  Its params ``params_x`` are the members' with their index
    appended as a last column, so that a subset (a refresh's) finds its
    tables.  The rhs is one ``torch.func.vjp`` of the members' rhs, the
    Jacobian [[J^T, 0], [f_p^T, 0]] each member's ``jacfwd`` (vmapped), the
    mass blockdiag(M^T, I) each member's."""
    eqn = base.eqn
    n = eqn.nstates
    N = n + nparams
    vmap = torch.func.vmap
    rhs_b = vmap(eqn.rhs, in_dims=(0, 0, 0))
    member_jac = vmap(torch.func.jacfwd(eqn.rhs, argnums=(1, 2)), in_dims=(0, 0, 0))

    def at(sigma, like, px):
        t = t_top - sigma.to(F64)
        return t.to(like.dtype), hermite_members(tab, t, px[:, -1].long())

    # the last point's pullback: Newton evaluates the rhs several times at
    # one (sigma, params) pair
    last = [None]

    def rhs(sigma, z, params):
        hit = last[0]
        if hit is None or hit[0] is not sigma or hit[1] is not params:
            tt, x = at(sigma, z, params)
            _, vjp = torch.func.vjp(lambda yy, pp: rhs_b(tt, yy, pp), x, params[:, :-1])
            last[0] = hit = (sigma, params, vjp)
        dlam, dgp = hit[2](z[..., :n].contiguous())
        return torch.cat([dlam, dgp], dim=-1)

    def rhs_jac(sigma, z, params):
        tt, x = at(sigma, z, params)
        jy, jp = member_jac(tt, x, params[:, :-1])
        out = z.new_zeros(z.shape[:-1] + (N, N))
        out[..., :n, :n] = jy.transpose(-1, -2)
        out[..., n:, :n] = jp.transpose(-1, -2)
        return out

    def init(sigma, params):
        return params.new_zeros((params.shape[0], N))

    adj_mass = None
    if eqn.mass is not None:
        m_b = vmap(eqn.mass, in_dims=(0, 0))

        def adj_mass(sigma, params):
            m_t = m_b((t_top - sigma.to(F64)).to(params.dtype), params[:, :-1])
            out = torch.eye(N, dtype=F64, device=params.device).expand(
                (params.shape[0], N, N)).clone()
            out[..., :n, :n] = m_t.transpose(-1, -2)
            return out

    adj_eqn = OdeEquations(rhs=rhs, init=init, mass=adj_mass, rhs_jac=rhs_jac,
                           nstates=N, nparams=nparams)
    return dataclasses.replace(member_adj, eqn=adj_eqn, params=params_x,
                               lockstep_nbatch=params_x.shape[0], linear_solver=DENSE)


def _stats_of(run) -> Stats:
    """The loop's (B,) counters, copied out."""
    return Stats(**{f.name: run.stats_mat[i].clone() for i, f in enumerate(fields(Stats))})


def forward_independent(base, t_eval, params_b, max_steps: int, max_events: int):
    """The batched forward pass with its recorder: ``(ys, status, stats,
    table)``; ``ys`` (neval, B, n) NaN for a member with a fatal status,
    ``status`` (B,) each member's final status."""
    from .solvers.bdf import BdfSolver
    from .solvers.bdf_independent import _Batched

    eqn = base.eqn
    has_reset = eqn.root is not None and eqn.reset is not None
    p = base
    if eqn.root is not None and not has_reset:
        # the single forward pass steps on through a root without a reset
        p = dataclasses.replace(base, eqn=dataclasses.replace(eqn, root=None, nroots=0))
    run = _Batched(BdfSolver(p), params_b)
    tab = Knots(params_b.shape[0], eqn.nstates, params_b, max_events if has_reset else 0)
    _, ys, _, _, _, _, _, st = run.solve_dense(t_eval, max_steps, recorder=tab)
    status = st.status
    ys = torch.where((status < 0)[None, :, None], math.nan, ys)
    return ys, status, _stats_of(run), tab


def backward_independent(base, t_eval, ct_ys, params_b, tab: Knots, live, max_steps: int,
                         info: dict):
    """Every member of ``live`` integrated backward through its own
    schedule (see the module docstring) -> dG/dp (B, nparams), NaN for a
    member whose backward solve failed or that is not ``live``."""
    from .solvers.bdf import BdfSolver
    from .solvers.bdf_independent import _Batched

    eqn = base.eqn
    n, nparams = eqn.nstates, eqn.nparams
    B = params_b.shape[0]
    dev = params_b.device
    te = [float(t) for t in t_eval]
    t_top = te[-1]
    member_adj = _adjoint_problem(base, t_top, nparams, [None], base=base)
    params_x = torch.cat([params_b, torch.arange(B, device=dev).to(F64)[:, None]], 1)
    lifted = _adjoint_members(base, member_adj, t_top, nparams, tab, params_x)
    run = _Batched(BdfSolver(member_adj), params_x, lifted=lifted)
    st = run.init_state(math.inf)

    # ---- each member's schedule: one read of the event record
    ev_count = tab.ev_count.tolist()
    ev_t = tab.ev_t.transpose(0, 1).tolist()
    t_end = t_top - float(base.t0)
    sched = [_boundary_schedule(te, {"t": ev_t[b][:ev_count[b]]}) for b in range(B)]
    L = max(len(s) for s in sched)
    targets = [[t_top - t for t, _, _ in s] + [t_end] * (L + 1 - len(s)) for s in sched]
    kinds = [[k for _, k, _ in s] + [0] * (L - len(s)) for s in sched]
    slots = [[i for _, _, i in s] + [0] * (L - len(s)) for s in sched]
    targets = torch.tensor(targets, dtype=F64, device=dev)
    kinds = torch.tensor(kinds, dtype=I64, device=dev)
    slots = torch.tensor(slots, dtype=I64, device=dev)
    nstages = torch.tensor([len(s) for s in sched], dtype=I64, device=dev)
    ar = torch.arange(B, device=dev)

    jump = _make_jump(base)
    jump_b = None if eqn.mass is None else torch.func.vmap(jump)
    core = _event_correction_core(eqn, _out_fn(eqn), False)

    def correct(lam, gp, t_star, y_m, dy_m, y_p, dy_p, params, k):
        return core(lam, gp, t_star, y_m, dy_m, y_p, dy_p, k, params, None)

    def apply(st, mask, stage):
        """The output jump or the event correction of each member of
        ``mask`` at its ``stage``, then the reinitialisation
        (adjoint._make_reinit)."""
        s = stage.clamp(max=L - 1)
        kind, slot = kinds[ar, s], slots[ar, s]
        lam, gp = st.y[:, :n], st.y[:, n:]
        jm = mask & (kind == 0)
        v = ct_ys[slot, ar]
        if jump_b is None:
            lam_j, gp_j = lam + v, gp
        else:
            tq = t_top - st.t
            lam_j, gp_j = jump_b(lam, gp, v, tq, hermite_members(tab, tq), params_b)
        y = torch.where(jm[:, None], torch.cat([lam_j, gp_j], dim=-1), st.y)
        # the event corrections: after one read of the members' root
        # indices, one vmapped call for the members of ``cm`` at each
        cm = mask & (kind == 1)
        e = slot.clamp(max=tab.ev_t.shape[0] - 1)
        root = torch.where(cm, tab.ev_idx[e, ar], -1).tolist() if any(ev_count) else []
        for k in sorted(set(root) - {-1}):
            sel = torch.tensor([b for b, r in enumerate(root) if r == k], device=dev)
            es = e[sel]
            ev = [tab.ev[key][es, sel] for key in ("y_minus", "dy_minus", "y_plus", "dy_plus")]
            lam_c, gp_c = torch.func.vmap(functools.partial(correct, k=k))(
                lam[sel], gp[sel], tab.ev_t[es, sel].to(y.dtype), *ev, params_b[sel])
            y[sel] = torch.cat([lam_c, gp_c], dim=-1)
        st.y = y
        st.state_modified = st.state_modified | mask
        st.dy = torch.where(mask[:, None], run.eqn.rhs(run.tt(st.t), st.y, params_x), st.dy)
        if run.alg is not None:
            y2, dy2, status = run.make_consistent(st.t, st.y, st.dy, mask)
            st.y, st.dy = y2, dy2
            st.status = torch.where(mask, status, st.status)

    failed = run.integrate_schedule(st, targets, nstages, apply, max_steps, live=live)
    bad = (failed != 0) | ~live
    y = torch.where(bad[:, None], math.nan, st.y)
    stats = _stats_of(run)
    for f in fields(Stats):
        getattr(stats, f.name).masked_fill_(~live, 0)
    info["backward"] = stats
    info["backward_status"] = torch.where(
        live, torch.where(failed != 0, failed, st.status), errors.INTERNAL_TIMESTEP)
    info["backward_rounds"], info["backward_host_reads"] = st.rounds, st.host_reads
    return torch.func.vmap(lambda p, l, g: _init_correction(base, p, l, g))(
        params_b, y[:, :n], y[:, n:])


def make_independent(problem, t_eval, nbatch: int, max_steps: int, bwd_max_steps, dev,
                     who: str, maxis=None):
    """``ys_of(params_b) -> (neval, B, n)`` of ``mode="independent"``: one
    ``torch.autograd.Function`` over the batched passes; ``ys_of.info``
    holds the last call's per-member forward and backward ``Stats`` ((B,)
    counters), ``status`` and ``backward_status`` ((B,) tensors; a member
    with a fatal forward status takes no backward solve: zero backward
    counters, status 0) and the table's bytes.

    ``maxis`` (a mesh's :class:`~.sharding.MemberAxis`) runs both passes on
    the rank's block of the global batch; the members are independent, so
    neither pass makes a collective.  ``ys``, the gradient and ``info``'s
    per-member entries are gathered whole on every rank (the table's bytes
    and the backward's rounds and host reads stay the rank's)."""
    from .adjoint import _differentiable
    from .ensemble import _gather_state

    base = problem.to(dev)
    te = [float(t) for t in t_eval]
    bwd_steps = bwd_max_steps or max_steps

    def whole(x, dim=0):
        return x if maxis is None else _gather_state(maxis, x, dim)

    def forward(params_b, info):
        if maxis is not None:
            params_b = maxis.split(params_b)
        ys, status, stats, tab = forward_independent(base, te, params_b, max_steps,
                                                     MAX_EVENTS)
        info["forward"] = whole(stats)
        info["status"] = whole(status)
        info["table_bytes"] = tab.nbytes()
        return whole(ys, 1), (params_b, tab, status)

    def backward(saved, ct, info):
        params_b, tab, status = saved
        if maxis is not None:
            ct = maxis.split(ct, 1)
        grad = backward_independent(base, te, ct, params_b, tab, status >= 0, bwd_steps,
                                    info)
        info["backward"] = whole(info["backward"])
        info["backward_status"] = whole(info["backward_status"])
        return whole(grad)

    return _differentiable(forward, backward, dev, who, nbatch=nbatch)
