"""Independent-ensemble BDF: B members in one batched loop, each with its
own step control (counterpart of ``jax.vmap`` over
``diffsol_tpu.solvers.bdf.BdfSolver.step`` and
``diffsol_tpu.drivers.solve_dense``, as ``diffsol_tpu.ensemble``'s
``mode="independent"`` runs them).

The solve loop, the host control, Newton masked per member, the root search
and the factorization of a subset are :mod:`.independent`'s; this module
brings BDF's state and step attempt.  D is (ND, B, n), and every scalar
of :class:`~.bdf.BdfState` becomes a (B,) tensor: the time, step size,
order, the Jacobian policy's counters, eta, the tstop, the status and the
root found; :class:`~.rk_common.Stats` holds a (B,) counter a field.
With ``sens=True`` the rows are (naug, B, n) and their difference matrix
sD is (ND, naug, B, n), each member's rows at its own order.

A round is one step attempt of every unfinished member, in the order of
decisions of ``BdfSolver.step``: the restart after a root or a reset, the
prediction from D at the member's own order (the coefficient tables are
gathered by the (B,) order and the sums masked, never looped over
members), Newton masked per member and then the rows' Newton against the
same factors, the error test (the rows in it when the problem sets
``sens_rtol`` and ``sens_atol``), and then the rejection (rescale, the
failure ladder) or the acceptance (the difference update, order
selection, the root check on the accepted interpolant, the tstop clamp).
A member's step sequence is its single solve's.

The Jacobian and the factorization of ``M - c J`` are refreshed only for
the members whose own policy asks, on that subset (``index_select`` /
``index_copy_``): ``torch.linalg.lu_factor_ex`` on the dense tier, the
band LU (K3 factors the subset's bands, K4 solves every member, and every
row of the sensitivities, against its own factors on the card) on the
banded tier, and one batched LU of the subset's (S K, nb, nb) blocks on
the block-diagonal tier.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, ClassVar, Optional

import torch

from .. import errors
from ..norms import error_scale
from ..ops.newton import ETA_RESET_JACOBIAN, ETA_RESET_TIMESTEP
from .bdf import (MAX_ORDER, ND, _ALPHA, _ERROR_CONST2, _EPS, _GAMMA, _r_mat, BdfSolver,
                  sum_in_order)
from .independent import (F64, I64, _CAUSES, BatchedLoop, _cast, _rdiv, _where,
                          _where_nd, _wm, member_stats)
from .rk_common import Stats


@dataclass
class IndependentState:
    """The batched state of an independent ensemble: the fields of
    :class:`~.bdf.BdfState` with a leading member axis ((B,) for its
    scalars, (B, n) for vectors, (ND, B, n) for D; the rows (naug, B, n)
    and their sD (ND, naug, B, n)), ``stats`` a :class:`~.rk_common.Stats`
    of (B,) counters, and the loop's own counts."""

    # the member dimension of each field whose leading one it is not, for
    # the gather of a sharded ensemble (ensemble.py); None for the Newton
    # matrices, whose layout is the tier's and which stay with their rank
    MEMBER_DIMS: ClassVar[dict] = dict(D=1, gD=1, s=1, sD=2, jac=None, factors=None)

    y: torch.Tensor
    dy: torch.Tensor
    t: torch.Tensor
    h: torch.Tensor
    D: torch.Tensor
    order: torch.Tensor
    n_equal_steps: torch.Tensor
    jac: torch.Tensor
    factors: Any
    eta: torch.Tensor
    prev_error_norm: torch.Tensor
    steps_since_jac: torch.Tensor
    steps_since_rhs_jac: torch.Tensor
    c_last: torch.Tensor
    newton_fails_total: torch.Tensor
    tstop: torch.Tensor
    status: torch.Tensor
    stats: Stats
    g: torch.Tensor
    gD: torch.Tensor
    root_g: torch.Tensor
    root_t: torch.Tensor
    root_idx: torch.Tensor
    state_modified: torch.Tensor
    s: Optional[torch.Tensor] = None
    sD: Optional[torch.Tensor] = None
    # accepted steps plus fatal attempts, as solve_dense's counter k
    n_steps: Optional[torch.Tensor] = None
    rounds: int = 0
    host_reads: int = 0
    newton_sweeps: int = 0  # Newton iterations of the batch (any member)
    # the Krylov tier's restarts and Arnoldi iterations, (B,) (None on the
    # other tiers)
    gmres_restarts: Optional[torch.Tensor] = None
    gmres_arnoldi: Optional[torch.Tensor] = None

    def member_stats(self, b: int) -> Stats:
        """Member ``b``'s counters as the single solve's :class:`Stats`."""
        return member_stats(self.stats, b)


def _bm(x, like):
    """(B,) or (neval, B) control values onto a tensor whose last two axes
    are (B, n) (the state, D's rows) or whose last three are (naug, B, n)
    (the rows): a trailing axis, and one for the rows' axis."""
    x = x.unsqueeze(-1)
    if like.ndim >= 3 and x.ndim >= 3:
        x = x.unsqueeze(-3)
    return x


class _Batched(BatchedLoop):
    """The BDF loop of one independent ensemble solve; see the module
    docstring."""

    SNAP = ("h", "D", "gD", "order", "n_equal_steps", "eta", "prev_error_norm",
            "steps_since_jac", "steps_since_rhs_jac", "c_last", "newton_fails_total",
            "state_modified")

    def __init__(self, solver: BdfSolver, params_b: torch.Tensor, lifted=None):
        super().__init__(solver, params_b, lifted)
        if self.sens:
            self.SNAP = self.SNAP + ("sD",)
        tk = dict(dtype=F64, device=self.dev)
        self.alpha = torch.as_tensor(_ALPHA, **tk)
        self.gamma_d = torch.as_tensor(_GAMMA[1:], dtype=self.dtype, device=self.dev)
        self.ec2 = torch.as_tensor(_ERROR_CONST2, **tk)
        self.u1 = torch.as_tensor(_r_mat(1.0), **tk)
        self.eye = torch.eye(ND, **tk)
        self.idx = torch.arange(ND, device=self.dev)

    # ------------------------------------------------------------------
    # the difference matrix at per-member order (bdf.py's helpers with the
    # sums masked, so that each member's arithmetic is its single solve's);
    # D is (ND, B, n) or the rows' (ND, naug, B, n)
    def _om(self, x, D):
        """An (ND, B) or (1, B) table onto D, whose member axis is its -2."""
        return x.view(x.shape[:1] + (1,) * (D.ndim - 3) + x.shape[1:] + (1,))

    def masked(self, D, order):
        """D with the rows past each member's order zeroed."""
        m = self.idx[:, None] <= order[None, :]
        return torch.where(self._om(m, D), D, 0.0)

    def predict(self, D, order, Dm=None):
        """sum_{i <= order} D[i], summed in predict_from_diff's order (the
        zeros past a member's order add nothing)."""
        Dm = self.masked(D, order) if Dm is None else Dm
        acc = Dm[0]
        for i in range(1, MAX_ORDER + 1):
            acc = acc + Dm[i]
        return acc

    def psi(self, D, order, Dm=None):
        """alpha[order] * sum_{1 <= i <= order} gamma[i] D[i] (psi_from_diff)."""
        Dm = self.masked(D, order) if Dm is None else Dm
        G = Dm[1:MAX_ORDER + 1] * self.gamma_d.view(
            (MAX_ORDER,) + (1,) * (D.ndim - 1))
        acc = G[0]
        for i in range(1, MAX_ORDER):
            acc = acc + G[i]
        return self.s(self.alpha[order]) * acc

    def update_diff(self, D, d, order):
        """update_diff at each member's order: D'[i] = sum_{k=i..order}
        D[k] + d for i <= order, D'[order+1] = d, D'[order+2] = d -
        D[order+1], the rest kept."""
        Dm = self.masked(D, order)
        acc = Dm[MAX_ORDER]
        rows = [acc]
        for i in range(MAX_ORDER - 1, -1, -1):
            acc = acc + Dm[i]
            rows.append(acc)
        A = torch.stack(rows[::-1]) + d
        idx = self.idx.view((ND,) + (1,) * (D.ndim - 1))
        o = self._om(order[None, :], D)
        new = torch.cat([torch.where(idx[:MAX_ORDER + 1] <= o, A, D[:MAX_ORDER + 1]),
                         D[MAX_ORDER + 1:]])
        tail = torch.where(idx[1:] == o + 2, d - D[:-1], new[1:])
        tail = torch.where(idx[1:] == o + 1, d, tail)
        return torch.cat([new[:1], tail])

    def ru(self, order, factor):
        """(B, ND, ND) R(factor) U acting on rows 0..order (compute_ru)."""
        j = torch.arange(ND, dtype=F64, device=self.dev)[None, None, :]
        m = torch.arange(1, ND, dtype=F64, device=self.dev)[None, :, None]
        rows = (m - 1.0 - factor[:, None, None] * j) / m
        ones = torch.ones((factor.shape[0], 1, ND), dtype=F64, device=self.dev)
        r = torch.cumprod(torch.cat([ones, rows], dim=1), dim=1)
        valid = ((self.idx[None, :, None] <= order[:, None, None])
                 & (self.idx[None, None, :] <= order[:, None, None]))
        r = torch.where(valid, r, self.eye)
        u = torch.where(valid, self.u1, self.eye)
        return r @ u

    def rescale(self, mask, order, factor, *Ds):
        """Each D (ND, B, ...) or the rows' sD (ND, naug, B, n) under a
        step-size change by ``factor`` for the members of ``mask``
        (rescale_all); the others untouched, and None passed through.  Each
        member sums as bdf.apply_ru does for its single solve: in order in
        float64 (bit for bit), a matrix product in float32 (float32's
        bound)."""
        ru = self.ru(order, torch.where(mask, factor, 1.0))
        out = []
        for D in Ds:
            if D is None or D.shape[-1] == 0:
                out.append(D)
                continue
            r = _cast(ru, D.dtype)
            if D.dtype != F64:  # bdf.apply_ru's matrix product, a member's RU each
                new = (torch.einsum("bij,iabk->jabk", r, D) if D.ndim == 4
                       else torch.einsum("bij,ib...->jb...", r, D))
            else:  # bdf.apply_ru's sum in order: (ND, ND, [1,] B, 1) columns
                r = r.permute(1, 2, 0).reshape((ND, ND) + (1,) * (D.ndim - 3)
                                               + (r.shape[0], 1))
                new = sum_in_order(r, D)
            out.append(_wm(mask, new, D) if D.ndim == 4 else _where_nd(mask, new, D))
        return out

    def interp(self, t, D, t1, h, order):
        """Interpolant of the last step at per-member times ``t`` ((B,) or
        (neval, B)) -> (..., B, n), or (..., naug, B, n) for the rows
        (interp_from_diff)."""
        if t.ndim == 1:
            y = D[0]
        elif D.ndim == 4:
            y = D[0].expand(t.shape[:-1] + D.shape[1:])
        else:
            y = D[0].expand(t.shape + D.shape[2:])
        tf = torch.ones_like(t)
        live = _bm(order, D[0])
        for i in range(MAX_ORDER):
            tf = tf * (t - (t1 - h * i)) / (h * (1.0 + i))
            term = _bm(_cast(tf, D.dtype), D[0]) * D[i + 1]
            y = y + torch.where(i < live, term, 0.0)
        return y

    def interp_deriv(self, t, D, t1, h, order):
        dy = torch.zeros_like(D[0])
        pi = torch.ones_like(t)
        d_pi = torch.zeros_like(t)
        for i in range(MAX_ORDER):
            denom = h * (1.0 + i)
            w = (t - (t1 - h * i)) / denom
            d_pi_new = d_pi * w + pi / denom
            pi_new = pi * w
            live = i < order
            d_pi = torch.where(live, d_pi_new, d_pi)
            pi = torch.where(live, pi_new, pi)
            dy = dy + torch.where(live.unsqueeze(-1), _cast(d_pi, D.dtype).unsqueeze(-1) * D[i + 1],
                                  0.0)
        return dy

    # ------------------------------------------------------------------
    def refresh(self, st, mask, t, y, c, rhs_pred, cause):
        """The Jacobian policy's refresh (BdfSolver._jac_slim) for the
        members of ``mask``: a new Jacobian where ``rhs_pred``, then M - c J
        factored, on the subset alone.  ``cause`` is a (B,) index into
        _CAUSES."""
        rhs_pred = rhs_pred & mask
        idx = torch.nonzero(mask).squeeze(1)
        self.reads += 1  # nonzero's size
        if idx.numel() == 0:
            return
        stats = st.stats
        pb = self.params.index_select(0, idx)
        t_s = t.index_select(0, idx)
        y_s = y.index_select(0, idx)
        jac_s = st.jac.index_select(0, idx)
        rj = rhs_pred.index_select(0, idx)
        jac_s = _where(rj, self.eqn.jac(self.tt(t_s), y_s, pb), jac_s)
        st.jac.index_copy_(0, idx, jac_s)
        self.factor_subset(st, idx, t_s, jac_s, c.index_select(0, idx))
        st.steps_since_jac = torch.where(mask, 0, st.steps_since_jac)
        st.c_last = torch.where(mask, c, st.c_last)
        st.eta = torch.where(mask, ETA_RESET_JACOBIAN, st.eta)
        one = mask.to(I64)
        stats.linear_solver_setups += one
        if self.eqn.mass is not None:
            stats.mass_evals += one
        for k, name in enumerate(_CAUSES):
            getattr(stats, name).add_(one & (cause == k).to(I64))
        st.steps_since_rhs_jac = torch.where(rhs_pred, 0, st.steps_since_rhs_jac)
        stats.jacobian_evals += rhs_pred.to(I64)
        stats.jac_mul_evals += rhs_pred.to(I64) * self.jvp_probes

    # ------------------------------------------------------------------
    def init_state(self, t_final: float) -> IndependentState:
        """BdfSolver.init_state of every member, then drivers.solve_dense's
        set_stop_time(final_time)."""
        p, B = self.p, self.B
        params = self.params
        t0 = float(p.t0)
        t = torch.full((B,), t0, dtype=F64, device=self.dev)
        y = self.eqn.init(p.t0, params)
        dy = self.eqn.rhs(self.tt(t), y, params)
        if p.integrate_out:
            dg = self.out(t, y)
            g = torch.zeros_like(dg)
        else:
            dg = g = y.new_zeros((B, 0))
        status = torch.zeros(B, dtype=I64, device=self.dev)
        if self.alg is not None:
            y, dy, status = self.make_consistent(t, y, dy, torch.ones_like(status, dtype=torch.bool))
        h = self.initial_step_size(t, y, dy, 1)
        D = y.new_zeros((ND, B) + tuple(y.shape[1:]))
        D[0] = y
        D[1] = self.s(h) * dy
        gD = g.new_zeros((ND,) + tuple(g.shape))
        if p.integrate_out:
            gD[0] = g
            gD[1] = self.s(h) * dg
        root_g = (self.eqn.root(self.tt(t), y, params) if self.eqn.root is not None
                  else y.new_zeros((B, 0)))
        c0 = h * float(_ALPHA[1])
        zl = torch.zeros(B, dtype=I64, device=self.dev)
        stats = self.new_stats()
        jac = self.eqn.jac(self.tt(t), y, params)
        a = self.spec.assemble(self.eqn.mass_repr(self.tt(t), params), jac, self.c_of(c0, jac))
        factors = self.spec.factor(a)
        stats.linear_solver_setups += 1
        stats.lu_from_checkpoint += 1
        stats.jacobian_evals += 1
        stats.jac_mul_evals += self.jvp_probes
        if self.eqn.mass is not None:
            stats.mass_evals += 1
        s = sD = None
        if self.sens:
            # a DAE's algebraic rows made consistent (state.rs:167-239)
            s, ds = self.sens_start(t, y, dy)
            sD = s.new_zeros((ND,) + tuple(s.shape))
            sD[0] = s
            sD[1] = self.s(h) * ds
        nan = torch.full((B,), math.nan, dtype=F64, device=self.dev)
        st = IndependentState(
            y=y, dy=dy, t=t, h=h, D=D, order=torch.ones(B, dtype=I64, device=self.dev),
            n_equal_steps=zl.clone(), jac=jac, factors=factors,
            eta=torch.full((B,), ETA_RESET_JACOBIAN, dtype=F64, device=self.dev),
            prev_error_norm=nan.clone(), steps_since_jac=zl.clone(),
            steps_since_rhs_jac=zl.clone(), c_last=c0, newton_fails_total=zl.clone(),
            tstop=nan.clone(), status=status, stats=stats, g=g, gD=gD, root_g=root_g,
            root_t=nan.clone(), root_idx=zl - 1,
            state_modified=torch.zeros(B, dtype=torch.bool, device=self.dev),
            s=s, sD=sD, n_steps=zl.clone(),
        )
        self.set_stop(st, torch.ones(B, dtype=torch.bool, device=self.dev),
                      torch.full((B,), float(t_final), dtype=F64, device=self.dev))
        return st

    def set_stop(self, st, mask, tstop):
        """set_stop_time (bdf.py:347-369) for the members of ``mask``, each
        to its own (B,) ``tstop``."""
        st.tstop = torch.where(mask, tstop, st.tstop)
        tr = 100.0 * _EPS * (st.t.abs() + st.h.abs())
        reached = (st.t - st.tstop).abs() <= tr
        over = mask & ~reached & torch.where(st.h > 0.0, st.t + st.h > st.tstop + tr,
                                             st.t + st.h < st.tstop - tr)
        factor = (st.tstop - st.t) / st.h
        st.D, st.gD, st.sD = self.rescale(over, st.order, factor, st.D, st.gD, st.sD)
        st.h = torch.where(over, st.h * factor, st.h)
        st.n_equal_steps = torch.where(over, 0, st.n_equal_steps)
        st.eta = torch.where(over, ETA_RESET_TIMESTEP, st.eta)
        st.status = torch.where(mask & (st.tstop < st.t - tr),
                                errors.STOP_TIME_BEFORE_CURRENT_TIME, st.status)

    # ------------------------------------------------------------------
    def integrate_schedule(self, st, targets, nstages, apply, max_steps: int, live=None):
        """Each member integrates to its targets in turn (``targets`` (B,
        L + 1), ascending in each row; member b's first ``nstages[b]``
        are boundaries, the next its end): at each boundary
        ``apply(st, mask, stage)`` changes the members of ``mask``, and
        the next step of those restarts at order 1.  A target at or
        behind a member's time is reached at once; an integration stops
        at its target, at a fatal step or after ``max_steps`` steps, as
        adjoint._integrate_to (a fatal status before a boundary ends the
        member there).  Members outside ``live`` take no part.  Returns
        the first fatal status of each member (0: none)."""
        B, dev = self.B, self.dev
        ar = torch.arange(B, device=dev)
        stage = torch.zeros(B, dtype=I64, device=dev)
        k = torch.zeros(B, dtype=I64, device=dev)
        failed = torch.zeros(B, dtype=I64, device=dev)
        done = (torch.zeros(B, dtype=torch.bool, device=dev) if live is None
                else ~live.to(dev))
        integ = torch.zeros_like(done)
        fresh = torch.ones_like(done)
        self.begin(st)
        snap = {nm: getattr(st, nm) for nm in self.SNAP}
        snap_stats = self.stats_mat.clone()

        def open_(mask):
            """Start each member of ``mask`` toward its current target: an
            integration (status reset, stop time set) where the target lies
            ahead, else an arrival."""
            tgt = targets[ar, stage]
            need = mask & (tgt > st.t)
            st.status = torch.where(need, errors.INTERNAL_TIMESTEP, st.status)
            self.set_stop(st, need, tgt)
            return need, mask & ~need

        integ, arrived = open_(~done)
        rounds = 0
        while True:
            # ---- arrivals: a fatal status ends the member; a boundary is
            # applied and the next target opened (at once where it is due)
            while self.read(arrived.any()):
                bad = arrived & (st.status < 0)
                failed = torch.where(bad & (failed == 0), st.status, failed)
                at_b = arrived & ~bad & (stage < nstages)
                done = done | (arrived & ~at_b)
                apply(st, at_b, stage)
                stage = torch.where(at_b, stage + 1, stage)
                k = torch.where(at_b, 0, k)
                need, arrived = open_(at_b)
                integ = integ | need
            any_run, any_mod = self.read(torch.stack(
                [integ.any(), (integ & fresh & st.state_modified).any()]))
            if not any_run:
                break
            rounds += 1
            run = integ
            fr = run & fresh
            mod = fr & st.state_modified
            for nm in self.SNAP:
                snap[nm] = _wm(fr, getattr(st, nm), snap[nm])
            snap_stats = torch.where(fr, self.stats_mat, snap_stats)
            acc, status_f, step_stop, _, _ = self.attempt(st, run, fr, mod, any_mod)
            fatal = run & (status_f != 0)
            # a fatal step keeps its start (the single solver returns the
            # old state with the status)
            self.restore(st, fatal, snap, snap_stats)
            st.status = torch.where(fatal, status_f, torch.where(acc, step_stop, st.status))
            fin = acc | fatal
            fresh = fin | (fresh & ~run)
            k = k + fin.to(I64)
            arrived = fin & ((st.status != errors.INTERNAL_TIMESTEP) | (k >= max_steps))
            integ = integ & ~arrived
        st.rounds = rounds
        st.host_reads = self.reads
        st.newton_sweeps = self.newton_sweeps
        return failed

    # ------------------------------------------------------------------
    def begin(self, st):
        """A step's own variables (BdfSolver.step's locals), per member."""
        B, dev = self.B, self.dev
        self.conv_fail = torch.zeros(B, dtype=torch.bool, device=dev)
        self.h_changed = torch.zeros_like(self.conv_fail)
        self.err_fails = torch.zeros(B, dtype=I64, device=dev)
        self.safety = torch.ones(B, dtype=F64, device=dev)
        self.err = torch.full_like(self.safety, math.inf)
        self.prev_err = st.prev_error_norm.clone()
        self.n_equal0 = st.n_equal_steps.clone()
        self.root_g0 = st.root_g

    def restart(self, st, mod):
        """Restart the difference matrices at order 1 from (y, dy) (and the
        rows' from (s, ds)) for the members of ``mod`` (bdf.py's
        state_modified block)."""
        opts = self.opts
        tr0 = 100.0 * _EPS * (st.t.abs() + st.h.abs())
        ov0 = mod & ~torch.isnan(st.tstop) & ((st.t - st.tstop).abs() > tr0) & torch.where(
            st.h > 0.0, st.t + st.h > st.tstop + tr0, st.t + st.h < st.tstop - tr0)
        h_m = torch.where(ov0, st.tstop - st.t, st.h)
        Dm = torch.zeros_like(st.D)
        Dm[0] = st.y
        Dm[1] = self.s(h_m) * st.dy
        st.D = _where_nd(mod, Dm, st.D)
        if self.p.integrate_out:
            gDm = torch.zeros_like(st.gD)
            gDm[0] = st.g
            gDm[1] = self.s(h_m) * self.out(st.t, st.y)
            st.gD = _where_nd(mod, gDm, st.gD)
        if self.sens:
            # the rows as the solve loop left them (interpolated to a root,
            # then across its reset), with their derivative there
            sDm = torch.zeros_like(st.sD)
            sDm[0] = st.s
            sDm[1] = self.s(h_m) * self.aug.rhs(self.tt(st.t), st.y, self.params, st.s)
            st.sD = _wm(mod, sDm, st.sD)
        st.order = torch.where(mod, 1, st.order)
        st.n_equal_steps = torch.where(mod, 0, st.n_equal_steps)
        st.prev_error_norm = torch.where(mod, math.nan, st.prev_error_norm)
        c1 = st.h * float(_ALPHA[1])
        rel1 = (c1 / st.c_last - 1.0).abs()
        rp = mod & (st.steps_since_rhs_jac >= opts.update_rhs_jacobian_after_steps)
        jp = mod & ((st.steps_since_jac >= opts.update_jacobian_after_steps)
                    | (rel1 > opts.threshold_to_update_jacobian))
        self.refresh(st, rp | jp, st.t, st.y, c1, rp, torch.zeros_like(st.order))
        st.eta = torch.where(ov0, ETA_RESET_TIMESTEP, st.eta)
        st.h = torch.where(mod, h_m, st.h)
        st.state_modified = st.state_modified & ~mod

    # ------------------------------------------------------------------
    def newton_state(self, st, run, y_pred, psi, cval, t_pred):
        """newton_solve of the state for every member of ``run`` (bdf.py's
        residual, weighed by y_pred) -> (x, converged, niter, eta)."""
        p, eqn, params = self.p, self.eqn, self.params
        cv = self.s(cval)
        tp = self.tt(t_pred)

        def residual(x):
            fx = eqn.rhs(tp, x, params)
            return eqn.mass_mul(tp, params, x - y_pred + psi) - cv * fx

        return self.newton(residual, y_pred, error_scale(y_pred, p.atol, p.rtol),
                           st.factors, st.eta, run)

    def newton_rows(self, st, run, y_pred, cval, t_pred, order):
        """The rows' Newton against the main step's factors
        (BdfSolver._sens_solve), from the eta the state's Newton started
        from -> (s_delta, converged, niter)."""
        p, eqn, params, aug = self.p, self.eqn, self.params, self.aug
        tp = self.tt(t_pred)
        jvp_rows, f_p = aug.linear_parts(tp, y_pred, params)
        Dm = self.masked(st.sD, order)
        s_pred = self.predict(st.sD, order, Dm)
        psi_s = self.psi(st.sD, order, Dm)
        cv = self.s(cval)

        def residual(S):
            # mass_mul broadcasts over the leading row axis
            return eqn.mass_mul(tp, params, S - s_pred + psi_s) - cv * (jvp_rows(S) + f_p)

        x, ok, niter, _ = self.newton(residual, s_pred,
                                      error_scale(s_pred, aug.atol(p), aug.rtol(p)),
                                      st.factors, st.eta, run)
        return x - s_pred, ok, niter

    def sens_err2(self, x, s):
        """The rows' squared error norm: each member's largest row's."""
        return self.wnorm2(x, s, self.p.sens_atol, self.p.sens_rtol)

    # ------------------------------------------------------------------
    def attempt(self, st, run, fr, mod, any_mod):
        """One step attempt (BdfSolver.step's accept loop, once) of every
        member of ``run``, committed: ``(accepted, fatal status (0: none),
        the step's stop, its root time, whether a member found a root)``."""
        p, eqn, params, B, cfg, opts = self.p, self.eqn, self.params, self.B, self.cfg, self.opts
        integrate_out = p.integrate_out
        out_in_err = p.output_in_error_control()
        sens_in_err = self.sens and p.sens_in_error_control()
        has_root = eqn.root is not None
        atol, rtol = p.atol, p.rtol
        m_newton = float(cfg.maximum_newton_iterations)
        ar = torch.arange(B, device=self.dev)
        if any_mod:
            self.restart(st, mod)
        if has_root:
            self.root_g0 = _where(fr, eqn.root(self.tt(st.t), st.y, params), self.root_g0)
        conv_fail = self.conv_fail & ~fr
        h_changed = self.h_changed & ~fr
        err_fails = torch.where(fr, 0, self.err_fails)
        safety = torch.where(fr, 1.0, self.safety)
        err = torch.where(fr, math.inf, self.err)
        prev_err = torch.where(fr, st.prev_error_norm, self.prev_err)
        n_equal0 = torch.where(fr, st.n_equal_steps, self.n_equal0)
        root_g0 = self.root_g0

        order, h = st.order, st.h
        Dm = self.masked(st.D, order)
        y_pred = self.predict(st.D, order, Dm)
        psi = self.psi(st.D, order, Dm)
        alpha_o = self.alpha[order]
        cval = h * alpha_o
        t_pred = st.t + h
        x, ok, niter, eta_n = self.newton_state(st, run, y_pred, psi, cval, t_pred)
        niter_total = niter
        if self.sens:
            # every row against the same factors, from the same eta
            s_delta, s_ok, s_niter = self.newton_rows(st, run, y_pred, cval, t_pred, order)
            ok = ok & s_ok
            niter_total = niter + s_niter
        d = x - y_pred
        g_delta = None
        if integrate_out:
            g_delta = self.s(cval) * self.out(st.t + h, y_pred) - self.psi(st.gD, order)
        err_a = self.wnorm2(d, st.y, atol, rtol) * self.ec2[order - 1]
        if out_in_err:
            e_g = self.wnorm2(g_delta, st.g, p.out_atol, p.out_rtol) * self.ec2[order]
            err_a = torch.where(e_g > err_a, e_g, err_a)
        if sens_in_err:
            e_s = self.sens_err2(s_delta, st.s) * self.ec2[order]
            err_a = torch.where(e_s > err_a, e_s, err_a)
        accepted = ok & (err_a <= 1.0)
        safety_a = _rdiv(0.9 * (2.0 * m_newton + 1.0), 2.0 * m_newton + niter.to(F64))
        first = ~ok & ~conv_fail
        second = ~ok & conv_fail
        err_fail = ok & ~accepted
        nf = run & ~ok
        st.newton_fails_total = st.newton_fails_total + nf.to(I64)
        too_many = nf & (st.newton_fails_total > cfg.maximum_newton_fails)
        acc = run & accepted
        err_n = torch.where(run & ok, err_a, err)
        # the accepted step's difference update and the error norms of
        # its neighbour orders (bdf.py:549-575), ahead of the controller
        # so that all its powers take one read
        D_new = self.update_diff(st.D, d, order)
        y_new = D_new[0]
        sD_new = s_new = None
        if self.sens:
            sD_new = self.update_diff(st.sD, s_delta, order)
            s_new = sD_new[0]

        def predicted_err(col, const_idx):
            e = self.wnorm2(D_new[col, ar], y_new, atol, rtol)
            if sens_in_err:
                es = self.sens_err2(sD_new[col, :, ar].transpose(0, 1), s_new)
                e = torch.where(es > e, es, e)
            return e * self.ec2[const_idx]

        em = predicted_err(order, (order - 1).clamp(min=0))
        em = torch.where(order > 1, em, math.inf)
        ep = predicted_err((order + 2).clamp(max=ND - 1), (order + 1).clamp(max=MAX_ORDER))
        ep = torch.where(order < MAX_ORDER, ep, math.inf)
        # an accepted attempt rescaled nothing, so h_changed is the step's
        sel = torch.where(h_changed, 1, n_equal0 + 1) > order
        pis = self.pi_raw(torch.stack([err_a, em, err_n, ep]),
                          torch.stack([prev_err, err_n, err_n, err_n]),
                          torch.stack([order + 1, order, order + 1, order + 2]),
                          torch.stack([run & err_fail] + [acc & sel] * 3))
        raw, f3 = pis[0], pis[1:]
        rej = safety_a * raw
        rej = torch.where(cfg.minimum_timestep_shrink > rej, cfg.minimum_timestep_shrink, rej)
        factor = torch.where(err_fail, rej, 0.3)
        do_rescale = run & (err_fail | second)
        h_new = h * torch.where(do_rescale, factor, 1.0)
        c_jac = h_new * alpha_o
        rel = (c_jac / st.c_last - 1.0).abs()
        rhs_f = ((first & (rel < opts.threshold_to_update_rhs_jacobian))
                 | (second & (st.steps_since_rhs_jac > 0)))
        stats = st.stats
        ni = torch.where(run, niter_total, 0)
        stats.newton_iterations += ni
        stats.newton_fails += nf.to(I64)
        stats.error_test_failures += (run & err_fail).to(I64)
        stats.rhs_evals += ni
        st.eta = torch.where(run, eta_n, st.eta)
        cause_f = torch.where(first, 1, torch.where(second, 2, 3))
        rejected = run & ~accepted
        err_fails = err_fails + (run & err_fail).to(I64)
        status_f = torch.zeros_like(order)
        status_f = torch.where(err_fail & (err_fails >= cfg.maximum_error_test_failures),
                               errors.TOO_MANY_ERROR_TEST_FAILURES, status_f)
        status_f = torch.where(do_rescale & (h_new.abs() < cfg.minimum_timestep),
                               errors.STEP_SIZE_TOO_SMALL, status_f)
        status_f = torch.where(too_many, errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES, status_f)
        status_f = torch.where(run, status_f, 0)
        conv_fail = conv_fail | nf
        err = err_n
        safety = torch.where(run & ok, safety_a, safety)
        prev_err = torch.where(rejected, math.nan, prev_err)
        h_changed = h_changed | do_rescale

        # ---- the accepted step (bdf.py:549-566)
        t_new = st.t + h
        dy_new = D_new[1] / self.s(h)
        g_new, gD_new = st.g, st.gD
        if integrate_out:
            g_new = self.predict(st.gD, order) + g_delta
            gD_new = self.update_diff(st.gD, g_delta, order)
        one = acc.to(I64)
        stats.steps += one
        st.steps_since_jac = st.steps_since_jac + one
        st.steps_since_rhs_jac = st.steps_since_rhs_jac + one
        n_equal = torch.where(h_changed, 1, n_equal0 + 1)
        # ---- order selection (bdf.py:568-610)
        sel = n_equal > order
        max_index = torch.argmax(f3, dim=0)
        sf = safety * f3[max_index, ar]
        sf = torch.where(cfg.maximum_timestep_growth < sf, cfg.maximum_timestep_growth, sf)
        sf = torch.where(cfg.minimum_timestep_shrink > sf, cfg.minimum_timestep_shrink, sf)
        do_change = sel & ((sf >= cfg.minimum_timestep_growth)
                           | (sf <= cfg.maximum_timestep_shrink) | (max_index != 1))
        new_order = order + max_index - 1
        order_new = torch.where(do_change, new_order, order)
        h_acc = h * torch.where(do_change, sf, 1.0)
        D_new, gD_new, sD_new = self.rescale(acc & do_change, new_order, sf, D_new, gD_new,
                                             sD_new)
        st.eta = torch.where(acc & do_change, ETA_RESET_TIMESTEP, st.eta)
        c2 = h_acc * self.alpha[order_new]
        rel2 = (c2 / st.c_last - 1.0).abs()
        rhs2 = do_change & (st.steps_since_rhs_jac >= opts.update_rhs_jacobian_after_steps)
        jac2 = do_change & ((st.steps_since_jac >= opts.update_jacobian_after_steps)
                            | (rel2 > opts.threshold_to_update_jacobian))
        # one refresh for the rejected members (the failure ladder's) and
        # the accepted ones whose order or step changed
        self.refresh(st, rejected | (acc & (rhs2 | jac2)),
                     torch.where(acc, t_new, st.t), _where(acc, y_new, st.y),
                     torch.where(acc, c2, c_jac), torch.where(acc, rhs2, rhs_f),
                     torch.where(acc, 4, cause_f))
        n_equal_new = torch.where(do_change, 0, n_equal)
        step_stop = torch.where(do_change & (h_acc.abs() < cfg.minimum_timestep),
                                errors.STEP_SIZE_TOO_SMALL, errors.INTERNAL_TIMESTEP)
        # ---- the root check on the accepted interpolant (bdf.py:612-624)
        step_root_t = torch.full_like(t_new, math.nan)
        step_root_idx = torch.full_like(order, -1)
        root_g_new = st.root_g
        any_found = False
        if has_root:
            found, rt, ri, g1, any_found = self.check_root(
                acc, root_g0, st.t, y_new, t_new,
                lambda tq: self.interp(tq, D_new, t_new, h_acc, order_new))
            froot = found & (step_stop == errors.INTERNAL_TIMESTEP)
            step_stop = torch.where(froot, errors.ROOT_FOUND, step_stop)
            step_root_t = torch.where(froot, rt, step_root_t)
            step_root_idx = torch.where(froot, ri, step_root_idx)
            root_g_new = _where(acc, g1.to(st.root_g.dtype), st.root_g)
        # ---- tstop, in-step form (bdf.py:626-643)
        has_ts = ~torch.isnan(st.tstop)
        tr1 = 100.0 * _EPS * (t_new.abs() + h_acc.abs())
        reached = has_ts & ((t_new - st.tstop).abs() <= tr1)
        over = has_ts & ~reached & torch.where(h_acc > 0.0, t_new + h_acc > st.tstop + tr1,
                                               t_new + h_acc < st.tstop - tr1)
        ts_factor = (st.tstop - t_new) / h_acc
        D_new, gD_new, sD_new = self.rescale(acc & over, order_new, ts_factor, D_new, gD_new,
                                             sD_new)
        h_acc = torch.where(over, h_acc * ts_factor, h_acc)
        n_equal_new = torch.where(over, 0, n_equal_new)
        st.eta = torch.where(acc & over, ETA_RESET_TIMESTEP, st.eta)
        step_stop = torch.where((step_stop == errors.INTERNAL_TIMESTEP) & reached,
                                errors.TSTOP_REACHED, step_stop)

        # ---- commit: the rejected attempt's D and h, the accepted step
        st.D, st.gD, st.sD = self.rescale(do_rescale, order, factor, st.D, st.gD, st.sD)
        st.D = _where_nd(acc, D_new, st.D)
        st.gD = _where_nd(acc, gD_new, st.gD)
        if self.sens:
            st.sD = _wm(acc, sD_new, st.sD)
            st.s = _wm(acc, s_new, st.s)
        st.h = torch.where(acc, h_acc, torch.where(run, h_new, st.h))
        st.y = _where(acc, y_new, st.y)
        st.dy = _where(acc, dy_new, st.dy)
        st.g = _where(acc, g_new, st.g)
        st.t = torch.where(acc, t_new, st.t)
        st.order = torch.where(acc, order_new, st.order)
        st.n_equal_steps = torch.where(acc, n_equal_new, st.n_equal_steps)
        st.prev_error_norm = torch.where(acc, err, st.prev_error_norm)
        st.root_g = root_g_new
        st.root_t = torch.where(acc, step_root_t, st.root_t)
        st.root_idx = torch.where(acc, step_root_idx, st.root_idx)
        self.conv_fail, self.h_changed, self.err_fails = conv_fail, h_changed, err_fails
        self.safety, self.err, self.prev_err, self.n_equal0 = safety, err, prev_err, n_equal0
        return acc, status_f, step_stop, step_root_t, any_found

    # ------------------------------------------------------------------
    def dense_output(self, st, te_b):
        """ys, the quadrature and the rows at (neval, B) times inside each
        member's last step (None for what the solve has not)."""
        gs = ss = None
        if self.p.integrate_out:
            gs = self.interp(te_b, st.gD, st.t, st.h, st.order)
        if self.sens:
            ss = self.interp(te_b, st.sD, st.t, st.h, st.order)
        return self.interp(te_b, st.D, st.t, st.h, st.order), gs, ss

    def at(self, st, tq):
        """(y, dy, g, s) at (B,) times inside each member's last step (g and
        s None without quadrature or rows)."""
        g = s = None
        if self.p.integrate_out:
            g = self.interp(tq, st.gD, st.t, st.h, st.order)
        if self.sens:
            s = self.interp(tq, st.sD, st.t, st.h, st.order)
        return (self.interp(tq, st.D, st.t, st.h, st.order),
                self.interp_deriv(tq, st.D, st.t, st.h, st.order), g, s)
