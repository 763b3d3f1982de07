"""Independent-ensemble SDIRK and ERK: B members in one batched loop, each
with its own step control (counterpart of ``jax.vmap`` over
``diffsol_tpu.solvers.sdirk.SdirkSolver.step`` and
``diffsol_tpu.solvers.erk.ErkSolver.step`` under
``diffsol_tpu.drivers.solve_dense``, as ``diffsol_tpu.ensemble``'s
``mode="independent"`` runs them).

The solve loop, the host control, Newton masked per member, the root search
and the factorization of a subset are :mod:`.independent`'s; this module
brings the Runge-Kutta state and step attempt.  Every scalar of
:class:`~.rk_common.RkState` becomes a (B,) tensor (t, h, t_prev, the
previous error norm, tstop, the status and the root found, and SDIRK's
eta, the Jacobian policy's counters and the step size of the last
factorization); the stage values ``diff`` are (s, B, n), the rows
(naug, B, n) and their stage values ``sdiff`` (s, naug, B, n).

A round is one step attempt of every unfinished member, its decisions in
the single solve's order:

* ERK (``ErkSolver.step``): the stages at the member's own t and h, the
  embedded error (with the output and the rows where their error control
  asks), then the rejection (the PI controller on the attempt's previous
  error, NaN after a rejection) or the acceptance (the controller on the
  step's previous error); s - 1 rhs evaluations an attempt.
* SDIRK (``SdirkSolver.step``): stage by stage, Newton masked per member
  against the member's own factors (a member that failed at a stage skips
  the later stages' Newton), the rows' Newton after the state's; the
  failure ladder (the first failure refreshes the Jacobian, the second
  cuts h by 0.3); the error test on the LU-filtered estimate; the safety
  factor of the last stage's Newton iterations; the Jacobian policy with
  its causes, evaluated per member, whose refresh of J and of the factors
  of M - gamma h J runs on the subset that asks.

Then, for both, the accepted step: the root check on the member's own
interpolant (the tableau's continuous extension, else the cubic Hermite,
at a (B,) theta) and the tstop clamp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, ClassVar, Optional

import torch

from .. import errors
from ..norms import error_scale
from ..ops.newton import ETA_RESET_JACOBIAN, ETA_RESET_TIMESTEP
from .erk import ErkSolver
from .independent import _CAUSES, _EPS, F64, I64, BatchedLoop, _rdiv, _where, _wm, member_stats
from .rk_common import Stats, stage_sum, tableau_arrays

# _CAUSES' indices of the SDIRK policy's causes
_FIRST_FAIL, _SECOND_FAIL, _ERROR_TEST, _STEP_SUCCESS = 1, 2, 3, 4


@dataclass
class RkIndependentState:
    """The batched state of an SDIRK or ERK independent ensemble: the
    fields of :class:`~.rk_common.RkState` with a leading member axis
    ((B,) scalars, (B, n) vectors, (s, B, n) stage values; the rows
    (naug, B, n), their stage values (s, naug, B, n)), ``stats`` a
    :class:`~.rk_common.Stats` of (B,) counters, and the loop's own
    counts.  The Jacobian and the policy's fields stay None for ERK."""

    # as bdf_independent.IndependentState.MEMBER_DIMS
    MEMBER_DIMS: ClassVar[dict] = dict(diff=1, gdiff=1, s=1, ds=1, s_prev=1, sdiff=2,
                                       jac=None, factors=None)

    y: torch.Tensor
    dy: torch.Tensor
    g: torch.Tensor
    t: torch.Tensor
    h: torch.Tensor
    y_prev: torch.Tensor
    dy_prev: torch.Tensor
    g_prev: torch.Tensor
    t_prev: torch.Tensor
    diff: torch.Tensor
    gdiff: torch.Tensor
    prev_error_norm: torch.Tensor
    root_g: torch.Tensor
    tstop: torch.Tensor
    status: torch.Tensor
    root_t: torch.Tensor
    root_idx: torch.Tensor
    state_modified: torch.Tensor
    stats: Stats
    jac: Optional[torch.Tensor] = None
    factors: Any = None
    eta: Optional[torch.Tensor] = None
    steps_since_jac: Optional[torch.Tensor] = None
    steps_since_rhs_jac: Optional[torch.Tensor] = None
    h_at_last_jac: Optional[torch.Tensor] = None
    s: Optional[torch.Tensor] = None
    ds: Optional[torch.Tensor] = None
    s_prev: Optional[torch.Tensor] = None
    sdiff: Optional[torch.Tensor] = None
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


def clamp_factors(f, min_reduce: float, max_reduce: float, min_increase: float,
                  max_increase: float):
    """ops.controller.clamp_factor on (B,) factors: the dead zone, then
    the clamps; a NaN factor stays NaN."""
    f = torch.where((max_reduce < f) & (f < min_increase), 1.0, f)
    f = torch.where(min_reduce > f, min_reduce, f)
    return torch.where(max_increase < f, max_increase, f)


def _tv(theta, like):
    """(B,) or (neval, B) values onto a tensor whose last two axes are
    (B, n), or whose last three are the rows' (naug, B, n)."""
    x = theta.unsqueeze(-1)
    if like.ndim >= 3 and x.ndim >= 3:
        x = x.unsqueeze(-3)
    return x


def _combine(w, diff):
    """sum_j w[..., j] diff[j] (stage_sum with per-member weights): w
    (*lead, B, s), diff (s, *mid, B, n) -> (*lead, *mid, B, n)."""
    s = diff.shape[0]
    lead, mid = tuple(w.shape[:-2]), tuple(diff.shape[1:-2])
    wv = w.movedim(-1, 0).reshape((s,) + lead + (1,) * len(mid) + (w.shape[-2], 1))
    dv = diff.reshape((s,) + (1,) * len(lead) + tuple(diff.shape[1:]))
    return (wv * dv).sum(0)


def _hermite(tv, u0, u1, diff):
    f0 = diff[0]
    f1 = diff[-1]
    q = (1.0 - 2.0 * tv) * (u1 - u0) + (tv - 1.0) * f0 + tv * f1
    return tv * (tv - 1.0) * q + (1.0 - tv) * u0 + tv * u1


def _hermite_deriv(tv, dt, u0, u1, diff):
    f0 = diff[0]
    f1 = diff[-1]
    q = (1.0 - 2.0 * tv) * (u1 - u0) + (tv - 1.0) * f0 + tv * f1
    dq = -2.0 * (u1 - u0) + f0 + f1
    return ((u1 - u0) + (2.0 * tv - 1.0) * q + tv * (tv - 1.0) * dq) / dt


class RkBatched(BatchedLoop):
    """The SDIRK or ERK loop of one independent ensemble solve; see the
    module docstring."""

    def __init__(self, solver, params_b: torch.Tensor):
        super().__init__(solver, params_b)
        tab = solver.tableau
        self.tab = tab
        self.erk = type(solver) is ErkSolver
        self.a, self.b, _, self.d, self.beta = tableau_arrays(tab, self.dev, self.dtype)
        self.c = tab.c
        self.ns = tab.s
        self.order = tab.order
        if self.beta is not None:
            self.kpow = torch.arange(1, self.beta.shape[1] + 1, dtype=self.dtype,
                                     device=self.dev)
        if self.erk:
            self.SNAP = ("h",)
        else:
            self.gamma = solver.gamma
            self.start = 1 if tab.skip_first_stage else 0
            self.SNAP = ("h", "eta", "steps_since_jac", "steps_since_rhs_jac", "h_at_last_jac")
        cfg = self.cfg
        self.clamps = (cfg.minimum_timestep_shrink, cfg.maximum_timestep_shrink,
                       cfg.minimum_timestep_growth, cfg.maximum_timestep_growth)

    # ------------------------------------------------------------------
    # dense output inside each member's last step [t0, t1]
    # (rk_common.interp_*), at (B,) or (neval, B) times
    def _weights(self, theta, deriv: bool):
        """(..., s) weights of the continuous extension at ``theta``
        (rk_common._beta_poly)."""
        k = self.kpow
        th = self.tt(theta).unsqueeze(-1)
        powers = k * th ** (k - 1.0) if deriv else th ** k
        return powers @ self.beta.T

    def _interp(self, t, t0, t1, u0, u1, diff):
        """u inside the step from (t0, u0) to (t1, u1) with stage values
        ``diff``."""
        dt = t1 - t0
        theta = torch.where(dt == 0.0, 1.0, (t - t0) / dt)
        if self.beta is not None:
            return u0 + _combine(self._weights(theta, False), diff)
        return _hermite(_tv(self.tt(theta), u0), u0, u1, diff)

    def interp_y(self, st, t):
        return self._interp(t, st.t_prev, st.t, st.y_prev, st.y, st.diff)

    def interp_dy(self, st, t):
        """dy/dt inside the last step; the stored dy on a zero-length
        step."""
        dt = st.t - st.t_prev
        theta = torch.where(dt == 0.0, 1.0, (t - st.t_prev) / dt)
        dtv = _tv(self.tt(dt), st.y)
        if self.beta is not None:
            dy = _combine(self._weights(theta, True), st.diff) / dtv
        else:
            dy = _hermite_deriv(_tv(self.tt(theta), st.y), dtv, st.y_prev, st.y, st.diff)
        return _where(dt == 0.0, st.dy, dy)

    def dense_output(self, st, te_b):
        gs = ss = None
        if self.p.integrate_out:
            gs = self._interp(te_b, st.t_prev, st.t, st.g_prev, st.g, st.gdiff)
        if self.sens:
            ss = self._interp(te_b, st.t_prev, st.t, st.s_prev, st.s, st.sdiff)
        return self.interp_y(st, te_b), gs, ss

    def at(self, st, tq):
        y, g, s = self.dense_output(st, tq)
        return y, self.interp_dy(st, tq), g, s

    # ------------------------------------------------------------------
    def tstop_check(self, t, h, tstop):
        """rk_common.tstop_check per member -> (reached, h)."""
        has = ~torch.isnan(tstop)
        tr = 100.0 * _EPS * (t.abs() + h.abs())
        reached = has & ((t - tstop).abs() <= tr)
        over = has & torch.where(h > 0.0, t + h > tstop + tr, t + h < tstop - tr)
        factor = torch.where(over & ~reached, (tstop - t) / h, 1.0)
        return reached, h * factor

    def policy(self, st, mask, t, y, h, cause):
        """SdirkSolver._jacobian_updates for the members of ``mask``, each
        with its own (t, y, h) and cause (an index into _CAUSES): its
        step-size proxy is h itself; J re-evaluated and M - gamma h J
        refactored, or refactored with the stale J, on the subset that
        asks."""
        opts, stats = self.opts, st.stats
        rel = (h / st.h_at_last_jac - 1.0).abs()
        ssrj, ssj = st.steps_since_rhs_jac, st.steps_since_jac
        rhs_pred = torch.where(
            cause == _STEP_SUCCESS, ssrj >= opts.update_rhs_jacobian_after_steps,
            torch.where(cause == _FIRST_FAIL, rel < opts.threshold_to_update_rhs_jacobian,
                        torch.where(cause == _SECOND_FAIL, ssrj > 0, cause != _ERROR_TEST)))
        jac_pred = ((cause != _STEP_SUCCESS) | (ssj >= opts.update_jacobian_after_steps)
                    | (rel > opts.threshold_to_update_jacobian))
        do = mask & (rhs_pred | jac_pred)
        rhs_pred = rhs_pred & do
        idx = torch.nonzero(do).squeeze(1)
        self.reads += 1  # nonzero's size
        if idx.numel() == 0:
            return
        pb = self.params.index_select(0, idx)
        t_s = t.index_select(0, idx)
        jac_s = st.jac.index_select(0, idx)
        rj = rhs_pred.index_select(0, idx)
        jac_s = _where(rj, self.eqn.jac(self.tt(t_s), y.index_select(0, idx), pb), jac_s)
        st.jac.index_copy_(0, idx, jac_s)
        self.factor_subset(st, idx, t_s, jac_s, self.gamma * h.index_select(0, idx))
        rp = rhs_pred.to(I64)
        stats.jacobian_evals += rp
        stats.jac_mul_evals += rp * self.jvp_probes
        if self.eqn.mass is not None:
            stats.mass_evals += rp
        st.steps_since_rhs_jac = torch.where(rhs_pred, 0, ssrj)
        one = do.to(I64)
        stats.linear_solver_setups += one
        for k, name in enumerate(_CAUSES):
            getattr(stats, name).add_(one & (cause == k).to(I64))
        st.steps_since_jac = torch.where(do, 0, ssj)
        st.h_at_last_jac = torch.where(do, h, st.h_at_last_jac)
        st.eta = torch.where(do, ETA_RESET_JACOBIAN, st.eta)

    # ------------------------------------------------------------------
    def init_state(self, t_final: float) -> RkIndependentState:
        """The solver's init_state of every member, then drivers.solve_dense's
        set_stop_time(final_time)."""
        p, B, dev = self.p, self.B, self.dev
        params = self.params
        t = torch.full((B,), float(p.t0), dtype=F64, device=dev)
        y = self.eqn.init(p.t0, params)
        dy = self.eqn.rhs(self.tt(t), y, params)
        g = (torch.zeros_like(self.out(t, y)) if p.integrate_out
             else y.new_zeros((B, 0)))
        status = torch.zeros(B, dtype=I64, device=dev)
        if not self.erk and self.alg is not None:
            y, dy, status = self.make_consistent(t, y, dy, torch.ones(B, dtype=torch.bool,
                                                                       device=dev))
        h = self.initial_step_size(t, y, dy, self.order)
        root_g = (self.eqn.root(self.tt(t), y, params) if self.eqn.root is not None
                  else y.new_zeros((B, 0)))
        stats = self.new_stats()
        zl = torch.zeros(B, dtype=I64, device=dev)
        nan = torch.full((B,), math.nan, dtype=F64, device=dev)
        ns = self.ns
        st = RkIndependentState(
            y=y, dy=dy, g=g, t=t, h=h, y_prev=y, dy_prev=dy, g_prev=g, t_prev=t.clone(),
            diff=y.new_zeros((ns,) + tuple(y.shape)), gdiff=g.new_zeros((ns,) + tuple(g.shape)),
            prev_error_norm=nan.clone(), root_g=root_g, tstop=nan.clone(), status=status,
            root_t=nan.clone(), root_idx=zl - 1,
            state_modified=torch.zeros(B, dtype=torch.bool, device=dev), stats=stats,
            n_steps=zl.clone())
        if not self.erk:
            # the policy's checkpoint: J and M - gamma h J of every member
            st.jac = self.eqn.jac(self.tt(t), y, params)
            a = self.spec.assemble(self.eqn.mass_repr(self.tt(t), params), st.jac,
                                   self.c_of(self.gamma * h, st.jac))
            st.factors = self.spec.factor(a)
            stats.jacobian_evals += 1
            stats.jac_mul_evals += self.jvp_probes
            if self.eqn.mass is not None:
                stats.mass_evals += 1
            stats.linear_solver_setups += 1
            stats.lu_from_checkpoint += 1
            st.steps_since_jac, st.steps_since_rhs_jac = zl.clone(), zl.clone()
            st.h_at_last_jac = h.clone()
            st.eta = torch.full((B,), ETA_RESET_JACOBIAN, dtype=F64, device=dev)
        if self.sens:
            s, ds = self.sens_start(t, y, dy)
            st.s, st.ds, st.s_prev = s, ds, s
            st.sdiff = s.new_zeros((ns,) + tuple(s.shape))
        # set_stop_time (rk_common.py:258-267)
        st.tstop = torch.full((B,), float(t_final), dtype=F64, device=dev)
        _, st.h = self.tstop_check(st.t, st.h, st.tstop)
        past = st.tstop < st.t - 100.0 * _EPS * (st.t.abs() + st.h.abs())
        st.status = torch.where(past, errors.STOP_TIME_BEFORE_CURRENT_TIME, st.status)
        return st

    # ------------------------------------------------------------------
    def begin(self, st):
        """A step's own variables (the solvers' step locals), per member."""
        self.natt = torch.zeros(self.B, dtype=I64, device=self.dev)
        self.updated_jac = torch.zeros(self.B, dtype=torch.bool, device=self.dev)
        self.prev_err = st.prev_error_norm.clone()
        self.root_g0 = st.root_g
        self.ds0 = st.ds

    def attempt(self, st, run, fr, mod, any_mod):
        """One step attempt of every member of ``run``, committed:
        ``(accepted, fatal status (0: none), the step's stop, its root
        time, whether a member found a root)``."""
        p, eqn, params = self.p, self.eqn, self.params
        self.natt = torch.where(fr, 0, self.natt)
        self.updated_jac = self.updated_jac & ~fr
        self.prev_err = torch.where(fr, st.prev_error_norm, self.prev_err)
        self.root_g0 = _where(fr, st.root_g, self.root_g0)
        if self.sens:
            self.ds0 = _wm(fr, st.ds, self.ds0)
        if any_mod:
            # root(t, y) and the rows' derivative afresh after a pin or a reset
            if eqn.root is not None:
                self.root_g0 = _where(mod, eqn.root(self.tt(st.t), st.y, params), self.root_g0)
            if self.sens:
                self.ds0 = _wm(mod, self.aug.rhs(self.tt(st.t), st.y, params, st.s), self.ds0)
        g_dg = self.out(st.t, st.y) if p.integrate_out else None
        if self.erk:
            return self.attempt_erk(st, run, g_dg)
        return self.attempt_sdirk(st, run, g_dg)

    def error_norm(self, st, e, eg, es):
        """The attempt's squared error norm: the state's, the output's and
        the rows' where their error control asks (the larger first, as
        Python's ``max``)."""
        p = self.p
        err = self.wnorm2(e, st.y, p.atol, p.rtol)
        if p.output_in_error_control():
            e_g = self.wnorm2(eg, st.g, p.out_atol, p.out_rtol)
            err = torch.where(e_g > err, e_g, err)
        if self.sens and p.sens_in_error_control():
            e_s = self.wnorm2(es, st.s, self.aug.atol(p), self.aug.rtol(p))
            err = torch.where(e_s > err, e_s, err)
        return err

    # ------------------------------------------------------------------
    def attempt_erk(self, st, run, g_dg):
        """ErkSolver.step's accept loop, once."""
        p, eqn, params, aug, cfg = self.p, self.eqn, self.params, self.aug, self.cfg
        a, c, ns = self.a, self.c, self.ns
        h = st.h
        hh = self.s(h)
        diff = st.y.new_empty((ns,) + tuple(st.y.shape))
        gdiff = st.g.new_zeros((ns,) + tuple(st.g.shape))
        diff[0] = hh * st.dy
        if p.integrate_out:
            gdiff[0] = hh * g_dg
        sdiff = s_i = ds_i = None
        if self.sens:
            sdiff = st.s.new_empty((ns,) + tuple(st.s.shape))
            sdiff[0] = hh * self.ds0
            s_i, ds_i = st.s, self.ds0
        y_i, k_i = st.y, st.dy
        for i in range(1, ns):
            y_i = st.y + stage_sum(a[i, :i], diff[:i])
            t_i = self.tt(st.t + c[i] * h)
            k_i = eqn.rhs(t_i, y_i, params)
            diff[i] = hh * k_i
            if self.sens:
                s_i = st.s + stage_sum(a[i, :i], sdiff[:i])
                ds_i = aug.rhs(t_i, y_i, params, s_i)
                sdiff[i] = hh * ds_i
            if p.integrate_out:
                gdiff[i] = hh * self.out(t_i, y_i)
        err = self.error_norm(st, stage_sum(self.d, diff), stage_sum(self.d, gdiff),
                              None if sdiff is None else stage_sum(self.d, sdiff))
        accepted = err < 1.0
        rej = run & ~accepted
        acc = run & accepted
        # the rejection's factor from the attempt's previous error (NaN
        # after a rejection), the accepted step's from the step's
        raws = self.pi_raw(torch.stack([err, err]),
                           torch.stack([self.prev_err, st.prev_error_norm]),
                           float(self.order + 1), torch.stack([rej, acc]))
        f = clamp_factors(0.9 * raws, *self.clamps)
        h_rej = h * f[0]
        self.natt = self.natt + rej.to(I64)
        self.prev_err = torch.where(rej, math.nan, self.prev_err)
        status_f = torch.where(rej & (h_rej.abs() < cfg.minimum_timestep),
                               errors.STEP_SIZE_TOO_SMALL, 0)
        status_f = torch.where(rej & (self.natt >= cfg.maximum_error_test_failures),
                               errors.TOO_MANY_ERROR_TEST_FAILURES, status_f)
        st.h = torch.where(rej, h_rej, st.h)
        stats = st.stats
        one = acc.to(I64)
        stats.steps += one
        stats.error_test_failures += one * self.natt
        # s-1 rhs evaluations an attempt (stage 0 is dy, first same as last)
        stats.rhs_evals += one * (ns - 1) * (self.natt + 1)
        g_new = st.g + stage_sum(self.b, gdiff) if p.integrate_out else st.g
        rows = None if not self.sens else (s_i, ds_i, sdiff)
        return self.finish(st, acc, status_f, h, h * f[1], y_i, k_i, g_new, diff, gdiff,
                           err, rows)

    # ------------------------------------------------------------------
    def _stage_predict(self, i: int, hh, dy0, diff):
        """Newton's starting guess for stage i (runge_kutta.rs:610-630)."""
        if i == 0:
            return hh * dy0
        if i == 1:
            return diff[0]
        c = self.c
        cc = (c[i] - c[i - 2]) / (c[i - 1] - c[i - 2])
        return (1.0 + cc) * diff[i - 1] - cc * diff[i - 2]

    def attempt_sdirk(self, st, run, g_dg):
        """SdirkSolver.step's accept loop, once."""
        p, eqn, params, aug, cfg = self.p, self.eqn, self.params, self.aug, self.cfg
        a, c, ns, gamma = self.a, self.c, self.ns, self.gamma
        stats = st.stats
        m = float(cfg.maximum_newton_iterations)
        h = st.h
        hh = self.s(h)
        diff = torch.zeros_like(st.diff)
        gdiff = torch.zeros_like(st.gdiff)
        sdiff = None if st.sdiff is None else torch.zeros_like(st.sdiff)
        if self.start == 1:
            diff[0] = hh * st.dy
            if p.integrate_out:
                gdiff[0] = hh * g_dg
            if self.sens:
                sdiff[0] = hh * self.ds0
        failed = torch.zeros_like(run)
        y_stage, z_last = st.y, diff[0]
        s_stage = st.s
        sz_last = None if sdiff is None else sdiff[0]
        niter = torch.zeros(self.B, dtype=I64, device=self.dev)  # the last stage's
        scale = error_scale(st.y, p.atol, p.rtol)
        scale_s = None if not self.sens else error_scale(st.s, aug.atol(p), aug.rtol(p))
        for i in range(self.start, ns):
            t_it = self.tt(st.t + c[i] * h)
            live = run & ~failed
            phi = st.y + stage_sum(a[i, :i], diff[:i]) if i > 0 else st.y

            def residual(z, phi=phi, t_it=t_it):
                fz = eqn.rhs(t_it, phi + gamma * z, params)
                return eqn.mass_mul(t_it, params, z) - hh * fz

            x, conv, ni, eta = self.newton(residual, self._stage_predict(i, hh, st.dy, diff),
                                           scale, st.factors, st.eta, live)
            st.eta = torch.where(live, eta, st.eta)
            z_last = _wm(live, x, z_last)
            y_stage = _wm(live, phi + gamma * x, y_stage)
            diff[i] = _wm(live, x, diff[i])
            fail = live & ~conv
            if self.sens:
                # the rows' stage: M sz = h (J (sphi + gamma sz) + f_p)
                # against the same factors (runge_kutta.rs:695-740)
                jvp_rows, f_p = aug.linear_parts(t_it, y_stage, params)
                sphi = st.s + stage_sum(a[i, :i], sdiff[:i]) if i > 0 else st.s

                def residual_s(sz, sphi=sphi, t_it=t_it, jvp_rows=jvp_rows, f_p=f_p):
                    return (eqn.mass_mul(t_it, params, sz)
                            - hh * (jvp_rows(sphi + gamma * sz) + f_p))

                xs, conv_s, ni_s, _ = self.newton(
                    residual_s, self._stage_predict(i, hh, self.ds0, sdiff), scale_s,
                    st.factors, st.eta, live)
                sz_last = _wm(live, xs, sz_last)
                sdiff[i] = _wm(live, xs, sdiff[i])
                s_stage = _wm(live, sphi + gamma * xs, s_stage)
                fail = fail | (live & ~conv_s)
                ni = ni + ni_s
            niter = torch.where(live, ni, niter)
            ni = torch.where(live, ni, 0)
            stats.newton_iterations += ni
            stats.rhs_evals += ni  # one rhs an iteration
            failed = failed | fail
            if p.integrate_out:
                gdiff[i] = hh * self.out(t_it, y_stage)

        # the failure ladder: the first failure refreshes J, the second
        # cuts h by 0.3
        nf = run & failed
        stats.newton_fails += nf.to(I64)
        second = nf & self.updated_jac
        first = nf & ~self.updated_jac
        self.updated_jac = self.updated_jac | first
        h_fail = torch.where(second, h * 0.3, h)
        status_f = torch.where(nf & (stats.newton_fails > cfg.maximum_newton_fails),
                               errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES, 0)
        status_f = torch.where(nf & (h_fail.abs() < cfg.minimum_timestep),
                               errors.STEP_SIZE_TOO_SMALL, status_f)

        # the error test on the LU-filtered embedded estimate
        ok = run & ~failed

        def filtered(x):
            if eqn.mass is not None:
                x = eqn.mass_mul(self.tt(st.t), params, x)
            return self.lin_solve(st.factors, x, ok)

        # the rows' estimate is solved where the error control reads it
        sens_err = sdiff is not None and p.sens_in_error_control()
        err = self.error_norm(
            st, filtered(stage_sum(self.d, diff)), stage_sum(self.d, gdiff),
            filtered(stage_sum(self.d, sdiff)) if sens_err else None)
        safety = _rdiv(2.0 * m + 1.0, 2.0 * m + niter.to(F64))
        raw = self.pi_raw(err, self.prev_err, float(self.order + 1), ok)
        factor = clamp_factors(0.9 * safety * raw, *self.clamps)
        accepted = err < 1.0
        ef = ok & ~accepted
        acc = ok & accepted
        h_ef = h * factor
        stats.error_test_failures += ef.to(I64)
        self.natt = self.natt + ef.to(I64)
        status_f = torch.where(ef & (self.natt >= cfg.maximum_error_test_failures),
                               errors.TOO_MANY_ERROR_TEST_FAILURES, status_f)
        status_f = torch.where(ef & (h_ef.abs() < cfg.minimum_timestep),
                               errors.STEP_SIZE_TOO_SMALL, status_f)
        self.prev_err = torch.where(nf | ef, math.nan, self.prev_err)

        # one policy call: the failures' and the error test's refresh at
        # the step's start with their new h, the accepted step's at its end
        # with the next h
        h_next = h * factor
        t_new = st.t + h
        st.eta = torch.where(second | ef | (acc & (factor != 1.0)), ETA_RESET_TIMESTEP, st.eta)
        cause = torch.where(first, _FIRST_FAIL, torch.where(
            second, _SECOND_FAIL, torch.where(ef, _ERROR_TEST, _STEP_SUCCESS)))
        self.policy(st, run, torch.where(acc, t_new, st.t), _where(acc, y_stage, st.y),
                    torch.where(nf, h_fail, torch.where(ef, h_ef, h_next)), cause)
        st.h = torch.where(nf, h_fail, torch.where(ef, h_ef, st.h))
        one = acc.to(I64)
        stats.steps += one
        st.steps_since_jac = st.steps_since_jac + one
        st.steps_since_rhs_jac = st.steps_since_rhs_jac + one
        g_new = st.g + stage_sum(self.b, gdiff) if p.integrate_out else st.g
        rows = None if not self.sens else (s_stage, sz_last / hh, sdiff)
        return self.finish(st, acc, status_f, h, h_next, y_stage, z_last / hh, g_new, diff,
                           gdiff, err, rows)

    # ------------------------------------------------------------------
    def finish(self, st, acc, status_f, h, h_next, y_new, dy_new, g_new, diff, gdiff, err,
               rows):
        """The accepted step of the members of ``acc``: the root check on
        its interpolant and the stop time (RkSolver._finish_step), then
        the commit; returns :meth:`attempt`'s tuple."""
        eqn = self.eqn
        t_new = st.t + h
        new = dict(y=y_new, dy=dy_new, g=g_new, t=t_new, y_prev=st.y, dy_prev=st.dy,
                   g_prev=st.g, t_prev=st.t, diff=diff, gdiff=gdiff)
        if rows is not None:
            new.update(s=rows[0], ds=rows[1], sdiff=rows[2], s_prev=st.s)
        step_stop = torch.full_like(st.status, errors.INTERNAL_TIMESTEP)
        step_root_t = torch.full_like(t_new, math.nan)
        step_root_idx = torch.full_like(st.root_idx, -1)
        root_g_new = st.root_g
        any_found = False
        if eqn.root is not None:
            found, rt, ri, g1, any_found = self.check_root(
                acc, self.root_g0, st.t, y_new, t_new,
                lambda tq: self._interp(tq, st.t, t_new, st.y, y_new, diff))
            step_stop = torch.where(found, errors.ROOT_FOUND, step_stop)
            step_root_t = torch.where(found, rt, step_root_t)
            step_root_idx = torch.where(found, ri, step_root_idx)
            root_g_new = _where(acc, g1.to(st.root_g.dtype), st.root_g)
        reached, h_next = self.tstop_check(t_new, h_next, st.tstop)
        step_stop = torch.where((step_stop == errors.INTERNAL_TIMESTEP) & reached,
                                errors.TSTOP_REACHED, step_stop)
        for name, v in new.items():
            setattr(st, name, _wm(acc, v, getattr(st, name)))
        st.h = torch.where(acc, h_next, st.h)
        st.prev_error_norm = torch.where(acc, err, st.prev_error_norm)
        st.root_g = root_g_new
        st.root_t = torch.where(acc, step_root_t, st.root_t)
        st.root_idx = torch.where(acc, step_root_idx, st.root_idx)
        st.state_modified = st.state_modified & ~acc
        return acc, status_f, step_stop, step_root_t, any_found
