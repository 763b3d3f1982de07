"""SDIRK/ESDIRK stepper: TR-BDF2, ESDIRK34 and custom tableaus
(counterpart of ``diffsol_tpu.solvers.sdirk``; reference sdirk.rs:90-560 on
the shared core runge_kutta.rs, stage operator op/sdirk.rs).

Each implicit stage solves

    F(z) = M z - h f(t + c_i h, phi_i + gamma z) = 0,
    phi_i = y_n + sum_{j<i} a_ij z_j,

by Newton against the frozen LU of ``M - gamma h J``, one factorization
for every stage (``ops/newton.py``, the problem's linear-solver tier).  The
embedded error estimate ``d . diff`` is premultiplied by that LU's inverse
(after ``M`` when there is a mass, sdirk.rs:474-495), which keeps it sound
on stiff problems.  A stage's Newton starts from an extrapolation of the
previous stage values (runge_kutta.rs:610-630); an ESDIRK tableau's
explicit first stage is h*dy.  The Jacobian-update policy has the
reference's five causes (sdirk.rs:256-304); a Newton failure first
refreshes the Jacobian, a second one cuts h by 0.3.

Augmented rows (``sens=True``: the forward sensitivities) solve each
stage after the state's, by Newton against the same LU (M sz = h (J (sphi
+ gamma sz) + f_p), runge_kutta.rs:695-740), and join the filtered error
test when the problem sets ``sens_rtol`` and ``sens_atol``.

The JAX version is a ``lax.while_loop`` over attempts with ``lax.cond``
branches; this one is an eager step, its scalar control in Python numbers.
The state is member-major, (n,) or (B, n) for a lockstep ensemble, whose
error norm is the mean over states and then the max over members.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import errors
from ..norms import squared_norm, squared_norm_and_worst
from ..ops.controller import clamp_factor, pi_controller_raw
from ..ops.newton import ETA_RESET_JACOBIAN, ETA_RESET_TIMESTEP, newton_solve
from ..problem import OdeProblem, SolverConfig
from .consistent_ic import algebraic_mask, make_consistent
from .rk_common import RkSolver, RkState, Stats, stage_sum
from .state import initial_state, initial_step_size
from .tableau import Tableau, tr_bdf2

# the causes of a Jacobian update (jacobian_update.rs), each with its
# lu_from_* counter
_STEP_SUCCESS = "lu_from_step_success"
_FIRST_CONV_FAIL = "lu_from_first_fail"
_SECOND_CONV_FAIL = "lu_from_second_fail"
_ERROR_TEST_FAIL = "lu_from_error_test"
_CHECKPOINT = "lu_from_checkpoint"


class SdirkSolver(RkSolver):
    """Singly diagonally implicit RK method on an :class:`OdeProblem`."""

    def __init__(self, problem: OdeProblem, tableau: Optional[Tableau] = None,
                 config: Optional[SolverConfig] = None, sens: bool = False,
                 augmented=None):
        tab = tableau if tableau is not None else tr_bdf2()
        a = np.asarray(tab.a)
        gamma = a[-1, -1]
        if gamma == 0.0:
            raise ValueError("SDIRK tableau requires a nonzero diagonal coefficient")
        diag = np.diag(a)
        if not np.allclose(diag[diag != 0.0], gamma):
            raise ValueError("SDIRK requires equal diagonal coefficients gamma")
        if not np.allclose(a[-1], np.asarray(tab.b)):
            raise ValueError("tableau must be stiffly accurate (a[-1] == b)")
        self.problem = problem
        self.tableau = tab
        self.gamma = float(gamma)
        self.config = config or SolverConfig.from_options(problem.options, "sdirk")
        self._alg_mask = algebraic_mask(problem)
        self._nb = problem.lockstep_nbatch
        self._tabs = {}
        # JVP probes an evaluation of the Jacobian (jac_mul_evals)
        self._jvp_probes = getattr(problem.eqn.rhs_jac, "jvp_probes",
                                   problem.eqn.nstates)
        self._set_aug(sens, augmented)

    # ------------------------------------------------------------------
    def _factor(self, t: float, params, jac, h: float):
        p = self.problem
        a = p.linear_solver.assemble(p.eqn.mass_repr(self._t(t), params), jac,
                                     self.gamma * h)
        return p.linear_solver.factor(a)

    def _jacobian_updates(self, st: dict, t: float, y, params, h: float, cause: str):
        """The Jacobian-update policy (sdirk.rs:256-304), whose step-size
        proxy is h itself: re-evaluate J and refactor, refactor with the
        stale J, or keep both.  Updates ``st`` in place."""
        opts = self.problem.options
        rel = abs(h / st["h_last"] - 1.0)
        rhs_pred = {
            _STEP_SUCCESS: st["ssrj"] >= opts.update_rhs_jacobian_after_steps,
            _FIRST_CONV_FAIL: rel < opts.threshold_to_update_rhs_jacobian,
            _SECOND_CONV_FAIL: st["ssrj"] > 0,
            _ERROR_TEST_FAIL: False,
        }.get(cause, True)
        jac_pred = (cause != _STEP_SUCCESS
                    or st["ssj"] >= opts.update_jacobian_after_steps
                    or rel > opts.threshold_to_update_jacobian)
        if not (rhs_pred or jac_pred):
            return
        stats = st["stats"]
        if rhs_pred:
            st["jac"] = self.problem.eqn.jac(self._t(t), y, params)
            stats.jacobian_evals += 1
            stats.jac_mul_evals += self._jvp_probes
            stats.mass_evals += int(self.problem.eqn.mass is not None)
            st["ssrj"] = 0
        st["factors"] = self._factor(t, params, st["jac"], h)
        stats.linear_solver_setups += 1
        st["ssj"] = 0
        st["h_last"] = h
        st["eta"] = ETA_RESET_JACOBIAN
        setattr(stats, cause, getattr(stats, cause) + 1)

    # ------------------------------------------------------------------
    def init_state(self, params=None) -> RkState:
        p = self.problem
        params = p.params if params is None else params
        y, dy, g, _ = initial_state(p, params)
        status = errors.INTERNAL_TIMESTEP
        if self._alg_mask is not None:
            y, dy, status = make_consistent(p, params, y, dy, self._alg_mask)
        h = initial_step_size(p, params, y, dy, self.order)
        t0 = float(p.t0)
        st = dict(stats=Stats(), jac=None, factors=None, ssj=0, ssrj=0, h_last=h,
                  eta=ETA_RESET_JACOBIAN)
        self._jacobian_updates(st, t0, y, params, h, _CHECKPOINT)
        s = self.tableau.s
        root_g = (p.eqn.root(p.t0, y, params) if p.eqn.root is not None
                  else y.new_zeros(0))
        rows = {}
        if self.sens:
            sv, ds = self.aug.start(p.t0, y, dy, params, self._alg_mask)
            rows = dict(s=sv, ds=ds, s_prev=sv,
                        sdiff=sv.new_zeros((s,) + tuple(sv.shape)))
        return RkState(
            y=y, dy=dy, g=g, t=t0, h=h, y_prev=y, dy_prev=dy, g_prev=g, t_prev=t0,
            diff=y.new_zeros((s,) + tuple(y.shape)),
            gdiff=g.new_zeros((s,) + tuple(g.shape)),
            prev_error_norm=math.nan, root_g=root_g, tstop=math.nan, status=status,
            stats=st["stats"], jac=st["jac"], factors=st["factors"],
            eta=ETA_RESET_JACOBIAN, steps_since_jac=0, steps_since_rhs_jac=0,
            h_at_last_jac=h, **rows,
        )

    def reinit_after_reset(self, state: RkState, params) -> RkState:
        p = self.problem
        dy = p.eqn.rhs(self._t(state.t), state.y, params)
        if self._alg_mask is None:
            return dataclasses.replace(state, dy=dy)
        y, dy, status = make_consistent(p, params, state.y, dy, self._alg_mask,
                                        t=state.t)
        return dataclasses.replace(state, y=y, dy=dy, status=status)

    # ------------------------------------------------------------------
    def _stage_predict(self, i: int, h: float, dy0, diff):
        """Newton's starting guess for stage i (runge_kutta.rs:610-630),
        of the state or, from ``ds`` and ``sdiff``, of the augmented rows."""
        if i == 0:
            return h * dy0
        if i == 1:
            return diff[0]
        c = self.tableau.c
        cc = (c[i] - c[i - 2]) / (c[i - 1] - c[i - 2])
        return (1.0 + cc) * diff[i - 1] - cc * diff[i - 2]

    def step(self, state: RkState, params=None) -> RkState:
        """One adaptive SDIRK step (sdirk.rs:409-545)."""
        p = self.problem
        cfg = self.config
        opts = p.options
        tab = self.tableau
        params = p.params if params is None else params
        a, b_vec, _, d_vec, _ = self._arrays(state.y.device)
        c_np = tab.c
        s = tab.s
        gamma = self.gamma
        start = 1 if tab.skip_first_stage else 0
        integrate_out = p.integrate_out
        ki, kp = opts.pi_control_integral, opts.pi_control_proportional
        eff_order = self.order + 1
        clamps = (cfg.minimum_timestep_shrink, cfg.maximum_timestep_shrink,
                  cfg.minimum_timestep_growth, cfg.maximum_timestep_growth)
        m = float(cfg.maximum_newton_iterations)

        root_g = state.root_g
        if p.eqn.root is not None and state.state_modified:
            root_g = p.eqn.root(self._t(state.t), state.y, params)
        g_dg = (self._out_rate(state.t, state.y, params) if integrate_out
                else state.y.new_zeros(0))
        aug = self.aug
        ds0 = None
        if self.sens:
            # the rows' derivative afresh after a reset corrected them
            ds0 = (aug.rhs(self._t(state.t), state.y, params, state.s)
                   if state.state_modified else state.ds)

        st = dict(stats=dataclasses.replace(state.stats), jac=state.jac,
                  factors=state.factors, eta=state.eta, ssj=state.steps_since_jac,
                  ssrj=state.steps_since_rhs_jac, h_last=state.h_at_last_jac)
        h = state.h
        prev_err = state.prev_error_norm
        updated_jac = False
        newton_fails = state.stats.newton_fails
        nattempts = 0
        wm = state.stats.worst_member
        status = errors.INTERNAL_TIMESTEP
        accepted = False
        while not accepted and status == errors.INTERNAL_TIMESTEP:
            diff = torch.zeros_like(state.diff)
            gdiff = torch.zeros_like(state.gdiff)
            sdiff = None if state.sdiff is None else torch.zeros_like(state.sdiff)
            if start == 1:
                diff[0] = h * state.dy
                if integrate_out:
                    gdiff[0] = h * g_dg
                if self.sens:
                    sdiff[0] = h * ds0
            failed = False
            y_stage = state.y
            z_last = diff[0]
            s_stage = state.s
            sz_last = None if sdiff is None else sdiff[0]
            niter = 0  # the last stage's Newton iterations
            for i in range(start, s):
                t_i = state.t + c_np[i] * h
                if not failed:
                    phi = state.y + stage_sum(a[i, :i], diff[:i]) if i > 0 else state.y
                    t_it = self._t(t_i)

                    def residual(z, phi=phi, t_it=t_it, h=h):
                        fz = p.eqn.rhs(t_it, phi + gamma * z, params)
                        return p.eqn.mass_mul(t_it, params, z) - h * fz

                    factors = st["factors"]

                    def lin(v, factors=factors):
                        return p.linear_solver.solve(factors, v)

                    res = newton_solve(
                        residual, lin,
                        self._stage_predict(i, h, state.dy, diff), state.y,
                        p.atol, p.rtol, st["eta"], tol=opts.nonlinear_solver_tolerance,
                        max_iter=cfg.maximum_newton_iterations)
                    st["eta"] = res.eta
                    niter = res.niter
                    z_last = res.x
                    y_stage = phi + gamma * z_last
                    diff[i] = z_last
                    failed = not res.converged
                    if self.sens:
                        # the rows' stage: M sz = h (J (sphi + gamma sz) + f_p)
                        # against the same factors (runge_kutta.rs:695-740)
                        jvp_rows, f_p = aug.linear_parts(t_it, y_stage, params)
                        sphi = (state.s + stage_sum(a[i, :i], sdiff[:i]) if i > 0
                                else state.s)

                        def residual_s(sz, sphi=sphi, t_it=t_it, h=h,
                                       jvp_rows=jvp_rows, f_p=f_p):
                            return (p.eqn.mass_mul(t_it, params, sz)
                                    - h * (jvp_rows(sphi + gamma * sz) + f_p))

                        res_s = newton_solve(
                            residual_s, lin, self._stage_predict(i, h, ds0, sdiff),
                            state.s, aug.atol(p), aug.rtol(p), st["eta"],
                            tol=opts.nonlinear_solver_tolerance,
                            max_iter=cfg.maximum_newton_iterations)
                        sz_last = res_s.x
                        sdiff[i] = sz_last
                        s_stage = sphi + gamma * sz_last
                        failed = failed or not res_s.converged
                        niter += res_s.niter
                    st["stats"].newton_iterations += niter
                    st["stats"].rhs_evals += niter  # one rhs an iteration
                if integrate_out:
                    gdiff[i] = h * self._out_rate(t_i, y_stage, params)

            if failed:
                newton_fails += 1
                st["stats"].newton_fails += 1
                if updated_jac:  # the second failure: a smaller step
                    h = h * 0.3
                    st["eta"] = ETA_RESET_TIMESTEP
                    self._jacobian_updates(st, state.t, state.y, params, h,
                                           _SECOND_CONV_FAIL)
                else:  # the first: a fresher Jacobian
                    self._jacobian_updates(st, state.t, state.y, params, h,
                                           _FIRST_CONV_FAIL)
                    updated_jac = True
                if newton_fails > cfg.maximum_newton_fails:
                    status = errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES
                if abs(h) < cfg.minimum_timestep:
                    status = errors.STEP_SIZE_TOO_SMALL
                prev_err = math.nan
                continue

            # the error test on the LU-filtered embedded estimate
            err_vec = stage_sum(d_vec, diff)
            if p.eqn.mass is not None:
                err_vec = p.eqn.mass_mul(self._t(state.t), params, err_vec)
            err_vec = p.linear_solver.solve(st["factors"], err_vec)
            sq, wm = squared_norm_and_worst(err_vec, state.y, p.atol, p.rtol)
            err = float(sq)
            if p.output_in_error_control():
                err = max(err, float(squared_norm(stage_sum(d_vec, gdiff), state.g,
                                                  p.out_atol, p.out_rtol)))
            if self.sens and p.sens_in_error_control():
                serr = stage_sum(d_vec, sdiff)
                if p.eqn.mass is not None:
                    serr = p.eqn.mass_mul(self._t(state.t), params, serr)
                serr = p.linear_solver.solve(st["factors"], serr)
                err = max(err, float(squared_norm(serr, state.s, aug.atol(p),
                                                  aug.rtol(p))))
            safety = (2.0 * m + 1.0) / (2.0 * m + niter)
            raw = float(pi_controller_raw(err, prev_err, ki, kp, eff_order))
            factor = clamp_factor(0.9 * safety * raw, *clamps)
            accepted = err < 1.0
            if not accepted:
                h = h * factor
                st["eta"] = ETA_RESET_TIMESTEP
                st["stats"].error_test_failures += 1
                self._jacobian_updates(st, state.t, state.y, params, h, _ERROR_TEST_FAIL)
                nattempts += 1
                if nattempts >= cfg.maximum_error_test_failures:
                    status = errors.TOO_MANY_ERROR_TEST_FAILURES
                if abs(h) < cfg.minimum_timestep:
                    status = errors.STEP_SIZE_TOO_SMALL
                prev_err = math.nan
        if status != errors.INTERNAL_TIMESTEP:
            # fatal: keep the old state, record the status
            return dataclasses.replace(state, status=status)

        # Jacobian updates for the next step, at the new step size
        h_next = h * factor
        if factor != 1.0:
            st["eta"] = ETA_RESET_TIMESTEP
        t_new = state.t + h
        self._jacobian_updates(st, t_new, y_stage, params, h_next, _STEP_SUCCESS)
        stats = st["stats"]
        stats.steps += 1
        stats.newton_fails = newton_fails
        stats.worst_member = wm
        g_new = state.g + stage_sum(b_vec, gdiff) if integrate_out else state.g
        rows = {}
        if self.sens:
            rows = dict(s=s_stage, ds=sz_last / h, sdiff=sdiff, s_prev=state.s)
        new = dataclasses.replace(
            state, y=y_stage, dy=z_last / h, g=g_new, t=t_new, h=h_next,
            y_prev=state.y, dy_prev=state.dy, g_prev=state.g, t_prev=state.t,
            diff=diff, gdiff=gdiff, prev_error_norm=err, root_g=root_g,
            state_modified=False, stats=stats, jac=st["jac"], factors=st["factors"],
            eta=st["eta"], steps_since_jac=st["ssj"] + 1,
            steps_since_rhs_jac=st["ssrj"] + 1, h_at_last_jac=st["h_last"],
            root_t=math.nan, root_idx=-1, **rows)
        return self._finish_step(new, state, params, root_g)
