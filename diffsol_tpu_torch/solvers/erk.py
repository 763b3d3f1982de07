"""Adaptive explicit Runge-Kutta stepper, TSIT45 and custom tableaus
(counterpart of ``diffsol_tpu.solvers.erk``; reference explicit_rk.rs:75-250
`ExplicitRk` on the shared core runge_kutta.rs).

One adaptive step: the stages (the first is h*dy, first same as last),
the embedded error ``d . diff`` in the WRMS norm (mean over states, max
over the members of a lockstep ensemble), the PI controller with the
dead-zone clamp, and a retry with a smaller step until the test passes.
Then a root check on the step's dense output and the stop time.  The JAX
version is a ``lax.while_loop``; this one is an eager step whose scalar
control lives in Python numbers, as in the port's BDF solver.
Augmented rows (``sens=True``: the forward sensitivities) go through the
same stages (runge_kutta.rs:537-608) and join the error test when the
problem sets ``sens_rtol`` and ``sens_atol``.

Requirements checked at construction (runge_kutta.rs:232-284): no mass
matrix; the tableau is explicit and stiffly accurate (last row of ``a``
equals ``b``) with c[0] = 0 and c[-1] = 1, so the last stage evaluates
the solution and is reused as the next step's first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .. import errors
from ..norms import squared_norm, squared_norm_and_worst
from ..ops.controller import clamp_factor, pi_controller_raw
from ..problem import OdeProblem, SolverConfig
from .rk_common import RkSolver, RkState, Stats, stage_sum
from .state import initial_state, initial_step_size
from .tableau import Tableau, tsit45


class ErkSolver(RkSolver):
    """Explicit RK method on an :class:`OdeProblem` (no mass matrix)."""

    def __init__(self, problem: OdeProblem, tableau: Optional[Tableau] = None,
                 config: Optional[SolverConfig] = None, sens: bool = False,
                 augmented=None):
        if problem.eqn.mass is not None:
            raise ValueError("explicit RK does not support mass matrices")
        tab = tableau if tableau is not None else tsit45()
        a = np.asarray(tab.a)
        if not np.allclose(np.triu(a), 0.0):
            raise ValueError("explicit RK requires a strictly lower-triangular tableau")
        if not (tab.c[0] == 0.0 and tab.c[-1] == 1.0):
            raise ValueError("tableau must have c[0]=0 and c[-1]=1")
        if not np.allclose(a[-1], np.asarray(tab.b)):
            raise ValueError("tableau must be stiffly accurate (a[-1] == b)")
        self.problem = problem
        self.tableau = tab
        self.config = config or SolverConfig.from_options(problem.options, "erk")
        self._nb = problem.lockstep_nbatch
        self._tabs = {}
        self._set_aug(sens, augmented)

    # ------------------------------------------------------------------
    def init_state(self, params=None) -> RkState:
        p = self.problem
        params = p.params if params is None else params
        y, dy, g, _ = initial_state(p, params)
        h = initial_step_size(p, params, y, dy, self.order)
        s = self.tableau.s
        t0 = float(p.t0)
        root_g = (p.eqn.root(p.t0, y, params) if p.eqn.root is not None
                  else y.new_zeros(0))
        rows = {}
        if self.sens:
            sv, ds = self.aug.start(p.t0, y, dy, params)
            rows = dict(s=sv, ds=ds, s_prev=sv,
                        sdiff=sv.new_zeros((s,) + tuple(sv.shape)))
        return RkState(
            y=y, dy=dy, g=g, t=t0, h=h, y_prev=y, dy_prev=dy, g_prev=g, t_prev=t0,
            diff=y.new_zeros((s,) + tuple(y.shape)),
            gdiff=g.new_zeros((s,) + tuple(g.shape)),
            prev_error_norm=math.nan, root_g=root_g, tstop=math.nan,
            status=errors.INTERNAL_TIMESTEP, stats=Stats(), **rows,
        )

    def _stages(self, h: float, y, dy, g_dg, t: float, params, a, s_rows=None,
                ds_rows=None):
        """The explicit stages: ``(diff, gdiff, y_last, k_last)``, and with
        the augmented rows ``s_rows`` (derivative ``ds_rows``) also
        ``(sdiff, s_last, ds_last)``."""
        p = self.problem
        c = self.tableau.c
        s = self.tableau.s
        diff = y.new_empty((s,) + tuple(y.shape))
        gdiff = g_dg.new_zeros((s,) + tuple(g_dg.shape))
        diff[0] = h * dy
        if p.integrate_out:
            gdiff[0] = h * g_dg
        sens = s_rows is not None
        if sens:
            sdiff = s_rows.new_empty((s,) + tuple(s_rows.shape))
            sdiff[0] = h * ds_rows
            s_i, ds_i = s_rows, ds_rows
        y_i, k_i = y, dy
        for i in range(1, s):
            y_i = y + stage_sum(a[i, :i], diff[:i])
            t_i = t + c[i] * h
            k_i = p.eqn.rhs(self._t(t_i), y_i, params)
            diff[i] = h * k_i
            if sens:
                s_i = s_rows + stage_sum(a[i, :i], sdiff[:i])
                ds_i = self.aug.rhs(self._t(t_i), y_i, params, s_i)
                sdiff[i] = h * ds_i
            if p.integrate_out:
                gdiff[i] = h * self._out_rate(t_i, y_i, params)
        if sens:
            return diff, gdiff, y_i, k_i, sdiff, s_i, ds_i
        return diff, gdiff, y_i, k_i

    def step(self, state: RkState, params=None) -> RkState:
        """One adaptive step (explicit_rk.rs:196-243)."""
        p = self.problem
        cfg = self.config
        opts = p.options
        params = p.params if params is None else params
        a, b_vec, _, d_vec, _ = self._arrays(state.y.device)
        ki, kp = opts.pi_control_integral, opts.pi_control_proportional
        eff_order = self.order + 1
        clamps = (cfg.minimum_timestep_shrink, cfg.maximum_timestep_shrink,
                  cfg.minimum_timestep_growth, cfg.maximum_timestep_growth)

        root_g = state.root_g
        if p.eqn.root is not None and state.state_modified:
            root_g = p.eqn.root(self._t(state.t), state.y, params)
        g_dg = (self._out_rate(state.t, state.y, params) if p.integrate_out
                else state.y.new_zeros(0))
        ds0 = None
        if self.sens:
            # the rows' derivative afresh after a reset corrected them
            ds0 = (self.aug.rhs(self._t(state.t), state.y, params, state.s)
                   if state.state_modified else state.ds)

        h = state.h
        natt = 0
        prev = state.prev_error_norm
        wm = state.stats.worst_member
        status = errors.INTERNAL_TIMESTEP
        accepted = False
        err = math.inf
        while not accepted and status == errors.INTERNAL_TIMESTEP:
            stages = self._stages(h, state.y, state.dy, g_dg, state.t, params, a,
                                  state.s if self.sens else None, ds0)
            diff, gdiff, y_new, dy_new = stages[:4]
            sq, wm = squared_norm_and_worst(stage_sum(d_vec, diff), state.y,
                                            p.atol, p.rtol)
            err = float(sq)
            if p.output_in_error_control():
                err = max(err, float(squared_norm(stage_sum(d_vec, gdiff), state.g,
                                                  p.out_atol, p.out_rtol)))
            if self.sens and p.sens_in_error_control():
                err = max(err, float(squared_norm(
                    stage_sum(d_vec, stages[4]), state.s, self.aug.atol(p),
                    self.aug.rtol(p))))
            accepted = err < 1.0
            if not accepted:
                raw = float(pi_controller_raw(err, prev, ki, kp, eff_order))
                h = h * clamp_factor(0.9 * raw, *clamps)
                natt += 1
                prev = math.nan
                if natt >= cfg.maximum_error_test_failures:
                    status = errors.TOO_MANY_ERROR_TEST_FAILURES
                elif abs(h) < cfg.minimum_timestep:
                    status = errors.STEP_SIZE_TOO_SMALL
        if status != errors.INTERNAL_TIMESTEP:
            # fatal: keep the old state, record the status
            return dataclasses.replace(state, status=status)

        # the next step's size, from the accepted error and the error of
        # the step before
        raw = float(pi_controller_raw(err, state.prev_error_norm, ki, kp, eff_order))
        h_next = h * clamp_factor(0.9 * raw, *clamps)
        t_new = state.t + h
        g_new = state.g + stage_sum(b_vec, gdiff) if p.integrate_out else state.g
        st = state.stats
        stats = dataclasses.replace(
            st, steps=st.steps + 1, error_test_failures=st.error_test_failures + natt,
            worst_member=wm,
            # s-1 rhs evaluations an attempt (stage 0 is dy, first same as last)
            rhs_evals=st.rhs_evals + (self.tableau.s - 1) * (natt + 1))
        rows = {}
        if self.sens:
            sdiff, s_new, ds_new = stages[4:]
            rows = dict(s=s_new, ds=ds_new, sdiff=sdiff, s_prev=state.s)
        new = dataclasses.replace(
            state, y=y_new, dy=dy_new, g=g_new, t=t_new, h=h_next,
            y_prev=state.y, dy_prev=state.dy, g_prev=state.g, t_prev=state.t,
            diff=diff, gdiff=gdiff, prev_error_norm=err, root_g=root_g,
            state_modified=False, stats=stats, root_t=math.nan, root_idx=-1, **rows)
        return self._finish_step(new, state, params, root_g)
