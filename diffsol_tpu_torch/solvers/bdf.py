"""Variable-order BDF/NDF stepper, orders 1-5 (counterpart of
``diffsol_tpu.solvers.bdf``; reference bdf.rs:111-1650).

One adaptive step: predict from the backward-difference matrix D, Newton
against the frozen LU of ``M - c*J`` (c = h*alpha_k), WRMS error test, PI
step-size control, R(factor)U rescaling of D on a step-size change, order
selection after order+1 equal steps, the stale-Jacobian update policy and
the convergence-failure ladder (1st failure: refresh J; 2nd: h *= 0.3).

Where the JAX version is straight-line traced arithmetic under
``lax.while_loop`` and ``lax.cond``, this one is an eager step: scalar
control (t, h, order, the counters and every heuristic) lives in Python
floats and ints, and only the state, D, J and the LU factors are tensors.
The state is member-major, (n,) for one instance and (B, n) for a
lockstep ensemble.

NDF coefficients (Shampine & Reichelt): kappa = [0, -0.1850, -1/9,
-0.0823, -0.0415, 0] (bdf.rs:253-260).  As in the JAX package, the
accepted state ``y`` is the corrected solution D[0].

Not ported yet: sensitivities, quadrature, roots and resets, and
consistent initial conditions for a singular mass.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import errors
from ..norms import squared_norm, squared_norm_and_worst
from ..ops.controller import pi_controller_raw
from ..ops.newton import ETA_RESET_JACOBIAN, ETA_RESET_TIMESTEP, newton_solve
from ..problem import OdeProblem, SolverConfig
from .rk_common import Stats
from .state import initial_step_size

MAX_ORDER = 5
ND = MAX_ORDER + 3  # rows of the difference matrix D

# static NDF coefficient tables (bdf.rs:253-276)
_KAPPA = np.array([0.0, -0.1850, -1.0 / 9.0, -0.0823, -0.0415, 0.0])
_GAMMA = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, MAX_ORDER + 1))])
_ALPHA = np.concatenate([[0.0], 1.0 / ((1.0 - _KAPPA[1:]) * _GAMMA[1:])])
# error_const2[i] = (kappa[i]*gamma[i] + 1/(i+1))^2, error_const2[0] = 1
_ERROR_CONST2 = np.concatenate(
    [[1.0], (_KAPPA[1:] * _GAMMA[1:] + 1.0 / np.arange(2, MAX_ORDER + 2)) ** 2]
)
_EPS = float(np.finfo(np.float64).eps)


def _r_mat(f: float) -> np.ndarray:
    """r[i, j] = prod_{m=1..i} (m - 1 - f*j)/m, r[0, j] = 1."""
    j = np.arange(ND, dtype=np.float64)[None, :]
    m = np.arange(1, ND, dtype=np.float64)[:, None]
    rows = np.concatenate([np.ones((1, ND)), (m - 1.0 - f * j) / m], axis=0)
    return np.cumprod(rows, axis=0)


def compute_ru(order: int, factor: float) -> np.ndarray:
    """(ND, ND) RU = R(factor) @ R(1) acting on D rows 0..order, identity
    on the tail (bdf.rs:433-463)."""
    idx = np.arange(ND)
    valid = (idx[:, None] <= order) & (idx[None, :] <= order)
    eye = np.eye(ND)
    r = np.where(valid, _r_mat(factor), eye)
    u = np.where(valid, _r_mat(1.0), eye)
    return r @ u


def apply_ru(ru: np.ndarray, D: torch.Tensor) -> torch.Tensor:
    """D'[j] = sum_i ru[i, j] * D[i]."""
    ru_t = torch.as_tensor(ru, dtype=D.dtype, device=D.device)
    return torch.tensordot(ru_t, D, dims=([0], [0]))


def predict_from_diff(D, order: int):
    """y_pred = sum_{i=0..order} D[i] (bdf.rs:667-672)."""
    acc = D[0]
    for i in range(1, order + 1):
        acc = acc + D[i]
    return acc


def psi_from_diff(D, order: int):
    """psi = alpha[order] * sum_{i=1..order} gamma[i] * D[i]."""
    acc = float(_GAMMA[1]) * D[1]
    for i in range(2, order + 1):
        acc = acc + float(_GAMMA[i]) * D[i]
    return float(_ALPHA[order]) * acc


def update_diff(D, d, order: int):
    """Difference update after an accepted step (bdf.rs:646-665):
    D'[i] = sum_{k=i..order} D[k] + d for i <= order, D'[order+1] = d,
    D'[order+2] = d - D[order+1]."""
    new = D.clone()
    acc = torch.zeros_like(D[0])
    for i in range(order, -1, -1):
        acc = acc + D[i]
        new[i] = acc + d
    new[order + 1] = d
    if order + 2 < ND:
        new[order + 2] = d - D[order + 1]
    return new


def interp_from_diff(t: float, D, t1: float, h: float, order: int):
    """Interpolation polynomial of the last step at time ``t``
    (bdf.rs:767-790)."""
    y = D[0]
    tf = 1.0
    for i in range(order):
        tf = tf * (t - (t1 - h * i)) / (h * (1.0 + i))
        y = y + tf * D[i + 1]
    return y


@dataclass
class BdfState:
    """Restartable BDF snapshot (reference BdfState, bdf_state.rs).
    ``D`` is the (ND, *y.shape) difference matrix; scalar control is held
    as Python numbers."""

    y: torch.Tensor
    dy: torch.Tensor
    t: float
    h: float
    D: torch.Tensor
    order: int
    n_equal_steps: int
    jac: torch.Tensor
    factors: tuple
    eta: float
    prev_error_norm: float  # NaN = none
    steps_since_jac: int
    steps_since_rhs_jac: int
    c_last: float
    newton_fails_total: int
    tstop: float
    status: int
    stats: Stats = field(default_factory=Stats)


class BdfSolver:
    """Variable-order NDF/BDF method on an :class:`OdeProblem`."""

    def __init__(self, problem: OdeProblem,
                 config: Optional[SolverConfig] = None):
        self.problem = problem
        self.config = config or SolverConfig.from_options(problem.options, "bdf")
        eqn = problem.eqn
        if eqn.mass is not None:
            if eqn.mass_diag_fn is None:
                raise NotImplementedError(
                    "non-diagonal mass is not ported yet (ROADMAP.md queue 1 "
                    "item 4)"
                )
            md = eqn.mass_diag_fn(problem.t0, problem.params)
            if bool((md == 0.0).any()):
                raise NotImplementedError(
                    "singular mass needs consistent initial conditions, not "
                    "ported yet (ROADMAP.md queue 1 item 4)"
                )
        self._jvp_probes = getattr(eqn.rhs_jac, "jvp_probes", eqn.nstates)

    def _t(self, t: float) -> torch.Tensor:
        return self.problem.t0.new_tensor(t)

    # ------------------------------------------------------------------
    def _jac_slim(self, st: dict, t, y, params, c, rhs_pred, jac_pred,
                  cause: str):
        """Jacobian-update policy (bdf.rs:467-505 + jacobian_update.rs):
        ``rhs_pred`` re-evaluates J and refactors, ``jac_pred`` refactors
        ``M - c*J`` with the stale J.  Updates ``st`` in place."""
        p = self.problem
        do_any = rhs_pred or jac_pred
        stats = st["stats"]
        if do_any:
            if rhs_pred:
                st["jac"] = p.eqn.jac(self._t(t), y, params)
            a = p.linear_solver.assemble(
                p.eqn.mass_repr(self._t(t), params), st["jac"], c)
            st["factors"] = p.linear_solver.factor(a)
            st["ssj"] = 0
            st["c_last"] = c
            st["eta"] = ETA_RESET_JACOBIAN
            stats.linear_solver_setups += 1
            stats.mass_evals += int(p.eqn.mass is not None)
            setattr(stats, cause, getattr(stats, cause) + 1)
        if rhs_pred:
            st["ssrj"] = 0
            stats.jacobian_evals += 1
            stats.jac_mul_evals += self._jvp_probes

    # ------------------------------------------------------------------
    def init_state(self, params=None) -> BdfState:
        p = self.problem
        params = p.params if params is None else params
        t0 = float(p.t0)
        y = p.eqn.init(p.t0, params)
        dy = p.eqn.rhs(p.t0, y, params)
        h = initial_step_size(p, params, y, dy, 1)
        D = y.new_zeros((ND,) + tuple(y.shape))
        D[0] = y
        D[1] = h * dy
        c0 = h * float(_ALPHA[1])
        st = dict(stats=Stats(), jac=None, factors=None, ssj=0, ssrj=0,
                  c_last=c0, eta=ETA_RESET_JACOBIAN)
        self._jac_slim(st, t0, y, params, c0, True, True, "lu_from_checkpoint")
        return BdfState(
            y=y, dy=dy, t=t0, h=h, D=D, order=1, n_equal_steps=0,
            jac=st["jac"], factors=st["factors"], eta=ETA_RESET_JACOBIAN,
            prev_error_norm=math.nan, steps_since_jac=0,
            steps_since_rhs_jac=0, c_last=c0, newton_fails_total=0,
            tstop=math.nan, status=errors.INTERNAL_TIMESTEP,
            stats=st["stats"],
        )

    def set_stop_time(self, state: BdfState, tstop: float) -> BdfState:
        """Set tstop, shrinking h (and rescaling D) if the next step would
        overshoot it (bdf.rs:694-731)."""
        tstop = float(tstop)
        state = dataclasses.replace(state, tstop=tstop)
        troundoff = 100.0 * _EPS * (abs(state.t) + abs(state.h))
        reached = abs(state.t - tstop) <= troundoff
        overshoot = not reached and (
            state.t + state.h > tstop + troundoff if state.h > 0.0
            else state.t + state.h < tstop - troundoff
        )
        if overshoot:
            factor = (tstop - state.t) / state.h
            state = dataclasses.replace(
                state, D=apply_ru(compute_ru(state.order, factor), state.D),
                h=state.h * factor, n_equal_steps=0, eta=ETA_RESET_TIMESTEP,
            )
        if tstop < state.t - troundoff:
            state = dataclasses.replace(
                state, status=errors.STOP_TIME_BEFORE_CURRENT_TIME)
        return state

    # ------------------------------------------------------------------
    def step(self, state: BdfState, params=None) -> BdfState:
        """One adaptive BDF step (bdf.rs:1277-1650)."""
        p = self.problem
        cfg = self.config
        opts = p.options
        params = p.params if params is None else params
        order = state.order
        max_newton = cfg.maximum_newton_iterations
        ki, kp = opts.pi_control_integral, opts.pi_control_proportional
        atol, rtol = p.atol, p.rtol

        st = dict(
            stats=dataclasses.replace(state.stats), jac=state.jac,
            factors=state.factors, eta=state.eta,
            ssj=state.steps_since_jac, ssrj=state.steps_since_rhs_jac,
            c_last=state.c_last,
        )
        D = state.D
        h = state.h
        y_pred = predict_from_diff(D, order)
        psi = psi_from_diff(D, order)
        d = torch.zeros_like(state.y)
        conv_fail = False
        err = math.inf
        safety = 1.0
        prev_err = state.prev_error_norm
        newton_fails = state.newton_fails_total
        err_fails_step = 0
        accepted = False
        h_changed = False
        status = errors.INTERNAL_TIMESTEP

        # ---- accept loop (bdf.rs:1324-1465): one iteration per attempt
        while not accepted and status == errors.INTERNAL_TIMESTEP:
            cval = h * float(_ALPHA[order])
            t_pred = self._t(state.t + h)

            def residual(x, t_pred=t_pred, y_pred=y_pred, psi=psi, cval=cval):
                fx = p.eqn.rhs(t_pred, x, params)
                return p.eqn.mass_mul(t_pred, params, x - y_pred + psi) - cval * fx

            factors = st["factors"]
            res = newton_solve(
                residual, lambda v: p.linear_solver.solve(factors, v),
                y_pred, y_pred, atol, rtol, st["eta"],
                tol=opts.nonlinear_solver_tolerance, max_iter=max_newton,
            )
            d = res.x - y_pred
            solve_ok = res.converged

            sq_d, wm_new = squared_norm_and_worst(d, state.y, atol, rtol)
            err_a = float(sq_d) * float(_ERROR_CONST2[order - 1])
            accepted_a = solve_ok and err_a <= 1.0
            stats = st["stats"]
            if solve_ok:
                stats.worst_member = wm_new
            m = float(max_newton)
            safety_a = 0.9 * (2.0 * m + 1.0) / (2.0 * m + res.niter)

            first = not solve_ok and not conv_fail
            second = not solve_ok and conv_fail
            err_fail = solve_ok and not accepted_a
            newton_fails += int(not solve_ok)
            too_many = not solve_ok and newton_fails > cfg.maximum_newton_fails
            raw = float(pi_controller_raw(err_a, prev_err, ki, kp, order + 1))
            rej_factor = max(safety_a * raw, cfg.minimum_timestep_shrink)
            factor = rej_factor if err_fail else 0.3
            do_rescale = err_fail or second
            h_new = h * (factor if do_rescale else 1.0)

            # jacobian-update predicates per failure kind (jacobian_update.rs)
            c_jac = h_new * float(_ALPHA[order])
            rel = abs(c_jac / st["c_last"] - 1.0)
            rhs_pred = (first and rel < opts.threshold_to_update_rhs_jacobian) or (
                second and st["ssrj"] > 0)
            stats.newton_iterations += res.niter
            stats.newton_fails += int(not solve_ok)
            stats.error_test_failures += int(err_fail)
            stats.rhs_evals += res.niter
            st["eta"] = res.eta
            cause = ("lu_from_first_fail" if first else
                     "lu_from_second_fail" if second else "lu_from_error_test")
            self._jac_slim(st, state.t, state.y, params, c_jac, rhs_pred,
                           not accepted_a, cause)

            if do_rescale:
                D = apply_ru(compute_ru(order, factor), D)
                y_pred = predict_from_diff(D, order)
                psi = psi_from_diff(D, order)

            err_fails_step += int(err_fail)
            if err_fail and err_fails_step >= cfg.maximum_error_test_failures:
                status = errors.TOO_MANY_ERROR_TEST_FAILURES
            if do_rescale and abs(h_new) < cfg.minimum_timestep:
                status = errors.STEP_SIZE_TOO_SMALL
            if too_many:
                status = errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES

            conv_fail = conv_fail or not solve_ok
            if solve_ok:
                err = err_a
                safety = safety_a
            if not accepted_a:
                prev_err = math.nan
            accepted = accepted_a
            h_changed = h_changed or do_rescale
            h = h_new

        if status != errors.INTERNAL_TIMESTEP:
            # fatal: keep the old state, record the status
            return dataclasses.replace(state, status=status)

        # ---- accepted step (bdf.rs:1469-1486)
        D_new = update_diff(D, d, order)
        y_new = D_new[0]
        t_new = state.t + h
        dy_new = D_new[1] / h
        stats = st["stats"]
        stats.steps += 1
        st["ssj"] += 1
        st["ssrj"] += 1
        n_equal = 1 if h_changed else state.n_equal_steps + 1

        # ---- order selection (bdf.rs:1489-1562)
        new_order, sel_factor, do_change = order, 1.0, False
        if n_equal > order:
            def predicted_err(col, const_idx):
                return float(squared_norm(D_new[col], y_new, atol, rtol)) * float(
                    _ERROR_CONST2[const_idx])

            em = predicted_err(order, max(order - 1, 0)) if order > 1 else math.inf
            ep = (predicted_err(order + 2, min(order + 1, MAX_ORDER))
                  if order < MAX_ORDER else math.inf)
            f3 = [float(pi_controller_raw(e, err, ki, kp, order + k))
                  for k, e in enumerate((em, err, ep))]
            max_index = int(np.argmax(f3))
            new_order = order + max_index - 1
            sel_factor = safety * f3[max_index]
            sel_factor = min(sel_factor, cfg.maximum_timestep_growth)
            sel_factor = max(sel_factor, cfg.minimum_timestep_shrink)
            do_change = (
                sel_factor >= cfg.minimum_timestep_growth
                or sel_factor <= cfg.maximum_timestep_shrink
                or max_index != 1
            )
        order_new = new_order if do_change else order
        h_new = h * (sel_factor if do_change else 1.0)
        if do_change:
            D_new = apply_ru(compute_ru(new_order, sel_factor), D_new)
            st["eta"] = ETA_RESET_TIMESTEP
        c2 = h_new * float(_ALPHA[order_new])
        rel2 = abs(c2 / st["c_last"] - 1.0)
        rhs_pred2 = do_change and st["ssrj"] >= opts.update_rhs_jacobian_after_steps
        jac_pred2 = do_change and (
            st["ssj"] >= opts.update_jacobian_after_steps
            or rel2 > opts.threshold_to_update_jacobian
        )
        self._jac_slim(st, t_new, y_new, params, c2, rhs_pred2, jac_pred2,
                       "lu_from_step_success")
        n_equal_new = 0 if do_change else n_equal
        stop = (errors.STEP_SIZE_TOO_SMALL
                if do_change and abs(h_new) < cfg.minimum_timestep
                else errors.INTERNAL_TIMESTEP)

        # ---- tstop (bdf.rs:694-731), in-step form
        tstop = state.tstop
        eta = st["eta"]
        if not math.isnan(tstop):
            tr1 = 100.0 * _EPS * (abs(t_new) + abs(h_new))
            reached = abs(t_new - tstop) <= tr1
            overshoot = not reached and (
                t_new + h_new > tstop + tr1 if h_new > 0.0
                else t_new + h_new < tstop - tr1
            )
            if overshoot:
                ts_factor = (tstop - t_new) / h_new
                D_new = apply_ru(compute_ru(order_new, ts_factor), D_new)
                h_new = h_new * ts_factor
                n_equal_new = 0
                eta = ETA_RESET_TIMESTEP
            if stop == errors.INTERNAL_TIMESTEP and reached:
                stop = errors.TSTOP_REACHED

        return BdfState(
            y=y_new, dy=dy_new, t=t_new, h=h_new, D=D_new, order=order_new,
            n_equal_steps=n_equal_new, jac=st["jac"], factors=st["factors"],
            eta=eta, prev_error_norm=err, steps_since_jac=st["ssj"],
            steps_since_rhs_jac=st["ssrj"], c_last=st["c_last"],
            newton_fails_total=newton_fails, tstop=tstop, status=stop,
            stats=stats,
        )

    # ------------------------------------------------------------------
    def interpolate(self, state: BdfState, t: float):
        return interp_from_diff(t, state.D, state.t, state.h, state.order)
