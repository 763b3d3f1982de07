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

Quadrature of an output advances a second difference matrix gD beside D
(op/bdf.rs:45-57), and a root function is checked on the accepted step's
interpolant (bdf.rs:1566-1579).  A mass is diagonal (applied elementwise)
or dense (a matrix product, and ``M - c*J`` assembled in the tier's
representation); a singular one starts from consistent initial conditions
(:mod:`.consistent_ic`).

With ``sens=True`` (or an ``augmented`` equation set) the continuous
forward sensitivities ride along (bdf.rs:934-989): their rows keep a
difference matrix ``sD`` of their own, are predicted and corrected by
Newton against the main step's factorized ``M - c*J`` after the main
solve, join the error test and the order selection when the problem sets
``sens_rtol`` and ``sens_atol``, and are rescaled with D.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import errors
from ..augmented import SensEquations
from ..norms import error_test_norms, max_norms
from ..ops.controller import pi_controller_raw
from ..ops.newton import ETA_RESET_JACOBIAN, ETA_RESET_TIMESTEP, newton_solve
from ..ops.rootfind import check_root
from ..problem import OdeProblem, SolverConfig
from ..sharding import refuse_state_axis
from .consistent_ic import algebraic_mask, make_consistent
from .rk_common import Stats
from .state import initial_state, initial_step_size

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


_IDX = np.arange(ND)
_EYE = np.eye(ND)
# rows and columns 0..order, and U = R(1) on them, for each order
_VALID = [(_IDX[:, None] <= o) & (_IDX[None, :] <= o) for o in range(ND)]
_U = [np.where(v, _r_mat(1.0), _EYE) for v in _VALID]


def compute_ru(order: int, factor: float) -> np.ndarray:
    """(ND, ND) RU = R(factor) @ R(1) acting on D rows 0..order, identity
    on the tail (bdf.rs:433-463)."""
    return np.where(_VALID[order], _r_mat(factor), _EYE) @ _U[order]


def sum_in_order(r: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """D'[j] = sum_i r[i, j] * D[i] (``r`` (ND, ND) broadcast against D's
    trailing axes), summed over i in order: one product and one cumsum
    along the leading axis, whose sum runs column by column from i = 0 on
    the CPU and the card alike, whatever D's other axes hold."""
    return torch.cumsum(r * D.unsqueeze(1), 0)[-1]


def apply_ru(ru: np.ndarray, D: torch.Tensor) -> torch.Tensor:
    """D'[j] = sum_i ru[i, j] * D[i].  float64 sums over i in order
    (:func:`sum_in_order`), as each member of the batched independent loop
    does (bdf_independent._Batched.rescale), so that a member and its
    single solve agree bit for bit: a matrix product's order depends on
    its shapes.  float32 keeps the matrix product, in both modules, with
    which its card and CPU solves were measured to agree
    (tests/test_torch_cuda.py's float32 step bound); there a member agrees
    with its single solve to float32's bound, not step for step."""
    ru_t = torch.as_tensor(ru, dtype=D.dtype, device=D.device)
    if D.dtype != torch.float64:
        return torch.tensordot(ru_t, D, dims=([0], [0]))
    return sum_in_order(ru_t.view((ND, ND) + (1,) * (D.ndim - 1)), D)


def rescale_all(D, gD, sD, order: int, factor: float):
    """The difference matrices of the state, the quadrature and the
    sensitivities (ND-leading; None without) under a step-size change by
    ``factor``."""
    ru = compute_ru(order, factor)
    return (apply_ru(ru, D), apply_ru(ru, gD),
            None if sD is None else apply_ru(ru, sD))


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


def interp_deriv_from_diff(t: float, D, t1: float, h: float, order: int):
    """d/dt of the interpolation polynomial (bdf.rs:792-810)."""
    dy = torch.zeros_like(D[0])
    pi, d_pi = 1.0, 0.0
    for i in range(order):
        denom = h * (1.0 + i)
        w = (t - (t1 - h * i)) / denom
        d_pi = d_pi * w + pi / denom
        pi = pi * w
        dy = dy + d_pi * D[i + 1]
    return dy


@dataclass
class BdfState:
    """Restartable BDF snapshot (reference BdfState, bdf_state.rs).
    ``D`` is the (ND, *y.shape) difference matrix and ``gD`` the
    quadrature's (ND, *g.shape), with ``g`` of size 0 when nothing is
    integrated; ``root_g`` holds the root function at the current point.
    With sensitivities, ``s`` holds the (naug, *y.shape) rows and ``sD``
    their (naug, ND, *y.shape) difference matrices (None without).
    Scalar control is held as Python numbers.  ``state_modified`` tells the
    next step to restart the difference matrices at order 1 from (y, dy)
    (after a pin-back to a root or a reset)."""

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
    g: Optional[torch.Tensor] = None
    gD: Optional[torch.Tensor] = None
    root_g: Optional[torch.Tensor] = None
    root_t: float = math.nan
    root_idx: int = -1
    state_modified: bool = False
    s: Optional[torch.Tensor] = None
    sD: Optional[torch.Tensor] = None


def _nd_first(sD):
    """(naug, ND, ...) -> the (ND, naug, ...) view the D helpers take."""
    return None if sD is None else sD.movedim(1, 0)


def _rows_first(sDt):
    return None if sDt is None else sDt.movedim(0, 1)


class BdfSolver:
    """Variable-order NDF/BDF method on an :class:`OdeProblem`;
    ``sens=True`` integrates the forward sensitivities
    (:class:`~diffsol_tpu_torch.augmented.SensEquations`) beside it, and
    ``augmented`` takes any other augmented equation set."""

    def __init__(self, problem: OdeProblem,
                 config: Optional[SolverConfig] = None, sens: bool = False,
                 augmented=None):
        if sens or augmented is not None:
            refuse_state_axis(problem, "a BdfSolver with sensitivities (sens=True)")
        self.problem = problem
        self.config = config or SolverConfig.from_options(problem.options, "bdf")
        eqn = problem.eqn
        # the partition of algebraic states (zero mass diagonal)
        self._alg_mask = algebraic_mask(problem)
        self._nb = problem.lockstep_nbatch
        self._jvp_probes = getattr(eqn.rhs_jac, "jvp_probes", eqn.nstates)
        if augmented is None and sens:
            augmented = SensEquations(problem)
        self.aug = augmented
        self.sens = self.has_sens = augmented is not None

    def with_config(self, config: SolverConfig):
        """A new solver over the same problem and augmented equations with
        another configuration (reference method.rs:84 `config_mut`); a
        solve goes on from the previous one's ``state``."""
        return type(self)(self.problem, config=config, augmented=self.aug)

    def _t(self, t: float) -> torch.Tensor:
        return self.problem.t0.new_tensor(t)

    def _sens_solve(self, t_pred, y_ctx, params, cval, sDt, order, factors, eta):
        """Newton on every augmented row against the main step's factors
        (bdf.rs:934-989): ``(s_delta, converged, niter)``."""
        p = self.problem
        aug = self.aug
        jvp_rows, f_p = aug.linear_parts(t_pred, y_ctx, params)
        s_pred = predict_from_diff(sDt, order)
        psi_s = psi_from_diff(sDt, order)

        def residual(S):
            # mass_mul broadcasts over the leading row axis
            return (p.eqn.mass_mul(t_pred, params, S - s_pred + psi_s)
                    - cval * (jvp_rows(S) + f_p))

        res = newton_solve(
            residual, lambda v: p.linear_solver.solve(factors, v),
            s_pred, s_pred, aug.atol(p), aug.rtol(p), eta,
            tol=p.options.nonlinear_solver_tolerance,
            max_iter=self.config.maximum_newton_iterations, axis=p.member_axis,
            saxis=p.state_axis,
        )
        return res.x - s_pred, res.converged, res.niter

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
        y, dy, g, dg = initial_state(p, params)
        ic_status = errors.INTERNAL_TIMESTEP
        if self._alg_mask is not None:
            y, dy, ic_status = make_consistent(p, params, y, dy, self._alg_mask)
        h = initial_step_size(p, params, y, dy, 1)
        D = y.new_zeros((ND,) + tuple(y.shape))
        D[0] = y
        D[1] = h * dy
        gD = g.new_zeros((ND,) + tuple(g.shape))
        if p.integrate_out:
            gD[0] = g
            gD[1] = h * dg
        root_g = (p.eqn.root(p.t0, y, params) if p.eqn.root is not None
                  else y.new_zeros(0))
        c0 = h * float(_ALPHA[1])
        st = dict(stats=Stats(), jac=None, factors=None, ssj=0, ssrj=0,
                  c_last=c0, eta=ETA_RESET_JACOBIAN)
        self._jac_slim(st, t0, y, params, c0, True, True, "lu_from_checkpoint")
        s = sD = None
        if self.sens:
            # a DAE's algebraic rows made consistent (state.rs:167-239)
            s, ds = self.aug.start(p.t0, y, dy, params, self._alg_mask)
            sD = s.new_zeros((s.shape[0], ND) + tuple(y.shape))
            sD[:, 0] = s
            sD[:, 1] = h * ds
        return BdfState(
            y=y, dy=dy, t=t0, h=h, D=D, order=1, n_equal_steps=0,
            jac=st["jac"], factors=st["factors"], eta=ETA_RESET_JACOBIAN,
            prev_error_norm=math.nan, steps_since_jac=0,
            steps_since_rhs_jac=0, c_last=c0, newton_fails_total=0,
            tstop=math.nan, status=ic_status,
            stats=st["stats"], g=g, gD=gD, root_g=root_g, s=s, sD=sD,
        )

    def _out(self, t: float, y, params):
        """The quadrature's integrand: ``out``, or the state itself."""
        p = self.problem
        return y if p.eqn.out is None else p.eqn.out(self._t(t), y, params)

    def reinit_after_reset(self, state: BdfState, params) -> BdfState:
        """Refresh dy (and re-solve the DAE's consistency) after a reset
        (reference state.rs apply_reset_with_mass)."""
        p = self.problem
        dy = p.eqn.rhs(self._t(state.t), state.y, params)
        if self._alg_mask is None:
            return dataclasses.replace(state, dy=dy)
        y, dy, status = make_consistent(p, params, state.y, dy, self._alg_mask,
                                        t=state.t)
        return dataclasses.replace(state, y=y, dy=dy, status=status)

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
            D, gD, sDt = rescale_all(state.D, state.gD, _nd_first(state.sD),
                                     state.order, factor)
            state = dataclasses.replace(
                state, D=D, gD=gD, sD=_rows_first(sDt), h=state.h * factor,
                n_equal_steps=0, eta=ETA_RESET_TIMESTEP,
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
        integrate_out = p.integrate_out
        out_in_err = p.output_in_error_control()
        tstop = state.tstop

        st = dict(
            stats=dataclasses.replace(state.stats), jac=state.jac,
            factors=state.factors, eta=state.eta,
            ssj=state.steps_since_jac, ssrj=state.steps_since_rhs_jac,
            c_last=state.c_last,
        )
        D = state.D
        gD = state.gD
        sDt = _nd_first(state.sD)
        sens_in_err = self.sens and p.sens_in_error_control()
        h = state.h
        n_equal0 = state.n_equal_steps
        prev_err0 = state.prev_error_norm
        if state.state_modified:
            # restart the difference matrices at order 1 from (y, dy)
            # (bdf.rs:1291-1319); at order 1 the tstop clamp is h itself
            tr0 = 100.0 * _EPS * (abs(state.t) + abs(state.h))
            overshoot0 = not math.isnan(tstop) and abs(state.t - tstop) > tr0 and (
                state.t + state.h > tstop + tr0 if state.h > 0.0
                else state.t + state.h < tstop - tr0)
            if overshoot0:
                h = tstop - state.t
            D = torch.zeros_like(state.D)
            D[0] = state.y
            D[1] = h * state.dy
            if integrate_out:
                gD = torch.zeros_like(state.gD)
                gD[0] = state.g
                gD[1] = h * self._out(state.t, state.y, params)
            if self.sens:
                # the rows as the driver left them (interpolated to a root,
                # then across its reset), with their derivative there
                sDt = torch.zeros_like(sDt)
                sDt[0] = state.s
                sDt[1] = h * self.aug.rhs(self._t(state.t), state.y, params, state.s)
            order, n_equal0, prev_err0 = 1, 0, math.nan
            c1 = state.h * float(_ALPHA[1])
            rel1 = abs(c1 / st["c_last"] - 1.0)
            self._jac_slim(
                st, state.t, state.y, params, c1,
                st["ssrj"] >= opts.update_rhs_jacobian_after_steps,
                st["ssj"] >= opts.update_jacobian_after_steps
                or rel1 > opts.threshold_to_update_jacobian,
                "lu_from_checkpoint")
            if overshoot0:
                st["eta"] = ETA_RESET_TIMESTEP
        # root(t, y) at the current point, whatever happened to the state
        root_g0 = (p.eqn.root(self._t(state.t), state.y, params)
                   if p.eqn.root is not None else state.root_g)
        g_delta = None
        y_pred = predict_from_diff(D, order)
        psi = psi_from_diff(D, order)
        d = torch.zeros_like(state.y)
        conv_fail = False
        err = math.inf
        safety = 1.0
        prev_err = prev_err0
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
                axis=p.member_axis, saxis=p.state_axis,
            )
            d = res.x - y_pred
            solve_ok = res.converged
            niter_total = res.niter
            if self.sens:
                # every row against the same factors, from the same eta
                s_delta, s_ok, s_niter = self._sens_solve(
                    t_pred, y_pred, params, cval, sDt, order, factors, st["eta"])
                solve_ok = solve_ok and s_ok
                niter_total += s_niter

            # quadrature delta (op/bdf.rs:45-57: d_g = c*dg - psi_g)
            if integrate_out:
                g_delta = (cval * self._out(state.t + h, y_pred, params)
                           - psi_from_diff(gD, order))

            # the quadrature and the rows join the test with the NEXT
            # error constant (the rows' norm is the largest row's)
            others = []
            if out_in_err:
                others.append((g_delta, state.g, p.out_atol, p.out_rtol))
            if sens_in_err:
                others.append((s_delta, state.s, p.sens_atol, p.sens_rtol))
            sq_d, wm_new, sq_o = error_test_norms((d, state.y, atol, rtol, p.state_axis),
                                                  others, p.member_axis)
            err_a = sq_d * float(_ERROR_CONST2[order - 1])
            for e in sq_o:
                err_a = max(err_a, e * float(_ERROR_CONST2[order]))
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
            stats.newton_iterations += niter_total
            stats.newton_fails += int(not solve_ok)
            stats.error_test_failures += int(err_fail)
            stats.rhs_evals += niter_total
            st["eta"] = res.eta
            cause = ("lu_from_first_fail" if first else
                     "lu_from_second_fail" if second else "lu_from_error_test")
            self._jac_slim(st, state.t, state.y, params, c_jac, rhs_pred,
                           not accepted_a, cause)

            if do_rescale:
                D, gD, sDt = rescale_all(D, gD, sDt, order, factor)
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
        g_new, gD_new = state.g, gD
        if integrate_out:
            g_new = predict_from_diff(gD, order) + g_delta
            gD_new = update_diff(gD, g_delta, order)
        s_new, sD_new = state.s, sDt
        if self.sens:
            sD_new = update_diff(sDt, s_delta, order)
            s_new = sD_new[0]
        stats = st["stats"]
        stats.steps += 1
        st["ssj"] += 1
        st["ssrj"] += 1
        n_equal = 1 if h_changed else n_equal0 + 1

        # ---- order selection (bdf.rs:1489-1562)
        new_order, sel_factor, do_change = order, 1.0, False
        if n_equal > order:
            # the predicted errors at order - 1 (D column order) and order + 1
            # (column order + 2), each with the rows' when they join the test
            cols = [c for c, on in ((order, order > 1), (order + 2, order < MAX_ORDER))
                    if on]
            parts = []
            for col in cols:
                parts.append((D_new[col], y_new, atol, rtol, p.state_axis))
                if sens_in_err:
                    parts.append((sD_new[col], s_new, p.sens_atol, p.sens_rtol))
            sq = max_norms(parts, p.member_axis)
            per = 2 if sens_in_err else 1
            pred = {col: max(sq[i * per:(i + 1) * per]) for i, col in enumerate(cols)}
            em = (pred[order] * float(_ERROR_CONST2[max(order - 1, 0)])
                  if order > 1 else math.inf)
            ep = (pred[order + 2] * float(_ERROR_CONST2[min(order + 1, MAX_ORDER)])
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
            D_new, gD_new, sD_new = rescale_all(D_new, gD_new, sD_new, new_order,
                                                sel_factor)
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

        # ---- root check (bdf.rs:1566-1579) on the accepted interpolant
        root_t, root_idx, root_g_new = math.nan, -1, root_g0
        if p.eqn.root is not None:
            res_root = check_root(
                lambda tt, yy: p.eqn.root(self._t(tt), yy, params),
                lambda tt: interp_from_diff(tt, D_new, t_new, h_new, order_new),
                root_g0, state.t, y_new, t_new, nbatch=self._nb, axis=p.member_axis)
            if res_root.found and stop == errors.INTERNAL_TIMESTEP:
                stop = errors.ROOT_FOUND
                root_t, root_idx = res_root.t_root, res_root.root_idx
            if res_root.inconsistent:
                stop = errors.ROOT_BATCH_INCONSISTENT
            root_g_new = res_root.g0_next

        # ---- tstop (bdf.rs:694-731), in-step form
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
                D_new, gD_new, sD_new = rescale_all(D_new, gD_new, sD_new, order_new,
                                                    ts_factor)
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
            stats=stats, g=g_new, gD=gD_new, root_g=root_g_new,
            root_t=root_t, root_idx=root_idx, state_modified=False,
            s=s_new, sD=_rows_first(sD_new),
        )

    # ------------------------------------------------------------------
    def interpolate(self, state: BdfState, t: float):
        return interp_from_diff(t, state.D, state.t, state.h, state.order)

    def interpolate_dy(self, state: BdfState, t: float):
        return interp_deriv_from_diff(t, state.D, state.t, state.h, state.order)

    def interpolate_out(self, state: BdfState, t: float):
        return interp_from_diff(t, state.gD, state.t, state.h, state.order)

    def interpolate_sens(self, state: BdfState, t: float):
        """The augmented rows at ``t``, (naug, *y.shape)."""
        return interp_from_diff(t, _nd_first(state.sD), state.t, state.h, state.order)
