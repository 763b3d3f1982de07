"""Solver statistics and the machinery the Runge-Kutta steppers share
(counterpart of ``diffsol_tpu.solvers.rk_common``; reference
runge_kutta.rs:32-1421 `Rk` and sdirk_state.rs `RkState`).

:class:`RkSolver` holds what the SDIRK and ERK solvers share: the stop
time, the root check of an accepted step and the dense output.  The state
of an SDIRK or ERK solve is :class:`RkState`: tensors for the
state and the accepted step's stage values ``diff[i] = z_i`` (member-major,
(s, n) or (s, B, n)), Python numbers for the scalar control, as in the
port's BDF state.  Dense output inside the last step [t_prev, t] uses the
tableau's continuous extension ``beta`` where it has one, else a cubic
Hermite on the first and last stage values (runge_kutta.rs:962-1079).
Augmented rows (forward sensitivities) keep their own stage values
``sdiff[i]``, (s, naug, *y.shape), and interpolate the same way.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import errors
from ..ops.rootfind import check_root
from ..problem import SolverConfig
from .tableau import Tableau

_EPS = float(np.finfo(np.float64).eps)


@dataclass
class Stats:
    """Solver counters (reference `OdeSolverStatistics`,
    ode_solver/mod.rs:28-77).  The five ``lu_from_*`` counters break
    ``linear_solver_setups`` down by cause; ``worst_member`` names the
    lockstep member that dominated the latest error test."""

    steps: int = 0
    error_test_failures: int = 0
    newton_iterations: int = 0
    newton_fails: int = 0
    linear_solver_setups: int = 0
    jacobian_evals: int = 0
    lu_from_checkpoint: int = 0
    lu_from_first_fail: int = 0
    lu_from_second_fail: int = 0
    lu_from_error_test: int = 0
    lu_from_step_success: int = 0
    worst_member: int = 0
    rhs_evals: int = 0
    jac_mul_evals: int = 0
    mass_evals: int = 0


@dataclass
class RkState:
    """Restartable ERK/SDIRK snapshot (reference `RkState`).

    ``y/dy/g/t/h`` are the current point (state.rs:21-43), ``*_prev`` the
    point before the last step (dense output), ``diff``/``gdiff`` the
    accepted step's stage values of the state and of the quadrature.
    ``tstop`` and ``prev_error_norm`` are NaN when unset.  The SDIRK solver
    also keeps the Jacobian, its factorization, Newton's eta memory and the
    Jacobian-update policy's counters; they stay None for ERK.  With
    augmented rows, ``s``/``ds``/``s_prev`` are the (naug, *y.shape) rows,
    their derivative and the rows before the last step, and ``sdiff`` the
    rows' stage values, (s, naug, *y.shape); all None without."""

    y: torch.Tensor
    dy: torch.Tensor
    g: torch.Tensor
    t: float
    h: float
    y_prev: torch.Tensor
    dy_prev: torch.Tensor
    g_prev: torch.Tensor
    t_prev: float
    diff: torch.Tensor
    gdiff: torch.Tensor
    prev_error_norm: float
    root_g: torch.Tensor
    tstop: float
    status: int
    root_t: float = math.nan
    root_idx: int = -1
    state_modified: bool = False
    stats: Stats = field(default_factory=Stats)
    jac: Optional[torch.Tensor] = None
    factors: Optional[tuple] = None
    eta: Optional[float] = None
    steps_since_jac: int = 0
    steps_since_rhs_jac: int = 0
    h_at_last_jac: Optional[float] = None
    s: Optional[torch.Tensor] = None
    ds: Optional[torch.Tensor] = None
    s_prev: Optional[torch.Tensor] = None
    sdiff: Optional[torch.Tensor] = None


def tableau_arrays(tab: Tableau, device=None, dtype=torch.float64):
    """``(a, b, c, d, beta)`` of a tableau as ``dtype`` tensors on
    ``device`` (``beta`` None without a continuous extension)."""
    def t(v):
        return torch.tensor(np.asarray(v), dtype=dtype, device=device)

    beta = None if tab.beta is None else t(tab.beta)
    return t(tab.a), t(tab.b), t(tab.c), t(tab.d), beta


def stage_sum(coef, rows):
    """sum_j coef[j] * rows[j] over the leading (stage) axis (a product
    and a sum: two launches, where a tensordot on the card costs a
    matrix product's host work)."""
    return (coef.reshape((-1,) + (1,) * (rows.ndim - 1)) * rows).sum(0)


# --------------------------------------------------------------------------
# dense output
# --------------------------------------------------------------------------


def _beta_poly(beta: torch.Tensor, theta: float, deriv: bool):
    """(s,) weights of the continuous extension at ``theta``:
    beta @ [theta^k] (or its derivative in theta), k = 1..p."""
    k = torch.arange(1, beta.shape[1] + 1, dtype=beta.dtype, device=beta.device)
    powers = k * theta ** (k - 1.0) if deriv else theta ** k
    return beta @ powers


def _theta(state: RkState, t: float):
    dt = state.t - state.t_prev
    return dt, (1.0 if dt == 0.0 else (float(t) - state.t_prev) / dt)


def interp_y(tab: Tableau, beta, state: RkState, t):
    """y inside [t_prev, t] (runge_kutta.rs:1083-1127); ``beta`` is the
    tableau's beta as a tensor on the state's device, or None."""
    _, theta = _theta(state, t)
    if tab.beta is not None:
        return state.y_prev + stage_sum(_beta_poly(beta, theta, False), state.diff)
    return _hermite(theta, state.y_prev, state.y, state.diff)


def interp_dy(tab: Tableau, beta, state: RkState, t):
    """dy/dt inside [t_prev, t]; the stored dy on a zero-length step."""
    dt, theta = _theta(state, t)
    if dt == 0.0:
        return state.dy
    if tab.beta is not None:
        return stage_sum(_beta_poly(beta, theta, True), state.diff) / dt
    return _hermite_deriv(theta, dt, state.y_prev, state.y, state.diff)


def interp_out(tab: Tableau, beta, state: RkState, t):
    """The integrated output inside [t_prev, t]."""
    _, theta = _theta(state, t)
    if tab.beta is not None:
        return state.g_prev + stage_sum(_beta_poly(beta, theta, False), state.gdiff)
    return _hermite(theta, state.g_prev, state.g, state.gdiff)


def interp_sens(tab: Tableau, beta, state: RkState, t):
    """The augmented rows inside [t_prev, t] (runge_kutta.rs:1083+), each
    row as :func:`interp_y` interpolates the state."""
    _, theta = _theta(state, t)
    if tab.beta is not None:
        return state.s_prev + stage_sum(_beta_poly(beta, theta, False), state.sdiff)
    return _hermite(theta, state.s_prev, state.s, state.sdiff)


def _hermite(theta, u0, u1, diff):
    f0 = diff[0]
    f1 = diff[-1]
    q = (1.0 - 2.0 * theta) * (u1 - u0) + (theta - 1.0) * f0 + theta * f1
    return theta * (theta - 1.0) * q + (1.0 - theta) * u0 + theta * u1


def _hermite_deriv(theta, dt, u0, u1, diff):
    f0 = diff[0]
    f1 = diff[-1]
    q = (1.0 - 2.0 * theta) * (u1 - u0) + (theta - 1.0) * f0 + theta * f1
    dq = -2.0 * (u1 - u0) + f0 + f1
    return ((u1 - u0) + (2.0 * theta - 1.0) * q + theta * (theta - 1.0) * dq) / dt


# --------------------------------------------------------------------------
# tstop
# --------------------------------------------------------------------------


def tstop_check(t: float, h: float, tstop: float):
    """Post-step tstop handling (runge_kutta.rs:752-783): ``(reached,
    h_new)``.  ``reached`` when t is within roundoff of tstop; otherwise h
    is scaled to land on tstop if the next step would overshoot it.  A NaN
    tstop means none."""
    if math.isnan(tstop):
        return False, h
    troundoff = 100.0 * _EPS * (abs(t) + abs(h))
    reached = abs(t - tstop) <= troundoff
    overshoot = (t + h > tstop + troundoff) if h > 0.0 else (t + h < tstop - troundoff)
    factor = (tstop - t) / h if overshoot and not reached else 1.0
    return reached, h * factor


def past_tstop(t: float, h: float, tstop: float) -> bool:
    """A stop time strictly before the current time (reference
    StopTimeBeforeCurrentTime); one within roundoff of it is allowed."""
    return tstop < t - 100.0 * _EPS * (abs(t) + abs(h))


class RkSolver:
    """What the Runge-Kutta solvers share (runge_kutta.rs `Rk`): a
    subclass sets ``problem``, ``tableau``, ``config``, ``_nb`` (the
    lockstep members) and ``_tabs`` (an empty dict), and brings
    ``init_state`` and ``step``."""

    def _set_aug(self, sens: bool, augmented):
        """Install the augmented equations: ``augmented``, or the forward
        sensitivities when ``sens``."""
        if augmented is None and sens:
            from ..augmented import SensEquations

            augmented = SensEquations(self.problem)
        self.aug = augmented
        self.sens = self.has_sens = augmented is not None

    def with_config(self, config: SolverConfig):
        """A new solver over the same problem, tableau and augmented
        equations with another configuration (reference method.rs:84
        `config_mut`); a solve goes on from the previous one's ``state``."""
        return type(self)(self.problem, tableau=self.tableau, config=config,
                          augmented=self.aug)

    @property
    def order(self) -> int:
        return self.tableau.order

    def _arrays(self, device):
        """The tableau's tensors on ``device`` in the problem's dtype, made
        once a device."""
        got = self._tabs.get(device)
        if got is None:
            got = self._tabs[device] = tableau_arrays(self.tableau, device,
                                                      self.problem.dtype)
        return got

    def _t(self, t: float) -> torch.Tensor:
        return self.problem.t0.new_tensor(t)

    def reinit_after_reset(self, state: RkState, params) -> RkState:
        return dataclasses.replace(
            state, dy=self.problem.eqn.rhs(self._t(state.t), state.y, params))

    def set_stop_time(self, state: RkState, tstop: float) -> RkState:
        """Set tstop and shrink h at once if the next step would overshoot
        it (runge_kutta.rs:436-444)."""
        tstop = float(tstop)
        _, h = tstop_check(state.t, state.h, tstop)
        state = dataclasses.replace(state, tstop=tstop, h=h)
        if past_tstop(state.t, h, tstop):
            state = dataclasses.replace(
                state, status=errors.STOP_TIME_BEFORE_CURRENT_TIME)
        return state

    # ------------------------------------------------------------------
    def _out_rate(self, t: float, y, params):
        p = self.problem
        return y if p.eqn.out is None else p.eqn.out(self._t(t), y, params)

    def _finish_step(self, new: RkState, old: RkState, params, root_g) -> RkState:
        """The root check inside the accepted step, then the stop time
        (runge_kutta.rs:752-783); sets the step's status."""
        p = self.problem
        stop = errors.INTERNAL_TIMESTEP
        if p.eqn.root is not None:
            res = check_root(
                lambda tt, yy: p.eqn.root(self._t(tt), yy, params),
                lambda tt: self.interpolate(new, tt),
                root_g, old.t, new.y, new.t, nbatch=self._nb, axis=p.member_axis)
            if res.found:
                stop = errors.ROOT_FOUND
                new = dataclasses.replace(new, root_t=res.t_root, root_idx=res.root_idx)
            if res.inconsistent:
                stop = errors.ROOT_BATCH_INCONSISTENT
            new = dataclasses.replace(new, root_g=res.g0_next)
        reached, h = tstop_check(new.t, new.h, old.tstop)
        if stop == errors.INTERNAL_TIMESTEP and reached:
            stop = errors.TSTOP_REACHED
        return dataclasses.replace(new, h=h, status=stop)

    # ------------------------------------------------------------------
    def _beta(self, state: RkState):
        return self._arrays(state.y.device)[4]

    def interpolate(self, state: RkState, t):
        return interp_y(self.tableau, self._beta(state), state, t)

    def interpolate_dy(self, state: RkState, t):
        return interp_dy(self.tableau, self._beta(state), state, t)

    def interpolate_out(self, state: RkState, t):
        return interp_out(self.tableau, self._beta(state), state, t)

    def interpolate_sens(self, state: RkState, t):
        return interp_sens(self.tableau, self._beta(state), state, t)
