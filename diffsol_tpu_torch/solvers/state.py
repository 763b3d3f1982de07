"""Initial state and step size (counterpart of
``diffsol_tpu.solvers.state``; reference state.rs:801-867 `set_step_size`,
:1086-1124 `new_without_initialise`)."""

from __future__ import annotations

import torch

from ..norms import norm as wrms_norm


def initial_state(problem, params):
    """(y0, dy0, g0, dg0) at t0; the quadrature pieces have size 0 when
    nothing is integrated, and integrate the state itself without an
    ``out`` function (state.rs:1098-1104)."""
    t0 = problem.t0
    y = problem.eqn.init(t0, params)
    dy = problem.eqn.rhs(t0, y, params)
    if problem.integrate_out:
        dg = y if problem.eqn.out is None else problem.eqn.out(t0, y, params)
        return y, dy, torch.zeros_like(dg), dg
    empty = y.new_zeros(0)
    return y, dy, empty, empty


def initial_step_size(problem, params, y0, dy0, solver_order: int) -> float:
    """Starting step size h.

    d0 = |y0|, d1 = |f0| in the tolerance-scaled norm; h0 = 0.01 d0/d1
    (1e-6 if either is tiny); an Euler probe gives
    d2 = |f(t0+h0, y0+h0 f0) - f0| / h0; then
    h1 = (0.01/max(d1, d2))^(1/(order+1)) and h = min(100 h0, h1).  The sign
    of ``problem.h0`` selects the direction of integration.
    """
    atol, rtol = problem.atol, problem.rtol
    axes = (problem.member_axis, problem.state_axis)
    t0 = float(problem.t0)
    is_neg = float(problem.h0) < 0.0

    d0 = float(wrms_norm(y0, y0, atol, rtol, *axes))
    d1 = float(wrms_norm(dy0, y0, atol, rtol, *axes))
    h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * (d0 / d1)

    sgn = -1.0 if is_neg else 1.0
    t1 = problem.t0.new_tensor(t0 + sgn * h0)
    y1 = y0 + (sgn * h0) * dy0
    f1 = problem.eqn.rhs(t1, y1, params)
    d2 = float(wrms_norm(f1 - dy0, y0, atol, rtol, *axes)) / abs(h0)

    max_d = max(d1, d2)
    if max_d < 1e-15:
        h1 = max(h0 * 1e-3, 1e-6)
    else:
        h1 = (0.01 / max_d) ** (1.0 / (1.0 + solver_order))
    return sgn * min(100.0 * h0, h1)
