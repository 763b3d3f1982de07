"""Augmented equation sets integrated beside the main equations
(counterpart of ``diffsol_tpu.augmented``; reference
ode_equations/mod.rs:42-186 ``AugmentedOdeEquations``).

All augmented rows ride one leading axis: a single instance's rows are
(naug, n), a lockstep ensemble's (naug, B, n) (member-major, where the JAX
package has (naug, n, B)).  Implicit steppers use :meth:`linear_parts`,
since the augmented rhs is affine in the rows, so that every row is solved
against the main step's factorized ``M - c J``; explicit steppers call
:meth:`AugmentedEquations.rhs`.

:class:`SensEquations` holds the continuous forward sensitivities
(sens_equations.rs:10-208): rows s_i = dy/dp_i with

    M s_i' = J s_i + df/dp_i,    s_i(t0) = dy0/dp_i,

the consistent algebraic rows of a DAE (state.rs:167-239) and the jump
across a reset (state.rs:308-560).  Every product with a Jacobian is a
forward-mode probe (``torch.func.jvp``) vmapped over the rows; df/dp comes
from nparams probes, never from a dense (B, nparams) Jacobian.
"""

from __future__ import annotations

import torch

_vmap = torch.func.vmap
_jvp = torch.func.jvp


def _jvp_closure(f, x):
    """v -> (df/dx)(x) v, vmapped over a leading axis of rows."""
    return _vmap(lambda v: _jvp(f, (x,), (v,))[1])


class AugmentedEquations:
    """Equation sets integrated beside the main system, as one
    ``(naug,) + y.shape`` tensor of rows."""

    naug: int = 0

    def atol(self, problem):
        return problem.sens_atol if problem.sens_atol is not None else problem.atol

    def rtol(self, problem):
        return problem.sens_rtol if problem.sens_rtol is not None else problem.rtol

    def init(self, t0, y0, dy0, params):
        """(S0, dS0), each (naug,) + y.shape."""
        raise NotImplementedError

    def start(self, t0, y0, dy0, params, is_alg=None):
        """(S0, dS0) at t0 for a solver: :meth:`init`, with a DAE's
        algebraic rows (``is_alg``) made consistent where the set can."""
        S, dS = self.init(t0, y0, dy0, params)
        if is_alg is not None and hasattr(self, "consistent_init"):
            S, dS = self.consistent_init(t0, y0, dy0, params, S, is_alg)
        return S, dS

    def linear_parts(self, t, y, params):
        """(jvp_rows, forcing) with rhs(S) == jvp_rows(S) + forcing."""
        raise NotImplementedError

    def rhs(self, t, y, params, S):
        jvp_rows, forcing = self.linear_parts(t, y, params)
        return jvp_rows(S) + forcing

    def apply_reset(self, t, y_minus, dy_minus, y_plus, dy_plus, params, S,
                    root_idx):
        """The rows across a reset event (identity by default)."""
        return S


class SensEquations(AugmentedEquations):
    """Forward sensitivities s_i = dy/dp_i as augmented rows (reference
    SensEquations, sens_equations.rs:10-208), for a single instance
    (params (np,), state (n,)) or a lockstep ensemble (params (B, np),
    state (B, n))."""

    def __init__(self, problem):
        self.problem = problem
        self.naug = int(problem.eqn.nparams)

    def _param_seeds(self, params):
        """(naug,) + params.shape: seed j is e_j for every member."""
        eye = torch.eye(self.naug, dtype=params.dtype, device=params.device)
        if params.ndim == 2:
            return eye[:, None, :].expand(-1, params.shape[0], -1).contiguous()
        return eye

    def _param_rows(self, f, params):
        """(naug,) + out.shape: d f(p) / dp_j, one probe a parameter."""
        return _vmap(lambda dp: _jvp(f, (params,), (dp,))[1])(
            self._param_seeds(params))

    def _f_p(self, t, y, params):
        rhs = self.problem.eqn.rhs
        return self._param_rows(lambda pp: rhs(t, y, pp), params)

    def linear_parts(self, t, y, params):
        rhs = self.problem.eqn.rhs
        return (_jvp_closure(lambda yy: rhs(t, yy, params), y),
                self._f_p(t, y, params))

    def init(self, t0, y0, dy0, params):
        init = self.problem.eqn.init
        S0 = self._param_rows(lambda pp: init(t0, pp), params)
        return S0, self.rhs(t0, y0, params, S0)

    def consistent_init(self, t0, y0, dy0, params, S0, is_alg):
        """The algebraic rows of a DAE's sensitivities (reference
        state.rs:167-239): with g the algebraic part of f,

            0 = d/dp g(y, p) = g_y_d s_d + g_y_a s_a + g_p,

        so s_a = -g_y_a^{-1} (g_y_d s_d + g_p) row by row.  The packed
        operator (f_y on the algebraic slots, identity on the others) is
        built from n probes broadcast over the members and factored by one
        (batched) ``torch.linalg`` LU; every row is one right-hand side."""
        from .solvers.consistent_ic import _blockwise_jacfwd

        rhs = self.problem.eqn.rhs
        is_alg = is_alg.to(y0.device)

        def jvp_y(v):
            return _jvp(lambda yy: rhs(t0, yy, params), (y0,), (v,))[1]

        def packed_apply(v):
            return torch.where(is_alg, jvp_y(torch.where(is_alg, v, 0.0)), v)

        f_p = self._f_p(t0, y0, params)
        s_dif = torch.where(is_alg, 0.0, S0)
        b_rows = torch.where(is_alg, -(_vmap(jvp_y)(s_dif) + f_p), 0.0)
        lu, piv = torch.linalg.lu_factor(_blockwise_jacfwd(packed_apply, y0))
        x = torch.linalg.lu_solve(lu, piv, b_rows.unsqueeze(-1)).squeeze(-1)
        S = torch.where(is_alg, x, S0)
        return S, self.rhs(t0, y0, params, S)

    def apply_reset(self, t, y_minus, dy_minus, y_plus, dy_plus, params, S,
                    root_idx):
        """The sensitivity jump across a reset at a root (reference
        state.rs:308-560 apply_reset_with_sens), at (t*, y-):

            dt*/dp_i = -(r_y s_i + r_p_i) / (r_y f- + r_t)   [fired root]
            s_i+     = R_y s_i + R_p_i + (R_y f- + R_t - f+) dt*/dp_i
        """
        eqn = self.problem.eqn
        if eqn.reset_n is not None:
            def reset(tt, yy, pp):
                return eqn.reset_n(tt, yy, pp, root_idx)
        else:
            reset = eqn.reset
        root = eqn.root
        t = torch.as_tensor(t, dtype=y_minus.dtype, device=y_minus.device)

        def time_partial(f):
            return _jvp(f, (t,), (torch.ones_like(t),))[1]

        R_t = time_partial(lambda tt: reset(tt, y_minus, params))
        r_t = time_partial(lambda tt: root(tt, y_minus, params))
        R_y = _jvp_closure(lambda yy: reset(t, yy, params), y_minus)
        r_y = _jvp_closure(lambda yy: root(t, yy, params), y_minus)
        R_p = self._param_rows(lambda pp: reset(t, y_minus, pp), params)
        r_p = self._param_rows(lambda pp: root(t, y_minus, pp), params)

        one = dy_minus.unsqueeze(0)
        denom = (r_y(one)[0] + r_t)[..., root_idx]
        c_dir = R_y(one)[0] + R_t - dy_plus
        dt_dp = -(r_y(S) + r_p)[..., root_idx] / denom  # (naug,) or (naug, B)
        return R_y(S) + R_p + c_dir * dt_dp[..., None]
