"""The port's forward sensitivities, twins of the nine tests of
tests/test_sens.py: each holds the port to the analytic, finite-difference
or oracle answer at the JAX test's own tolerance, and to the JAX package's
result on the same problem (carried across with ``problem_from_jax``).

Two routes, as in the JAX package: ``solve_dense_fwd_sens`` (forward mode
through the solve) and the continuous sensitivity equations
(``sens=True``).  The continuous rows run the JAX algorithm step for step,
so they match JAX's to roundoff (CONT_RTOL, with equal steps and Newton
iterations).  The forward-mode route differentiates the port's eager solve
along the step sequence its primal chose, where JAX's ``jacfwd`` also
carries dh/dp through its ``while_loop``: the two part by terms of the
order of the tolerance, held to FWD_RTOL of the largest sensitivity
(measured on the CPU: 1.3e-10 for BDF, 6.2e-10 for TSIT45 and 3.4e-7 for
TR-BDF2 on the exponential decay at rtol 1e-8, 9.0e-8 for BDF on the
logistic equation at rtol 1e-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.drivers import solve_dense as jax_solve_dense
from diffsol_tpu.ensemble import make_lockstep_problem as jax_lockstep_problem
from diffsol_tpu.models import exponential_decay as jed
from diffsol_tpu.models import logistic as jlog
from diffsol_tpu.models import robertson as jrob
from diffsol_tpu.sens import solve_dense_fwd_sens as jax_fwd_sens

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.interop import problem_from_jax, solution_to_numpy
from diffsol_tpu_torch.models import exponential_decay as ted
from diffsol_tpu_torch.models import logistic as tlog
from diffsol_tpu_torch.models import robertson as trob

torch.set_num_threads(1)

# the continuous rows against JAX's: the same float64 algorithm, equal
# step and Newton counts, rows to roundoff
CONT_RTOL = 1e-9
# the forward-mode route against JAX's jacfwd, relative to the largest
# sensitivity (frozen against carried step sizes)
FWD_RTOL = 1e-6


def _fwd(solver, t_eval, params=None):
    """The port's solve_dense_fwd_sens on the CPU, as numpy."""
    ys, sens = dtt.solve_dense_fwd_sens(solver, t_eval, params=params, device="cpu")
    return ys.numpy(), sens.numpy()


def _rows(sol):
    """Solution.sens in the layout of solve_dense_fwd_sens, (np, neval, n)."""
    return np.moveaxis(solution_to_numpy(sol)["sens"], 1, 0)


def _twin_continuous(jsol, tsol):
    """The port's continuous rows against JAX's: the same stop, steps and
    Newton iterations, rows within CONT_RTOL of the largest."""
    assert tsol.stop_reason == int(jsol.stop_reason)
    assert tsol.state.stats.steps == int(jsol.state.stats.steps)
    assert tsol.state.stats.newton_iterations == int(jsol.state.stats.newton_iterations)
    js = np.asarray(jsol.sens)
    ts = solution_to_numpy(tsol)["sens"]
    np.testing.assert_allclose(ts, js, rtol=0, atol=CONT_RTOL * np.abs(js).max())


def _twin_fwd(jsens, tsens):
    jsens = np.asarray(jsens)
    np.testing.assert_allclose(tsens, jsens, rtol=0, atol=FWD_RTOL * np.abs(jsens).max())


def _expected_sens(t_eval, p):
    a, y0 = float(p[0]), float(p[1])
    t = np.asarray(t_eval)
    e = np.exp(-a * t)
    dda = np.stack([-t * y0 * e, -t * y0 * e], axis=1)
    ddy0 = np.stack([e, e], axis=1)
    return np.stack([dda, ddy0], axis=0)  # (2, neval, 2)


def _decay(rtol, atol, sens_tols=None):
    jp = jed.problem(rtol=rtol, atol=atol)
    if sens_tols is not None:
        jp = jp.replace(sens_rtol=jnp.asarray(sens_tols[0]),
                        sens_atol=jnp.full((2,), sens_tols[1]))
    return jp, problem_from_jax(jp, ted.rhs, ted.init)


def _logistic(rtol, atol, sens_tols=None):
    jp = jlog.problem(rtol=rtol, atol=atol)
    if sens_tols is not None:
        jp = jp.replace(sens_rtol=jnp.asarray(sens_tols[0]),
                        sens_atol=jnp.full((1,), sens_tols[1]))
    return jp, problem_from_jax(jp, tlog.rhs, tlog.init)


METHODS = {
    "bdf": (lambda p: dt.BdfSolver(p), lambda p: dtt.BdfSolver(p)),
    "erk": (lambda p: dt.ErkSolver(p), lambda p: dtt.ErkSolver(p)),
    "sdirk": (lambda p: dt.SdirkSolver(p, tableau=dt.tr_bdf2()),
              lambda p: dtt.SdirkSolver(p, tableau=dtt.tr_bdf2())),
}


@pytest.mark.parametrize("method", sorted(METHODS))
def test_jacfwd_sens_exponential_decay(method):
    """Forward mode through the solve against dy/da = -t y0 e^{-at}, dy/dy0
    = e^{-at} (rtol 1e-4, atol 1e-7, as the JAX test) and against JAX's
    jacfwd."""
    jp, tp = _decay(1e-8, 1e-10)
    jm, tm = METHODS[method]
    t_eval = np.linspace(0.0, 1.0, 6)
    ys, sens = _fwd(tm(tp), t_eval)
    assert ys.shape == (6, 2) and sens.shape == (2, 6, 2)
    np.testing.assert_allclose(sens, _expected_sens(t_eval, [0.1, 1.0]), rtol=1e-4, atol=1e-7)
    _twin_fwd(jax_fwd_sens(jm(jp), jnp.asarray(t_eval))[1], sens)


def test_jacfwd_sens_vs_finite_differences():
    """Forward mode on the logistic equation against central differences of
    its analytic solution (rtol 1e-3, atol 1e-7) and JAX's jacfwd."""
    jp, tp = _logistic(1e-9, 1e-11)
    t_eval = np.linspace(0.0, 5.0, 4)
    _, sens = _fwd(dtt.BdfSolver(tp), t_eval)
    p0 = np.asarray(jp.params)
    eps = 1e-6
    for i in range(3):
        pp, pm = p0.copy(), p0.copy()
        pp[i] += eps
        pm[i] -= eps
        fd = (tlog.soln(t_eval, pp) - tlog.soln(t_eval, pm)) / (2 * eps)
        np.testing.assert_allclose(sens[i], fd, rtol=1e-3, atol=1e-7)
    _twin_fwd(jax_fwd_sens(dt.BdfSolver(jp), jnp.asarray(t_eval))[1], sens)


def test_continuous_sens_bdf():
    """BdfSolver(sens=True) with the rows in the error test against the
    analytic sensitivities (rtol 1e-3, atol 1e-6) and JAX's rows."""
    jp, tp = _decay(1e-6, 1e-8, sens_tols=(1e-6, 1e-8))
    assert tp.sens_in_error_control()
    t_eval = np.linspace(0.0, 1.0, 6)
    sol = dtt.solve_dense(dtt.BdfSolver(tp, sens=True), t_eval, device="cpu")
    assert sol.stop_reason >= 0 and sol.sens.shape == (6, 2, 2)
    np.testing.assert_allclose(_rows(sol), _expected_sens(t_eval, [0.1, 1.0]), rtol=1e-3,
                               atol=1e-6)
    _twin_continuous(jax_solve_dense(dt.BdfSolver(jp, sens=True), jnp.asarray(t_eval)), sol)


def test_continuous_sens_matches_jacfwd():
    """The continuous rows against the forward-mode oracle (rtol 5e-4, atol
    1e-7), and against JAX's rows."""
    jp, tp = _logistic(1e-8, 1e-10, sens_tols=(1e-8, 1e-10))
    t_eval = np.linspace(0.0, 5.0, 4)
    sol = dtt.solve_dense(dtt.BdfSolver(tp, sens=True), t_eval, device="cpu")
    _, sens_fwd = _fwd(dtt.BdfSolver(tp), t_eval)
    np.testing.assert_allclose(_rows(sol), sens_fwd, rtol=5e-4, atol=1e-7)
    _twin_continuous(jax_solve_dense(dt.BdfSolver(jp, sens=True), jnp.asarray(t_eval)), sol)


def test_erk_continuous_sens_matches_oracle():
    """TSIT45's rows against the oracle (< 1e-4) and JAX's rows."""
    jp, tp = _logistic(1e-6, 1e-6)
    t_eval = np.array([0.5, 1.0, 2.0])
    sol = dtt.solve_dense(dtt.ErkSolver(tp, sens=True), t_eval, max_steps=2000,
                          device="cpu")
    assert sol.stop_reason == errors.TSTOP_REACHED
    _, sens_o = _fwd(dtt.ErkSolver(tp), t_eval)
    assert np.max(np.abs(_rows(sol) - sens_o)) < 1e-4
    _twin_continuous(jax_solve_dense(dt.ErkSolver(jp, sens=True), jnp.asarray(t_eval),
                                     max_steps=2000), sol)


def test_sdirk_continuous_sens_matches_oracle():
    """TR-BDF2's and ESDIRK34's rows against the oracle (< 5e-4) and JAX's
    rows."""
    jp, tp = _logistic(1e-6, 1e-6)
    t_eval = np.array([0.5, 1.0, 2.0])
    for jt, tt in ((None, None), (dt.esdirk34(), dtt.esdirk34())):
        sol = dtt.solve_dense(dtt.SdirkSolver(tp, tableau=tt, sens=True), t_eval,
                              max_steps=2000, device="cpu")
        assert sol.stop_reason == errors.TSTOP_REACHED
        _, sens_o = _fwd(dtt.SdirkSolver(tp, tableau=tt), t_eval)
        assert np.max(np.abs(_rows(sol) - sens_o)) < 5e-4
        _twin_continuous(jax_solve_dense(dt.SdirkSolver(jp, tableau=jt, sens=True),
                                         jnp.asarray(t_eval), max_steps=2000), sol)


@pytest.mark.parametrize("method", ["bdf", "erk"])
def test_reset_sens_correction_vs_finite_differences(method):
    """The rows through root and reset events (the jump correction of
    state.rs:308-560) against central differences for both parameters
    (< 1e-3: p0 moves the event time, p1 the reset value), and JAX's."""
    cls, jcls = {"bdf": (dtt.BdfSolver, dt.BdfSolver),
                 "erk": (dtt.ErkSolver, dt.ErkSolver)}[method]
    t_eval = np.array([2.0, 6.0, 10.0])

    def ys_at(p0, p1):
        return dtt.solve_dense(cls(ted.problem_with_reset(p=(p0, p1))), t_eval,
                               max_steps=4000, device="cpu").ys.numpy()

    eps = 1e-6
    fd0 = (ys_at(0.1 + eps, 1.0) - ys_at(0.1 - eps, 1.0)) / (2 * eps)
    fd1 = (ys_at(0.1, 1.0 + eps) - ys_at(0.1, 1.0 - eps)) / (2 * eps)
    jp = jed.problem_with_reset()
    tp = problem_from_jax(jp, ted.rhs, ted.init, root=ted.root, reset=ted.reset)
    sol = dtt.solve_dense(cls(tp, sens=True), t_eval, max_steps=4000, device="cpu")
    assert sol.stop_reason == errors.TSTOP_REACHED
    sens = _rows(sol)
    assert np.max(np.abs(sens[0] - fd0)) < 1e-3
    assert np.max(np.abs(sens[1] - fd1)) < 1e-3
    _twin_continuous(jax_solve_dense(jcls(jp, sens=True), jnp.asarray(t_eval),
                                     max_steps=4000), sol)


def test_dae_sens_consistent_init():
    """The Robertson DAE's rows (consistent algebraic rows at t0) against
    the oracle (5e-3 of the largest) and JAX's rows; and the rows satisfy
    the conservation x + y + z = 1 at t0: each sums to 0 (1e-10)."""
    jp = jrob.problem_dae()
    tp = problem_from_jax(jp, trob.rhs_dae, trob.init, mass=trob.mass)
    t_eval = np.array([0.4, 4.0, 40.0])
    solver = dtt.BdfSolver(tp, sens=True)
    sol = dtt.solve_dense(solver, t_eval, max_steps=4000, device="cpu")
    assert sol.stop_reason == errors.TSTOP_REACHED
    _, sens_o = _fwd(dtt.BdfSolver(tp), t_eval)
    err = np.max(np.abs(_rows(sol) - sens_o))
    scale = np.max(np.abs(sens_o))
    assert err / scale < 5e-3, (err, scale)
    s0 = solver.init_state().s.numpy()  # (np, n)
    assert np.max(np.abs(s0.sum(-1))) < 1e-10
    _twin_continuous(jax_solve_dense(dt.BdfSolver(jp, sens=True), jnp.asarray(t_eval),
                                     max_steps=4000), sol)


def test_lockstep_continuous_sens():
    """A lockstep ensemble of 4 with continuous rows: member 1 against its
    single solve's oracle (1e-3 of the largest), every member against JAX
    lockstep's rows."""
    B = 4
    k1 = 0.04 * (1.0 + 0.05 * np.linspace(-1, 1, B))
    params = np.stack([k1, np.full((B,), 1e4), np.full((B,), 3e7)], axis=1)
    t_eval = np.array([0.4, 4.0, 40.0])
    jp = jrob.problem_ode()
    tp = problem_from_jax(jp, trob.rhs_ode, trob.init)
    sol = dtt.solve_dense_ensemble(lambda p: dtt.BdfSolver(p, sens=True), tp, t_eval,
                                   params, mode="lockstep", max_steps=4000, device="cpu")
    assert sol.stop_reason == errors.TSTOP_REACHED and sol.tier == "lockstep"
    assert sol.sens.shape == (3, 3, B, 3)
    _, sens_o = _fwd(dtt.BdfSolver(tp), t_eval, params=params[1])
    err = np.max(np.abs(sol.sens[:, :, 1].numpy() - np.moveaxis(sens_o, 0, 1)))
    scale = np.max(np.abs(sens_o))
    assert err / scale < 1e-3, (err, scale)
    _twin_continuous(jax_solve_dense(
        dt.BdfSolver(jax_lockstep_problem(jp, B), sens=True), jnp.asarray(t_eval),
        params=jnp.asarray(params), max_steps=4000), sol)
