"""The port's SDIRK (TR-BDF2, ESDIRK34) and explicit RK (TSIT45) steppers
against the JAX package's, twins of tests/test_sdirk.py and
tests/test_erk.py.

Both sides are float64 and run the same algorithm; JAX keeps Newton's and
the controller's bookkeeping in float32, and the LUs differ (torch.linalg
against the unrolled smalllu).  Those roundoff-level differences leave
every step decision the same unless one lands within roundoff of its
threshold, so each twin holds:

* ys within rtol 1e-6, atol 1e-14 of the JAX solver on the same problem;
* accepted steps, and each Jacobian-update counter, within 2;
* the same stop reason, and a root time within 1e-8 relative.

The tableaus are the JAX package's, coefficient for coefficient, and the
dense output of one recorded state agrees with JAX's within 1e-13.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.models import exponential_decay as jed
from diffsol_tpu.models import logistic as jlog
from diffsol_tpu.solvers import rk_common as jrk

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import exponential_decay as ted
from diffsol_tpu_torch.models import logistic as tlog
from diffsol_tpu_torch.solvers import rk_common as trk

torch.set_num_threads(1)

TRAJ_RTOL, TRAJ_ATOL = 1e-6, 1e-14
STEP_SLACK = 2
ROOT_RTOL = 1e-8
COUNTERS = ("linear_solver_setups", "jacobian_evals", "lu_from_checkpoint",
            "lu_from_first_fail", "lu_from_second_fail", "lu_from_error_test",
            "lu_from_step_success")
TABLEAUS = {"tr_bdf2": (dt.tr_bdf2, dtt.tr_bdf2), "esdirk34": (dt.esdirk34, dtt.esdirk34)}


def _stiff_rhs(lib):
    def rhs(t, y, p):
        return lib.stack([-1000.0 * y[0] + 999.0 * y[1], -y[1]])
    return rhs


def _problems(name, rtol, atol):
    """(JAX problem, the port's) of a fixture."""
    if name == "exponential_decay":
        jp = jed.problem(rtol=rtol, atol=atol)
        return jp, problem_from_jax(jp, ted.rhs, ted.init)
    if name == "logistic":
        jp = jlog.problem(rtol=rtol, atol=atol)
        return jp, problem_from_jax(jp, tlog.rhs, tlog.init)
    if name == "root":
        jp = jed.problem_with_root(rtol=rtol, atol=atol)
        return jp, problem_from_jax(jp, ted.rhs, ted.init, root=ted.root)
    if name == "reset":
        jp = jed.problem_with_reset(rtol=rtol, atol=atol)
        return jp, problem_from_jax(jp, ted.rhs, ted.init, root=ted.root, reset=ted.reset)
    if name == "stiff":
        jp = (dt.OdeBuilder().rhs(_stiff_rhs(jnp)).init(lambda t, p: jnp.array([2.0, 1.0]))
              .p([0.0]).rtol(rtol).atol(atol).build())
        return jp, problem_from_jax(
            jp, _stiff_rhs(torch), lambda t, p: torch.tensor([2.0, 1.0], dtype=torch.float64))
    raise ValueError(name)


def _stats_match(got, ref, counters=()):
    assert got.stop_reason == int(ref.stop_reason)
    sj, st = ref.state.stats, got.state.stats
    assert abs(st.steps - int(sj.steps)) <= STEP_SLACK, (st.steps, int(sj.steps))
    for c in counters:
        assert abs(getattr(st, c) - int(getattr(sj, c))) <= STEP_SLACK, c


def _dense_pair(jsolver, tsolver, t_eval, counters=()):
    """solve_dense on both sides, held to the twin's tolerances."""
    ref = dt.solve_dense(jsolver, jnp.asarray(t_eval))
    got = dtt.solve_dense(tsolver, t_eval, device="cpu")
    _stats_match(got, ref, counters)
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)
    return got, ref


def _adaptive_pair(jsolver, tsolver, final_time, counters=()):
    """solve (every internal step) on both sides: equal points, ys and ts
    within the twin's tolerances."""
    ref = dt.solve(jsolver, final_time)
    got = dtt.solve(tsolver, final_time, device="cpu")
    _stats_match(got, ref, counters)
    n = min(got.n_points, int(ref.n_points))
    assert abs(got.n_points - int(ref.n_points)) <= STEP_SLACK
    np.testing.assert_allclose(got.ts[:n].numpy(), np.asarray(ref.ts[:n]), rtol=TRAJ_RTOL)
    np.testing.assert_allclose(got.ys[:n].numpy(), np.asarray(ref.ys[:n]), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)
    return got, ref


# ---------------------------------------------------------------------------
# tableaus and dense output


@pytest.mark.parametrize("name", ["tr_bdf2", "esdirk34", "tsit45"])
def test_tableau_coefficients_equal_jax(name):
    jt, tt = getattr(dt, name)(), getattr(dtt, name)()
    for f in ("a", "b", "c", "d", "beta", "order"):
        assert getattr(tt, f) == getattr(jt, f), f
    assert (tt.s, tt.skip_first_stage, tt.is_sdirk) == (jt.s, jt.skip_first_stage, jt.is_sdirk)


@pytest.mark.parametrize("method", ["tr_bdf2", "esdirk34", "tsit45"])
def test_interpolation_of_a_recorded_state_matches_jax(method):
    """The JAX solver's state after five logistic steps (with a quadrature
    of the state, so g and gdiff are real, and the forward sensitivities,
    so s and sdiff are), read into an RkState: y, dy, the output and the
    sensitivity rows inside the last step agree with JAX's within 1e-13.
    TR-BDF2 and TSIT45 interpolate with their beta polynomial, ESDIRK34
    with the cubic Hermite."""
    jp = dataclasses.replace(jlog.problem(rtol=1e-6, atol=1e-8), integrate_out=True)
    js = dt.solver(jp, method, sens=True)
    st = js.init_state()
    for _ in range(5):
        st = js.step(st)
    a = {f.name: getattr(st, f.name) for f in dataclasses.fields(trk.RkState)
         if f.name in ("y", "dy", "g", "y_prev", "dy_prev", "g_prev", "diff", "gdiff",
                       "s", "s_prev")}
    rec = trk.RkState(
        **{k: torch.tensor(np.asarray(v)) for k, v in a.items()},
        # the JAX rows' stage values are (naug, s, n), the port's (s, naug, n)
        sdiff=torch.tensor(np.moveaxis(np.asarray(st.sdiff), 1, 0)),
        t=float(st.t), h=float(st.h), t_prev=float(st.t_prev),
        prev_error_norm=float(st.prev_error_norm), root_g=torch.zeros(0),
        tstop=float("nan"), status=0)
    tab = getattr(dtt, method)()
    beta = trk.tableau_arrays(tab)[4]
    for theta in (0.0, 0.3, 0.5, 0.9, 1.0):
        t = float(st.t_prev) + theta * (float(st.t) - float(st.t_prev))
        for tf, jf in ((trk.interp_y, jrk.interp_y), (trk.interp_dy, jrk.interp_dy),
                       (trk.interp_out, jrk.interp_out), (trk.interp_sens, jrk.interp_sens)):
            np.testing.assert_allclose(tf(tab, beta, rec, t).numpy(),
                                       np.asarray(jf(js.tableau, st, jnp.asarray(t))),
                                       rtol=1e-13, atol=1e-13)


# ---------------------------------------------------------------------------
# twins of tests/test_sdirk.py


@pytest.mark.parametrize("tab", sorted(TABLEAUS))
def test_sdirk_exponential_decay(tab):
    jp, tp = _problems("exponential_decay", 1e-6, 1e-8)
    jt, tt = TABLEAUS[tab]
    t_eval = np.linspace(0.0, 1.0, 11)
    got, _ = _dense_pair(dt.SdirkSolver(jp, tableau=jt()), dtt.SdirkSolver(tp, tableau=tt()),
                         t_eval, COUNTERS)
    assert got.stop_reason == errors.TSTOP_REACHED
    np.testing.assert_allclose(got.ys.numpy(), ted.soln(t_eval, [0.1, 1.0]), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("tab", sorted(TABLEAUS))
def test_sdirk_logistic(tab):
    jp, tp = _problems("logistic", 1e-6, 1e-8)
    jt, tt = TABLEAUS[tab]
    t_eval = np.linspace(0.0, 10.0, 11)
    got, _ = _dense_pair(dt.SdirkSolver(jp, tableau=jt()), dtt.SdirkSolver(tp, tableau=tt()),
                         t_eval, COUNTERS)
    np.testing.assert_allclose(got.ys.numpy(), tlog.soln(t_eval, [1.0, 1.0, 0.1]),
                               rtol=1e-4, atol=1e-6)


def test_sdirk_stiff():
    jp, tp = _problems("stiff", 1e-6, 1e-8)
    t_eval = np.linspace(0.0, 10.0, 11)
    got, _ = _dense_pair(dt.SdirkSolver(jp, tableau=dt.tr_bdf2()),
                         dtt.SdirkSolver(tp, tableau=dtt.tr_bdf2()), t_eval, COUNTERS)
    expected = np.stack([np.exp(-t_eval) + np.exp(-1000.0 * t_eval), np.exp(-t_eval)], axis=1)
    np.testing.assert_allclose(got.ys.numpy(), expected, rtol=1e-4, atol=1e-6)
    assert got.state.stats.steps < 1000


def test_sdirk_root_finding():
    jp, tp = _problems("root", 1e-8, 1e-10)
    got, ref = _adaptive_pair(dt.SdirkSolver(jp, tableau=dt.tr_bdf2()),
                              dtt.SdirkSolver(tp, tableau=dtt.tr_bdf2()), 20.0, COUNTERS)
    assert got.stop_reason == errors.ROOT_FOUND
    np.testing.assert_allclose(got.state.t, float(ref.state.t), rtol=ROOT_RTOL)
    np.testing.assert_allclose(got.state.t, np.log(1.0 / 0.6) / 0.1, rtol=1e-6)


def test_sdirk_statistics_sane():
    """The counters of a whole solve equal JAX's, the Newton and rhs
    counts among them."""
    jp, tp = _problems("logistic", 1e-6, 1e-8)
    got, ref = _adaptive_pair(dt.SdirkSolver(jp, tableau=dt.esdirk34()),
                              dtt.SdirkSolver(tp, tableau=dtt.esdirk34()), 10.0,
                              COUNTERS + ("newton_iterations", "rhs_evals",
                                          "error_test_failures", "jac_mul_evals"))
    stats = got.state.stats
    assert stats.steps > 3
    assert stats.newton_iterations >= stats.steps
    assert stats.linear_solver_setups >= 1
    # with the sensitivities every stage's row solve adds its Newton
    # iterations (and rhs evaluations), as JAX counts them
    jps = dataclasses.replace(jp, sens_rtol=jnp.asarray(1e-6), sens_atol=jnp.full((1,), 1e-8))
    tps = problem_from_jax(jps, tlog.rhs, tlog.init)
    got_s, ref_s = _adaptive_pair(dt.SdirkSolver(jps, tableau=dt.esdirk34(), sens=True),
                                  dtt.SdirkSolver(tps, tableau=dtt.esdirk34(), sens=True),
                                  10.0, COUNTERS + ("newton_iterations", "rhs_evals"))
    assert got_s.state.stats.newton_iterations == int(ref_s.state.stats.newton_iterations)
    assert got_s.state.stats.newton_iterations > stats.newton_iterations


# ---------------------------------------------------------------------------
# twins of tests/test_erk.py


def test_solve_dense_exponential_decay():
    jp, tp = _problems("exponential_decay", 1e-6, 1e-8)
    t_eval = np.linspace(0.0, 1.0, 11)
    got, _ = _dense_pair(dt.ErkSolver(jp), dtt.ErkSolver(tp), t_eval)
    assert got.stop_reason == errors.TSTOP_REACHED
    np.testing.assert_allclose(got.ys.numpy(), ted.soln(t_eval, [0.1, 1.0]), rtol=1e-5,
                               atol=1e-7)


def test_solve_dense_logistic():
    jp, tp = _problems("logistic", 1e-6, 1e-8)
    t_eval = np.linspace(0.0, 10.0, 21)
    got, _ = _dense_pair(dt.ErkSolver(jp), dtt.ErkSolver(tp), t_eval, ("rhs_evals",))
    np.testing.assert_allclose(got.ys.numpy(), tlog.soln(t_eval, [1.0, 1.0, 0.1]),
                               rtol=1e-5, atol=1e-7)


def test_solve_adaptive_records_steps():
    jp, tp = _problems("exponential_decay", 1e-6, 1e-6)
    got, _ = _adaptive_pair(dt.ErkSolver(jp), dtt.ErkSolver(tp), 1.0)
    n = got.n_points
    assert n > 2 and got.ts[0] == 0.0
    np.testing.assert_allclose(got.ts[n - 1], 1.0, rtol=1e-12)
    np.testing.assert_allclose(got.ys[:n].numpy(), ted.soln(got.ts[:n].numpy(), [0.1, 1.0]),
                               rtol=1e-5, atol=1e-7)
    assert got.state.stats.steps == n - 1


def test_interpolation_accuracy():
    """Five manual steps on both sides: the same state, and the port's
    interpolant inside the last step against the analytic solution."""
    jp, tp = _problems("logistic", 1e-8, 1e-10)
    js, ts_ = dt.ErkSolver(jp), dtt.ErkSolver(tp)
    sj, st = js.init_state(), ts_.init_state()
    for _ in range(5):
        sj, st = js.step(sj), ts_.step(st)
    # JAX's controller powers are float32: the step times part at ~1e-8
    np.testing.assert_allclose(st.t, float(sj.t), rtol=TRAJ_RTOL)
    np.testing.assert_allclose(st.y.numpy(), np.asarray(sj.y), rtol=TRAJ_RTOL)
    t_mid = 0.5 * (st.t_prev + st.t)
    exact = tlog.soln(t_mid, [1.0, 1.0, 0.1])
    np.testing.assert_allclose(ts_.interpolate(st, t_mid).numpy(), exact, rtol=1e-7)
    dy = ts_.interpolate_dy(st, t_mid).numpy()
    np.testing.assert_allclose(dy, exact * (1.0 - exact), rtol=1e-5)


def test_root_finding_stops():
    jp, tp = _problems("root", 1e-8, 1e-10)
    got, ref = _adaptive_pair(dt.ErkSolver(jp), dtt.ErkSolver(tp), 20.0)
    assert got.stop_reason == errors.ROOT_FOUND
    t_expected = float(np.log(1.0 / 0.6) / 0.1)
    np.testing.assert_allclose(got.state.t, float(ref.state.t), rtol=ROOT_RTOL)
    np.testing.assert_allclose(got.state.t, t_expected, rtol=1e-6)
    np.testing.assert_allclose(float(got.state.y[0]), 0.6, rtol=1e-6)
    assert got.root_idx == int(ref.root_idx) == 0


def test_reset_continues():
    jp, tp = _problems("reset", 1e-8, 1e-10)
    got, _ = _adaptive_pair(dt.ErkSolver(jp), dtt.ErkSolver(tp), 20.0)
    assert got.stop_reason == errors.TSTOP_REACHED
    ys = got.ys[:got.n_points].numpy()
    assert ys[:, 0].min() > 0.59
    assert np.sum(np.diff(ys[:, 0]) > 0.3) >= 3


def test_error_controls_step_size():
    errs = []
    for rtol in (1e-3, 1e-6, 1e-9):
        jp, tp = _problems("logistic", rtol, rtol * 1e-2)
        t_eval = np.linspace(0.0, 10.0, 5)
        got, _ = _dense_pair(dt.ErkSolver(jp), dtt.ErkSolver(tp), t_eval)
        errs.append(float(np.max(np.abs(got.ys.numpy()
                                        - tlog.soln(t_eval, [1.0, 1.0, 0.1])))))
    assert errs[2] < errs[1] < errs[0]
    assert errs[2] < 1e-8


@pytest.mark.parametrize("method", ["tsit45", "tr_bdf2"])
def test_vmap_ensemble(method):
    """tests/test_erk.py:112's ensemble as the reference's ``nbatch``
    lockstep ensemble (the JAX test vmaps independent solves): every
    member against the analytic solution at that test's tolerances, and
    the lockstep stepper against JAX's on the same 16 members, step by
    step through ``solve``, whose error norm is the max over members.
    (The JAX lockstep ``solve_dense`` of an RK method cannot interpolate:
    ROADMAP.md queue 3.)"""
    jp, tp = _problems("exponential_decay", 1e-6, 1e-8)
    t_eval = np.linspace(0.0, 1.0, 7)
    a = np.linspace(0.05, 1.0, 16)
    params = np.stack([a, np.ones_like(a)], axis=1)
    sol = dtt.solve_dense_ensemble(lambda pr: dtt.solver(pr, method), tp, t_eval, params,
                                   mode="lockstep", device="cpu")
    assert sol.ys.shape == (7, 16, 2) and sol.tier == "lockstep"
    for i in range(16):
        np.testing.assert_allclose(sol.ys[:, i].numpy(), ted.soln(t_eval, params[i]),
                                   rtol=2e-5, atol=1e-7)
    jl = dt.make_lockstep_problem(jp, 16)
    tl = dtt.make_lockstep_problem(tp, 16)
    ref = dt.solve(dt.solver(jl, method), 1.0, params=jnp.asarray(params))
    got = dtt.solve(dtt.solver(tl, method), 1.0, params=params, device="cpu")
    _stats_match(got, ref)
    n = min(got.n_points, int(ref.n_points))
    # JAX's lockstep state is (n, B), the port's (B, n)
    np.testing.assert_allclose(got.ys[:n].numpy(), np.swapaxes(np.asarray(ref.ys[:n]), 1, 2),
                               rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
    assert got.state.stats.worst_member == int(ref.state.stats.worst_member)
