"""``mode="independent"`` batched for SDIRK and ERK, with ``sens=True`` and on
the block-diagonal tier (:mod:`diffsol_tpu_torch.solvers.rk_independent`
and :mod:`diffsol_tpu_torch.solvers.bdf_independent` on the shared driver
of :mod:`diffsol_tpu_torch.solvers.independent`): one loop, each member
its own step size, Newton iterations, failure ladder, Jacobian policy,
events and stop.

Each member of a batched solve is held to the port's own single solve of
that member: its whole ``Stats``, its stop and root, and ys, gs and the
sensitivity rows within 1e-12 + 1e-10 |ref|.  The single solves are the
twins that tests/test_torch_rk.py and tests/test_torch_sens.py hold to
JAX.  Three cases go to JAX's ``vmap`` independent mode directly (module
fixtures, B <= 4): TSIT45 on tests/test_erk.py:112's decay, TR-BDF2 on
Robertson (test_torch_rk.py's twin bound: ys within rtol 1e-6, atol
1e-14, steps within 2) and BDF with sensitivity rows on Robertson
(test_torch_sens.py's: equal steps and Newton iterations, rows within
1e-9 of the largest).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.models import exponential_decay as jed
from diffsol_tpu.models import robertson as jrob

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.drivers import solve_dense
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import exponential_decay as ted
from diffsol_tpu_torch.models import fused_cases as fc
from diffsol_tpu_torch.models import heat1d
from diffsol_tpu_torch.models import robertson as rob
from diffsol_tpu_torch.solvers.bdf_independent import IndependentState
from diffsol_tpu_torch.solvers.rk_independent import RkIndependentState

torch.set_num_threads(1)
F64 = torch.float64
RTOL, ATOL = 1e-10, 1e-12  # a member against its single solve
TRAJ_RTOL, TRAJ_ATOL, STEP_SLACK = 1e-6, 1e-14, 2  # test_torch_rk.py's twins
CONT_RTOL = 1e-9  # test_torch_sens.py's continuous rows
DECAY_T = np.linspace(0.0, 1.0, 7)
ROB_T = [0.4, 4.0, 40.0]
SENS_T = [0.4, 4.0]
HEAT_T = [0.01, 0.05, 0.1]
HEAT_D = [[0.5], [1.0], [1.5], [2.0]]


def _make(method, **kw):
    return lambda pr: dtt.solver(pr, method, **kw)


def _decay_params():
    a = np.linspace(0.05, 1.0, 4)
    return np.stack([a, np.ones_like(a)], axis=1)


def _robertson_params(B, lo=0.5, hi=4.0):
    k1 = 0.04 * np.geomspace(lo, hi, B)
    return np.stack([k1, np.full(B, 1e4), np.full(B, 3e7)], axis=1)


def _sens_params(B=3):
    """test_torch_sens.py's lockstep members: k1 within 5 %."""
    k1 = 0.04 * (1.0 + 0.05 * np.linspace(-1, 1, B))
    return np.stack([k1, np.full(B, 1e4), np.full(B, 3e7)], axis=1)


def _robertson_twin():
    """The JAX package's Robertson ODE and the port's problem from it."""
    jp = jrob.problem_ode()
    return jp, problem_from_jax(jp, rob.rhs_ode, rob.init)


def _batched(make, problem, t_eval, pb, max_steps=100_000):
    sol = dtt.solve_dense_ensemble(make, problem, t_eval, pb, mode="independent",
                                   max_steps=max_steps, device="cpu")
    assert sol.tier == "independent"
    assert isinstance(sol.state, (IndependentState, RkIndependentState))
    return sol


def _members_match(sol, make, problem, t_eval, pb, max_steps=100_000):
    """Each member against its own single solve: Stats, stop, root, ys, gs
    and the rows within 1e-12 + 1e-10 |ref|."""
    pb = torch.as_tensor(pb, dtype=F64)
    for b in range(pb.shape[0]):
        one = solve_dense(make(problem), t_eval, params=pb[b], max_steps=max_steps,
                          device="cpu")
        assert dataclasses.asdict(sol.state.member_stats(b)) == dataclasses.asdict(
            one.state.stats), b
        assert int(sol.stop_reason[b]) == one.stop_reason, b
        assert int(sol.root_idx[b]) == one.root_idx
        if one.root_idx >= 0:
            assert float(sol.root_t[b]) == pytest.approx(one.root_t, rel=1e-12)
        pairs = [(sol.ys[:, b], one.ys)]
        if one.gs is not None:
            pairs.append((sol.gs[:, b], one.gs))
        if one.sens is not None:
            pairs.append((sol.sens[:, :, b], one.sens))
        for got, ref in pairs:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)
    return sol


def _solve_and_match(make, problem, t_eval, pb, max_steps=100_000):
    return _members_match(_batched(make, problem, t_eval, pb, max_steps), make, problem,
                          t_eval, pb, max_steps)


# ---------------------------------------------------------------------------
# JAX's independent mode (vmap of the single solve), one solve a fixture


@pytest.fixture(scope="module")
def jax_erk():
    jp = jed.problem(rtol=1e-6, atol=1e-8)
    sol = dt.solve_dense_ensemble(dt.ErkSolver, jp, jnp.asarray(DECAY_T),
                                  jnp.asarray(_decay_params()), mode="independent")
    return jp, dict(ys=np.asarray(sol.ys), stop=np.asarray(sol.stop_reason),
                    steps=np.asarray(sol.state.stats.steps))


@pytest.fixture(scope="module")
def jax_sdirk():
    jp, tp = _robertson_twin()
    sol = dt.solve_dense_ensemble(lambda p: dt.SdirkSolver(p, tableau=dt.tr_bdf2()), jp,
                                  jnp.asarray(ROB_T), jnp.asarray(_robertson_params(4)),
                                  mode="independent")
    return tp, dict(ys=np.asarray(sol.ys), stop=np.asarray(sol.stop_reason),
                    steps=np.asarray(sol.state.stats.steps))


@pytest.fixture(scope="module")
def jax_bdf_sens():
    jp, tp = _robertson_twin()
    sol = dt.solve_dense_ensemble(lambda p: dt.BdfSolver(p, sens=True), jp,
                                  jnp.asarray(SENS_T), jnp.asarray(_sens_params()),
                                  mode="independent")
    # only ys is moved to (neval, B, n): the rows come back (B, neval,
    # naug, n), the stats (B,)
    return tp, dict(ys=np.asarray(sol.ys), sens=np.asarray(sol.sens),
                    stop=np.asarray(sol.stop_reason),
                    steps=np.asarray(sol.state.stats.steps),
                    newton=np.asarray(sol.state.stats.newton_iterations))


# ---------------------------------------------------------------------------


def test_erk_decay_matches_jax_vmap(jax_erk):
    """tests/test_erk.py:112's decay with a spread of rates, B = 4: each
    member its own steps, the analytic solution at that test's bound, and
    JAX's vmapped TSIT45 at the twins' bound."""
    jp, ref = jax_erk
    tp = problem_from_jax(jp, ted.rhs, ted.init)
    pb = _decay_params()
    sol = _solve_and_match(_make("tsit45"), tp, DECAY_T, pb)
    assert isinstance(sol.state, RkIndependentState) and sol.state.jac is None
    assert sol.stop_reason.tolist() == ref["stop"].tolist() == [errors.TSTOP_REACHED] * 4
    assert len(set(sol.state.stats.steps.tolist())) > 1  # own step sequences
    assert np.abs(sol.state.stats.steps.numpy() - ref["steps"]).max() <= STEP_SLACK
    np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
    for b in range(4):
        np.testing.assert_allclose(sol.ys[:, b].numpy(), ted.soln(DECAY_T, pb[b]),
                                   rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("method", ["tr_bdf2", "esdirk34"])
def test_sdirk_robertson_members(method, jax_sdirk):
    """Robertson with k1 spread, B = 4: whole Stats equal to the single
    solves'; TR-BDF2 also against JAX's vmapped solve."""
    tp, ref = jax_sdirk
    pb = _robertson_params(4)
    sol = _solve_and_match(_make(method), tp, ROB_T, pb)
    st = sol.state
    assert sol.stop_reason.tolist() == [errors.TSTOP_REACHED] * 4
    assert len(set(st.stats.steps.tolist())) > 1
    # each member refactored M - gamma h J on its own schedule
    assert len(set(st.stats.linear_solver_setups.tolist())) > 1
    if method == "tr_bdf2":
        assert sol.stop_reason.tolist() == ref["stop"].tolist()
        assert np.abs(st.stats.steps.numpy() - ref["steps"]).max() <= STEP_SLACK
        np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=TRAJ_RTOL, atol=TRAJ_ATOL)


def test_sdirk_member_fails_newton_while_the_others_go_on():
    """Two Newton iterations at most: every member's ladder (a failure
    refreshes J, a second in the step cuts h by 0.3) on its own, and
    member 1 runs out of Newton failures and returns to its step's start
    while the others finish."""
    problem = rob.problem_ode()
    cfg = dataclasses.replace(dtt.SolverConfig.from_options(problem.options, "sdirk"),
                              maximum_newton_iterations=2)
    pb = [[0.02, 1e4, 3e5], [0.04, 1e4, 3e6]]
    sol = _solve_and_match(_make("tr_bdf2", config=cfg), problem, ROB_T + [4000.0], pb)
    stats = sol.state.stats
    assert sol.stop_reason.tolist() == [errors.TSTOP_REACHED,
                                        errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES]
    assert int(stats.newton_fails[1]) == cfg.maximum_newton_fails
    assert bool((stats.lu_from_second_fail > 0).all())
    assert float(sol.state.t[1]) < 4000.0 == float(sol.state.t[0])


def test_max_steps_member():
    """One member runs out of steps while the others finish."""
    pb = [[0.5], [1.0], [5.0]]  # 15, 24 and 30 TSIT45 steps
    problem = (dtt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y * (1.0 + torch.sin(p[0] * t)))
               .init(lambda t, p: torch.ones(1, dtype=F64, device=p.device))
               .p([1.0]).rtol(1e-6).atol(1e-8).build())
    sol = _solve_and_match(_make("tsit45"), problem, [1.0, 2.0, 4.0], pb, max_steps=25)
    assert sol.stop_reason.tolist() == [errors.TSTOP_REACHED, errors.TSTOP_REACHED,
                                        errors.MAX_STEPS_REACHED]
    assert int(sol.state.n_steps[2]) == 25


def _ball():
    return (dtt.OdeBuilder().rhs(fc.ball_rhs)
            .init(lambda t, p: torch.tensor([10.0, 0.0], dtype=F64, device=p.device))
            .root(lambda t, y, p: y[0:1]).p([9.81]).rtol(1e-8).atol(1e-10)
            .reset(lambda t, y, p: torch.stack([torch.full_like(y[0], 1e-9), -0.8 * y[1]]))
            .build())


@pytest.mark.parametrize("method", ["tr_bdf2", "tsit45"])
def test_bouncing_balls_with_resets(method):
    """Three gravities: each ball bounces at its own times and the height
    follows the closed form through the second bounce."""
    g = [[6.0], [9.81], [15.0]]
    t_eval = [0.5, 1.5, 2.5]
    sol = _solve_and_match(_make(method), _ball(), t_eval, g, max_steps=4000)
    assert sol.stop_reason.tolist() == [errors.TSTOP_REACHED] * 3
    for b, (gb,) in enumerate(g):
        np.testing.assert_allclose(sol.ys[:, b, 0].numpy(),
                                   fc.ball_height(t_eval, g=gb, e=0.8), atol=1e-5)


@pytest.mark.parametrize("method", ["tsit45", "esdirk34"])
def test_quadrature_members(method):
    """fc.quadrature_problem(): each member's gdiff beside its stages."""
    pb = [[0.1, 1.0], [0.5, 2.0], [2.0, 0.5]]
    sol = _solve_and_match(_make(method), fc.quadrature_problem(), fc.QUAD_T_EVAL, pb)
    a, y0 = np.asarray(pb)[:, 0], np.asarray(pb)[:, 1]
    te = np.asarray(fc.QUAD_T_EVAL)[:, None]
    np.testing.assert_allclose(sol.gs[:, :, 0].numpy(), y0 * (1.0 - np.exp(-a * te)) / a,
                               rtol=1e-5)


@pytest.mark.parametrize("method", ["tr_bdf2", "tsit45"])
def test_stop_between_t_eval_points(method):
    """Decay stopping at its root y = 0.5 (t = ln 2 / a) between output
    points, each member at its own on its method's interpolant; the points
    past a member's stop stay zero."""
    pb = [[0.5], [1.0], [2.0], [4.0]]
    t_eval = fc.ROOT_STOP_T_EVAL
    sol = _solve_and_match(_make(method), fc.root_stop_problem(), t_eval, pb)
    assert sol.stop_reason.tolist() == [errors.ROOT_FOUND] * 4
    np.testing.assert_allclose(sol.root_t.numpy(), np.log(2.0) / np.ravel(pb), rtol=1e-4)
    past = np.asarray(t_eval)[:, None] > sol.root_t.numpy()[None, :]
    assert past.any() and (~past).any()
    assert float(sol.ys[torch.as_tensor(past)].abs().max()) == 0.0


def test_banded_heat1d_esdirk34():
    """heat1d n = 16 on the banded tier, four diffusivities: the band LU's
    plain versions factor the refreshed members' M - gamma h J and solve
    every stage's Newton sweep against each member's own factors."""
    problem, soln = heat1d.make(mgrid=15, banded=True)
    assert problem.linear_solver.name.startswith("banded")
    sol = _solve_and_match(_make("esdirk34"), problem, HEAT_T, HEAT_D)
    for b, (d,) in enumerate(HEAT_D):
        np.testing.assert_allclose(sol.ys[:, b].numpy(), soln(HEAT_T, d), atol=2e-3)


@pytest.mark.parametrize("method", ["bdf", "tr_bdf2", "tsit45"])
@pytest.mark.parametrize("case", ["robertson", "heat1d_banded"])
def test_sens_members(method, case):
    """sens=True batched: the rows (naug, B, n) through each member's own
    steps, Newton against its own factors (banded: the naug B rows in one
    solve, row r against member r mod B's factors), held to the single
    solves' rows.  TSIT45 runs Robertson over its first, non-stiff
    millisecond."""
    if case == "robertson":
        problem = rob.problem_ode()
        pb = _robertson_params(2)
        t_eval = [1e-4, 1e-3, 3e-3] if method == "tsit45" else SENS_T[:1]
    else:
        problem, _ = heat1d.make(mgrid=15, banded=True)
        pb, t_eval = HEAT_D[::3], HEAT_T[:1]
    sol = _solve_and_match(_make(method, sens=True), problem, t_eval, pb)
    naug = problem.eqn.nparams
    assert tuple(sol.sens.shape) == (len(t_eval), naug, len(pb), problem.eqn.nstates)
    assert sol.stop_reason.tolist() == [errors.TSTOP_REACHED] * len(pb)


def test_bdf_sens_matches_jax_vmap(jax_bdf_sens):
    """BdfSolver(sens=True) independent, B = 3, against JAX's vmapped solve:
    equal steps and Newton iterations a member, the rows within 1e-9 of
    the largest (test_torch_sens.py's continuous twin)."""
    tp, ref = jax_bdf_sens
    make = _make("bdf", sens=True)
    sol = _solve_and_match(make, tp, SENS_T, _sens_params())
    assert sol.stop_reason.tolist() == ref["stop"].tolist()
    assert sol.state.stats.steps.tolist() == ref["steps"].tolist()
    assert sol.state.stats.newton_iterations.tolist() == ref["newton"].tolist()
    js = np.transpose(ref["sens"], (1, 2, 0, 3))  # -> (neval, naug, B, n)
    assert tuple(sol.sens.shape) == js.shape
    np.testing.assert_allclose(sol.sens.numpy(), js, rtol=0,
                               atol=CONT_RTOL * np.abs(js).max())
    np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=TRAJ_RTOL, atol=TRAJ_ATOL)


@pytest.mark.parametrize("method", ["bdf", "tr_bdf2"])
def test_diagonal_mass_dae_with_rows(method):
    """Robertson DAE (mass diag(1, 1, 0)) with sens=True: each member's
    consistent state and algebraic rows, then its own steps."""
    pb = _robertson_params(2)
    sol = _solve_and_match(_make(method, sens=True), rob.problem_dae(), SENS_T[:1], pb)
    np.testing.assert_allclose(sol.ys.sum(-1).numpy(), 1.0, atol=1e-6)
    # d(x + y + z)/dp = 0 on the algebraic constraint
    np.testing.assert_allclose(sol.sens.sum(-1).numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("method", ["bdf", "tr_bdf2"])
def test_block_tier_members(method):
    """robertson_ode in an ngroups = 4 layout on the block-diagonal tier, B
    = 3: a refresh factors the refreshed members' (S K, nb, nb) blocks in
    one batched LU, and each member solves against its own K blocks."""
    problem = rob.problem_ode_groups(4)
    assert problem.linear_solver.name == "blockdiag(3,4)"
    pb = _robertson_params(3)
    sol = _solve_and_match(_make(method), problem, [1.0, 100.0], pb)
    assert sol.stop_reason.tolist() == [errors.TSTOP_REACHED] * 3
    # the groups share each member's parameters: equal within a member
    ys = sol.ys.reshape(-1, 3, 4, 3)
    np.testing.assert_allclose(ys.numpy(), ys[:, :, :1].expand_as(ys).numpy(), rtol=1e-12)
