"""Twins of the twelve tests of tests/test_api.py (the method factory,
resumable staged solves, state mutation, statistics, the error status,
a non-zero t0, derivative dense output, checkpoints, a stop time in the
past, a mid-run config change and the float32 tier), parametrised as
there.  Each holds the port to the JAX test's own bound (analytic
solutions, counters, error codes), and where the JAX package solves the
same problem cheaply, to its result: the same float64 algorithm, so
API_RTOL (measured: 1e-12 and below) and equal counters.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.models import exponential_decay as jed
from diffsol_tpu.models import logistic as jlog
from diffsol_tpu.models import robertson as jrob
from diffsol_tpu.utils import stats_dict as jax_stats_dict

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.models import exponential_decay, logistic, robertson
from diffsol_tpu_torch.utils import stats_dict, stats_json

torch.set_num_threads(1)

F64 = torch.float64
API_RTOL = 1e-9


def _solve_dense(solver, t_eval, **kw):
    return dtt.solve_dense(solver, t_eval, device="cpu", **kw)


def _solve(solver, final_time, **kw):
    return dtt.solve(solver, final_time, device="cpu", **kw)


@pytest.mark.parametrize("method", dtt.METHODS)
def test_factory_methods(method):
    problem = exponential_decay.problem(rtol=1e-6, atol=1e-8)
    sol = _solve_dense(dtt.solver(problem, method), np.linspace(0.0, 1.0, 5))
    expected = exponential_decay.soln(sol.ts.numpy(), problem.params.numpy())
    np.testing.assert_allclose(sol.ys.numpy(), expected, rtol=1e-4, atol=1e-6)
    jsol = dt.solve_dense(dt.solver(jed.problem(rtol=1e-6, atol=1e-8), method),
                          jnp.linspace(0.0, 1.0, 5))
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(jsol.ys), rtol=API_RTOL)
    assert sol.state.stats.steps == int(jsol.state.stats.steps)


def test_staged_resume_matches_single_solve():
    """A Solution's final state is a restartable checkpoint (reference
    solution.rs resumable solves)."""
    problem = logistic.problem(rtol=1e-8, atol=1e-10)
    solver = dtt.BdfSolver(problem)
    t2 = np.linspace(6.0, 10.0, 5)
    sol1 = _solve_dense(solver, np.linspace(0.0, 5.0, 6))
    assert sol1.stop_reason == errors.TSTOP_REACHED
    sol2 = _solve_dense(solver, t2, state=sol1.state)
    expected = logistic.soln(t2, problem.params.numpy())
    np.testing.assert_allclose(sol2.ys.numpy(), expected, rtol=1e-6, atol=1e-9)
    jsolver = dt.BdfSolver(jlog.problem(rtol=1e-8, atol=1e-10))
    j1 = dt.solve_dense(jsolver, jnp.linspace(0.0, 5.0, 6))
    j2 = dt.solve_dense(jsolver, jnp.asarray(t2), state=j1.state)
    np.testing.assert_allclose(sol2.ys.numpy(), np.asarray(j2.ys), rtol=API_RTOL)


def test_state_mut_and_continue():
    """Reference test_state_mut: halve the state mid-solve and continue;
    the solver restarts at order 1 from the modified state."""
    problem = exponential_decay.problem(rtol=1e-8, atol=1e-10)
    solver = dtt.BdfSolver(problem)
    st = _solve_dense(solver, np.linspace(0.0, 1.0, 3)).state
    y_new = st.y * 0.5
    st = dataclasses.replace(st, y=y_new, dy=problem.eqn.rhs(problem.t0.new_tensor(st.t),
                                                             y_new, problem.params),
                             state_modified=True)
    t2 = np.array([1.5, 2.0])
    sol2 = _solve_dense(solver, t2, state=st)
    a = float(problem.params[0])
    expected = 0.5 * np.exp(-a * 1.0) * np.exp(-a * (t2 - 1.0))
    np.testing.assert_allclose(sol2.ys[:, 0].numpy(), expected, rtol=1e-6)


def test_stats_helpers():
    """stats_dict / stats_json of a Solution: the JAX package's counters,
    one for one, in its key order."""
    sol = _solve_dense(dtt.BdfSolver(logistic.problem()), np.linspace(0.0, 5.0, 3))
    d = stats_dict(sol)
    assert d["steps"] > 0
    assert d["newton_iterations"] >= d["steps"]
    assert "steps" in stats_json(sol)
    assert stats_dict(sol.state) == d
    jd = jax_stats_dict(dt.solve_dense(dt.BdfSolver(jlog.problem()), jnp.linspace(0.0, 5.0, 3)))
    assert list(d) == list(jd) and d == jd


def _blow_up(lib):
    return (
        dtt.OdeBuilder() if lib is torch else dt.OdeBuilder()
    ).rhs(lambda t, y, p: y * y).init(
        (lambda t, p: torch.ones(1, dtype=F64)) if lib is torch
        else (lambda t, p: jnp.array([1.0]))
    ).p([0.0]).rtol(1e-8).atol(1e-10).build()


def test_error_status_raises():
    """dy/dt = y^2 from y0 = 1 blows up at t = 1: the solve ends with an
    error code (JAX's) and raise_for_status raises DiffsolError."""
    sol = _solve_dense(dtt.BdfSolver(_blow_up(torch)), [0.5, 2.0], max_steps=2000)
    assert sol.stop_reason < 0
    with pytest.raises(errors.DiffsolError) as info:
        sol.raise_for_status()
    assert info.value.code == sol.stop_reason
    jsol = dt.solve_dense(dt.BdfSolver(_blow_up(jnp)), jnp.asarray([0.5, 2.0]), max_steps=2000)
    assert sol.stop_reason == int(jsol.stop_reason)
    ok = _solve_dense(dtt.BdfSolver(logistic.problem()), [1.0])
    assert ok.raise_for_status() is ok


def test_nonzero_t0():
    """Integration from t0 = 3 with BDF and TSIT45."""
    problem = (
        dtt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * y)
        .init(lambda t, p: torch.full((1,), 2.0, dtype=F64))
        .p([0.4])
        .t0(3.0)
        .rtol(1e-8)
        .atol(1e-10)
        .build()
    )
    for method in ("bdf", "tsit45"):
        t_eval = np.array([3.5, 4.0, 5.0])
        sol = _solve_dense(dtt.solver(problem, method), t_eval)
        np.testing.assert_allclose(sol.ys[:, 0].numpy(), 2.0 * np.exp(-0.4 * (t_eval - 3.0)),
                                   rtol=1e-6)


def test_interpolate_dy():
    """Derivative dense output (reference test_interpolate_dy,
    ode_solver/mod.rs:909): after 25 steps, interpolate_dy inside the last
    step against the rhs at the interpolated state."""
    problem = logistic.problem(rtol=1e-9, atol=1e-11)
    for method in ("bdf", "tr_bdf2", "tsit45"):
        s = dtt.solver(problem, method)
        state = s.init_state()
        for _ in range(25):
            state = s.step(state)
        if hasattr(state, "t_prev"):
            t_mid = state.t - 0.4 * (state.t - state.t_prev)
        else:
            t_mid = state.t - 0.3 * state.h
        y_mid = s.interpolate(state, t_mid)
        dy_mid = s.interpolate_dy(state, t_mid)
        expected = logistic.rhs(t_mid, y_mid, problem.params)
        np.testing.assert_allclose(dy_mid.numpy(), expected.numpy(), rtol=1e-4, atol=1e-8)


def test_checkpoint_serialize_resume(tmp_path):
    """A mid-solve checkpoint saved with torch.save and loaded with
    torch.load resumes bit for bit like the state in memory (reference
    checkpoint/set_state, method.rs:56-70)."""
    problem = logistic.problem(rtol=1e-8, atol=1e-10)
    solver = dtt.BdfSolver(problem)
    t2 = np.linspace(5.0, 10.0, 6)
    sol1 = _solve_dense(solver, np.linspace(0.0, 4.0, 5))
    path = tmp_path / "ckpt.pt"
    torch.save(sol1.state, path)
    state2 = torch.load(path, weights_only=False)
    sol_resumed = _solve_dense(solver, t2, state=state2)
    sol_direct = _solve_dense(solver, t2, state=sol1.state)
    assert torch.equal(sol_resumed.ys, sol_direct.ys)
    np.testing.assert_allclose(sol_resumed.ys.numpy(), logistic.soln(t2, problem.params.numpy()),
                               rtol=1e-6, atol=1e-9)


def test_stop_time_before_current_time():
    """A final time in the past ends STOP_TIME_BEFORE_CURRENT_TIME, and
    raise_for_status raises."""
    s = dtt.solver(logistic.problem(), "bdf")
    sol = _solve_dense(s, [1.0, 2.0], max_steps=1000)
    assert sol.stop_reason >= 0
    sol2 = _solve_dense(s, [0.5], state=sol.state, max_steps=1000)
    assert sol2.stop_reason == errors.STOP_TIME_BEFORE_CURRENT_TIME
    with pytest.raises(errors.DiffsolError):
        sol2.raise_for_status()


def test_with_config_mid_run():
    """A staged solve continues under a new config (reference method.rs:84
    config_mut): with the timestep growth clamped to 1 the second stage
    takes more steps than under the default, and ends at the same state."""
    problem = logistic.problem(rtol=1e-8, atol=1e-10)
    solver = dtt.BdfSolver(problem)
    sol1 = _solve(solver, 1.0, max_steps=2000)
    steps1 = sol1.state.stats.steps
    sol_def = _solve(solver, 5.0, state=sol1.state, max_steps=2000)
    frozen = dataclasses.replace(solver.config, maximum_timestep_growth=1.0,
                                 minimum_timestep_growth=1.0)
    sol_frz = _solve(solver.with_config(frozen), 5.0, state=sol1.state, max_steps=2000)
    assert sol_frz.stop_reason == errors.TSTOP_REACHED
    assert sol_frz.state.stats.steps - steps1 > sol_def.state.stats.steps - steps1
    np.testing.assert_allclose(sol_frz.state.y.numpy(), sol_def.state.y.numpy(), rtol=1e-6)


def _logistic_builder(lib, dtype=None):
    init = ((lambda t, p: p[2:3].clone()) if lib is torch
            else (lambda t, p: jnp.asarray([p[2]])))
    b = ((dtt.OdeBuilder() if lib is torch else dt.OdeBuilder())
         .rhs(lambda t, y, p: p[0] * y * (1.0 - y / p[1])).init(init)
         .p([1.0, 10.0, 0.1]).rtol(1e-5).atol(1e-7))
    return b if dtype is None else b.dtype(dtype)


def test_f32_solves():
    """The float32 tier (reference ScalarType::F32): the whole solve
    carries float32 and meets the float64 trajectory within 2e-4; stiff
    Robertson at rtol 1e-4 in float32 reaches 0.985172 within 5e-3.  The
    JAX package's float32 solve of the same problem is within the same
    2e-4 (its time and step control are float32 too, the port's Python
    floats)."""
    t_eval = np.linspace(0.5, 5.0, 4)
    sol32 = _solve_dense(dtt.BdfSolver(_logistic_builder(torch, torch.float32).build()), t_eval)
    sol64 = _solve_dense(dtt.BdfSolver(_logistic_builder(torch).build()), t_eval)
    assert sol32.ys.dtype == torch.float32 and sol64.ys.dtype == F64
    assert sol32.stop_reason >= 0
    np.testing.assert_allclose(sol32.ys.numpy(), sol64.ys.numpy(), rtol=2e-4)
    j32 = dt.solve_dense(dt.BdfSolver(_logistic_builder(jnp, jnp.float32).build()),
                         jnp.asarray(t_eval))
    np.testing.assert_allclose(sol32.ys.numpy(), np.asarray(j32.ys), rtol=2e-4)
    prob32 = robertson.problem_ode(rtol=1e-4, atol=1e-6, dtype=torch.float32)
    s = _solve_dense(dtt.BdfSolver(prob32), [0.4, 4.0], max_steps=5000)
    assert s.ys.dtype == torch.float32 and s.stop_reason >= 0
    np.testing.assert_allclose(float(s.ys[0, 0]), 0.985172, rtol=5e-3)
    js = dt.solve_dense(dt.BdfSolver(jrob.problem_ode(rtol=1e-4, atol=1e-6, dtype=jnp.float32)),
                        jnp.asarray([0.4, 4.0]), max_steps=5000)
    np.testing.assert_allclose(s.ys.numpy(), np.asarray(js.ys), rtol=5e-3)


def test_builder_rebuild_does_not_stack_dtype_wrappers():
    """build() leaves the builder as it was: a second build in float64
    keeps the 1e-12 that a float32 cast would round away."""
    b = (
        dtt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * y)
        .init(lambda t, p: torch.full((1,), 1.0 + 1e-12, dtype=F64))
        .p([1.0])
        .dtype(torch.float32)
    )
    p32 = b.build()
    assert p32.dtype == torch.float32 and p32.params.dtype == torch.float32
    assert float(p32.eqn.init(p32.t0, p32.params)[0]) == 1.0
    p64 = b.dtype(torch.float64).build()
    y = p64.eqn.init(p64.t0, p64.params)
    assert y.dtype == F64
    assert float(y[0]) != 1.0
