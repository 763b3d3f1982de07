"""Diagonal-mass DAEs: the port against the JAX package.

Module by module on the same inputs: ``solvers.consistent_ic`` (the
consistent state to 1e-10), the eager BDF on the Robertson DAE to t = 4e6
(against JAX and the CVODE table), the lockstep DAE ensemble at B = 4, and
the fused tier's plain version against the Pallas kernel in interpret
mode at the configuration of tests/test_pallas_stepper.py:35 (B = 4 in one
tile), with the tier's scope raises of :19 and :68.  The JAX kernel keeps
its heuristics in float32 and its state in double-float pairs, the port is
float64 throughout: trajectories agree to ~1e-7 relative (1e-6 is the
bound).  Each JAX solve runs once, in a module-scoped fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.ensemble import make_lockstep_problem as jax_lockstep_problem
from diffsol_tpu.ensemble import solve_dense_ensemble as jax_ensemble
from diffsol_tpu.models import exponential_decay_algebraic as jeda
from diffsol_tpu.models import robertson as jrob
from diffsol_tpu.solvers import consistent_ic as jic

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import exponential_decay_algebraic as teda
from diffsol_tpu_torch.models import robertson as trob
from diffsol_tpu_torch.ops import fused_stepper as fs
from diffsol_tpu_torch.ops.eqn_codegen import UnsupportedForKernel
from diffsol_tpu_torch.solvers import consistent_ic as tic

torch.set_num_threads(1)

B = 4
F64 = torch.float64
T_FUSED = [0.4, 4.0, 40.0]
T_SINGLE = [0.4, 4.0, 40.0, 400.0, 4e3, 4e4, 4e5, 4e6]
STEP_SLACK = 2
FUSED_RTOL, FUSED_ATOL = 1e-6, 1e-12


def _params(nbatch):
    k1 = 0.04 * (1.0 + 0.1 * np.linspace(-1.0, 1.0, nbatch))
    return np.stack([k1, np.full(nbatch, 1e4), np.full(nbatch, 3e7)], axis=1)


@pytest.fixture(scope="module")
def jax_runs():
    problem = jrob.problem_dae(rtol=1e-4, atol=(1e-8, 1e-6, 1e-6))
    params = jnp.asarray(_params(B))
    fused = jax_ensemble(dt.BdfSolver, problem, T_FUSED, params, mode="fused",
                         interpret=True)
    lp = jax_lockstep_problem(problem, B)
    lock = dt.solve_dense(dt.BdfSolver(lp), jnp.asarray(T_FUSED), params=params,
                          max_steps=2000)
    single = dt.solve_dense(dt.BdfSolver(problem), jnp.asarray(T_SINGLE))
    return dict(
        problem=problem,
        fused_ys=np.asarray(fused.ys), fused_stop=int(fused.stop_reason),
        fused_steps=np.asarray(fused.tile_steps), fused_tier=fused.tier,
        lock_ys=np.moveaxis(np.asarray(lock.ys), -1, 1),
        lock_stop=int(lock.stop_reason), lock_steps=int(lock.state.stats.steps),
        single_ys=np.asarray(single.ys), single_stop=int(single.stop_reason),
        single_steps=int(single.state.stats.steps),
    )


@pytest.fixture(scope="module")
def port_problem(jax_runs):
    return problem_from_jax(jax_runs["problem"], trob.rhs_dae, trob.init, mass=trob.mass)


def test_problem_from_jax_carries_the_dae(jax_runs, port_problem):
    jp = jax_runs["problem"]
    assert port_problem.eqn.mass_diag_fn is not None
    assert port_problem.ic_options.max_newton_iterations == jp.ic_options.max_newton_iterations
    assert port_problem.ic_options.armijo_constant == jp.ic_options.armijo_constant
    md = port_problem.eqn.mass_diag_fn(port_problem.t0, port_problem.params)
    np.testing.assert_array_equal(md.numpy(), [1.0, 1.0, 0.0])
    np.testing.assert_array_equal(tic.algebraic_mask(port_problem).numpy(),
                                  np.asarray(jic.algebraic_mask(jp)))
    moved = port_problem.to("cpu")
    assert moved.ic_options is port_problem.ic_options


def test_fused_dae_matches_pallas_interpret(jax_runs, port_problem):
    """The slice as a whole and its kernel module: solve_dense_ensemble
    (mode="fused", device="cpu") runs the plain version of the kernel."""
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, port_problem, T_FUSED, _params(B),
                                   mode="fused", tile=B, device="cpu")
    assert sol.tier == "fused_small_reference" and jax_runs["fused_tier"] == "fused_small"
    assert sol.stop_reason == jax_runs["fused_stop"] == dtt.errors.TSTOP_REACHED
    assert sol.tile_steps.tolist() == jax_runs["fused_steps"].tolist()
    np.testing.assert_allclose(sol.ys.numpy(), jax_runs["fused_ys"], rtol=FUSED_RTOL,
                               atol=FUSED_ATOL)
    # the constraint x + y + z = 1 holds along the whole trajectory
    np.testing.assert_allclose(sol.ys.sum(-1).numpy(), 1.0, atol=1e-6)
    # and the tier agrees with the lockstep DiagMass path at the solver's
    # tolerance (tests/test_pallas_stepper.py:63-65)
    np.testing.assert_allclose(sol.ys.numpy(), jax_runs["lock_ys"], rtol=5e-3, atol=1e-8)


def test_fused_config_of_the_dae(port_problem):
    solve = fs.make_fused_bdf_solve(port_problem, T_FUSED, B, tile=B)
    cfg = solve.cfg
    assert cfg.has_mass and cfg.mass_const == (1.0, 1.0, 0.0)
    assert not cfg.extended and cfg.nroot == 0 and cfg.nquad == 0
    assert "#define MODEL_HAS_MASS 1" in solve.header
    assert "out[2] = T(0.0);" in solve.header  # the constant diagonal, folded
    ys, status, steps = solve(torch.tensor(_params(B)))
    assert status.tolist() == [fs.OK]


def test_lockstep_dae_matches_jax_lockstep(jax_runs, port_problem):
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, port_problem, T_FUSED, _params(B),
                                   mode="lockstep", device="cpu")
    assert sol.stop_reason == jax_runs["lock_stop"] == dtt.errors.TSTOP_REACHED
    assert abs(sol.state.stats.steps - jax_runs["lock_steps"]) <= STEP_SLACK
    np.testing.assert_allclose(sol.ys.numpy(), jax_runs["lock_ys"], rtol=1e-6, atol=1e-12)


def test_robertson_dae_single_instance_matches_jax_and_soln(jax_runs, port_problem):
    sol = dtt.solve_dense(dtt.BdfSolver(port_problem), T_SINGLE, device="cpu")
    assert sol.stop_reason == jax_runs["single_stop"] == dtt.errors.TSTOP_REACHED
    assert abs(sol.state.stats.steps - jax_runs["single_steps"]) <= STEP_SLACK
    ys = sol.ys.numpy()
    np.testing.assert_allclose(ys, jax_runs["single_ys"], rtol=1e-6, atol=1e-14)
    rows = trob.SOLN[1:9]
    np.testing.assert_allclose(ys[:, 0], rows[:, 1], rtol=5e-3, atol=1e-10)
    np.testing.assert_allclose(ys[:, 2], rows[:, 3], rtol=5e-3, atol=1e-8)
    np.testing.assert_allclose(ys.sum(-1), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# consistent initial conditions
# ---------------------------------------------------------------------------

def _two_state(jnp_like):
    """An inconsistent 2-state DAE in either package: y0' = -p0 y0,
    0 = y0 + y1 - 0.5 with init [1, 0]."""
    if jnp_like:
        return (dt.OdeBuilder()
                .rhs(lambda t, y, p: jnp.array([-p[0] * y[0], y[0] + y[1] - 0.5]))
                .init(lambda t, p: jnp.array([1.0, 0.0]))
                .mass(lambda t, p: jnp.diag(jnp.array([1.0, 0.0]))).p([0.1]).build())
    return (dtt.OdeBuilder()
            .rhs(lambda t, y, p: torch.stack([-p[0] * y[0], y[0] + y[1] - 0.5]))
            .init(lambda t, p: torch.tensor([1.0, 0.0], dtype=F64))
            .mass(lambda t, p: torch.diag(torch.tensor([1.0, 0.0], dtype=F64)))
            .p([0.1]).build())


@pytest.mark.parametrize("case", ["exponential_decay_algebraic", "two_state"])
def test_make_consistent_matches_jax(case):
    if case == "two_state":
        jp, tp = _two_state(True), _two_state(False)
    else:
        jp, tp = jeda.problem(), teda.problem()
    jy = jp.eqn.init(jp.t0, jp.params)
    jdy = jp.eqn.rhs(jp.t0, jy, jp.params)
    ry, rdy, rstatus = jic.make_consistent(jp, jp.params, jy, jdy, jic.algebraic_mask(jp))
    ty = tp.eqn.init(tp.t0, tp.params)
    tdy = tp.eqn.rhs(tp.t0, ty, tp.params)
    gy, gdy, gstatus = tic.make_consistent(tp, tp.params, ty, tdy, tic.algebraic_mask(tp))
    assert gstatus == int(rstatus) == dtt.errors.INTERNAL_TIMESTEP
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(gdy.numpy(), np.asarray(rdy), rtol=1e-10, atol=1e-10)
    want = [1.0, -0.5] if case == "two_state" else [1.0, 1.0, 1.0]
    np.testing.assert_allclose(gy.numpy(), want, atol=1e-10)


def test_make_consistent_lockstep_and_failure():
    tp = teda.problem()
    lp = dtt.make_lockstep_problem(tp, 3)
    params = torch.tensor([[0.1], [0.2], [0.3]], dtype=F64)
    state = dtt.BdfSolver(lp).init_state(params)
    assert state.status == dtt.errors.INTERNAL_TIMESTEP
    np.testing.assert_allclose(state.y.numpy(), np.ones((3, 3)), atol=1e-10)
    np.testing.assert_allclose(state.dy.numpy(), -params.numpy() * [1.0, 1.0, 0.0],
                               atol=1e-10)
    # an algebraic row with no solution: the typed failure, the state kept
    bad = (dtt.OdeBuilder()
           .rhs(lambda t, y, p: torch.stack([-y[0], y[1] * y[1] + 1.0]))
           .init(lambda t, p: torch.tensor([1.0, 0.5], dtype=F64))
           .mass(lambda t, p: torch.diag(torch.tensor([1.0, 0.0], dtype=F64))).build())
    state = dtt.BdfSolver(bad).init_state()
    assert state.status == dtt.errors.INITIAL_CONDITION_DID_NOT_CONVERGE
    sol = dtt.solve_dense(dtt.BdfSolver(bad), [1.0], device="cpu")
    assert sol.stop_reason == dtt.errors.INITIAL_CONDITION_DID_NOT_CONVERGE


def test_exponential_decay_algebraic_solves_from_inconsistent_init():
    tp = teda.problem()
    sol = dtt.solve_dense(dtt.BdfSolver(tp), [1.0, 5.0, 10.0], device="cpu")
    assert sol.stop_reason == dtt.errors.TSTOP_REACHED
    np.testing.assert_allclose(sol.ys.numpy(), teda.soln([1.0, 5.0, 10.0], (0.1,)),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the fused tier's scope (tests/test_pallas_stepper.py:19, :68)
# ---------------------------------------------------------------------------

def test_fused_rejects_inconsistent_dae_init_and_auto_goes_lockstep():
    problem = _two_state(False)
    with pytest.raises(UnsupportedForKernel, match="consistent"):
        fs.make_fused_bdf_solve(problem, [1.0], 4, tile=4)
    params = np.full((4, 1), 0.1)
    with pytest.raises(UnsupportedForKernel, match="consistent"):
        dtt.solve_dense_ensemble(dtt.BdfSolver, problem, [1.0], params, mode="fused",
                                 device="cpu")
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, [1.0], params, mode="auto",
                                   device="cpu")
    assert sol.tier == "lockstep" and sol.stop_reason == dtt.errors.TSTOP_REACHED
    np.testing.assert_allclose(sol.ys[0, :, 0].numpy(), np.exp(-0.1), rtol=1e-5)
    np.testing.assert_allclose(sol.ys.sum(-1).numpy(), 0.5, atol=1e-8)


def test_fused_rejects_a_dense_mass():
    problem = (dtt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y)
               .init(lambda t, p: torch.ones(2, dtype=F64))
               .mass(lambda t, p: torch.tensor([[1.0, 0.5], [0.0, 1.0]], dtype=F64))
               .p([0.5]).build())
    with pytest.raises(UnsupportedForKernel, match="ROADMAP"):
        fs.make_fused_bdf_solve(problem, [1.0], 4)


def test_fused_replays_a_mass_that_depends_on_t():
    """A diagonal that changes with t or p is not folded but replayed at
    every step; M y' = -a y with M = (1 + t) I has y = (1 + t)^(-a)."""
    problem = (dtt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y)
               .init(lambda t, p: torch.ones(2, dtype=F64))
               .mass(lambda t, p: torch.diag(torch.stack([1.0 + t + 0.0 * p[0]] * 2)))
               .p([0.5]).rtol(1e-6).atol(1e-8).build())
    solve = fs.make_fused_bdf_solve(problem, [1.0, 3.0], 4, tile=2)
    assert solve.cfg.has_mass and solve.cfg.mass_const is None
    assert "model_mass" in solve.header
    a = np.array([0.5, 0.7, 0.9, 1.1])
    ys, status, steps = solve(torch.tensor(a[:, None]))
    assert status.tolist() == [fs.OK, fs.OK]
    exact = (1.0 + np.array([1.0, 3.0]))[:, None] ** (-a[None, :])
    np.testing.assert_allclose(ys[:, 0, :].numpy(), exact, rtol=1e-4)
