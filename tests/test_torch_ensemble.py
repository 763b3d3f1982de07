"""Ensembles: the port's lockstep mode and the fused tier's plain version
against the JAX package, the problem interop and mode routing.  (The CUDA
kernel against its plain version is tests/test_torch_cuda.py.)

The JAX side runs once per module at the configuration of
tests/test_pallas_stepper.py:85-115: Robertson with k1 spread +-10% over
B=8 members, t_eval up to 400, rtol=1e-4, atol=(1e-8, 1e-6, 1e-6).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.ensemble import make_lockstep_problem as jax_lockstep_problem
from diffsol_tpu.models import robertson as jrob
from diffsol_tpu.ops.pallas_stepper import make_pallas_bdf_solve

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.interop import problem_from_jax, solution_to_numpy
from diffsol_tpu_torch.models import robertson as trob
from diffsol_tpu_torch.ops import fused_stepper as fs

torch.set_num_threads(1)

B = 8
T_EVAL = [0.4, 4.0, 40.0, 400.0]
STEP_SLACK = 2


def _params(nbatch):
    k1 = 0.04 * (1.0 + 0.1 * np.linspace(-1.0, 1.0, nbatch))
    return np.stack([k1, np.full(nbatch, 1e4), np.full(nbatch, 3e7)], axis=1)


@pytest.fixture(scope="module")
def jax_runs():
    problem = jrob.problem_ode(rtol=1e-4, atol=(1e-8, 1e-6, 1e-6))
    params = jnp.asarray(_params(B))
    fused = make_pallas_bdf_solve(problem, T_EVAL, nbatch=B, tile=8, interpret=True)
    ys, status, steps = fused(params)
    lp = jax_lockstep_problem(problem, B)
    lock = dt.solve_dense(dt.BdfSolver(lp), jnp.asarray(T_EVAL), params=params,
                          max_steps=2000)
    return dict(
        problem=problem,
        fused_ys=np.asarray(ys), fused_status=np.asarray(status),
        fused_steps=np.asarray(steps),
        lock_ys=np.moveaxis(np.asarray(lock.ys), -1, 1),  # (neval, B, n)
        lock_stop=int(lock.stop_reason), lock_steps=int(lock.state.stats.steps),
    )


@pytest.fixture(scope="module")
def port_problem(jax_runs):
    return problem_from_jax(jax_runs["problem"], trob.rhs_ode, trob.init)


def test_lockstep_matches_jax(jax_runs, port_problem):
    """Same algorithm in float64 on both sides (see test_torch_bdf.py for
    the reasons behind rtol=1e-6 and the step slack)."""
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, port_problem, T_EVAL,
                                   torch.tensor(_params(B)), mode="lockstep",
                                   device="cpu")
    got = solution_to_numpy(sol)
    assert got["tier"] == "lockstep"
    assert got["stop_reason"] == jax_runs["lock_stop"] == dtt.errors.TSTOP_REACHED
    assert got["ys"].shape == (len(T_EVAL), B, 3)
    np.testing.assert_allclose(got["ys"], jax_runs["lock_ys"], rtol=1e-6, atol=1e-14)
    assert abs(sol.state.stats.steps - jax_runs["lock_steps"]) <= STEP_SLACK


def test_fused_plain_matches_jax_interpret(jax_runs, port_problem):
    """The fused tier's plain version against the Pallas kernel in
    interpret mode, at test_pallas_stepper.py:115's tolerance: the Pallas
    kernel keeps its state in double-float pairs (~2^-48) and its
    heuristics in float32, the port everything in float64."""
    solve = fs.make_fused_bdf_solve(port_problem, T_EVAL, B, tile=8)
    ys, status, steps = solve(torch.tensor(_params(B)))
    assert status.tolist() == jax_runs["fused_status"].tolist() == [fs.OK]
    np.testing.assert_allclose(ys.numpy(), jax_runs["fused_ys"], rtol=5e-3, atol=1e-8)
    assert abs(int(steps[0]) - int(jax_runs["fused_steps"][0])) <= STEP_SLACK
    assert int(steps[0]) > 10


def test_fused_mode_on_cpu_runs_the_plain_version(jax_runs, port_problem):
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, port_problem, T_EVAL,
                                   torch.tensor(_params(B)), mode="fused", tile=4,
                                   device="cpu")
    got = solution_to_numpy(sol)
    assert got["tier"] == "fused_small_reference"
    assert got["stop_reason"] == dtt.errors.TSTOP_REACHED
    assert got["ys"].shape == (len(T_EVAL), B, 3)  # the JAX public layout
    assert got["tile_steps"].shape == (2,)
    # two tiles of 4 step on their own: a different result than one tile
    # of 8 by design, still within the solver tolerance of the JAX kernel
    np.testing.assert_allclose(got["ys"], np.moveaxis(jax_runs["fused_ys"], -1, 1),
                               rtol=5e-3, atol=1e-8)


def test_auto_mode_on_cpu_is_lockstep(jax_runs, port_problem):
    """``mode="auto"`` goes lockstep for a problem outside every kernel's
    scope: here Robertson plus ``0 * erf(y)``, an op the kernels' tracer
    does not take, which leaves the solution as it was."""
    def rhs(t, y, p):
        return trob.rhs_ode(t, y, p) + 0.0 * torch.erf(y)

    problem = dataclasses.replace(
        port_problem, eqn=dataclasses.replace(port_problem.eqn, rhs=rhs))
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, T_EVAL[:2],
                                   _params(B), mode="auto", device="cpu")
    assert sol.tier == "lockstep"
    assert sol.stop_reason == dtt.errors.TSTOP_REACHED
    # a stop time of 4 in place of 400 changes the last steps: agreement
    # at the solver tolerance
    np.testing.assert_allclose(sol.ys.numpy(), jax_runs["lock_ys"][:2],
                               rtol=5e-3, atol=1e-8)


def test_auto_mode_on_cpu_takes_the_kernel_plain_version(port_problem):
    """``mode="auto"`` takes a kernel tier whenever the problem is in its
    scope, on any device: on the CPU that is the kernel's plain version."""
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, port_problem, T_EVAL[:2],
                                   _params(4), mode="auto", device="cpu")
    assert sol.tier == "fused_small_reference"
    assert sol.stop_reason == dtt.errors.TSTOP_REACHED


def test_independent_mode(jax_runs, port_problem):
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, port_problem, T_EVAL,
                                   torch.tensor(_params(B)[:2]), mode="independent",
                                   device="cpu")
    assert sol.tier == "independent"
    assert sol.stop_reason.tolist() == [dtt.errors.TSTOP_REACHED] * 2
    # each member takes its own steps: agreement at the solver tolerance
    np.testing.assert_allclose(sol.ys.numpy(), jax_runs["lock_ys"][:, :2],
                               rtol=5e-3, atol=1e-8)


def test_problem_from_jax_round_trips_every_option():
    opts = dt.OdeSolverOptions(
        max_nonlinear_solver_iterations=7, max_error_test_failures=11,
        max_nonlinear_solver_failures=13, nonlinear_solver_tolerance=0.15,
        min_timestep=1e-11, max_timestep_growth=3.0, min_timestep_growth=1.5,
        max_timestep_shrink=0.8, min_timestep_shrink=0.3,
        update_jacobian_after_steps=17, update_rhs_jacobian_after_steps=41,
        threshold_to_update_jacobian=0.25, threshold_to_update_rhs_jacobian=0.15,
        pi_control_proportional=0.1, pi_control_integral=0.4,
    )
    pj = (dt.OdeBuilder().rhs(jrob.rhs_ode).init(jrob.init).p([0.05, 2e4, 1e7])
          .t0(0.5).h0(1e-3).rtol(1e-5).atol(jnp.asarray([1e-9, 1e-7, 1e-7]))
          .options(opts).build())
    pt = problem_from_jax(pj, trob.rhs_ode, trob.init)
    for f in dataclasses.fields(dt.OdeSolverOptions):
        assert getattr(pt.options, f.name) == getattr(opts, f.name), f.name
    np.testing.assert_array_equal(pt.params.numpy(), np.asarray(pj.params))
    np.testing.assert_array_equal(pt.atol.numpy(), np.asarray(pj.atol))
    for name in ("t0", "h0", "rtol"):
        assert float(getattr(pt, name)) == float(getattr(pj, name))
    assert pt.params.dtype == pt.atol.dtype == torch.float64
    cfg = dtt.SolverConfig.from_options(pt.options, "bdf")
    assert cfg == dataclasses.replace(
        dtt.SolverConfig(), **dataclasses.asdict(
            dt.SolverConfig.from_options(opts, "bdf")))
