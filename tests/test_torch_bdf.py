"""The port's single-instance BdfSolver on the stiff Robertson ODE, against
the JAX BdfSolver and against the reference's CVODE table.

Both solvers are float64 and run the same algorithm; they differ in the
LU (torch.linalg vs the JAX package's unrolled smalllu) and in the
controller's and Newton's bookkeeping, which JAX keeps in float32.  Those
roundoff-level differences leave every step decision the same unless one
lands within roundoff of its threshold, so the trajectories agree to
rtol=1e-6 (two hundred times tighter than the solver's rtol=1e-4) and the
accepted step counts within 2 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.models import robertson as jrob

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.interop import problem_from_jax, solution_to_numpy
from diffsol_tpu_torch.models import heat1d as theat
from diffsol_tpu_torch.models import robertson as trob

torch.set_num_threads(1)

T_EVAL = trob.SOLN[1:9, 0]  # 0.4 ... 4e6
TRAJ_RTOL, TRAJ_ATOL = 1e-6, 1e-14
STEP_SLACK = 2


@pytest.fixture(scope="module")
def port_solution():
    problem = problem_from_jax(jrob.problem_ode(), trob.rhs_ode, trob.init)
    return dtt.solve_dense(dtt.BdfSolver(problem), T_EVAL, max_steps=20_000, device="cpu")


def test_bdf_robertson_matches_jax(port_solution):
    sol_j = dt.solve_dense(dt.BdfSolver(jrob.problem_ode()), jnp.asarray(T_EVAL),
                           max_steps=20_000)
    got = solution_to_numpy(port_solution)
    assert got["stop_reason"] == int(sol_j.stop_reason) == dtt.errors.TSTOP_REACHED
    assert got["ys"].shape == (len(T_EVAL), 3)
    np.testing.assert_allclose(got["ys"], np.asarray(sol_j.ys), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)
    steps_j = int(sol_j.state.stats.steps)
    assert abs(port_solution.state.stats.steps - steps_j) <= STEP_SLACK
    # the same Jacobian-update policy: LU setups agree as closely
    assert abs(port_solution.state.stats.linear_solver_setups
               - int(sol_j.state.stats.linear_solver_setups)) <= STEP_SLACK


def test_bdf_robertson_matches_cvode_table(port_solution):
    """tests/test_dae.py:71-72's tolerances against robertson.SOLN."""
    ys = port_solution.ys.numpy()
    expected = trob.SOLN[1:9, 1:]
    np.testing.assert_allclose(ys[:, 0], expected[:, 0], rtol=5e-3, atol=1e-10)
    np.testing.assert_allclose(ys[:, 2], expected[:, 2], rtol=5e-3, atol=1e-8)


def test_bdf_diagonal_mass_and_failures():
    """A constant diagonal mass takes the elementwise path (M y' = f with
    M = diag(2, 2) halves the decay rate), a singular one starts from
    consistent initial conditions (y1 = y0 here), a dense one takes the
    matrix path, each also in float32 (``OdeBuilder.dtype``), and what the
    port still lacks raises with its ROADMAP item."""
    f64 = torch.float64
    problem = (
        dtt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * y)
        .init(lambda t, p: torch.ones(2, dtype=f64))
        .mass(lambda t, p: torch.diag(torch.tensor([2.0, 2.0], dtype=f64)))
        .p([1.0])
        .rtol(1e-8)
        .atol(1e-10)
        .build()
    )
    assert problem.eqn.mass_diag_fn is not None
    sol = dtt.solve_dense(dtt.BdfSolver(problem), [0.5, 1.0], device="cpu")
    assert sol.stop_reason == dtt.errors.TSTOP_REACHED
    np.testing.assert_allclose(sol.ys[:, 0].numpy(), np.exp(-0.5 * np.array([0.5, 1.0])),
                               rtol=1e-6)
    # a singular diagonal mass starts from consistent initial conditions
    singular = (
        dtt.OdeBuilder()
        .rhs(lambda t, y, p: torch.stack([-y[0], y[0] - y[1]]))
        .init(lambda t, p: torch.ones(2, dtype=f64))
        .mass(lambda t, p: torch.diag(torch.tensor([1.0, 0.0], dtype=f64)))
        .rtol(1e-8)
        .atol(1e-10)
        .build()
    )
    sol = dtt.solve_dense(dtt.BdfSolver(singular), [0.5, 1.0], device="cpu")
    assert sol.stop_reason == dtt.errors.TSTOP_REACHED
    np.testing.assert_allclose(sol.ys.numpy(), np.exp(-np.array([0.5, 1.0]))[:, None]
                               * np.ones(2), rtol=1e-6)
    # a dense (non-diagonal) mass takes the matrix path: M y' = -y with
    # M = [[1, .5], [0, 1]] has y2 = e^{-t}, y1 = e^{-t} (1 + t/2)
    dense_mass = (
        dtt.OdeBuilder()
        .rhs(lambda t, y, p: -y)
        .init(lambda t, p: torch.ones(2, dtype=f64))
        .mass(lambda t, p: torch.tensor([[1.0, 0.5], [0.0, 1.0]], dtype=f64))
        .rtol(1e-8)
        .atol(1e-10)
        .build()
    )
    assert dense_mass.eqn.mass_diag_fn is None
    sol = dtt.solve_dense(dtt.BdfSolver(dense_mass), [0.5, 1.0], device="cpu")
    t = np.array([0.5, 1.0])
    np.testing.assert_allclose(sol.ys.numpy(), np.exp(-t)[:, None]
                               * np.stack([1.0 + 0.5 * t, np.ones(2)], axis=1), rtol=1e-6)
    # float32 (ROADMAP item 18b): the same three masses build and solve in
    # float32, the diagonal one on the elementwise path, within float32's
    # tolerance of the float64 solutions
    for prob in (problem, singular, dense_mass):
        b32 = (dtt.OdeBuilder().rhs(prob.eqn.rhs).init(prob.eqn.init)
               .mass(prob.eqn.mass).p(prob.params.tolist()).rtol(1e-5).atol(1e-7)
               .dtype(torch.float32))
        p32 = b32.build()
        assert p32.dtype == p32.params.dtype == p32.atol.dtype == torch.float32
        assert (p32.eqn.mass_diag_fn is None) == (prob.eqn.mass_diag_fn is None)
        s32 = dtt.solve_dense(dtt.BdfSolver(p32), [0.5, 1.0], device="cpu")
        s64 = dtt.solve_dense(dtt.BdfSolver(prob), [0.5, 1.0], device="cpu")
        assert s32.ys.dtype == torch.float32
        assert s32.stop_reason == dtt.errors.TSTOP_REACHED
        np.testing.assert_allclose(s32.ys.numpy(), s64.ys.numpy(), rtol=2e-4)
    with pytest.raises(TypeError, match="float64 or torch.float32"):
        dtt.OdeBuilder().dtype(torch.float16)
    # what is still outside the port names its ROADMAP item
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        dtt.OdeBuilder().linear_solver("krylov")


def test_solve_dense_runs_on_the_card_unless_asked_for_the_cpu():
    """Without ``device`` a single-instance solve runs on the card, the
    banded tier's included; where there is none it raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for problem in (trob.problem_ode(), theat.make(mgrid=7, banded=True)[0]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dtt.solve_dense(dtt.BdfSolver(problem), [0.01])
        sol = dtt.solve_dense(dtt.BdfSolver(problem), [0.01], device="cpu")
        assert sol.stop_reason == dtt.errors.TSTOP_REACHED
        assert sol.ys.device.type == "cpu" and sol.ys.dtype == torch.float64
