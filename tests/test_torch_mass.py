"""A mass given as a matrix, and a Jacobian given by the user
(``rhs_implicit``), against the JAX package's BdfSolver and SdirkSolver.

The problems: the 2-D heat DAE of ``models/heat2d_mass.py`` (the
closure-built twin of tests/test_diffsl.py's DiffSL model, D and M as
matrices, the Jacobian D through ``rhs_implicit``), with that model's
structurally diagonal singular mass and with the non-diagonal consistent
mass; and a non-singular non-diagonal mass, alone and in a lockstep
ensemble.  Tolerances as tests/test_torch_bdf.py: ys within rtol 1e-6,
atol 1e-14 of JAX, accepted steps within 2, the same stop reason; the
Jacobian evaluations and their probe count (n for a user Jacobian) equal
JAX's, and ``problem_from_jax`` carries a user Jacobian across.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import heat2d_mass

torch.set_num_threads(1)
F64 = torch.float64
TRAJ_RTOL, TRAJ_ATOL = 1e-6, 1e-14
STEP_SLACK = 2
M2 = np.array([[1.0, 0.5], [0.0, 1.0]])


def _jax_heat(consistent):
    D, M, y0 = heat2d_mass.matrices(4, consistent)
    Dj, Mj = jnp.asarray(D), jnp.asarray(M)
    return (dt.OdeBuilder().rhs_implicit(lambda t, y, p: Dj @ y, lambda t, y, p: Dj)
            .init(lambda t, p: jnp.asarray(y0)).mass(lambda t, p: Mj).p([1.0])
            .rtol(1e-7).atol(1e-7).build())


def _match(got, ref):
    assert got.stop_reason == int(ref.stop_reason) == errors.TSTOP_REACHED
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)
    sj, st = ref.state.stats, got.state.stats
    assert abs(st.steps - int(sj.steps)) <= STEP_SLACK
    assert st.jacobian_evals == int(sj.jacobian_evals)
    assert st.jac_mul_evals == int(sj.jac_mul_evals)


@pytest.mark.parametrize("method", ["bdf", "tr_bdf2"])
@pytest.mark.parametrize("consistent", [False, True], ids=["diagonal", "dense"])
def test_heat2d_mass_with_user_jacobian_matches_jax(consistent, method):
    tp, jp = heat2d_mass.problem(4, consistent), _jax_heat(consistent)
    # the lumped mass is structurally diagonal, the consistent one is not
    assert (tp.eqn.mass_diag_fn is None) == (jp.eqn.mass_diag_fn is None) == consistent
    t_eval = np.array([0.01, 0.05])
    got = dtt.solve_dense(dtt.solver(tp, method), t_eval, max_steps=2000, device="cpu")
    ref = dt.solve_dense(dt.solver(jp, method), jnp.asarray(t_eval), max_steps=2000)
    _match(got, ref)
    assert got.state.stats.jac_mul_evals == 16 * got.state.stats.jacobian_evals
    # problem_from_jax carries the user Jacobian across, like the callables
    carried = problem_from_jax(jp, tp.eqn.rhs, tp.eqn.init, mass=tp.eqn.mass,
                               rhs_jac=tp.eqn.rhs_jac)
    assert carried.eqn.rhs_jac is tp.eqn.rhs_jac
    again = dtt.solve_dense(dtt.solver(carried, method), t_eval, max_steps=2000, device="cpu")
    torch.testing.assert_close(again.ys, got.ys, rtol=0.0, atol=0.0)
    # the algebraic edge stays at zero
    edge = np.abs(heat2d_mass.matrices(4, consistent)[1]).sum(axis=1) == 0.0
    assert float(got.ys[:, torch.as_tensor(edge)].abs().max()) < 1e-9


def _mass2(lib):
    return lambda t, p: lib.asarray(M2) if lib is jnp else torch.tensor(M2)


@pytest.mark.parametrize("method", ["bdf", "tr_bdf2"])
def test_dense_mass_ode_and_lockstep_match_jax(method):
    """M = [[1, .5], [0, 1]], M y' = -a y: one solve, and a lockstep
    ensemble over a, whose dense mass stacks to (B, n, n), against JAX's
    and the exact solution; ``mode="auto"`` goes lockstep, since the
    kernels take a diagonal mass only."""
    def tb(p):
        return (dtt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y)
                .init(lambda t, p: torch.ones(2, dtype=F64, device=p.device))
                .mass(_mass2(torch)).p(p).rtol(1e-8).atol(1e-10).build())

    jp = (dt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y).init(lambda t, p: jnp.ones(2))
          .mass(_mass2(jnp)).p([1.0]).rtol(1e-8).atol(1e-10).build())
    tp = tb([1.0])
    assert tp.eqn.mass_diag_fn is None
    t_eval = np.array([0.5, 1.0])
    got = dtt.solve_dense(dtt.solver(tp, method), t_eval, device="cpu")
    _match(got, dt.solve_dense(dt.solver(jp, method), jnp.asarray(t_eval)))
    params = np.array([[0.5], [1.0], [2.0]])
    sol = dtt.solve_dense_ensemble(lambda pr: dtt.solver(pr, method), tp, t_eval, params,
                                   mode="auto", device="cpu")
    assert sol.tier == "lockstep" and sol.ys.shape == (2, 3, 2)
    if method == "bdf":
        ref = dt.solve_dense_ensemble(dt.BdfSolver, jp, jnp.asarray(t_eval),
                                      jnp.asarray(params), mode="lockstep")
        np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), rtol=TRAJ_RTOL,
                                   atol=TRAJ_ATOL)
    # every member against y2 = e^{-at}, y1 = e^{-at} (1 + a t / 2) within
    # 200 rtol (the parity sweep's CHECK)
    for b, (a,) in enumerate(params):
        exact = np.exp(-a * t_eval)[:, None] * np.stack([1.0 + 0.5 * a * t_eval,
                                                         np.ones(2)], axis=1)
        np.testing.assert_allclose(sol.ys[:, b].numpy(), exact, rtol=200 * 1e-8)
