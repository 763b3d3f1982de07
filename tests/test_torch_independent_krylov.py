"""``mode="independent"`` on the matrix-free Krylov tier: one batched loop
(solvers/independent.py) in which every member keeps its own frozen point,
preconditioner and GMRES (ops/krylov.py's ``gmres_batched``, the restart
test, breakdown and counts each a member's).

Each member is held to the port's own single Krylov solve of it (the twins
tests/test_torch_krylov*.py hold to JAX): its whole ``Stats``, its GMRES
restarts and Arnoldi iterations (``IndependentState.gmres_restarts`` /
``gmres_arnoldi`` against ``ops.krylov.gmres_counts`` of the single solve)
and ys within 1e-12 + 1e-10 |ref|.  One case goes to JAX's ``vmap``
independent mode on the Krylov tier (a module fixture), at the Krylov
twins' bound: equal accepted steps, ys within 1e-8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.drivers import solve_dense
from diffsol_tpu_torch.models import fused_cases as fc
from diffsol_tpu_torch.models import heat2d
from diffsol_tpu_torch.ops import krylov as tk
from diffsol_tpu_torch.solvers.bdf_independent import IndependentState
from diffsol_tpu_torch.solvers.rk_independent import RkIndependentState

torch.set_num_threads(1)
F64 = torch.float64
RTOL, ATOL = 1e-10, 1e-12
TWIN_RTOL = 1e-8  # tests/test_torch_krylov.py's bound against JAX
DECAY_PB = [[0.5], [1.0], [2.0]]


def _decay_root(precond="lu32"):
    p = (dtt.OdeBuilder().rhs(fc.decay_rhs).init(fc.decay_init).root(fc.decay_root)
         .p([1.0]).rtol(1e-6).atol(1e-8).linear_solver("krylov").build())
    if precond != "lu32":
        p = dataclasses.replace(p, linear_solver=tk.make_krylov_solver(p.eqn.rhs,
                                                                       precond=precond))
    return p


def _coupling(n, seed=2):
    C = torch.tensor(np.random.default_rng(seed).uniform(-0.01, 0.01, (n, n)))
    return (dtt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y + C @ y)
            .init(lambda t, p: torch.ones(n, dtype=F64, device=p.device))
            .p([1.0]).rtol(1e-6).atol(1e-8).linear_solver("krylov").build())


def _members_match(make, problem, t_eval, pb):
    """The batched solve, then each member against its single solve: whole
    Stats, GMRES restarts and Arnoldi iterations, stop, ys (and the rows)
    within 1e-12 + 1e-10 |ref|."""
    sol = dtt.solve_dense_ensemble(make, problem, t_eval, pb, mode="independent",
                                   device="cpu")
    st = sol.state
    assert sol.tier == "independent"
    assert isinstance(st, (IndependentState, RkIndependentState))
    assert tuple(st.gmres_restarts.shape) == tuple(st.gmres_arnoldi.shape) == (len(pb),)
    for b in range(len(pb)):
        tk.reset_gmres_counts()
        one = solve_dense(make(problem), t_eval, params=torch.tensor(pb[b], dtype=F64),
                          device="cpu")
        counts = tk.gmres_counts()
        assert dataclasses.asdict(st.member_stats(b)) == dataclasses.asdict(one.state.stats), b
        assert int(st.gmres_restarts[b]) == counts["restarts"], b
        assert int(st.gmres_arnoldi[b]) == counts["arnoldi"], b
        assert int(sol.stop_reason[b]) == one.stop_reason
        pairs = [(sol.ys[:, b], one.ys)]
        if one.sens is not None:
            pairs.append((sol.sens[:, :, b], one.sens))
        for got, ref in pairs:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)
    return sol


@pytest.mark.parametrize("precond", ["lu32", "tridiag", "none"])
def test_bdf_decay_with_root_each_preconditioner(precond):
    """tests/test_torch_independent.py's stop-at-root decay on the Krylov
    tier, each preconditioner: every member stops at its own root."""
    problem = _decay_root(precond)
    sol = _members_match(dtt.BdfSolver, problem, fc.ROOT_STOP_T_EVAL, DECAY_PB)
    assert sol.stop_reason.tolist() == [errors.ROOT_FOUND] * 3
    np.testing.assert_allclose(sol.root_t.numpy(), np.log(2.0) / np.ravel(DECAY_PB),
                               rtol=1e-5)


def test_tr_bdf2_decay_with_root():
    """SDIRK joins: TR-BDF2's stage Newton and its filtered error estimate
    each run their GMRES for their members alone."""
    sol = _members_match(lambda pr: dtt.solver(pr, "tr_bdf2"), _decay_root(),
                         fc.ROOT_STOP_T_EVAL, DECAY_PB)
    assert isinstance(sol.state, RkIndependentState)


def test_coupling_with_p_spread():
    """rhs = -p y + C y at n = 40, C dense uniform(-0.01, 0.01): restart
    30 < n, so every member's GMRES restarts on its own."""
    pb = [[0.5], [1.25], [2.0]]
    sol = _members_match(dtt.BdfSolver, _coupling(40), [0.5, 1.0], pb)
    assert len(set(sol.state.gmres_restarts.tolist())) > 1
    assert bool((sol.state.gmres_arnoldi > 0).all())


def test_sens_rows_each_their_gmres():
    """BdfSolver(sens=True): the rows' Newton solves each row's GMRES per
    member (ops/krylov.py's _rows)."""
    _members_match(lambda pr: dtt.BdfSolver(pr, sens=True), _coupling(12), [0.5, 1.0],
                   [[0.5], [2.0]])


def test_heat2d_dae_batched_consistent_ics():
    """The heat2d DAE (mgrid 5): the consistent initial conditions by the
    matrix-free residual solver per member (GMRES counted), then the
    DiagMass operator; n = 25 < restart, so each member's Krylov space
    runs out and breaks down on its own."""
    fns = heat2d.callables(5)
    kry = (dtt.OdeBuilder().rhs(fns["rhs"]).init(fns["init"]).mass(fns["mass"]).p([1.0])
           .rtol(1e-5).atol(1e-5).linear_solver("krylov").build())
    sol = _members_match(dtt.BdfSolver, kry, [0.01, 0.1], [[0.5], [2.0]])
    assert sol.stop_reason.tolist() == [errors.TSTOP_REACHED] * 2


@pytest.fixture(scope="module")
def jax_decay():
    """JAX's vmap independent mode on the Krylov tier: the decay with a
    root, three rates."""
    jp = (dt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y).init(lambda t, p: jnp.ones((1,)))
          .root(lambda t, y, p: y[0:1] - 0.5).p([1.0]).rtol(1e-6).atol(1e-8)
          .linear_solver("krylov").build())
    sol = dt.solve_dense_ensemble(dt.BdfSolver, jp, jnp.asarray(fc.ROOT_STOP_T_EVAL),
                                  jnp.asarray(DECAY_PB), mode="independent")
    return dict(ys=np.asarray(sol.ys), steps=np.asarray(sol.state.stats.steps),
                root_t=np.asarray(sol.root_t))


def test_matches_jax_vmap(jax_decay):
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, _decay_root(), fc.ROOT_STOP_T_EVAL,
                                   DECAY_PB, mode="independent", device="cpu")
    assert sol.state.stats.steps.tolist() == jax_decay["steps"].tolist()
    np.testing.assert_allclose(sol.ys.numpy(), jax_decay["ys"], rtol=TWIN_RTOL, atol=1e-14)
    np.testing.assert_allclose(sol.root_t.numpy(), jax_decay["root_t"], rtol=TWIN_RTOL)
