"""Twins of tests/test_blockdiag.py: the port's block-diagonal tier
(``ops/blockdiag.py``) against the JAX package's on the same problems.

The JAX tier lays its blocks out batch-last, (nb, nb, K), and the port
stacks them, (K, nb, nb); both pivot.  Held here:

* the routing and the block layout (perm, nb, K) equal JAX's, the blocks
  equal JAX's and ``jacfwd``'s to 1e-12;
* solves within rtol 1e-6, atol 1e-14 of the JAX solve of the same
  problem (1e-10 absolute for the padded components, as the JAX test);
* lockstep members within rtol 2e-3 of their single solves (the JAX
  test's bound) and within rtol 1e-6 of the JAX lockstep ensemble;
* a JAX problem on the block tier arrives in the port on it, and a
  block-diagonal DAE starts from the consistent initial conditions JAX
  finds (its dense branch).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import diffsol_tpu as dt
from diffsol_tpu.models import robertson as jrob
from diffsol_tpu.ops import blockdiag as jbd
from diffsol_tpu.ops.coloring import detect_sparsity as jdetect

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import robertson as trob
from diffsol_tpu_torch.ops import blockdiag as tbd
from diffsol_tpu_torch.ops.coloring import detect_sparsity as tdetect

torch.set_num_threads(1)
F64 = torch.float64
TRAJ_RTOL, TRAJ_ATOL = 1e-6, 1e-14


def _init_groups(ngroups):
    return lambda t, p: torch.tensor([1.0, 0.0, 0.0], dtype=F64).repeat(ngroups)


def test_builder_routes_block_diagonal_pattern():
    tp, jp = trob.problem_ode_groups(50), jrob.problem_ode_groups(50)
    assert tp.linear_solver.name == jp.linear_solver.name == "blockdiag(3,50)"
    np.testing.assert_array_equal(tp.linear_solver.meta[2], np.asarray(jp.linear_solver.meta[2]))
    y0 = tp.eqn.init(tp.t0, tp.params)
    jac = tp.eqn.jac(tp.t0, y0, tp.params)
    assert jac.shape == (50, 3, 3)  # the block stack, not a dense (150, 150)
    assert tp.eqn.rhs_jac.jvp_probes == jp.eqn.rhs_jac.jvp_probes == 3


def test_blockdiag_jac_matches_jacfwd():
    tp, jp = trob.problem_ode_groups(7), jrob.problem_ode_groups(7)
    y = np.random.default_rng(1).uniform(0.1, 1.0, size=(21,))
    t0 = torch.tensor(0.0, dtype=F64)
    blocks = tp.eqn.jac(t0, torch.tensor(y), tp.params).numpy()  # (7, 3, 3)
    dense = torch.func.jacfwd(tp.eqn.rhs, argnums=1)(t0, torch.tensor(y), tp.params).numpy()
    jblocks = np.asarray(jp.eqn.jac(0.0, jnp.asarray(y), jp.params))  # (3, 3, 7)
    for k in range(7):
        np.testing.assert_allclose(blocks[k], dense[3 * k:3 * k + 3, 3 * k:3 * k + 3],
                                   rtol=1e-12)
        np.testing.assert_allclose(blocks[k], jblocks[:, :, k], rtol=1e-12)
        dense[3 * k:3 * k + 3, 3 * k:3 * k + 3] = 0.0
    assert np.all(dense == 0.0)  # the compression is lossless


def test_blockdiag_solve_matches_reference_table():
    """ngroups=50 through the block tier: the CVODE values in every group,
    every group alike, and the JAX solve."""
    tp = trob.problem_ode_groups(50)
    t_eval = np.array([0.4, 4.0, 40.0])
    sol = dtt.solve_dense(dtt.BdfSolver(tp), t_eval, max_steps=2000, device="cpu")
    assert sol.stop_reason == errors.TSTOP_REACHED
    ys = sol.ys.numpy().reshape(3, 50, 3)
    for row in range(3):
        np.testing.assert_allclose(ys[row, :, 0], trob.SOLN[row + 1, 1], rtol=5e-3)
        assert np.ptp(ys[row, :, 0]) < 1e-10
    ref = dt.solve_dense(dt.BdfSolver(jrob.problem_ode_groups(50)), jnp.asarray(t_eval),
                         max_steps=2000)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)
    assert abs(sol.state.stats.steps - int(ref.state.stats.steps)) <= 2
    assert sol.state.stats.jac_mul_evals == int(ref.state.stats.jac_mul_evals)


def _uneven_rhs(lib):
    def rhs(t, y, p):
        a = lib.stack([-y[0] + 0.5 * y[1], -0.8 * y[1] + 0.1 * y[0]])
        b = lib.stack([-2.0 * y[2] + y[3], -1.5 * y[3] + 0.2 * y[4], -0.7 * y[4] + 0.3 * y[2]])
        cat = lib.concatenate if lib is jnp else torch.cat
        return cat([a, b]) * p[0]
    return rhs


def test_blockdiag_uneven_components_padded():
    """Components of 2 and 3 states pad to one block size: the layout is
    JAX's, and the block solve matches the dense one (the JAX test's
    bound) and JAX's block solve."""
    y0 = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    tp = (dtt.OdeBuilder().rhs(_uneven_rhs(torch)).init(lambda t, p: torch.tensor(y0))
          .p([1.0]).rtol(1e-8).atol(1e-10).build())
    jp = (dt.OdeBuilder().rhs(_uneven_rhs(jnp)).init(lambda t, p: jnp.asarray(y0))
          .p([1.0]).rtol(1e-8).atol(1e-10).build())
    rows, cols = tdetect(tp.eqn.rhs, tp.t0, torch.tensor(y0), tp.params, 5)
    perm, nb, K = tbd.detect_blocks(rows, cols, 5)
    jperm, jnb, jK = jbd.detect_blocks(*jdetect(jp.eqn.rhs, jp.t0, jnp.asarray(y0),
                                                jp.params, 5), 5)
    assert (nb, K) == (jnb, jK) == (3, 2)
    np.testing.assert_array_equal(perm, np.asarray(jperm))
    # 5 states < 8: the builder keeps dense, so the tier is given directly
    tblk = (dtt.OdeBuilder().rhs(_uneven_rhs(torch)).init(lambda t, p: torch.tensor(y0))
            .p([1.0]).rtol(1e-8).atol(1e-10)
            .linear_solver(tbd.make_blockdiag_solver(perm, nb, K)).build())
    jblk = dataclasses.replace(
        jp, eqn=dataclasses.replace(jp.eqn, rhs_jac=jbd.make_blockdiag_jac(
            jp.eqn.rhs, jperm, nb, K, 5)),
        linear_solver=jbd.make_blockdiag_solver(jperm, nb, K, 5))
    t_eval = np.array([0.5, 1.0, 2.0])
    sol_b = dtt.solve_dense(dtt.BdfSolver(tblk), t_eval, max_steps=2000, device="cpu")
    sol_d = dtt.solve_dense(dtt.BdfSolver(tp), t_eval, max_steps=2000, device="cpu")
    assert sol_b.stop_reason == errors.TSTOP_REACHED
    np.testing.assert_allclose(sol_b.ys.numpy(), sol_d.ys.numpy(), rtol=1e-6, atol=1e-10)
    ref = dt.solve_dense(dt.BdfSolver(jblk), jnp.asarray(t_eval), max_steps=2000)
    np.testing.assert_allclose(sol_b.ys.numpy(), np.asarray(ref.ys), rtol=TRAJ_RTOL,
                               atol=1e-10)


def test_blockdiag_lockstep_ensemble():
    """The block axis K and the member axis B fuse into one (B K, nb, nb)
    LU stack: members match their single solves (the JAX test's bound) and
    the JAX lockstep ensemble."""
    tp = trob.problem_ode_groups(5)
    assert tp.linear_solver.name == "blockdiag(3,5)"
    B = 4
    base = tp.params.numpy()
    pb = base[None, :] * (1.0 + 0.05 * np.linspace(-1.0, 1.0, B)[:, None])
    t_eval = np.array([1.0, 100.0, 1e4])
    assert dtt.make_lockstep_problem(tp, B).linear_solver.name == "blockdiag_lockstep(3,5,4)"
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, t_eval, pb, mode="lockstep",
                                   max_steps=20_000, device="cpu")
    assert sol.ys.shape == (3, B, 15)
    solver = dtt.BdfSolver(tp)
    for b in range(B):
        one = dtt.solve_dense(solver, t_eval, params=pb[b], max_steps=20_000, device="cpu")
        np.testing.assert_allclose(sol.ys[:, b].numpy(), one.ys.numpy(), rtol=2e-3,
                                   atol=1e-10)
    ref = dt.solve_dense_ensemble(dt.BdfSolver, jrob.problem_ode_groups(5),
                                  jnp.asarray(t_eval), jnp.asarray(pb), mode="lockstep",
                                  max_steps=20_000)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)


def _dae_groups(lib, ngroups):
    """Robertson DAE groups (mass diag(1, 1, 0) a group) whose algebraic
    z starts off the constraint x + y + z = 1."""
    def rhs(t, y, p):
        u = y.reshape(ngroups, 3)
        r0 = -p[0] * u[:, 0] + p[1] * u[:, 1] * u[:, 2]
        r1 = p[0] * u[:, 0] - p[1] * u[:, 1] * u[:, 2] - p[2] * u[:, 1] * u[:, 1]
        r2 = u[:, 0] + u[:, 1] + u[:, 2] - 1.0
        stack = jnp.stack if lib is jnp else torch.stack
        return stack([r0, r1, r2], 1).reshape(-1)

    diag = np.tile([1.0, 1.0, 0.0], ngroups)
    y0 = np.tile([1.0, 0.0, 0.1], ngroups)
    if lib is jnp:
        return rhs, lambda t, p: jnp.diag(jnp.asarray(diag)), lambda t, p: jnp.asarray(y0)
    return (rhs, lambda t, p: torch.diag(torch.tensor(diag)),
            lambda t, p: torch.tensor(y0))


def test_problem_from_jax_carries_the_block_tier():
    """``problem_from_jax`` brings a JAX problem on the block tier across
    on the same layout, and a block-diagonal DAE (4 groups, n = 12) takes
    the consistent-IC branch JAX takes for it."""
    jp = jrob.problem_ode_groups(5)
    tp = problem_from_jax(jp, trob._groups_rhs(5), _init_groups(5))
    assert tp.linear_solver.name == "blockdiag(3,5)"
    np.testing.assert_array_equal(tp.linear_solver.meta[2], np.asarray(jp.linear_solver.meta[2]))
    t_eval = np.array([0.4, 4.0, 40.0])
    sol = dtt.solve_dense(dtt.BdfSolver(tp), t_eval, max_steps=2000, device="cpu")
    ref = dt.solve_dense(dt.BdfSolver(jp), jnp.asarray(t_eval), max_steps=2000)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)

    jrhs, jmass, jinit = _dae_groups(jnp, 4)
    trhs, tmass, tinit = _dae_groups(torch, 4)
    jd = (dt.OdeBuilder().rhs(jrhs).init(jinit).mass(jmass).p(list(trob.P_DEFAULT))
          .rtol(1e-4).atol(np.tile([1e-8, 1e-6, 1e-6], 4)).use_coloring().build())
    td = problem_from_jax(jd, trhs, tinit, mass=tmass)
    assert td.linear_solver.name == jd.linear_solver.name == "blockdiag(3,4)"
    st, sj = dtt.BdfSolver(td).init_state(), dt.BdfSolver(jd).init_state()
    assert st.status == int(sj.status) == errors.INTERNAL_TIMESTEP
    np.testing.assert_allclose(st.y.numpy(), np.asarray(sj.y), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(st.y.numpy().reshape(4, 3).sum(axis=1), 1.0, rtol=1e-12)
    sol = dtt.solve_dense(dtt.BdfSolver(td), t_eval, max_steps=2000, device="cpu")
    ref = dt.solve_dense(dt.BdfSolver(jd), jnp.asarray(t_eval), max_steps=2000)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)
    np.testing.assert_allclose(sol.ys.numpy()[:, 0::3], trob.SOLN[1:4, 1:2].repeat(4, 1),
                               rtol=5e-3)
