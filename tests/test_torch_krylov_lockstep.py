"""The port's matrix-free Krylov tier in lockstep against the JAX
package: twins of the lockstep tests of tests/test_krylov.py.  The
lockstep lift runs ONE GMRES over the joint B*n system with joint norms
and a (B, n, n) float32 LU stack as the preconditioner, on the port's
member-major (B, n) state where JAX keeps (n, B).  Each solve is held at
the JAX test's tolerance against the dense or banded solve, and against
JAX's krylov solve: equal accepted steps and Newton iterations, ys within
1e-8 relative.
"""

import jax.numpy as jnp
import numpy as np
import torch

import diffsol_tpu as dt
from diffsol_tpu.ensemble import make_lockstep_problem as jax_lockstep
from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.models import heat2d as jheat2d

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.ensemble import make_lockstep_problem
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import heat1d as theat
from diffsol_tpu_torch.ops import krylov as tk

torch.set_num_threads(1)
F64 = torch.float64
TWIN_RTOL = 1e-8


def _twin_stats(sol_t, sol_j):
    assert sol_t.state.stats.steps == int(sol_j.state.stats.steps)
    assert sol_t.state.stats.newton_iterations == int(sol_j.state.stats.newton_iterations)


def _heat1d_krylov(mgrid, rtol, atol):
    ref, _ = jheat.make(mgrid=mgrid)
    jkry = (dt.OdeBuilder().rhs(ref.eqn.rhs).init(ref.eqn.init)
            .p(np.asarray(ref.params)).rtol(rtol).atol(atol).linear_solver("krylov").build())
    tp, _ = theat.make(mgrid, rtol=rtol, atol=atol)
    kry = (dtt.OdeBuilder().rhs(tp.eqn.rhs).init(tp.eqn.init).p([1.0])
           .rtol(rtol).atol(atol).linear_solver("krylov").build())
    return jkry, kry, tp


def test_krylov_lockstep_ensemble_matches_independent():
    """heat1d (n = 32) with four spread diffusivities through
    ``krylov_lockstep(lu32)``: one joint GMRES a Newton solve; members meet
    their single-instance dense solves (rtol 1e-4, atol 1e-7; the JAX test
    holds them to its single krylov solves at that bound) and the batch
    meets JAX's lockstep krylov solve."""
    jkry, kry, dense = _heat1d_krylov(31, 1e-6, 1e-8)
    nb = 4
    lp = make_lockstep_problem(kry, nb)
    assert lp.linear_solver.name == "krylov_lockstep(lu32)"
    assert lp.linear_solver.meta == (1e-6, 30, 10, "lu32", nb)
    assert lp.eqn.rhs_jac.jvp_probes == 0
    d = np.linspace(0.8, 1.2, nb)
    te = [0.05, 0.1]
    tk.reset_gmres_counts()
    sol = dtt.solve_dense(dtt.BdfSolver(lp), te, params=torch.tensor(d)[:, None],
                          max_steps=2000, device="cpu")
    counts = tk.gmres_counts()
    assert sol.stop_reason >= 0
    # one GMRES over the joint system for each Newton iteration, one host
    # read before the restarts and one after each
    assert counts["calls"] == sol.state.stats.newton_iterations
    assert counts["host_reads"] == counts["calls"] + counts["restarts"]
    for i, di in enumerate(d):
        one = dtt.solve_dense(dtt.BdfSolver(dense), te, params=[di], max_steps=2000,
                              device="cpu")
        np.testing.assert_allclose(sol.ys[:, i].numpy(), one.ys.numpy(), rtol=1e-4, atol=1e-7)
    jsol = dt.solve_dense(dt.BdfSolver(jax_lockstep(jkry, nb)), jnp.asarray(te),
                          params=jnp.asarray(d)[:, None], max_steps=2000)
    _twin_stats(sol, jsol)
    np.testing.assert_allclose(sol.ys.numpy(), np.swapaxes(np.asarray(jsol.ys), 1, 2),
                               rtol=TWIN_RTOL, atol=1e-14)


def test_krylov_lockstep_dae_consistent_ic():
    """The heat2d DAE (n = 64, diagonal singular mass), three members,
    lockstep krylov: the batched matrix-free consistent ICs (per-member
    probes, one joint GMRES) and the joint GMRES steps; the trajectory
    meets the banded lockstep solve (rtol 1e-3, atol 1e-6) and JAX's
    lockstep krylov solve."""
    ref = jheat2d.make(mgrid=8)
    jkry = (dt.OdeBuilder().rhs(ref.eqn.rhs).init(ref.eqn.init).mass(ref.eqn.mass)
            .p(np.asarray(ref.params)).rtol(1e-5).atol(1e-5).linear_solver("krylov").build())
    kry = problem_from_jax(jkry, model="heat2d")
    band = problem_from_jax(ref, model="heat2d")
    nb = 3
    params = kry.params.expand(nb, -1).clone()
    te = [0.01, 0.1]
    sol = dtt.solve_dense(dtt.BdfSolver(make_lockstep_problem(kry, nb)), te, params=params,
                          max_steps=2000, device="cpu")
    assert sol.stop_reason >= 0
    solb = dtt.solve_dense(dtt.BdfSolver(make_lockstep_problem(band, nb)), te,
                           params=params, max_steps=2000, device="cpu")
    np.testing.assert_allclose(sol.ys.numpy(), solb.ys.numpy(), rtol=1e-3, atol=1e-6)
    jsol = dt.solve_dense(
        dt.BdfSolver(jax_lockstep(jkry, nb)), jnp.asarray(te),
        params=jnp.broadcast_to(jkry.params, (nb,) + jkry.params.shape), max_steps=2000)
    _twin_stats(sol, jsol)
    np.testing.assert_allclose(sol.ys.numpy(), np.swapaxes(np.asarray(jsol.ys), 1, 2),
                               rtol=TWIN_RTOL, atol=1e-14)
