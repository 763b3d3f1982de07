"""Twins of tests/test_models.py:13-52: the fixtures of
``diffsol_tpu_torch.models.misc`` (gaussian decay, dy/dt = y^2, Lorenz,
robertson_ode groups) held to their analytic or reference values at the
JAX test's tolerances, and to the JAX package's solve of the same problem
within rtol 1e-6, atol 1e-14 (Lorenz, chaotic, at the JAX test's own
BDF-against-ERK bound)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.models import misc as jmisc

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.models import misc as tmisc
from diffsol_tpu_torch.models import robertson as trob

torch.set_num_threads(1)

TRAJ_RTOL, TRAJ_ATOL = 1e-6, 1e-14


def _pair(jp, tp, t_eval, max_steps=100_000, solver="BdfSolver"):
    ref = dt.solve_dense(getattr(dt, solver)(jp), jnp.asarray(t_eval), max_steps=max_steps)
    got = dtt.solve_dense(getattr(dtt, solver)(tp), t_eval, max_steps=max_steps,
                          device="cpu")
    assert got.stop_reason == int(ref.stop_reason)
    assert abs(got.state.stats.steps - int(ref.state.stats.steps)) <= 2
    return got, np.asarray(ref.ys)


def test_gaussian_decay():
    tp = tmisc.gaussian_decay_problem(size=10)
    t_eval = np.linspace(0.0, 9.0, 10)
    got, ref = _pair(jmisc.gaussian_decay_problem(size=10), tp, t_eval)
    np.testing.assert_allclose(got.ys.numpy(), ref, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
    np.testing.assert_allclose(got.ys.numpy(),
                               tmisc.gaussian_decay_soln(t_eval, tp.params.numpy()),
                               rtol=1e-4, atol=1e-6)


def test_dydt_y2():
    t_eval = np.linspace(0.0, 20.0, 11)
    got, ref = _pair(jmisc.dydt_y2_problem(size=10), tmisc.dydt_y2_problem(size=10), t_eval)
    assert got.stop_reason == errors.TSTOP_REACHED
    np.testing.assert_allclose(got.ys.numpy(), ref, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
    np.testing.assert_allclose(got.ys.numpy(), tmisc.dydt_y2_soln(t_eval), rtol=1e-3,
                               atol=1e-6)


def test_lorenz_bdf_vs_erk():
    """A chaotic system: BDF and ERK agree over a short horizon at a tight
    tolerance (the JAX test's bound), and each follows its JAX
    counterpart."""
    t_eval = np.linspace(0.0, 5.0, 11)
    sols = {}
    for solver in ("BdfSolver", "ErkSolver"):
        got, ref = _pair(jmisc.lorenz_problem(rtol=1e-9, atol=1e-11),
                         tmisc.lorenz_problem(rtol=1e-9, atol=1e-11), t_eval,
                         max_steps=200_000, solver=solver)
        np.testing.assert_allclose(got.ys.numpy(), ref, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
        sols[solver] = got.ys.numpy()
    np.testing.assert_allclose(sols["BdfSolver"], sols["ErkSolver"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tier", ["dense", "blockdiag"])
def test_robertson_ode_groups(tier):
    """Five duplicated Robertson groups, dense (``misc``) and on the
    block-diagonal tier (``robertson.problem_ode_groups``): every group
    against the CVODE table, and the dense one against JAX."""
    ngroups = 5
    data = trob.SOLN
    t_eval = data[1:7, 0]
    if tier == "dense":
        tp = tmisc.robertson_ode_groups(ngroups=ngroups)
        assert tp.linear_solver.name == "dense"
        got, ref = _pair(jmisc.robertson_ode_groups(ngroups=ngroups), tp, t_eval,
                         max_steps=20_000)
        np.testing.assert_allclose(got.ys.numpy(), ref, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
    else:
        tp = trob.problem_ode_groups(ngroups)
        assert tp.linear_solver.name == f"blockdiag(3,{ngroups})"
        got = dtt.solve_dense(dtt.BdfSolver(tp), t_eval, max_steps=20_000, device="cpu")
    assert got.stop_reason == errors.TSTOP_REACHED
    ys = got.ys.numpy().reshape(len(t_eval), ngroups, 3)
    for g in range(ngroups):
        np.testing.assert_allclose(ys[:, g, 0], data[1:7, 1], rtol=5e-3)
        np.testing.assert_allclose(ys[:, g, 2], data[1:7, 3], rtol=5e-3, atol=1e-8)
