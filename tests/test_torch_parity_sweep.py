"""Twin of tests/test_parity_sweep.py: the port's trajectory-parity sweep
at rtol = 1e-6, atol = 1e-8.

* Every fixture with an exact solution, through each of the four methods
  of ``solver``/``METHODS``: within 200 rtol of the exact solution (the
  JAX test's ``CHECK``) and within rtol 1e-6 (atol 1e-14) of the JAX
  package's ``dt.solver(pr, m)`` on the same problem.  The explicit method
  refuses the DAE, as the JAX one does.
* The Robertson DAE against IDA's decades (table precision, 1e-3).
* heat1d self-convergence against a tight-tolerance oracle of the same
  semidiscrete system, and against the JAX solve.

The JAX side of each case runs once per module (a cache filled at first
use).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.models import exponential_decay as jed
from diffsol_tpu.models import exponential_decay_algebraic as jeda
from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.models import logistic as jlog
from diffsol_tpu.models import misc as jmisc
from diffsol_tpu.models import robertson as jrob

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.models import exponential_decay as ted
from diffsol_tpu_torch.models import exponential_decay_algebraic as teda
from diffsol_tpu_torch.models import heat1d as theat
from diffsol_tpu_torch.models import logistic as tlog
from diffsol_tpu_torch.models import misc as tmisc
from diffsol_tpu_torch.models import robertson as trob

torch.set_num_threads(1)

RTOL = 1e-6
ATOL = 1e-8
CHECK = 200 * RTOL
TRAJ_RTOL, TRAJ_ATOL = 1e-6, 1e-14
MAX_STEPS = 40_000


def _tight_j(problem):
    return dataclasses.replace(problem, rtol=jnp.asarray(RTOL, problem.rtol.dtype),
                               atol=jnp.full_like(problem.atol, ATOL))


def _tight_t(problem):
    return dataclasses.replace(problem, rtol=torch.tensor(RTOL, dtype=torch.float64),
                               atol=torch.full_like(problem.atol, ATOL))


def case_exponential_decay():
    t = np.array([0.25, 0.5, 1.0])
    return (jed.problem(rtol=RTOL, atol=ATOL), ted.problem(rtol=RTOL, atol=ATOL), t,
            np.exp(-0.1 * t)[:, None] * np.ones(2))


def case_logistic():
    t = np.array([1.0, 5.0, 10.0])
    return (jlog.problem(rtol=RTOL, atol=ATOL), tlog.problem(rtol=RTOL, atol=ATOL), t,
            tlog.soln(t, [1.0, 1.0, 0.1]))


def case_gaussian_decay():
    t = np.array([0.5, 1.0])
    tp = _tight_t(tmisc.gaussian_decay_problem())
    return (_tight_j(jmisc.gaussian_decay_problem()), tp, t,
            tmisc.gaussian_decay_soln(t, tp.params.numpy()))


def case_dydt_y2():
    t = np.array([0.4, 0.8])
    return (_tight_j(jmisc.dydt_y2_problem()), _tight_t(tmisc.dydt_y2_problem()), t,
            tmisc.dydt_y2_soln(t))


def case_exponential_decay_algebraic():
    t = np.array([0.4, 0.8])
    return (_tight_j(jeda.problem()), _tight_t(teda.problem()), t, teda.soln(t, [0.1]))


CASES = {
    "exponential_decay": case_exponential_decay,
    "logistic": case_logistic,
    "gaussian_decay": case_gaussian_decay,
    "dydt_y2": case_dydt_y2,
    "exponential_decay_algebraic": case_exponential_decay_algebraic,
}


@pytest.fixture(scope="module")
def jax_solutions():
    """(case, method) -> the JAX package's ys, filled at first use."""
    return {}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("method", dtt.METHODS)
def test_exact_solution_parity(name, method, jax_solutions):
    jp, tp, t_eval, exact = CASES[name]()
    if method == "tsit45" and tp.eqn.mass is not None:
        # explicit RK cannot integrate a DAE, on either side
        with pytest.raises(ValueError, match="mass"):
            dtt.solver(tp, method)
        with pytest.raises(ValueError, match="mass"):
            dt.solver(jp, method)
        return
    sol = dtt.solve_dense(dtt.solver(tp, method), t_eval, max_steps=MAX_STEPS, device="cpu")
    assert sol.stop_reason >= 0
    ys = sol.ys.numpy()
    err = np.max(np.abs(ys - exact) / (np.abs(exact) + 1e-3))
    assert err < CHECK, (name, method, err)
    key = (name, method)
    if key not in jax_solutions:
        jax_solutions[key] = np.asarray(dt.solve_dense(
            dt.solver(jp, method), jnp.asarray(t_eval), max_steps=MAX_STEPS).ys)
    np.testing.assert_allclose(ys, jax_solutions[key], rtol=TRAJ_RTOL, atol=TRAJ_ATOL)


def test_robertson_dae_ida_decades():
    """The Robertson DAE against the IDA reference over 8 decades (the
    table's own precision, 1e-3), and against the JAX solve."""
    atol = (1e-10, 1e-8, 1e-8)
    pr = trob.problem_dae(rtol=RTOL, atol=atol)
    decades = np.array([0.4, 4.0, 40.0, 400.0, 4e3, 4e4, 4e5, 4e6])
    expected = np.array([
        [9.851641e-01, 3.386242e-05, 1.480205e-02],
        [9.055097e-01, 2.240338e-05, 9.446793e-02],
        [7.158017e-01, 9.185037e-06, 2.841892e-01],
        [4.505360e-01, 3.223271e-06, 5.494608e-01],
        [1.832299e-01, 8.944378e-07, 8.167692e-01],
        [3.898902e-02, 1.622006e-07, 9.610108e-01],
        [4.936383e-03, 1.984224e-08, 9.950636e-01],
        [5.168093e-04, 2.068293e-09, 9.994832e-01],
    ])
    sol = dtt.solve_dense(dtt.solver(pr, "bdf"), decades, max_steps=MAX_STEPS, device="cpu")
    assert sol.stop_reason == errors.TSTOP_REACHED
    np.testing.assert_allclose(sol.ys.numpy(), expected, rtol=1e-3, atol=1e-10)
    ref = dt.solve_dense(dt.solver(jrob.problem_dae(rtol=RTOL, atol=atol), "bdf"),
                         jnp.asarray(decades), max_steps=MAX_STEPS)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)


def test_heat1d_self_convergence():
    """heat1d at rtol 1e-6 against a tight-tolerance oracle of the same
    semidiscrete system (the spatial error excluded by construction), and
    against the JAX solve at rtol 1e-6."""
    pr, _ = theat.make(mgrid=20, rtol=RTOL, atol=ATOL)
    pr_tight, _ = theat.make(mgrid=20, rtol=1e-10, atol=1e-12)
    t = np.array([0.01, 0.05, 0.1])
    ys = dtt.solve_dense(dtt.solver(pr, "bdf"), t, max_steps=MAX_STEPS, device="cpu").ys
    ys_o = dtt.solve_dense(dtt.solver(pr_tight, "bdf"), t, max_steps=MAX_STEPS,
                           device="cpu").ys
    assert float((ys - ys_o).abs().max()) < CHECK
    jp, _ = jheat.make(mgrid=20, rtol=RTOL, atol=ATOL)
    ref = dt.solve_dense(dt.solver(jp, "bdf"), jnp.asarray(t), max_steps=MAX_STEPS)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref.ys), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)
