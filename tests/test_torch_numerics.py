"""The port's numerics core against the JAX package: WRMS norms, the PI
controller, Newton, the dense linear solver, the initial step size and the
BDF difference-matrix helpers.

Inputs come from a numpy seed and go through both packages.  Everything is
float64 on both sides, so the tolerance is 1e-12 -- except where the JAX
function rounds to float32 on purpose (the controller's powers and
Newton's eta, which the TPU computes in f32): those are compared at
float32 resolution, and against a float64 numpy formula at 1e-12.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsol_tpu import norms as jnorms
from diffsol_tpu.ops import controller as jctrl
from diffsol_tpu.ops import linsol as jlinsol
from diffsol_tpu.ops import newton as jnewton
from diffsol_tpu.solvers import bdf as jbdf
from diffsol_tpu.solvers import state as jstate
from diffsol_tpu.models import robertson as jrob

from diffsol_tpu_torch import norms
from diffsol_tpu_torch.equations import DiagMass
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import robertson as trob
from diffsol_tpu_torch.ops import controller, linsol, newton
from diffsol_tpu_torch.solvers import bdf
from diffsol_tpu_torch.solvers.state import initial_step_size

torch.set_num_threads(1)

TOL = 1e-12
F32_RTOL = 1e-5  # a few float32 ulps (2^-23 ~ 1.2e-7) through pow and products


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


@pytest.mark.parametrize("nbatch", [1, 6])
def test_norms_match_jax(nbatch):
    rng = np.random.default_rng(1)
    n = 4
    shape = (n,) if nbatch == 1 else (nbatch, n)
    x = rng.normal(size=shape)
    y = rng.normal(size=shape) * 10.0
    atol = rng.uniform(1e-8, 1e-6, size=n)
    rtol = 1e-4
    # the JAX lockstep layout is (n, B); the port's is member-major (B, n)
    xj = x if nbatch == 1 else x.T
    yj = y if nbatch == 1 else y.T
    aj = atol if nbatch == 1 else atol[:, None]
    ref = float(jnorms.squared_norm(jnp.asarray(xj), jnp.asarray(yj),
                                    jnp.asarray(aj), rtol, nbatch))
    got = float(norms.squared_norm(_t(x), _t(y), _t(atol), rtol))
    np.testing.assert_allclose(got, ref, rtol=TOL)
    ref_n = float(jnorms.norm(jnp.asarray(xj), jnp.asarray(yj),
                              jnp.asarray(aj), rtol, nbatch))
    np.testing.assert_allclose(float(norms.norm(_t(x), _t(y), _t(atol), rtol)),
                               ref_n, rtol=TOL)
    _, worst_j = jnorms.squared_norm_and_worst(
        jnp.asarray(xj), jnp.asarray(yj), jnp.asarray(aj), rtol, nbatch)
    _, worst_t = norms.squared_norm_and_worst(_t(x), _t(y), _t(atol), rtol)
    assert worst_t == int(worst_j)


def _pi_f64(err, prev, ki, kp, order):
    err_s = min(max(err, 1e-30), 1e30)
    if kp == 0.0 or math.isnan(prev):
        return err_s ** (-ki / order)
    prev_s = min(max(prev, 1e-30), 1e30)
    return err_s ** (-(ki + kp) / order) * prev_s ** (kp / order)


@pytest.mark.parametrize("kp", [0.0, 0.2])
def test_pi_controller_matches_jax(kp):
    rng = np.random.default_rng(2)
    ki = 0.5
    errs = np.concatenate([10.0 ** rng.uniform(-6, 3, 8), [0.0, 1e-40, 1e40]])
    prevs = np.concatenate([10.0 ** rng.uniform(-6, 3, 8), [np.nan, 1.0, np.nan]])
    orders = rng.integers(1, 7, size=errs.size)
    got = controller.pi_controller_raw(_t(errs), _t(prevs), ki, kp,
                                       torch.tensor(orders)).numpy()
    want = [_pi_f64(e, p, ki, kp, o) for e, p, o in zip(errs, prevs, orders)]
    np.testing.assert_allclose(got, want, rtol=TOL)
    ref = np.asarray(jctrl.pi_controller_raw(
        jnp.asarray(errs), jnp.asarray(prevs), ki, kp, jnp.asarray(orders)))
    np.testing.assert_allclose(got, ref, rtol=F32_RTOL)


def _newton_system(rng, n, nbatch):
    """F(x) = A x + 0.1 x^3 - b per member, with the chord (frozen)
    Jacobian A + 0.3 diag(x0^2) at x0."""
    shape = (n,) if nbatch == 1 else (nbatch, n)
    A = rng.normal(size=shape + (n,)) * 0.2 + 3.0 * np.eye(n)
    b = rng.normal(size=shape)
    x0 = rng.normal(size=shape) * 0.1
    Jm = A + 0.3 * np.einsum("...i,ij->...ij", x0**2, np.eye(n))
    return A, b, x0, Jm


@pytest.mark.parametrize("nbatch", [1, 5])
def test_newton_matches_jax(nbatch):
    rng = np.random.default_rng(3)
    n = 3
    A, b, x0, Jm = _newton_system(rng, n, nbatch)
    atol = np.full(n, 1e-6)
    rtol = 1e-4
    eta0 = 20.0**1.25

    # port: member-major (B, n)
    At, bt = _t(A), _t(b)
    facs = linsol.DENSE.factor(_t(Jm))
    res_t = newton.newton_solve(
        lambda x: (At @ x.unsqueeze(-1)).squeeze(-1) + 0.1 * x**3 - bt,
        lambda v: linsol.DENSE.solve(facs, v),
        _t(x0), _t(x0), _t(atol), rtol, eta0, tol=0.2, max_iter=10)

    # JAX: one instance, or the (n, B) lockstep layout with a vmapped LU
    if nbatch == 1:
        fj = jlinsol.DENSE.factor(jnp.asarray(Jm))

        def jres(x):
            return jnp.asarray(A) @ x + 0.1 * x**3 - jnp.asarray(b)

        def jsolve(v):
            return jlinsol.DENSE.solve(fj, v)

        x0j, aj = jnp.asarray(x0), jnp.asarray(atol)
    else:
        import jax

        fj = jax.vmap(jlinsol.DENSE.factor)(jnp.asarray(Jm))

        def jres(x):  # x (n, B)
            xb = x.T
            r = jnp.einsum("bij,bj->bi", jnp.asarray(A), xb) + 0.1 * xb**3 - b
            return r.T

        def jsolve(v):
            return jax.vmap(jlinsol.DENSE.solve)(fj, v.T).T

        x0j, aj = jnp.asarray(x0.T), jnp.asarray(atol[:, None])
    res_j = jnewton.newton_solve(jres, jsolve, x0j, x0j, aj, rtol, eta0,
                                 tol=0.2, max_iter=10, nbatch=nbatch)
    xj = np.asarray(res_j.x) if nbatch == 1 else np.asarray(res_j.x).T
    assert res_t.converged == bool(res_j.converged)
    assert res_t.niter == int(res_j.niter)
    assert res_t.niter >= 2
    np.testing.assert_allclose(res_t.x.numpy(), xj, rtol=TOL, atol=TOL)
    # eta is float32 bookkeeping in JAX
    np.testing.assert_allclose(res_t.eta, float(res_j.eta), rtol=F32_RTOL)


@pytest.mark.parametrize("mass", ["identity", "diag"])
def test_dense_linsol_matches_jax(mass):
    rng = np.random.default_rng(4)
    n = 4
    J = rng.normal(size=(n, n))
    d = rng.uniform(0.5, 2.0, size=n)
    c = 0.3
    b = rng.normal(size=n)
    m_t = None if mass == "identity" else DiagMass(_t(d))
    m_j = None if mass == "identity" else jlinsol.DiagMass(jnp.asarray(d))
    a_t = linsol.DENSE.assemble(m_t, _t(J), c)
    a_j = jlinsol.DENSE.assemble(m_j, jnp.asarray(J), c)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=TOL, atol=TOL)
    x_t = linsol.DENSE.solve(linsol.DENSE.factor(a_t), _t(b))
    x_j = jlinsol.DENSE.solve(jlinsol.DENSE.factor(a_j), jnp.asarray(b))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=TOL, atol=TOL)
    # member-major batch (B, n, n) solves each member alike
    As = _t(np.stack([np.asarray(a_j)] * 3))
    xs = linsol.DENSE.solve(linsol.DENSE.factor(As), _t(np.stack([b] * 3)))
    np.testing.assert_allclose(xs.numpy(), np.stack([np.asarray(x_j)] * 3),
                               rtol=TOL, atol=TOL)


def test_initial_step_size_matches_jax():
    pj = jrob.problem_ode()
    pt = problem_from_jax(pj, trob.rhs_ode, trob.init)
    yj = pj.eqn.init(pj.t0, pj.params)
    hj = float(jstate.initial_step_size(
        pj, pj.params, yj, pj.eqn.rhs(pj.t0, yj, pj.params), 1))
    yt = pt.eqn.init(pt.t0, pt.params)
    ht = initial_step_size(pt, pt.params, yt, pt.eqn.rhs(pt.t0, yt, pt.params), 1)
    np.testing.assert_allclose(ht, hj, rtol=TOL)


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
def test_difference_matrix_helpers_match_jax(order):
    rng = np.random.default_rng(10 + order)
    n = 3
    D = rng.normal(size=(bdf.ND, n))
    d = rng.normal(size=n)
    factor = float(rng.uniform(0.2, 2.0))
    Dj, Dt = jnp.asarray(D), _t(D)
    ru_j = np.asarray(jbdf._compute_ru(order, factor, jnp.float64))
    ru_t = bdf.compute_ru(order, factor)
    np.testing.assert_allclose(ru_t, ru_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(bdf.apply_ru(ru_t, Dt).numpy(),
                               np.asarray(jbdf._apply_ru(jnp.asarray(ru_j), Dj)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(bdf.predict_from_diff(Dt, order).numpy(),
                               np.asarray(jbdf._predict_from_diff(Dj, order)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(bdf.psi_from_diff(Dt, order).numpy(),
                               np.asarray(jbdf._psi(Dj, order, jnp.float64)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        bdf.update_diff(Dt, _t(d), order).numpy(),
        np.asarray(jbdf._update_diff(Dj, jnp.asarray(d), order)),
        rtol=TOL, atol=TOL)
    t1, h = 2.0, 0.25
    np.testing.assert_allclose(
        bdf.interp_from_diff(1.9, Dt, t1, h, order).numpy(),
        np.asarray(jbdf._interp_from_diff(1.9, Dj, t1, h, order)),
        rtol=TOL, atol=TOL)
