"""Forward sensitivities through the port's matrix-free Krylov tier
against the JAX package: the twin of tests/test_krylov.py's sensitivity
test, the rows of the continuous sensitivity equations each through its
own GMRES, and forward mode (``torch.func.jvp``) through the solve and its
GMRES.
"""

import jax.numpy as jnp
import numpy as np
import torch

import diffsol_tpu as dt
from diffsol_tpu.models import heat1d as jheat

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.models import heat1d as theat

torch.set_num_threads(1)
TWIN_RTOL = 1e-8


def test_krylov_forward_sensitivities():
    """Forward sensitivities of a krylov problem (heat1d, n = 16): the
    sens=True rows (naug, n), each row its own GMRES against the frozen
    point, meet the dense solve's dy/dp (rtol 2e-3, atol 1e-7, the JAX
    test's bound) and JAX's rows with equal steps; forward mode through
    the solve and its GMRES meets forward mode through the dense solve
    within 1e-10.  (Forward mode against JAX's jacfwd parts by ~1.3e-6 on
    the dense tier as on this one: the port's step control is Python
    floats, ROADMAP queue 3.)"""
    ref, _ = jheat.make(mgrid=15)
    jkry = (dt.OdeBuilder().rhs(ref.eqn.rhs).init(ref.eqn.init)
            .p(np.asarray(ref.params)).rtol(1e-7).atol(1e-9).linear_solver("krylov").build())
    tp, _ = theat.make(15, rtol=1e-7, atol=1e-9)
    kry = (dtt.OdeBuilder().rhs(tp.eqn.rhs).init(tp.eqn.init).p([1.0])
           .rtol(1e-7).atol(1e-9).linear_solver("krylov").build())
    te = [0.05, 0.1]
    _, sens_d = dtt.solve_dense_fwd_sens(dtt.BdfSolver(tp), te, device="cpu")
    sol = dtt.solve_dense(dtt.BdfSolver(kry, sens=True), te, device="cpu")
    assert sol.stop_reason >= 0
    np.testing.assert_allclose(sol.sens[:, 0].numpy(), sens_d[0].numpy(), rtol=2e-3, atol=1e-7)
    jsol = dt.solve_dense(dt.BdfSolver(jkry, sens=True), jnp.asarray(te))
    assert sol.state.stats.steps == int(jsol.state.stats.steps)
    assert sol.state.stats.newton_iterations == int(jsol.state.stats.newton_iterations)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(jsol.ys), rtol=TWIN_RTOL)
    np.testing.assert_allclose(sol.sens.numpy(), np.asarray(jsol.sens), rtol=TWIN_RTOL,
                               atol=1e-14)
    ys, sens = dtt.solve_dense_fwd_sens(dtt.BdfSolver(kry), te, device="cpu")
    np.testing.assert_allclose(ys.numpy(), sol.ys.numpy(), rtol=1e-12)
    np.testing.assert_allclose(sens.numpy(), sens_d.numpy(), rtol=1e-10)
