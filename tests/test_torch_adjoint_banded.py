"""A banded lockstep ensemble's gradient: heat1d (mgrid = 10, tridiagonal,
``banded(1, 1)``), three diffusivities, through
``make_differentiable_solve_ensemble``.  The forward pass runs the banded
tier (on the CPU the band LU's plain version, on the card K3/K4); the
backward pass always runs the dense (B, n + 1, n + 1) adjoint.

Held against the JAX package's gradient on the same problem (its lockstep
adjoint over a banded forward, ``kernel="auto"``, which is the f64 XLA
band LU off a TPU) and against the port's dense tier.  The port and JAX
take the same 203 forward steps; the backward solves part by two of ~435
steps (JAX keeps its Newton bookkeeping in float32, ROADMAP.md queue 3
"not faults"), and the gradients by 2.2e-8 of the largest (measured on the
CPU), held to BANDED_JAX_RTOL.  The two tiers of the port solve the same
Newton systems to roundoff: TIERS_RTOL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsol_tpu.adjoint_ensemble import make_differentiable_solve_ensemble as jax_mdse
from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.ops import banded as jb

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.models import heat1d as theat

from test_torch_adjoint import grad_of

torch.set_num_threads(1)

MGRID = 10
T_EVAL = [0.02, 0.05, 0.1]
D = np.linspace(0.5, 2.0, 3)[:, None]
BANDED_JAX_RTOL = 1e-7
TIERS_RTOL = 1e-9


def _sum_sq(ys):
    return (ys**2).sum()


@pytest.fixture(scope="module")
def jax_banded_grad():
    jp, _ = jheat.make(mgrid=MGRID, rtol=1e-8, atol=1e-10)
    jp = dataclasses.replace(jp, linear_solver=jb.make_banded_solver(1, 1),
                             eqn=dataclasses.replace(jp.eqn,
                                                     rhs_jac=jb.make_banded_jac(jp.eqn.rhs, 1, 1)))
    fn = jax_mdse(jp, jnp.asarray(T_EVAL), len(D))
    return np.asarray(jax.grad(lambda p: _sum_sq(fn(p)))(jnp.asarray(D)))


def _port_grad(banded, **kw):
    problem, _ = theat.make(mgrid=MGRID, rtol=1e-8, atol=1e-10, banded=banded)
    fn = dtt.make_differentiable_solve_ensemble(problem, T_EVAL, len(D), device="cpu", **kw)
    return grad_of(fn, D, _sum_sq), fn.info


def test_banded_lockstep_gradient_matches_jax_and_the_dense_tier(jax_banded_grad):
    g_band, info = _port_grad(True)
    assert info["forward"].steps == 203
    # the Motivation's JAX numbers, recomputed here
    np.testing.assert_allclose(jax_banded_grad.ravel(),
                               [-6.65683849, -2.78159862, -1.41825115], rtol=1e-8)
    err = np.abs(g_band - jax_banded_grad).max() / np.abs(jax_banded_grad).max()
    assert err < BANDED_JAX_RTOL, (g_band, jax_banded_grad)
    g_dense, _ = _port_grad(False)
    np.testing.assert_allclose(g_band, g_dense, rtol=TIERS_RTOL)


def test_banded_lockstep_bounded_gradient():
    """The bounded mode re-solves every segment on the banded tier (K3/K4
    on the card) and meets the dense table's gradient at the JAX bounded
    twins' 2e-4."""
    g_dense, _ = _port_grad(True)
    g_bnd, info = _port_grad(True, checkpoint_interval=32)
    assert info["resolve_steps"] >= info["forward"].steps - 32
    np.testing.assert_allclose(g_bnd, g_dense, rtol=2e-4)
