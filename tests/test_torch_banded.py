"""The port's banded linear-solver tier against the JAX package: the band
helpers and colored band Jacobians (ops/banded.py), the plain band LU
(ops/band_lu.py) against the JAX f64 XLA loop and the f32 Pallas kernels
in interpret mode, the builder and interop wiring, and the lockstep heat1d
ensemble against JAX lockstep.  Inputs are made with numpy from a seed.
(The band LU kernels against their plain versions are
tests/test_torch_cuda.py.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.ensemble import make_lockstep_problem as jax_lockstep_problem
from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.ops import banded as jb
from diffsol_tpu.ops import pallas_banded

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.equations import DiagMass
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import heat1d as theat
from diffsol_tpu_torch.ops import band_lu
from diffsol_tpu_torch.ops import banded as tb
from diffsol_tpu_torch.ops.linsol import DENSE

torch.set_num_threads(1)
F64 = torch.float64


def _stencil5(lib, n):
    """The ml = mu = 2 fourth-order stencil of test_pallas_band.py:95-132,
    written for jnp or torch."""
    h = 1.0 / (n + 1)

    def rhs(t, y, p):
        z2, z1 = lib.zeros_like(y[:2]), lib.zeros_like(y[:1])
        cat = jnp.concatenate if lib is jnp else torch.cat
        ym2 = cat([z2, y[:-2]])
        ym1 = cat([z1, y[:-1]])
        yp1 = cat([y[1:], z1])
        yp2 = cat([y[2:], z2])
        return p[0] * (-ym2 + 16.0 * ym1 - 30.0 * y + 16.0 * yp1 - yp2) / (12.0 * h * h)

    return rhs


def _rhs_pair(case):
    """(JAX rhs, torch rhs, n, ml, mu) of one band Jacobian case."""
    if case == "heat1d":
        jp, _ = jheat.make(mgrid=15)
        tp, _ = theat.make(mgrid=15)
        return jp.eqn.rhs, tp.eqn.rhs, 16, 1, 1
    return _stencil5(jnp, 17), _stencil5(torch, 17), 17, 2, 2


@pytest.mark.parametrize("case", ["heat1d", "stencil5"])
def test_banded_jac_and_helpers_match_jax(case):
    jrhs, trhs, n, ml, mu = _rhs_pair(case)
    rng = np.random.default_rng(11)
    y = rng.standard_normal(n)
    p = np.array([rng.uniform(0.5, 2.0)])
    jband = np.asarray(jb.make_banded_jac(jrhs, ml, mu)(0.0, jnp.asarray(y), jnp.asarray(p)))
    tjac = tb.make_banded_jac(trhs, ml, mu)
    assert tjac.jvp_probes == ml + mu + 1
    tband = tjac(torch.tensor(0.0, dtype=F64), torch.tensor(y), torch.tensor(p)).numpy()
    np.testing.assert_allclose(tband, jband, rtol=1e-14, atol=1e-14)
    dense = np.asarray(jb.band_to_dense(jnp.asarray(jband), ml, mu))
    np.testing.assert_allclose(tb.band_to_dense(torch.tensor(tband), ml, mu).numpy(),
                               dense, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(tb.dense_to_band(torch.tensor(dense), ml, mu).numpy(),
                               np.asarray(jb.dense_to_band(jnp.asarray(dense), ml, mu)),
                               rtol=1e-14, atol=1e-14)
    # and the band is the Jacobian: against jacfwd of the torch rhs
    jd = torch.func.jacfwd(trhs, argnums=1)(torch.tensor(0.0, dtype=F64), torch.tensor(y),
                                           torch.tensor(p))
    np.testing.assert_allclose(dense, jd.numpy(), rtol=1e-14, atol=1e-12)


def _dominant(rng, n, ml, mu):
    """test_banded.py:110's diagonally dominant band matrix."""
    a = np.eye(n) * 4.0 + rng.standard_normal((n, n)) * 0.2
    a *= np.abs(np.arange(n)[None, :] - np.arange(n)[:, None]) <= max(ml, mu)
    a *= (np.arange(n)[:, None] - np.arange(n)[None, :] <= ml)
    a *= (np.arange(n)[None, :] - np.arange(n)[:, None] <= mu)
    return a


@pytest.mark.parametrize("ml,mu,n", [(1, 1, 12), (3, 2, 20), (0, 3, 9), (3, 0, 9),
                                     (4, 4, 33), (20, 20, 64)])
def test_plain_band_lu_matches_jax_xla(ml, mu, n):
    """The plain factor and solve against JAX ``_band_lu_factor`` /
    ``_band_lu_solve`` (both float64, the same operation order) for one
    member and for three, at test_banded.py:110's shapes and at the 2-D
    models' width (nb = 41)."""
    rng = np.random.default_rng(7)
    a = _dominant(rng, n, ml, mu)
    b = rng.standard_normal(n)
    band = np.asarray(jb.dense_to_band(jnp.asarray(a), ml, mu))
    jf = np.asarray(jb._band_lu_factor(jnp.asarray(band), ml, mu))  # (nb, n + mu)
    jx = np.asarray(jb._band_lu_solve(jnp.asarray(jf), jnp.asarray(b), ml, mu))
    F = band_lu.band_lu_factor(torch.tensor(band), ml, mu)  # (n + mu, nb, 1)
    x = band_lu.band_lu_solve(F, torch.tensor(b), ml, mu)
    np.testing.assert_allclose(F.lu[:, :, 0].numpy().T, jf, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(a @ x.numpy(), b, rtol=1e-10, atol=1e-10)
    # three members, member-major (B, nb, n): each its own system
    scale = 1.0 + 0.1 * np.arange(3)
    bands = band[None] * scale[:, None, None]
    FB = band_lu.band_lu_factor(torch.tensor(bands), ml, mu)
    xB = band_lu.band_lu_solve(FB, torch.tensor(np.tile(b, (3, 1))), ml, mu)
    for m in range(3):
        np.testing.assert_allclose(xB[m].numpy(), np.linalg.solve(a * scale[m], b),
                                   rtol=1e-10, atol=1e-12)


def test_plain_band_lu_matches_jax_pallas_interpret():
    """The plain band LU against the f32 Pallas kernels in interpret mode
    at one shape, to test_banded.py:120's 1e-4 (the Pallas side is f32)."""
    rng = np.random.default_rng(7)
    ml, mu, n = 3, 2, 20
    a = _dominant(rng, n, ml, mu)
    b = rng.standard_normal(n)
    band = jb.dense_to_band(jnp.asarray(a), ml, mu)
    pf = pallas_banded.band_lu_factor(band, ml, mu)  # (n + mu, nb) f32
    px = np.asarray(pallas_banded.band_lu_solve(pf, jnp.asarray(b), ml, mu))
    F = band_lu.band_lu_factor(torch.tensor(np.asarray(band)), ml, mu)
    x = band_lu.band_lu_solve(F, torch.tensor(b), ml, mu)
    # the column-leading layouts are the same
    np.testing.assert_allclose(F.lu[:, :, 0].numpy(), np.asarray(pf), rtol=1e-4, atol=1e-5)
    assert np.max(np.abs(x.numpy() - px)) < 1e-4


def test_solve_broadcasts_one_factorization():
    rng = np.random.default_rng(3)
    a = _dominant(rng, 10, 1, 3)
    F = band_lu.band_lu_factor(tb.dense_to_band(torch.tensor(a), 1, 3), 1, 3)
    bs = torch.tensor(rng.standard_normal((4, 10)))
    xs = band_lu.band_lu_solve(F, bs, 1, 3)
    assert xs.shape == (4, 10)
    np.testing.assert_allclose(xs.numpy(), np.linalg.solve(a, bs.numpy().T).T,
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mass", ["identity", "diagonal", "dense"])
def test_assemble_matches_dense(mass):
    """``M - cJ`` on the band equals the dense tier's matrix, for each
    mass representation, one member and a lockstep stack."""
    rng = np.random.default_rng(5)
    n, ml, mu, c = 9, 1, 2, 0.3
    spec = tb.make_banded_solver(ml, mu)
    J = torch.tensor(_dominant(rng, n, ml, mu))
    jband = tb.dense_to_band(J, ml, mu)
    md = torch.tensor(rng.uniform(0.5, 2.0, n))
    m = {"identity": None, "diagonal": DiagMass(md), "dense": torch.diag(md)}[mass]
    want = DENSE.assemble(m, J, c)
    got = spec.assemble(m, jband, c)
    np.testing.assert_allclose(tb.band_to_dense(got, ml, mu).numpy(), want.numpy(),
                               rtol=1e-15, atol=1e-15)
    mB = {"identity": None, "diagonal": DiagMass(md.expand(2, n)),
          "dense": torch.diag(md).expand(2, n, n)}[mass]
    gotB = spec.assemble(mB, jband.expand(2, -1, -1), c)
    assert gotB.shape == (2, ml + mu + 1, n)
    np.testing.assert_allclose(gotB[1].numpy(), got.numpy(), rtol=0, atol=0)


def test_builder_and_interop_route_the_banded_tier():
    jp, _ = jheat.make(mgrid=15)
    jp = dataclasses.replace(jp, linear_solver=jb.make_banded_solver(1, 1, kernel="xla"))
    tp, _ = theat.make(mgrid=15)
    pt = problem_from_jax(jp, tp.eqn.rhs, tp.eqn.init)
    assert pt.linear_solver.name == "banded(1,1)"
    assert pt.linear_solver.meta == (1, 1)
    assert pt.eqn.rhs_jac.jvp_probes == 3  # the builder installed the band Jacobian
    y = torch.linspace(0.0, 1.0, 16, dtype=F64)
    assert pt.eqn.jac(torch.tensor(0.0, dtype=F64), y, pt.params).shape == (3, 16)
    assert dtt.OdeBuilder().linear_solver(DENSE)._linear_solver is DENSE
    for name in ("banded", "dense"):
        with pytest.raises(TypeError, match="make_banded_solver"):
            dtt.OdeBuilder().linear_solver(name)
    # a dense JAX problem stays dense
    jdense, _ = jheat.make(mgrid=15)
    assert problem_from_jax(jdense, tp.eqn.rhs, tp.eqn.init).linear_solver is DENSE


def test_lockstep_heat1d_matches_jax_lockstep():
    """heat1d mgrid=15, B=4 members through the lockstep banded tier,
    against JAX lockstep on kernel="xla" (both float64, the same band LU):
    equal steps and Newton iterations, trajectories to 1e-9."""
    t_eval = [0.01, 0.05, 0.2]
    params = np.linspace(0.5, 2.0, 4)[:, None]
    jp, _ = jheat.make(mgrid=15, rtol=1e-6, atol=1e-8)
    jp = dataclasses.replace(
        jp, linear_solver=jb.make_banded_solver(1, 1, kernel="xla"),
        eqn=dataclasses.replace(jp.eqn, rhs_jac=jb.make_banded_jac(jp.eqn.rhs, 1, 1)))
    jsol = dt.solve_dense(dt.BdfSolver(jax_lockstep_problem(jp, 4)), jnp.asarray(t_eval),
                          params=jnp.asarray(params), max_steps=2000)
    tp, _ = theat.make(mgrid=15, rtol=1e-6, atol=1e-8, banded=True)
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, t_eval, params, mode="lockstep",
                                   device="cpu")
    assert sol.tier == "lockstep"
    assert sol.stop_reason == int(jsol.stop_reason) == dtt.errors.TSTOP_REACHED
    assert sol.state.stats.steps == int(jsol.state.stats.steps)
    assert sol.state.stats.newton_iterations == int(jsol.state.stats.newton_iterations)
    assert sol.state.stats.jac_mul_evals == int(jsol.state.stats.jac_mul_evals)
    np.testing.assert_allclose(sol.ys.numpy(), np.moveaxis(np.asarray(jsol.ys), -1, 1),
                               rtol=1e-9, atol=1e-14)


def test_entry_point_runs_on_the_card_unless_asked_for_the_cpu():
    """Without ``device`` the solve runs on the card; where there is none
    it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    tp, _ = theat.make(mgrid=7, banded=True)
    for params in ([[1.0]], np.ones((1, 1)), torch.ones(1, 1, dtype=F64)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dtt.solve_dense_ensemble(dtt.BdfSolver, tp, [0.01], params, mode="fused")
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, [0.01], [[1.0]], mode="lockstep",
                                   device="cpu")
    assert sol.ys.device.type == "cpu" and sol.ys.dtype == F64
