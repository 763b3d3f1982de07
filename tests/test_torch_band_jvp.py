"""Forward mode through the band LU (ops/band_lu.py's autograd.Functions):
the factor carries no tangent and the solve's rule is x' = A^-1 (b' - A' x),
one more solve on the same factors.  On the CPU the plain versions go
through the same Functions, so the rule is tested here; on the card the
solves are K4 launches (tests/test_torch_cuda.py).

``solve_dense_fwd_sens`` of heat1d on the banded tier is held to forward
mode straight through the plain operations (no Function, the tangent
carried op by op) within 1e-12 relative; to the JAX package's
``solve_dense_fwd_sens`` within FWD_RTOL of the largest sensitivity at
rtol 1e-8 (JAX's jacfwd also carries dh/dp through its step control, the
port's step control is Python floats: tests/test_torch_sens.py); and to
the continuous rows of ``BdfSolver(sens=True)`` within the bound that
tests/test_torch_sens.py holds the two routes to (ROUTES_RTOL,
ROUTES_ATOL).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.ops import banded as jb
from diffsol_tpu.sens import solve_dense_fwd_sens as jax_fwd_sens

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.models import heat1d
from diffsol_tpu_torch.ops import band_lu
from diffsol_tpu_torch.ops.banded import band_to_dense

torch.set_num_threads(1)

FWD_RTOL = 1e-6
# tests/test_torch_sens.py::test_continuous_sens_matches_jacfwd's bound
ROUTES_RTOL, ROUTES_ATOL = 5e-4, 1e-7
T_EVAL = [0.01, 0.05, 0.2]


def _band(nbatch, n, ml, mu, seed):
    from diffsol_tpu_torch.ops.banded import _band_index

    rng = np.random.default_rng(seed)
    band = rng.standard_normal((nbatch, ml + mu + 1, n))
    band[:, mu] += 2.0 * (ml + mu + 1)
    return torch.tensor(band * _band_index(n, ml, mu)[1])


@pytest.mark.parametrize("ml,mu,naug", [(1, 1, 1), (3, 2, 1), (2, 4, 3)])
def test_solve_rule_matches_a_dense_solve(ml, mu, naug):
    """jvp of band_lu_solve(band_lu_factor(A), b) in (A, b) against
    jvp of torch.linalg.solve on the dense A, member by member, with naug
    right-hand sides a factorization (rows naug-major): within 1e-12.  The
    factors alone carry a zero tangent."""
    B, n = 3, 9
    band, dband = _band(B, n, ml, mu, 0), _band(B, n, ml, mu, 1)
    rng = np.random.default_rng(2)
    b = torch.tensor(rng.standard_normal((naug * B, n)))
    db = torch.tensor(rng.standard_normal((naug * B, n)))

    def through_band(a, rhs):
        return band_lu.band_lu_solve(band_lu.band_lu_factor(a, ml, mu), rhs, ml, mu)

    x, dx = torch.func.jvp(through_band, (band, b), (dband, db))

    def dense(a, rhs):
        m = torch.arange(naug * B) % B
        mats = torch.stack([band_to_dense(a[k], ml, mu) for k in range(B)])[m]
        return torch.linalg.solve(mats, rhs)

    x_d, dx_d = torch.func.jvp(dense, (band, b), (dband, db))
    torch.testing.assert_close(x, x_d, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dx, dx_d, rtol=1e-12, atol=1e-12)
    _, dF = torch.func.jvp(lambda a: band_lu.band_lu_factor(a, ml, mu).lu, (band,), (dband,))
    assert not dF.any()


def _plain_fwd_sens(problem, params=None):
    """solve_dense_fwd_sens with the band LU's plain versions called
    directly, their in-place column loops carrying the tangent op by op."""
    saved = band_lu._BandFactor.apply, band_lu._BandSolve.apply
    band_lu._BandFactor.apply = staticmethod(
        lambda band, ml, mu: band_lu.band_lu_factor_reference(band, ml, mu))
    band_lu._BandSolve.apply = staticmethod(
        lambda F, band, b2, ml, mu: band_lu.band_lu_solve_reference(F, b2, ml, mu))
    try:
        return dtt.solve_dense_fwd_sens(dtt.BdfSolver(problem), T_EVAL, params=params,
                                        device="cpu")
    finally:
        band_lu._BandFactor.apply, band_lu._BandSolve.apply = saved


def test_fwd_sens_banded_matches_plain_operations_and_jax():
    """heat1d n = 16 on the banded tier at rtol 1e-8: through the
    Functions as through the plain operations (1e-12), and as JAX's
    solve_dense_fwd_sens on its banded tier (FWD_RTOL)."""
    problem, _ = heat1d.make(15, rtol=1e-8, atol=1e-10, banded=True)
    ys, sens = dtt.solve_dense_fwd_sens(dtt.BdfSolver(problem), T_EVAL, device="cpu")
    ys_p, sens_p = _plain_fwd_sens(problem)
    assert sens.shape == (1, 3, 16)
    torch.testing.assert_close(ys, ys_p, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(sens, sens_p, rtol=1e-12, atol=1e-12 * float(sens_p.abs().max()))
    jp, _ = jheat.make(mgrid=15, rtol=1e-8, atol=1e-10)
    jp = dataclasses.replace(
        jp, linear_solver=jb.make_banded_solver(1, 1),
        eqn=dataclasses.replace(jp.eqn, rhs_jac=jb.make_banded_jac(jp.eqn.rhs, 1, 1)))
    jys, jsens = jax_fwd_sens(dt.BdfSolver(jp), jnp.asarray(T_EVAL))
    jsens = np.asarray(jsens)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(sens.numpy(), jsens, rtol=0,
                               atol=FWD_RTOL * np.abs(jsens).max())


def test_fwd_sens_banded_lockstep_matches_the_continuous_rows():
    """A lockstep heat1d ensemble of 4 diffusivities on the banded tier:
    solve_dense_fwd_sens through the Functions as through the plain
    operations (1e-12), and as BdfSolver(sens=True)'s continuous rows of
    the same ensemble within the two routes' bound."""
    problem, _ = heat1d.make(15, rtol=1e-6, atol=1e-8, banded=True)
    params = np.linspace(0.5, 2.0, 4)[:, None]
    lp = dtt.make_lockstep_problem(problem, 4)
    ys, sens = dtt.solve_dense_fwd_sens(dtt.BdfSolver(lp), T_EVAL, params=params, device="cpu")
    _, sens_p = _plain_fwd_sens(lp, params)
    assert sens.shape == (1, 3, 4, 16)
    torch.testing.assert_close(sens, sens_p, rtol=1e-12, atol=1e-12 * float(sens_p.abs().max()))
    rows = dtt.solve_dense_ensemble(lambda p: dtt.BdfSolver(p, sens=True), problem, T_EVAL,
                                    params, mode="lockstep", device="cpu")
    cont = rows.sens.movedim(1, 0)  # (naug, neval, B, n)
    torch.testing.assert_close(rows.ys, ys, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sens.numpy(), cont.numpy(), rtol=ROUTES_RTOL, atol=ROUTES_ATOL)
