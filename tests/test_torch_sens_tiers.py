"""The port's sensitivity machinery against the JAX package's functions,
where tests/test_sens.py has no twin: ``SensEquations`` part by part, the
augmented rows through each linear-solver tier (dense, block-diagonal,
banded and its plain band LU), the banded lockstep solve, and the fused
and auto ensemble modes with a sensitivity solver.  Inputs come from numpy
seeds; each test states its tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.augmented import SensEquations as JaxSens
from diffsol_tpu.ensemble import make_lockstep_problem as jax_lockstep_problem
from diffsol_tpu.ensemble import solve_dense_ensemble as jax_ensemble
from diffsol_tpu.models import exponential_decay as jed
from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.models import robertson as jrob
from diffsol_tpu.ops import banded as jb

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.augmented import SensEquations
from diffsol_tpu_torch.interop import problem_from_jax, solution_to_numpy
from diffsol_tpu_torch.models import exponential_decay as ted
from diffsol_tpu_torch.models import heat1d as theat
from diffsol_tpu_torch.models import robertson as trob
from diffsol_tpu_torch.ops import band_lu
from diffsol_tpu_torch.ops import banded as tb
from diffsol_tpu_torch.ops.eqn_codegen import UnsupportedForKernel

torch.set_num_threads(1)
PARTS_TOL = 1e-12


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _robertson_pair(kind, B=None):
    """(JAX problem, the port's) of the Robertson ODE or DAE, lifted to a
    B-member lockstep ensemble when B is given."""
    if kind == "ode":
        jp = jrob.problem_ode()
        tp = problem_from_jax(jp, trob.rhs_ode, trob.init)
    else:
        jp = jrob.problem_dae()
        tp = problem_from_jax(jp, trob.rhs_dae, trob.init, mass=trob.mass)
    if B is None:
        return jp, tp
    return jax_lockstep_problem(jp, B), dtt.make_lockstep_problem(tp, B)


def _lockstep_params(B, seed):
    rng = np.random.default_rng(seed)
    k1 = 0.04 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, B))
    return np.stack([k1, np.full(B, 1e4), np.full(B, 3e7)], axis=1)


def _to_jax_rows(x, lockstep):
    """The port's member-major rows (..., B, n) in JAX's (..., n, B)."""
    x = np.asarray(x)
    return jnp.asarray(np.swapaxes(x, -1, -2) if lockstep else x)


def _from_jax_rows(x, lockstep):
    x = np.asarray(x)
    return np.swapaxes(x, -1, -2) if lockstep else x


@pytest.mark.parametrize("B", [None, 3])
def test_linear_parts_match_jax(B):
    """jvp_rows(S) and df/dp of the Robertson ODE at a random state, one
    instance and a lockstep ensemble of 3, against JAX's to 1e-12."""
    jp, tp = _robertson_pair("ode", B)
    lock = B is not None
    rng = np.random.default_rng(4)
    shape = (3,) if not lock else (B, 3)
    y = rng.uniform(0.0, 1.0, shape)
    S = rng.standard_normal((3,) + shape)
    params = _lockstep_params(B, 5) if lock else np.asarray(jp.params)
    jrows, jfp = JaxSens(jp).linear_parts(jnp.asarray(0.3), _to_jax_rows(y, lock),
                                          jnp.asarray(params))
    trows, tfp = SensEquations(tp).linear_parts(_t(0.3), _t(y), _t(params))
    scale = max(1.0, np.abs(np.asarray(jfp)).max())
    np.testing.assert_allclose(tfp.numpy(), _from_jax_rows(jfp, lock), rtol=PARTS_TOL,
                               atol=PARTS_TOL * scale)
    jr = _from_jax_rows(jrows(_to_jax_rows(S, lock)), lock)
    np.testing.assert_allclose(trows(_t(S)).numpy(), jr, rtol=PARTS_TOL,
                               atol=PARTS_TOL * np.abs(jr).max())


def test_init_matches_jax():
    """S0 = dy0/dp and dS0 of the exponential decay (y0 = p[1]) against
    JAX's to 1e-12."""
    jp = jed.problem()
    tp = problem_from_jax(jp, ted.rhs, ted.init)
    y0, dy0 = np.array([1.0, 1.0]), np.array([-0.1, -0.1])
    jS, jdS = JaxSens(jp).init(jnp.asarray(0.0), jnp.asarray(y0), jnp.asarray(dy0),
                               jp.params)
    tS, tdS = SensEquations(tp).init(_t(0.0), _t(y0), _t(dy0), tp.params)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), rtol=PARTS_TOL, atol=PARTS_TOL)
    np.testing.assert_allclose(tdS.numpy(), np.asarray(jdS), rtol=PARTS_TOL, atol=PARTS_TOL)
    assert tS.shape == (2, 2)


@pytest.mark.parametrize("B", [None, 3])
def test_consistent_init_matches_jax(B):
    """The Robertson DAE's algebraic sensitivity rows at a consistent t0
    state, from random differential rows, against JAX's to 1e-12: the
    dense LU of one instance and the batched (B, n, n) LU of a lockstep
    ensemble."""
    jp, tp = _robertson_pair("dae", B)
    lock = B is not None
    rng = np.random.default_rng(6)
    shape = (3,) if not lock else (B, 3)
    y0 = np.broadcast_to(np.array([0.9, 1e-5, 0.1 - 1e-5]), shape).copy()
    dy0 = rng.standard_normal(shape)
    S0 = rng.standard_normal((3,) + shape)
    params = _lockstep_params(B, 7) if lock else np.asarray(jp.params)
    is_alg = np.array([False, False, True])
    jS, jdS = JaxSens(jp).consistent_init(
        jnp.asarray(0.0), _to_jax_rows(y0, lock), _to_jax_rows(dy0, lock),
        jnp.asarray(params), _to_jax_rows(S0, lock),
        jnp.asarray(is_alg[:, None] if lock else is_alg))
    tS, tdS = SensEquations(tp).consistent_init(
        _t(0.0), _t(y0), _t(dy0), _t(params), _t(S0), torch.tensor(is_alg))
    for got, ref in ((tS, jS), (tdS, jdS)):
        ref = _from_jax_rows(ref, lock)
        np.testing.assert_allclose(got.numpy(), ref, rtol=PARTS_TOL,
                                   atol=PARTS_TOL * np.abs(ref).max())
    # the algebraic row of each sensitivity holds the linearized constraint
    # s_x + s_y + s_z = 0 (x + y + z = 1 for every p)
    assert float(tS.sum(-1).abs().max()) < 1e-12


@pytest.mark.parametrize("B", [None, 3])
def test_apply_reset_matches_jax(B):
    """The sensitivity jump across the exponential decay's reset (root
    y0 - 0.6, reset to p[1]) at random rows and states, against JAX's to
    1e-12."""
    jp = jed.problem_with_reset()
    tp = problem_from_jax(jp, ted.rhs, ted.init, root=ted.root, reset=ted.reset)
    lock = B is not None
    if lock:
        jp, tp = jax_lockstep_problem(jp, B), dtt.make_lockstep_problem(tp, B)
    rng = np.random.default_rng(8)
    shape = (2,) if not lock else (B, 2)
    y_m, y_p = np.full(shape, 0.6), np.ones(shape)
    dy_m, dy_p = -0.1 * y_m, -0.1 * y_p
    S = rng.standard_normal((2,) + shape)
    params = (np.stack([0.1 + 0.01 * np.arange(B), np.ones(B)], axis=1) if lock
              else np.asarray(jp.params))
    args = (y_m, dy_m, y_p, dy_p)
    jS = JaxSens(jp).apply_reset(jnp.asarray(5.1), *(_to_jax_rows(a, lock) for a in args),
                                 jnp.asarray(params), _to_jax_rows(S, lock),
                                 jnp.asarray(0))
    tS = SensEquations(tp).apply_reset(_t(5.1), *(_t(a) for a in args), _t(params), _t(S), 0)
    ref = _from_jax_rows(jS, lock)
    np.testing.assert_allclose(tS.numpy(), ref, rtol=PARTS_TOL,
                               atol=PARTS_TOL * np.abs(ref).max())


def test_block_tier_rows_match_the_dense_jacobian():
    """robertson_ode's five groups on the block tier (one (5, 3, 3) LU
    stack; lockstep, one (15, 3, 3) stack) against the same problem with
    its dense Jacobian: equal steps, rows within 1e-8 of the largest."""
    t_eval = [0.4, 4.0, 40.0]
    blk, dense = trob.problem_ode_groups(5), trob.problem_ode_groups(5, use_coloring=False)
    assert blk.linear_solver.name == "blockdiag(3,5)" and dense.linear_solver.name == "dense"
    params = _lockstep_params(3, 9)
    for run in (
        lambda pr: dtt.solve_dense(dtt.BdfSolver(pr, sens=True), t_eval, max_steps=4000,
                                   device="cpu"),
        lambda pr: dtt.solve_dense_ensemble(lambda q: dtt.BdfSolver(q, sens=True), pr,
                                            t_eval, params, max_steps=4000, device="cpu"),
    ):
        got, ref = run(blk), run(dense)
        assert got.stop_reason == ref.stop_reason == errors.TSTOP_REACHED
        assert got.state.stats.steps == ref.state.stats.steps
        scale = float(ref.sens.abs().max())
        np.testing.assert_allclose(got.sens.numpy(), ref.sens.numpy(), rtol=0,
                                   atol=1e-8 * scale)


def _band_rows(seed, naug=3, B=5, n=24, ml=2, mu=3):
    """A random diagonally dominant (B, nb, n) band and (naug, B, n) rows."""
    rng = np.random.default_rng(seed)
    band = rng.standard_normal((B, ml + mu + 1, n))
    band[:, mu] += 2.0 * (ml + mu + 1)
    band *= tb._band_index(n, ml, mu)[1]
    return band, rng.standard_normal((naug, B, n)), ml, mu


def test_banded_rows_match_jax_xla():
    """(naug, B, n) rows through the banded tier's solve (one naug-major
    (naug B, n) plain band LU solve, row r against member r mod B) against
    the JAX tier's f64 loop on (naug, n, B) rows, to 1e-12.  (JAX's
    ``kernel="auto"`` resolves to ``"xla"`` on the CPU; an explicit
    ``kernel="xla"`` cannot solve augmented rows in lockstep, ROADMAP.md
    queue 3.)"""
    band, rows, ml, mu = _band_rows(10)
    jspec = jb.make_banded_solver(ml, mu)
    assert jspec.meta[2] == "xla"
    jx = np.asarray(jspec.solve(jspec.factor(jnp.asarray(np.moveaxis(band, 0, -1))),
                                jnp.asarray(np.swapaxes(rows, -1, -2))))
    tspec = tb.make_banded_solver(ml, mu)
    tx = tspec.solve(tspec.factor(_t(band)), _t(rows)).numpy()
    np.testing.assert_allclose(tx, np.swapaxes(jx, -1, -2), rtol=PARTS_TOL,
                               atol=PARTS_TOL * np.abs(jx).max())
    # the same as row-by-row solves, and one factorization serves all rows
    F = band_lu.band_lu_factor(_t(band), ml, mu)
    for a in range(rows.shape[0]):
        np.testing.assert_allclose(tx[a], band_lu.band_lu_solve(F, _t(rows[a]), ml, mu).numpy(),
                                   rtol=1e-14, atol=1e-14)
    F1 = band_lu.band_lu_factor(_t(band[:1]), ml, mu)
    x1 = band_lu.band_lu_solve(F1, _t(rows.reshape(-1, rows.shape[-1])), ml, mu)
    np.testing.assert_allclose(
        x1.numpy(), band_lu.band_lu_solve_reference(
            F1.lu.expand(-1, -1, x1.shape[0]).contiguous(), _t(rows.reshape(-1, rows.shape[-1])),
            ml, mu).numpy(), rtol=1e-15, atol=0)


def test_banded_rows_match_jax_pallas_interpret():
    """The same rows against the JAX tier's f32 Pallas kernels in interpret
    mode (the factors repeated naug times, folded into the lanes), to
    float32's 1e-4: both compute one function."""
    band, rows, ml, mu = _band_rows(11)
    jspec = jb.make_banded_solver(ml, mu, kernel="pallas")
    jx = np.asarray(jspec.solve(jspec.factor(jnp.asarray(np.moveaxis(band, 0, -1))),
                                jnp.asarray(np.swapaxes(rows, -1, -2))))
    tspec = tb.make_banded_solver(ml, mu)
    tx = tspec.solve(tspec.factor(_t(band)), _t(rows)).numpy()
    assert np.max(np.abs(tx - np.swapaxes(jx, -1, -2))) < 1e-4


def test_banded_lockstep_sensitivities_match_jax():
    """heat1d n=33, B=8 diffusivities through the banded tier with
    BdfSolver(sens=True) in lockstep, against JAX lockstep on its f64 band
    loop: equal steps and Newton iterations, rows within 1e-9 of the
    largest."""
    t_eval = [0.01, 0.05, 0.2]
    params = np.linspace(0.5, 2.0, 8)[:, None]
    jp, _ = jheat.make(mgrid=32, rtol=1e-6, atol=1e-8)
    jp = dataclasses.replace(
        jp, linear_solver=jb.make_banded_solver(1, 1),
        eqn=dataclasses.replace(jp.eqn, rhs_jac=jb.make_banded_jac(jp.eqn.rhs, 1, 1)))
    jsol = dt.solve_dense(dt.BdfSolver(jax_lockstep_problem(jp, 8), sens=True),
                          jnp.asarray(t_eval), params=jnp.asarray(params), max_steps=2000)
    tp, _ = theat.make(mgrid=32, rtol=1e-6, atol=1e-8, banded=True)
    sol = dtt.solve_dense_ensemble(lambda p: dtt.BdfSolver(p, sens=True), tp, t_eval,
                                   params, mode="lockstep", device="cpu")
    assert sol.stop_reason == int(jsol.stop_reason) == errors.TSTOP_REACHED
    assert sol.state.stats.steps == int(jsol.state.stats.steps)
    assert sol.state.stats.newton_iterations == int(jsol.state.stats.newton_iterations)
    js = np.asarray(jsol.sens)
    ts = solution_to_numpy(sol)["sens"]
    assert ts.shape == js.shape == (3, 1, 33, 8)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-9 * np.abs(js).max())


def test_fwd_sens_refuses_the_band_kernels():
    """Forward mode through a band kernel launch would read zero tangents:
    the launch wrappers refuse a tensor under torch.func.jvp, naming the
    continuous route, before they look for a card."""
    band, rows, ml, mu = _band_rows(12, naug=1)
    F = band_lu.band_lu_factor(_t(band), ml, mu)
    b = _t(rows[0])

    def through_k4(x):
        return band_lu.launch_band_lu_solve(F.lu, x, ml, mu)

    def through_k3(x):
        return band_lu.launch_band_lu_factor(x, ml, mu)

    for fn, x in ((through_k4, b), (through_k3, _t(band))):
        with pytest.raises(RuntimeError, match=r"BdfSolver\(problem, sens=True\)"):
            torch.func.jvp(fn, (x,), (torch.ones_like(x),))
    # the plain version on the CPU carries the tangent: d(A^-1 b)/db = A^-1
    _, tangent = torch.func.jvp(lambda x: band_lu.band_lu_solve(F, x, ml, mu), (b,), (b,))
    np.testing.assert_allclose(tangent.numpy(), band_lu.band_lu_solve(F, b, ml, mu).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_fused_and_auto_modes_with_a_sensitivity_solver():
    """JAX's fused tier takes no notice of a sens=True factory and returns
    sens=None without a word (ROADMAP.md queue 3); the port's fused mode
    raises and its auto mode goes lockstep, returning the rows."""
    B = 4
    params = _lockstep_params(B, 13)
    t_eval = [0.4, 4.0]
    # the problem and shapes of tests/test_pallas_stepper.py's fused-mode
    # call, whose compiled kernel the persistent cache then holds once
    jp = jrob.problem_ode(rtol=1e-4, atol=(1e-8, 1e-6, 1e-6))
    jsol = jax_ensemble(lambda p: dt.BdfSolver(p, sens=True), jp, t_eval,
                        jnp.asarray(params), mode="fused", interpret=True)
    assert jsol.tier.startswith("fused") and jsol.sens is None
    tp = problem_from_jax(jp, trob.rhs_ode, trob.init)

    def make(p):
        return dtt.BdfSolver(p, sens=True)

    with pytest.raises(UnsupportedForKernel, match="lockstep"):
        dtt.solve_dense_ensemble(make, tp, t_eval, params, mode="fused", device="cpu")
    auto = dtt.solve_dense_ensemble(make, tp, t_eval, params, mode="auto", device="cpu")
    assert auto.tier == "lockstep" and auto.sens.shape == (2, 3, B, 3)
    # the ys JAX's fused tier returned are the same solution's
    np.testing.assert_allclose(auto.ys.numpy(), np.asarray(jsol.ys), rtol=1e-3, atol=1e-8)
    assert bool(torch.isfinite(auto.sens).all())


def test_sens_mul_and_transpose_match_jax():
    """(df/dp) v by forward mode and (df/dp)^T w by reverse mode on the
    Robertson ODE at a random state, against the JAX equations' to
    1e-12."""
    jp, tp = _robertson_pair("ode")
    rng = np.random.default_rng(14)
    y, v, w = rng.uniform(0.0, 1.0, 3), rng.standard_normal(3), rng.standard_normal(3)
    for name, arg in (("sens_mul", v), ("sens_transpose_mul", w)):
        ref = np.asarray(getattr(jp.eqn, name)(jnp.asarray(0.5), jnp.asarray(y), jp.params,
                                                jnp.asarray(arg)))
        got = getattr(tp.eqn, name)(_t(0.5), _t(y), tp.params, _t(arg)).numpy()
        np.testing.assert_allclose(got, ref, rtol=PARTS_TOL, atol=PARTS_TOL * np.abs(ref).max())


@pytest.mark.parametrize("tier", ["dense", "dense_lockstep", "blockdiag", "blockdiag_lockstep"])
def test_rows_through_the_lu_tiers_in_one_call(tier):
    """(naug, n) and lockstep (naug, B, n) rows through the dense and block
    tiers' ``solve`` in one broadcast ``lu_solve``, against a solve a row,
    to 1e-14."""
    rng = np.random.default_rng(15)
    problem = trob.problem_ode_groups(4, use_coloring=tier.startswith("blockdiag"))
    lock = tier.endswith("lockstep")
    if lock:
        problem = dtt.make_lockstep_problem(problem, 3)
    spec = problem.linear_solver
    shape = (3, 12) if lock else (12,)
    params = _t(_lockstep_params(3, 16)) if lock else problem.params
    jac = problem.eqn.jac(_t(0.0), _t(rng.uniform(0.0, 1.0, shape)), params)
    factors = spec.factor(spec.assemble(None, jac, 0.3))
    rows = _t(rng.standard_normal((5,) + shape))
    got = spec.solve(factors, rows)
    assert got.shape == rows.shape
    for a in range(rows.shape[0]):
        np.testing.assert_allclose(got[a].numpy(), spec.solve(factors, rows[a]).numpy(),
                                   rtol=1e-14, atol=1e-14)
