"""The 2-D method-of-lines DAEs, heat2d and foodweb: the port against the
JAX package.

Both models are built ONCE in JAX and carried across with
``interop.problem_from_jax(..., model=...)``, so the port's callables run
on the JAX problem's own arrays (mass diagonal, hence the interior mask,
and initial state), band spec and tolerances; the rhs, its band Jacobian
and the codegen's IR are compared on inputs from a numpy seed.  Then:
``solve_dense`` through the banded and the dense tier against JAX
``solve_dense`` (rtol 5e-4, atol 1e-6: tests/test_banded.py:78,
tests/test_models.py:55), banded ``make_consistent`` against JAX's
(1e-10), the fused banded tier's plain version (K2's) on heat2d and on
foodweb, whose inconsistent ``init`` goes through the host-side
consistent-IC solve, against the port's lockstep path at the solver's
tolerance, and on heat2d against the Pallas kernel in interpret mode with
equal accepted steps.  Small sizes: heat2d mgrid = 5 and 6 (n = 25, 36),
foodweb nx = 4 (n = 32, ml = mu = 8).  The Dirichlet-row DAE and the wide
stencil of tests/test_pallas_band.py are in tests/test_torch_band_stepper.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.models import foodweb as jfood
from diffsol_tpu.models import heat2d as jheat
from diffsol_tpu.ops.banded import make_banded_solver as jax_banded_solver
from diffsol_tpu.solvers import consistent_ic as jic

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import foodweb as tfood
from diffsol_tpu_torch.models import heat2d as theat
from diffsol_tpu_torch.ops import eqn_codegen as cg
from diffsol_tpu_torch.ops import fused_band_stepper as fb
from diffsol_tpu_torch.ops.banded import dense_to_band
from diffsol_tpu_torch.solvers import consistent_ic as tic

torch.set_num_threads(1)
F64 = torch.float64
SOLVER_RTOL, SOLVER_ATOL = 5e-4, 1e-6
HEAT_T = [0.01, 0.03, 0.1]
FOOD_T = [1e-3, 1e-2, 1e-1]
MGRID, NX = 6, 4


def _jax_problem(name, banded=True):
    if name == "heat2d":
        p = jheat.make(mgrid=MGRID, banded=False)
        band = MGRID
    else:
        p = jfood.make(nx=NX, banded=False)
        band = 2 * NX
    if not banded:
        return p
    # the f64 XLA band path, as the JAX package's own CPU tests run it
    import dataclasses

    from diffsol_tpu.ops.banded import make_banded_jac

    spec = jax_banded_solver(band, band, kernel="xla")
    eqn = dataclasses.replace(p.eqn, rhs_jac=make_banded_jac(p.eqn.rhs, band, band))
    return dataclasses.replace(p, eqn=eqn, linear_solver=spec)


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX problem, the port's problem carried from it), banded."""
    out = {}
    for name in ("heat2d", "foodweb"):
        jp = _jax_problem(name)
        out[name] = (jp, problem_from_jax(jp, model=name))
    return out


@pytest.mark.parametrize("name", ["heat2d", "foodweb"])
def test_model_carried_from_jax_has_its_constants_and_band(pairs, name):
    jp, tp = pairs[name]
    band = MGRID if name == "heat2d" else 2 * NX
    assert tp.linear_solver.name == f"banded({band},{band})"
    assert tp.eqn.nstates == jp.eqn.nstates and tp.eqn.nout == jp.eqn.nout
    assert float(tp.rtol) == float(jp.rtol)
    np.testing.assert_array_equal(tp.atol.numpy(), np.asarray(jp.atol))
    t0 = torch.tensor(0.0, dtype=F64)
    np.testing.assert_array_equal(tp.eqn.init(t0, tp.params).numpy(),
                                  np.asarray(jp.eqn.init(jp.t0, jp.params)))
    np.testing.assert_array_equal(tp.eqn.mass_diag_fn(t0, tp.params).numpy(),
                                  np.asarray(jp.eqn.mass_diag_fn(jp.t0, jp.params)))
    # the package's own model has the same constants
    mine = theat.make(MGRID) if name == "heat2d" else tfood.make(NX)
    np.testing.assert_array_equal(mine.eqn.init(t0, mine.params).numpy(),
                                  tp.eqn.init(t0, tp.params).numpy())
    np.testing.assert_array_equal(mine.eqn.mass_diag_fn(t0, mine.params).numpy(),
                                  tp.eqn.mass_diag_fn(t0, tp.params).numpy())
    assert mine.linear_solver.name == tp.linear_solver.name
    if name == "foodweb":
        assert tfood.SOLN.tolist() == jfood.SOLN.tolist()
        u = np.random.default_rng(2).uniform(size=(3, 2 * NX * NX))
        np.testing.assert_array_equal(tfood.corner_values(u, NX),
                                      jfood.corner_values(u, NX))


@pytest.mark.parametrize("name", ["heat2d", "foodweb"])
def test_rhs_band_jacobian_and_ir_match_jax(pairs, name):
    """Same seeded state through both packages: rhs to 1e-13 relative, the
    41-probe-style colored band Jacobian to 1e-12, and the codegen's IR
    (value and dual) against the callable and ``jacfwd``."""
    jp, tp = pairs[name]
    n = tp.eqn.nstates
    rng = np.random.default_rng(7)
    y = rng.uniform(0.5, 1.5, n) * (1e3 if name == "foodweb" else 1.0)
    ty, t = torch.tensor(y), torch.tensor(0.2, dtype=F64)
    f_j = np.asarray(jp.eqn.rhs(jnp.asarray(0.2), jnp.asarray(y), jp.params))
    f_t = tp.eqn.rhs(t, ty, tp.params)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-13, atol=1e-13 * np.abs(f_j).max())
    band_j = np.asarray(jp.eqn.rhs_jac(jnp.asarray(0.2), jnp.asarray(y), jp.params))
    band_t = tp.eqn.rhs_jac(t, ty, tp.params)
    np.testing.assert_allclose(band_t.numpy(), band_j, rtol=1e-12,
                               atol=1e-12 * np.abs(band_j).max())
    ir = cg.trace_ir(tp.eqn.rhs, ("t", "y", "p"), (None, n, 1))
    assert len(ir.outputs) == n
    assert not any(node[0] == "where" for node in ir.nodes)  # constant masks fold
    np.testing.assert_allclose(cg.eval_rhs(ir, t, ty, tp.params).numpy(), f_t.numpy(),
                               rtol=1e-13, atol=1e-13 * np.abs(f_j).max())
    dense = torch.func.jacfwd(tp.eqn.rhs, argnums=1)(t, ty, tp.params)
    np.testing.assert_allclose(cg.jacobian(ir, t, ty, tp.params).numpy(), dense.numpy(),
                               rtol=1e-12, atol=1e-12 * float(dense.abs().max()))
    ml, mu = tp.linear_solver.meta
    np.testing.assert_array_equal(dense_to_band(dense, ml, mu).numpy(), band_t.numpy())
    header = cg.emit_cuda_header(cg.trace_model(tp.eqn.rhs, None, n, 1))
    assert f"#define MODEL_N {n}" in header and f"out[{n - 1}] =" in header


@pytest.mark.parametrize("name,banded", [("heat2d", True), ("heat2d", False),
                                         ("foodweb", True), ("foodweb", False)])
def test_solve_dense_matches_jax(pairs, name, banded):
    """``solve_dense`` through the banded tier and the dense one against JAX
    ``solve_dense`` of the same problem, rtol 5e-4 / atol 1e-6; foodweb
    starts from its raw inconsistent ``init``."""
    jp = pairs[name][0] if banded else _jax_problem(name, banded=False)
    tp = pairs[name][1] if banded else problem_from_jax(jp, model=name)
    assert tp.linear_solver.name.startswith("banded") == banded
    te = HEAT_T if name == "heat2d" else FOOD_T
    ref = dt.solve_dense(dt.BdfSolver(jp), jnp.asarray(te), max_steps=3000)
    sol = dtt.solve_dense(dtt.BdfSolver(tp), te, max_steps=3000, device="cpu")
    assert sol.stop_reason == int(ref.stop_reason) == dtt.errors.TSTOP_REACHED
    ref_ys = np.asarray(ref.ys)
    np.testing.assert_allclose(sol.ys.numpy(), ref_ys, rtol=SOLVER_RTOL,
                               atol=SOLVER_ATOL * max(1.0, np.abs(ref_ys).max()))
    assert abs(int(sol.state.stats.steps) - int(ref.state.stats.steps)) <= 3
    if name == "heat2d":  # the algebraic boundary rows stay at 0
        md = tp.eqn.mass_diag_fn(tp.t0, tp.params).numpy()
        np.testing.assert_allclose(sol.ys.numpy()[:, md == 0.0], 0.0, atol=1e-9)


@pytest.mark.parametrize("batched", [False, True])
def test_banded_make_consistent_matches_jax(pairs, batched):
    """The banded branch (ml+mu+1 cyclic probes of the packed residual,
    factored by the band LU) against JAX's, on foodweb's inconsistent
    ``init``: y and dy to 1e-10 relative, for one problem and for a
    lockstep batch of three."""
    jp, tp = pairs["foodweb"]
    t0 = torch.tensor(0.0, dtype=F64)
    y0 = tp.eqn.init(t0, tp.params)
    md = tp.eqn.mass_diag_fn(t0, tp.params)
    is_alg = md == 0.0
    f0 = tp.eqn.rhs(t0, y0, tp.params)
    assert float(f0[is_alg].abs().max()) > 1.0  # inconsistent as given
    dy0 = torch.where(is_alg, 0.0, f0)
    jy0 = jp.eqn.init(jp.t0, jp.params)
    jf0 = jp.eqn.rhs(jp.t0, jy0, jp.params)
    j_alg = jnp.asarray(is_alg.numpy())
    y_j, dy_j, st_j = jic.make_consistent(jp, jp.params, jy0, jnp.where(j_alg, 0.0, jf0),
                                          j_alg)
    assert int(st_j) >= 0
    if batched:
        from diffsol_tpu_torch.ensemble import make_lockstep_problem

        lp = make_lockstep_problem(tp, 3)
        y, dy, st = tic.make_consistent(lp, lp.params, y0.expand(3, -1).contiguous(),
                                        dy0.expand(3, -1).contiguous(), is_alg)
        assert torch.equal(y[0], y[2]) and torch.equal(dy[0], dy[1])
        y, dy = y[1], dy[1]
    else:
        y, dy, st = tic.make_consistent(tp, tp.params, y0, dy0, is_alg)
    assert st >= 0
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-10)
    np.testing.assert_allclose(dy.numpy(), np.asarray(dy_j), rtol=1e-10,
                               atol=1e-10 * float(dy.abs().max()))
    # Newton stops on the WRMS norm of its correction: the algebraic
    # residual fell by more than a thousand, and only algebraic states moved
    f1 = tp.eqn.rhs(t0, y, tp.params)
    assert float(f1[is_alg].abs().max()) < 1e-3 * float(f0[is_alg].abs().max())
    assert float(((y - y0)[~is_alg]).abs().max()) == 0.0


@pytest.mark.parametrize("name", ["heat2d", "foodweb"])
def test_fused_band_plain_version_matches_lockstep(pairs, name):
    """K2's plain version through ``mode="fused"`` against the port's
    lockstep path (the band LU's plain versions), B = 3 identical members:
    both end TSTOP and agree at the solver's tolerance; foodweb's
    consistent-IC solve runs on the host side of the fused tier."""
    tp = pairs[name][1]
    te, ms = (HEAT_T, 100_000) if name == "heat2d" else (FOOD_T, 3000)
    pb = np.ones((3, 1))
    fused = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, te, pb, mode="fused",
                                     max_steps=ms, device="cpu")
    lock = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, te, pb, mode="lockstep",
                                    max_steps=ms, device="cpu")
    assert fused.tier == "fused_band_reference" and lock.tier == "lockstep"
    assert fused.stop_reason == lock.stop_reason == dtt.errors.TSTOP_REACHED
    assert fused.gs is None  # heat2d's out() is not integrated
    scale = max(1.0, float(lock.ys.abs().max()))
    np.testing.assert_allclose(fused.ys.numpy(), lock.ys.numpy(), rtol=SOLVER_RTOL,
                               atol=SOLVER_ATOL * scale)
    assert torch.equal(fused.ys[:, 0], fused.ys[:, 2])
    solve = fb.make_fused_band_bdf_solve(tp, te, 3, max_steps=ms)
    assert solve.cfg.needs_ic_solve == (name == "foodweb")
    assert solve.cfg.ml == solve.cfg.mu == (MGRID if name == "heat2d" else 2 * NX)


def _heat2d_float_mask(lib, mgrid):
    """heat2d with its interior mask as a float factor, m lap + (1 - m) y:
    the Pallas band kernel takes float array constants only (a boolean
    ``where`` mask is a captured constant it refuses), the port takes
    both."""
    n = mgrid * mgrid
    dx = 1.0 / (mgrid - 1)
    idx = np.arange(n)
    ii, jj = idx % mgrid, idx // mgrid
    interior = (ii > 0) & (ii < mgrid - 1) & (jj > 0) & (jj < mgrid - 1)
    m = np.where(interior, 1.0, 0.0)
    u0 = m * 16.0 * (ii * dx) * (1.0 - ii * dx) * (jj * dx) * (1.0 - jj * dx)
    if lib is jnp:
        mc, u0c, asarray = jnp.asarray(m), jnp.asarray(u0), jnp.asarray
    else:
        mc, u0c, asarray = torch.tensor(m), torch.tensor(u0), torch.as_tensor

    def rhs(t, y, p):
        u = y.reshape(mgrid, mgrid)
        lap = (lib.roll(u, 1, 0) + lib.roll(u, -1, 0) + lib.roll(u, 1, 1)
               + lib.roll(u, -1, 1) - 4.0 * u).reshape(-1) / (dx * dx)
        return mc * lap + (1.0 - mc) * y

    return rhs, (lambda t, p: u0c + 0.0), (lambda t, p: lib.diag(mc))


def test_fused_band_plain_version_matches_pallas_interpret_on_heat2d():
    """A 2-D heat DAE, mgrid = 5 (n = 25, ml = mu = 5, 11 colored probes,
    algebraic boundary rows), through the Pallas band kernel in interpret
    mode and K2's plain version, B = 2 in one tile: equal accepted steps,
    and ys to 1e-6 of the largest value (the JAX kernel keeps its norms and
    controller in float32 and its state in double-float)."""
    from diffsol_tpu.ops.pallas_stepper_band import make_pallas_band_bdf_solve

    mgrid = 5
    jrhs, jinit, jmass = _heat2d_float_mask(jnp, mgrid)
    jp = (dt.OdeBuilder().rhs(jrhs).init(jinit).mass(jmass).p([1.0]).rtol(1e-5).atol(1e-5)
          .linear_solver(jax_banded_solver(mgrid, mgrid)).build())
    trhs, tinit, tmass = _heat2d_float_mask(torch, mgrid)
    tp = problem_from_jax(jp, trhs, tinit, mass=tmass)
    assert tp.linear_solver.name == "banded(5,5)"
    te = [0.01, 0.05]
    ys_j, status_j, steps_j = make_pallas_band_bdf_solve(
        jp, te, nbatch=2, tile=2, interpret=True)(jnp.ones((2, 1)))
    ys, status, steps = fb.make_fused_band_bdf_solve(tp, te, 2)(torch.ones(2, 1, dtype=F64))
    assert int(jnp.min(status_j)) >= 0 and status.tolist() == [0]
    assert steps.tolist() == np.asarray(steps_j).tolist()
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=1e-6,
                               atol=1e-6 * float(ys.abs().max()))
    # the port's own heat2d (a boolean mask) takes the same steps
    ys_b, _, steps_b = fb.make_fused_band_bdf_solve(theat.make(mgrid), te, 2)(
        torch.ones(2, 1, dtype=F64))
    assert steps_b.tolist() == steps.tolist()
    np.testing.assert_allclose(ys_b.numpy(), ys.numpy(), rtol=1e-9, atol=1e-12)


def _with_roundoff_noise(problem):
    """The problem with its rhs perturbed by one unit of roundoff, 1.2e-16
    relative with a sign that changes from value to value: what another
    order of the same float64 operations does to it."""
    import dataclasses

    rhs0 = problem.eqn.rhs

    def noisy(t, y, p):
        f = rhs0(t, y, p)
        return f * (1.0 + 1.2e-16 * torch.sin(f * 12345.678 + 1.0))

    return dataclasses.replace(problem, eqn=dataclasses.replace(problem.eqn, rhs=noisy))


def test_foodweb_steps_are_sensitive_to_roundoff_and_heat2d_is_not():
    """Why K2 is held to its plain version by equal steps and 1e-9 on heat2d
    but by the solver's tolerance on foodweb: one unit of roundoff on the
    rhs of the plain version itself changes foodweb's accepted steps and
    moves its trajectory by ~1e-5 relative (inside 10 error weights),
    while heat2d keeps its steps and moves by ~1e-14.  Early in foodweb's
    transient the error estimate is ~1e-10, so roundoff in d = x - y_pred
    is 1e-8 of it, and the growing dynamics carry that into the step-size
    decisions."""
    one = torch.ones(1, 1, dtype=F64)
    moved = {}
    for name, problem, te, ms in (("foodweb", tfood.make(NX), FOOD_T, 3000),
                                  ("heat2d", theat.make(MGRID), HEAT_T, 100_000)):
        solve = fb.make_fused_band_bdf_solve(problem, te, 1, max_steps=ms)
        ys, status, steps = solve(one)
        ys_n, status_n, steps_n = fb._finish(solve.cfg, *fb.fused_band_bdf_reference(
            solve.cfg, _with_roundoff_noise(problem), one))
        assert status.tolist() == status_n.tolist() == [0]
        w = float(problem.rtol) * ys.abs() + problem.atol[None, :, None]
        moved[name] = (int(steps[0]) - int(steps_n[0]),
                       float(((ys - ys_n).abs() / ys.abs().clamp(min=1e-300)).max()),
                       float(((ys - ys_n).abs() / w).max()))
    assert moved["heat2d"][0] == 0 and moved["heat2d"][1] < 1e-12
    assert moved["foodweb"][0] != 0
    assert 1e-7 < moved["foodweb"][1] and moved["foodweb"][2] < 10.0


def test_wide_band_tile_and_scratch_follow_the_jax_rule():
    """At the 2-D models' full sizes the JAX tile rule gives 128
    (pallas_stepper_band.py:201-222), and a member's scratch in the CUDA
    kernel is D, J, the factored band and three state vectors."""
    for n, half, neval in ((400, 20, 3), (200, 20, 3)):
        nb = 2 * half + 1
        assert fb.default_tile(n, nb, half, 20, neval) == 128
        cfg = fb.BandConfig(
            n=n, nparams=1, t0=0.0, rtol=1e-5, atol=(1e-5,) * n, t_eval=(0.1,) * neval,
            nbatch=1024, tile=128, ntiles=8, max_steps=10, max_newton_iter=10,
            max_newton_fails=50, max_error_test_fails=40, min_timestep=1e-32,
            nl_tol=0.2, ki=0.5, kp=0.0, update_jacobian_after_steps=20,
            update_rhs_jacobian_after_steps=50, threshold_to_update_jacobian=0.3,
            jac_reuse=True, ml=half, mu=half)
        assert fb.scratch_doubles(cfg) == 8 * n + n * nb + (n + half) * nb + 3 * n
