"""Outputs and their quadrature: the port against the JAX package.

``solve_dense`` and ``solve`` with ``integrate_out`` (with and without an ``out``
function, with and without error control) and with ``out`` alone against
JAX ``solve_dense`` / ``solve`` (gs to 1e-6), the lockstep ensemble, and
the fused tier's plain version against the Pallas kernel in interpret mode
at the configurations of tests/test_pallas_stepper.py:275 (quadrature of
the state) and :307 (an explicit out() whose out_rtol/out_atol join the
error test), B = 4 in one tile.  On this smooth, non-stiff decay the two
kernels do NOT take equal steps: the JAX kernel, with its norms, rates and
controller in float32, takes 45 accepted steps where the float64 port
takes 50, with or without the quadrature (so the difference lies in the
ODE stepping both share, not in gD; ROADMAP.md queue 3 logs it).  With
different step sequences ys and gs agree at the solver's tolerance, 1e-5
relative, the bound the JAX package's own tests hold against the closed
forms.  Each JAX solve runs once, in a module-scoped fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.ensemble import solve_dense_ensemble as jax_ensemble
from diffsol_tpu.models import exponential_decay as jed

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.drivers import solve as torch_solve
from diffsol_tpu_torch.interop import problem_from_jax, solution_to_numpy
from diffsol_tpu_torch.models import exponential_decay as ted
from diffsol_tpu_torch.models import fused_cases as fc
from diffsol_tpu_torch.ops import fused_stepper as fs

torch.set_num_threads(1)

B = 4
FUSED_RTOL, FUSED_ATOL = 1e-5, 1e-12
# accepted steps, port minus JAX kernel: 50 - 45 and 60 - 55 measured
FUSED_STEP_SLACK = 6
A_QUAD = 0.1 * (1.0 + 0.05 * np.linspace(-1.0, 1.0, B))
P_QUAD = np.stack([A_QUAD, np.ones(B)], axis=1)
P_QUAD_ERR = np.full((B, 1), 0.5)
T_EAGER = [1.0, 5.0, 10.0]


def _jax_quad_err_problem():
    return (dt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y)
            .init(lambda t, p: jnp.array([1.0]))
            .out(lambda t, y, p: jnp.array([y[0] * y[0]]))
            .p([0.5]).rtol(1e-6).atol(1e-8).integrate_out()
            .out_rtol(1e-6).out_atol(1e-8).build())


@pytest.fixture(scope="module")
def jax_runs():
    quad = (dt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y)
            .init(lambda t, p: jnp.array([p[1], 2.0 * p[1]]))
            .p([0.1, 1.0]).rtol(1e-6).atol(1e-8).integrate_out().build())
    quad_err = _jax_quad_err_problem()
    f_quad = jax_ensemble(dt.BdfSolver, quad, fc.QUAD_T_EVAL, jnp.asarray(P_QUAD),
                          mode="fused", interpret=True)
    f_err = jax_ensemble(dt.BdfSolver, quad_err, fc.QUAD_ERR_T_EVAL,
                         jnp.asarray(P_QUAD_ERR), mode="fused", interpret=True)
    te = jnp.asarray(T_EAGER)
    e_quad = dt.solve_dense(dt.BdfSolver(jed.problem(integrate_out=True)), te)
    e_err = dt.solve_dense(dt.BdfSolver(quad_err), te)
    adaptive = dt.solve(dt.BdfSolver(quad_err), 4.0, max_steps=300)
    n = int(adaptive.n_points)

    def packed(sol):
        return dict(ys=np.asarray(sol.ys), gs=np.asarray(sol.gs),
                    stop=int(sol.stop_reason),
                    steps=(None if sol.tile_steps is None
                           else np.asarray(sol.tile_steps)))

    return dict(
        quad_err_problem=quad_err, f_quad=packed(f_quad), f_err=packed(f_err),
        e_quad=packed(e_quad), e_err=packed(e_err),
        e_err_steps=int(e_err.state.stats.steps),
        adaptive=dict(n=n, ts=np.asarray(adaptive.ts)[:n],
                      gs=np.asarray(adaptive.gs)[:n]),
    )


@pytest.fixture(scope="module")
def port_quad_err(jax_runs):
    return problem_from_jax(jax_runs["quad_err_problem"], fc.decay_rhs, fc.decay_init,
                            out=fc.square_out)


def test_problem_from_jax_carries_the_output_fields(jax_runs, port_quad_err):
    p = port_quad_err
    assert p.integrate_out and p.eqn.nout == 1 and p.output_in_error_control()
    assert float(p.out_rtol) == 1e-6 and p.out_atol.tolist() == [1e-8]
    mine = fc.quadrature_err_problem()
    assert float(mine.out_rtol) == float(p.out_rtol)
    assert mine.out_atol.tolist() == p.out_atol.tolist()
    assert not ted.problem(integrate_out=True).output_in_error_control()


def test_fused_quadrature_matches_pallas_interpret(jax_runs):
    ref = jax_runs["f_quad"]
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, fc.quadrature_problem(), fc.QUAD_T_EVAL,
                                   P_QUAD, mode="fused", tile=B, device="cpu")
    assert sol.tier == "fused_small_reference"
    assert sol.stop_reason == ref["stop"] == dtt.errors.TSTOP_REACHED
    assert abs(int(sol.tile_steps[0]) - int(ref["steps"][0])) <= FUSED_STEP_SLACK
    assert tuple(sol.gs.shape) == (3, B, 2)
    np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=FUSED_RTOL, atol=FUSED_ATOL)
    np.testing.assert_allclose(sol.gs.numpy(), ref["gs"], rtol=FUSED_RTOL, atol=FUSED_ATOL)
    exact = (1.0 - np.exp(-A_QUAD[None, :] * np.asarray(fc.QUAD_T_EVAL)[:, None])) / A_QUAD
    np.testing.assert_allclose(sol.gs[:, :, 0].numpy(), exact, rtol=1e-5)
    np.testing.assert_allclose(sol.gs[:, :, 1].numpy(), 2.0 * exact, rtol=1e-5)
    assert solution_to_numpy(sol)["gs"].shape == (3, B, 2)


def test_fused_quadrature_error_control_matches_pallas_interpret(jax_runs, port_quad_err):
    ref = jax_runs["f_err"]
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, port_quad_err, fc.QUAD_ERR_T_EVAL,
                                   P_QUAD_ERR, mode="fused", tile=B, device="cpu")
    assert sol.stop_reason == ref["stop"] == dtt.errors.TSTOP_REACHED
    assert abs(int(sol.tile_steps[0]) - int(ref["steps"][0])) <= FUSED_STEP_SLACK
    np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=FUSED_RTOL, atol=FUSED_ATOL)
    np.testing.assert_allclose(sol.gs.numpy(), ref["gs"], rtol=FUSED_RTOL, atol=FUSED_ATOL)
    exact = 1.0 - np.exp(-np.asarray(fc.QUAD_ERR_T_EVAL))
    np.testing.assert_allclose(sol.gs[:, 0, 0].numpy(), exact, rtol=1e-5)
    # the error control costs steps: without it the tile takes fewer
    loose = dtt.solve_dense_ensemble(
        dtt.BdfSolver, dtt.OdeBuilder().rhs(fc.decay_rhs).init(fc.decay_init)
        .out(fc.square_out).p([0.5]).rtol(1e-6).atol(1e-8).integrate_out().build(),
        fc.QUAD_ERR_T_EVAL, P_QUAD_ERR, mode="fused", tile=B, device="cpu")
    assert int(loose.tile_steps[0]) < int(sol.tile_steps[0])


def test_fused_config_of_the_quadratures(port_quad_err):
    cfg = fs.make_fused_bdf_solve(fc.quadrature_problem(), fc.QUAD_T_EVAL, B).cfg
    assert (cfg.nquad, cfg.has_out, cfg.out_in_err, cfg.extended) == (2, False, False, True)
    solve = fs.make_fused_bdf_solve(port_quad_err, fc.QUAD_ERR_T_EVAL, B)
    cfg = solve.cfg
    assert (cfg.nquad, cfg.has_out, cfg.out_in_err) == (1, True, True)
    assert cfg.out_rtol == 1e-6 and cfg.out_atol == (1e-8,)
    assert "#define MODEL_OUT_IN_ERR 1" in solve.header and "model_out" in solve.header
    res = solve(torch.tensor(P_QUAD_ERR))
    assert set(res) == {"ys", "status", "steps", "n_points", "gs"}
    assert res["n_points"].tolist() == [2]


def test_solve_dense_quadrature_matches_jax(jax_runs, port_quad_err):
    ref = jax_runs["e_quad"]
    sol = dtt.solve_dense(dtt.BdfSolver(ted.problem(integrate_out=True)), T_EAGER,
                          device="cpu")
    assert sol.stop_reason == ref["stop"] == dtt.errors.TSTOP_REACHED
    np.testing.assert_allclose(sol.gs.numpy(), ref["gs"], rtol=1e-6)
    np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=1e-6)
    exact = (1.0 - np.exp(-0.1 * np.asarray(T_EAGER))) / 0.1
    np.testing.assert_allclose(sol.gs[:, 0].numpy(), exact, rtol=1e-4)
    ref = jax_runs["e_err"]
    sol = dtt.solve_dense(dtt.BdfSolver(port_quad_err), T_EAGER, device="cpu")
    assert sol.stop_reason == ref["stop"]
    assert abs(sol.state.stats.steps - jax_runs["e_err_steps"]) <= 2
    np.testing.assert_allclose(sol.gs.numpy(), ref["gs"], rtol=1e-6)
    np.testing.assert_allclose(sol.gs[:, 0].numpy(),
                               1.0 - np.exp(-np.asarray(T_EAGER)), rtol=1e-5)


def test_solve_records_the_quadrature_at_every_step(jax_runs, port_quad_err):
    ref = jax_runs["adaptive"]
    sol = torch_solve(dtt.BdfSolver(port_quad_err), 4.0, max_steps=300, device="cpu")
    assert sol.stop_reason == dtt.errors.TSTOP_REACHED
    assert abs(sol.n_points - ref["n"]) <= 2
    n = min(sol.n_points, ref["n"]) - 1  # the steps before the tstop landing
    np.testing.assert_allclose(sol.ts[:n].numpy(), ref["ts"][:n], rtol=1e-6)
    np.testing.assert_allclose(sol.gs[:n].numpy(), ref["gs"][:n], rtol=1e-6, atol=1e-12)
    last = sol.n_points - 1
    np.testing.assert_allclose(float(sol.ts[last]), 4.0, rtol=1e-12)
    np.testing.assert_allclose(float(sol.gs[last, 0]), 1.0 - np.exp(-4.0), rtol=1e-5)


def test_out_without_quadrature_is_evaluated_at_the_output_points():
    """With ``out`` and no ``integrate_out`` ``solve_dense`` returns out(t, y)
    (reference method.rs:965-999), in both packages."""
    jp = (dt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y)
          .init(lambda t, p: jnp.array([1.0]))
          .out(lambda t, y, p: jnp.array([y[0] * y[0]])).p([0.5]).rtol(1e-6).atol(1e-8)
          .build())
    ref = dt.solve_dense(dt.BdfSolver(jp), jnp.asarray(T_EAGER))
    tp = problem_from_jax(jp, fc.decay_rhs, fc.decay_init, out=fc.square_out)
    assert not tp.integrate_out and tp.eqn.nout == 1
    sol = dtt.solve_dense(dtt.BdfSolver(tp), T_EAGER, device="cpu")
    np.testing.assert_allclose(sol.gs.numpy(), np.asarray(ref.gs), rtol=1e-6)
    np.testing.assert_allclose(sol.gs[:, 0].numpy(), np.exp(-np.asarray(T_EAGER)), rtol=1e-4)
    # the fused tier integrates nothing then, and returns the plain triple
    solve = fs.make_fused_bdf_solve(tp, T_EAGER, B)
    assert solve.cfg.nquad == 0 and not solve.cfg.extended


def test_lockstep_quadrature_matches_the_members():
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, fc.quadrature_problem(), fc.QUAD_T_EVAL,
                                   P_QUAD, mode="lockstep", device="cpu")
    assert sol.tier == "lockstep" and tuple(sol.gs.shape) == (3, B, 2)
    exact = (1.0 - np.exp(-A_QUAD[None, :] * np.asarray(fc.QUAD_T_EVAL)[:, None])) / A_QUAD
    np.testing.assert_allclose(sol.gs[:, :, 0].numpy(), exact, rtol=1e-5)
    ind = dtt.solve_dense_ensemble(dtt.BdfSolver, fc.quadrature_problem(), fc.QUAD_T_EVAL,
                                   P_QUAD, mode="independent", device="cpu")
    np.testing.assert_allclose(ind.gs.numpy(), sol.gs.numpy(), rtol=1e-4)


def test_pallas_interpret_steps_are_its_cpu_product_rounding(jax_runs, monkeypatch):
    """The 45 accepted steps the Pallas kernel takes in interpret mode on
    this decay, against the port's 50, come from one effect of XLA's CPU
    backend on ``df32.mul`` (fused_cases.pallas_cpu_tile_product): with
    that rounding put on the plain version's three tile-scalar products,
    the port takes the JAX kernel's 45 steps exactly, and without it 50."""
    problem = fc.quadrature_problem()
    plain = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, fc.QUAD_T_EVAL, P_QUAD,
                                     mode="fused", tile=B, device="cpu")
    monkeypatch.setattr(fs, "_tile_mul", fc.pallas_cpu_tile_product)
    emulated = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, fc.QUAD_T_EVAL, P_QUAD,
                                        mode="fused", tile=B, device="cpu")
    ref = jax_runs["f_quad"]
    assert int(plain.tile_steps[0]) == 50
    assert emulated.tile_steps.tolist() == ref["steps"].tolist() == [45]
    np.testing.assert_allclose(emulated.gs.numpy(), ref["gs"], rtol=FUSED_RTOL,
                               atol=FUSED_ATOL)


def test_df32_product_of_a_tile_scalar_is_off_under_jit_on_cpu():
    """The cause, in the JAX package alone: compiled for the CPU,
    ``df32.mul`` of a (1, 1) scalar and a (1, 4) vector returns the exact
    product plus the float32 rounding error of ``hi * hi`` once more
    (eagerly, and with both operands (1, 4), it is exact to ~1e-15)."""
    import jax

    from diffsol_tpu.ops import df32

    h = np.float32(0.0003097602748312056)  # the kernel's first step size here
    a = -0.095
    hi = np.float32(a)
    lo = np.float32(a - np.float64(hi))
    y = df32.DF(jnp.full((1, 4), hi), jnp.full((1, 4), lo))

    def product(shape, jit):
        x = df32.DF(jnp.full(shape, h), jnp.zeros(shape, jnp.float32))
        r = (jax.jit(df32.mul) if jit else df32.mul)(x, y)
        return float(np.float64(r.hi[0, 0]) + np.float64(r.lo[0, 0]))

    exact = float(np.float64(h)) * (float(np.float64(hi)) + float(np.float64(lo)))
    twice = float(np.float64(h)) * float(np.float64(hi)) - float(np.float64(h * hi))
    assert abs(product((1, 1), False) / exact - 1.0) < 1e-14
    assert abs(product((1, 4), True) / exact - 1.0) < 1e-14
    off = product((1, 1), True)
    assert abs(off / exact - 1.0) > 1e-8
    assert abs(off - (exact + twice)) < 1e-14 * abs(exact)
    port = fc.pallas_cpu_tile_product(torch.tensor([float(h)], dtype=torch.float64),
                                      torch.full((1, 1, 1), a, dtype=torch.float64))
    assert abs(float(port) - off) < 1e-14 * abs(exact)
