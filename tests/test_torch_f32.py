"""The float32 tier (``OdeBuilder.dtype(torch.float32)``) against the JAX
package's float32 solves of the same problems: lockstep Robertson on the
dense tier (twin of tests/test_ensemble.py::test_f32_lockstep_ensemble),
heat1d on the banded tier through the band LU's float plain version
(against JAX's ``make_banded_solver(kernel="xla")`` in float32), the
block-diagonal tier, TR-BDF2 and TSIT45, the fused tiers' float64 kernels
on a float32 problem, and ``interop.problem_from_jax`` carrying the dtype;
and the float32 independent ensemble against its members' single solves.

The JAX package keeps its times and step control in float32, the port
keeps them in Python floats (float64), so the two float32 solves part by
float32 roundoff steered through the step sequence: each is held to the
JAX test's bound against float64, and to the JAX float32 solve within that
same bound (or in error weights, atol + rtol |y|, where stated).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.ensemble import make_lockstep_problem as jax_lockstep_problem
from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.models import robertson as jrob
from diffsol_tpu.ops.banded import make_banded_solver as jax_banded_solver

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import heat1d, logistic, robertson

torch.set_num_threads(1)

F32 = torch.float32
# tests/test_ensemble.py:224-227's bound, float32 against float64
F32_ATOL = 2e-4


def _k1_params(nb):
    k1 = 0.04 * (1.0 + 0.1 * np.linspace(-1.0, 1.0, nb))
    return np.stack([k1, np.full(nb, 1.0e4), np.full(nb, 3.0e7)], axis=1)


def _jax_lockstep(problem, params, t_eval, max_steps=5000):
    lp = jax_lockstep_problem(problem, params.shape[0])
    return dt.solve_dense(dt.BdfSolver(lp), jnp.asarray(t_eval, lp.atol.dtype),
                          params=jnp.asarray(params).astype(lp.params.dtype),
                          max_steps=max_steps)


def test_f32_lockstep_ensemble():
    """B = 8 Robertson members, k1 spread +-10 %, lockstep in float32:
    float32 out, conservation within 1e-5, members within 2e-4 of the
    float64 lockstep solve and of JAX's float32 one."""
    params = _k1_params(8)
    t_eval = [0.4, 40.0]

    def solve(dtype):
        return dtt.solve_dense_ensemble(
            dtt.BdfSolver, robertson.problem_ode(rtol=1e-4, atol=1e-6, dtype=dtype), t_eval,
            params, mode="lockstep", max_steps=5000, device="cpu")

    s32, s64 = solve(F32), solve(None)
    assert s32.ys.dtype == F32 and s32.state.y.dtype == F32 and s32.tier == "lockstep"
    assert s32.stop_reason >= 0
    y32 = s32.ys.double().numpy()
    np.testing.assert_allclose(y32.sum(axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(y32, s64.ys.numpy(), rtol=0, atol=F32_ATOL)
    j32 = _jax_lockstep(jrob.problem_ode(rtol=1e-4, atol=1e-6, dtype=jnp.float32), params, t_eval)
    assert j32.ys.dtype == jnp.float32
    np.testing.assert_allclose(y32, np.swapaxes(np.asarray(j32.ys, np.float64), 1, 2),
                               rtol=0, atol=F32_ATOL)


def _jax_heat1d_f32(mgrid):
    """heat1d on JAX's banded tier, f64 XLA band LU ("xla"), in float32."""
    p64, _ = jheat.make(mgrid=mgrid, rtol=1e-4, atol=1e-6)
    return (dt.OdeBuilder().rhs(p64.eqn.rhs).init(p64.eqn.init).p([1.0]).rtol(1e-4)
            .atol(1e-6).linear_solver(jax_banded_solver(1, 1, kernel="xla"))
            .dtype(jnp.float32).build())


def test_f32_banded_lockstep_heat1d():
    """heat1d n = 33, B = 8 diffusivities linspace(0.5, 2.0), lockstep on
    the banded tier in float32: the band LU's float plain version (its
    factors float32), the JAX float32 solve's 77 steps, within one error
    weight of it (measured 0.20) and of the port's float64 solve
    (measured 0.05)."""
    params = np.linspace(0.5, 2.0, 8)[:, None]
    t_eval = [0.01, 0.05, 0.2]

    def solve(dtype):
        pr, _ = heat1d.make(32, rtol=1e-4, atol=1e-6, banded=True, dtype=dtype)
        return dtt.solve_dense_ensemble(dtt.BdfSolver, pr, t_eval, params, mode="lockstep",
                                        device="cpu")

    s32, s64 = solve(F32), solve(None)
    assert s32.ys.dtype == F32 and s32.state.factors[0].dtype == F32
    assert s32.stop_reason == errors.TSTOP_REACHED
    j32 = _jax_lockstep(_jax_heat1d_f32(32), params, t_eval)
    assert j32.ys.dtype == jnp.float32
    assert s32.state.stats.steps == int(j32.state.stats.steps) == 77
    jy = np.swapaxes(np.asarray(j32.ys, np.float64), 1, 2)
    weights = 1e-6 + 1e-4 * np.abs(s64.ys.numpy())
    y32 = s32.ys.double().numpy()
    assert (np.abs(y32 - jy) / weights).max() < 1.0
    assert (np.abs(y32 - s64.ys.numpy()) / weights).max() < 1.0


def test_f32_block_tier_lockstep():
    """robertson_ode with 4 groups on the block-diagonal tier, lockstep
    over 4 members in float32, against its float64 solve and JAX's
    float32 one within 2e-4."""
    params = _k1_params(4)
    t_eval = [0.4, 40.0]

    def solve(dtype):
        pr = robertson.problem_ode_groups(4, rtol=1e-4, dtype=dtype)
        assert pr.linear_solver.name.startswith("blockdiag")
        return dtt.solve_dense_ensemble(dtt.BdfSolver, pr, t_eval, params, mode="lockstep",
                                        max_steps=5000, device="cpu")

    s32, s64 = solve(F32), solve(None)
    assert s32.ys.dtype == F32 and s32.stop_reason >= 0
    y32 = s32.ys.double().numpy()
    np.testing.assert_allclose(y32, s64.ys.numpy(), rtol=0, atol=F32_ATOL)
    j32 = _jax_lockstep(jrob.problem_ode_groups(4, rtol=1e-4, dtype=jnp.float32), params, t_eval)
    np.testing.assert_allclose(y32, np.swapaxes(np.asarray(j32.ys, np.float64), 1, 2),
                               rtol=0, atol=F32_ATOL)


def test_f32_independent_members_and_their_single_solves():
    """mode="independent" in float32: 4 Robertson members, k1 spread 0.5x
    to 4x, each against its single float32 solve.  float32 keeps the R.U
    rescale's matrix product (bdf.apply_ru, _Batched.rescale) and the
    batched LU rounds otherwise than the single one, so the contract is
    float32's bound, not equal steps as in float64: the same stop, ys
    within 2e-4 and steps within 15 %."""
    from diffsol_tpu_torch.drivers import solve_dense

    k1 = 0.04 * np.geomspace(0.5, 4.0, 4)
    params = np.stack([k1, np.full(4, 1e4), np.full(4, 3e7)], axis=1)
    t_eval = [0.4, 40.0, 4e5]
    pr = robertson.problem_ode(rtol=1e-4, atol=1e-6, dtype=F32)
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, pr, t_eval, params, mode="independent",
                                   max_steps=5000, device="cpu")
    assert sol.tier == "independent" and sol.ys.dtype == F32
    for b in range(4):
        one = solve_dense(dtt.BdfSolver(pr), t_eval, params=torch.tensor(params[b], dtype=F32),
                          max_steps=5000, device="cpu")
        assert int(sol.stop_reason[b]) == one.stop_reason == errors.TSTOP_REACHED
        steps = int(sol.state.member_stats(b).steps)
        assert abs(steps - one.state.stats.steps) <= 0.15 * one.state.stats.steps, b
        np.testing.assert_allclose(sol.ys[:, b].double().numpy(), one.ys.double().numpy(),
                                   rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("method", ["tr_bdf2", "esdirk34", "tsit45"])
def test_f32_rk_methods(method):
    """The logistic equation at rtol 1e-5 in float32 through TR-BDF2,
    ESDIRK34 and TSIT45 (the tableau in float32): float32 out, within 2e-4
    of float64 (tests/test_api.py::test_f32_solves' bound).  TSIT45 is
    also within 2e-4 of JAX's float32 solve; JAX's SDIRK cannot run in
    float32 (its lax.cond at sdirk.py:446 mixes float32 and float64
    branches, a TypeError: ROADMAP.md queue 3), so the SDIRK methods are
    held to their own float64 solves alone."""
    t_eval = np.linspace(0.5, 5.0, 4)

    def solve(dtype):
        pr = logistic.problem(rtol=1e-5, atol=1e-7, p=(1.0, 10.0, 0.1)) if dtype is None else \
            dtt.OdeBuilder().rhs(logistic.rhs).init(logistic.init).p([1.0, 10.0, 0.1]) \
            .rtol(1e-5).atol(1e-7).dtype(dtype).build()
        return dtt.solve_dense(dtt.solver(pr, method), t_eval, device="cpu")

    s32, s64 = solve(F32), solve(None)
    assert s32.ys.dtype == F32 and s32.state.diff.dtype == F32
    assert s32.stop_reason == errors.TSTOP_REACHED
    np.testing.assert_allclose(s32.ys.numpy(), s64.ys.numpy(), rtol=2e-4)
    jp = (dt.OdeBuilder().rhs(lambda t, y, p: p[0] * y * (1.0 - y / p[1]))
          .init(lambda t, p: jnp.asarray([p[2]])).p([1.0, 10.0, 0.1]).rtol(1e-5).atol(1e-7)
          .dtype(jnp.float32).build())
    if method != "tsit45":
        with pytest.raises(TypeError, match="dtypes do not match"):
            dt.solve_dense(dt.solver(jp, method), jnp.asarray(t_eval, jnp.float32))
        return
    j32 = dt.solve_dense(dt.solver(jp, method), jnp.asarray(t_eval, jnp.float32))
    np.testing.assert_allclose(s32.ys.numpy(), np.asarray(j32.ys), rtol=2e-4)


def _fused_params():
    rng = np.random.default_rng(0)
    params = np.tile(np.array([0.04, 1e4, 3e7]), (8, 1))
    params[:, 0] *= 1 + 0.1 * (2 * rng.random(8) - 1)
    return params


FUSED_T_EVAL = [0.4, 4.0, 40.0]


@pytest.fixture(scope="module")
def jax_fused_f32():
    """JAX's solve_dense_ensemble(..., mode="fused", interpret=True) on its
    float32 Robertson (the Pallas kernel in interpret mode, about a
    minute on the CPU, run once for the module)."""
    jp = jrob.problem_ode(rtol=1e-4, atol=1e-6, dtype=jnp.float32)
    return dt.solve_dense_ensemble(dt.BdfSolver, jp, jnp.asarray(FUSED_T_EVAL, jnp.float32),
                                   jnp.asarray(_fused_params(), jnp.float32), mode="fused",
                                   interpret=True)


@pytest.mark.parametrize("mode", ["fused", "auto"])
def test_f32_problem_on_the_fused_tier(mode, jax_fused_f32):
    """The JAX package's fused tier takes a float32 problem and runs its
    float64 kernel, params cast up (pallas_stepper.py:2036), returning
    float64 from tier "fused_small"; the port does the same (K1's plain
    version here, its float64 build on the card): as many steps as JAX's,
    ys within 1e-6 relative of JAX's (the kernels' float32 heuristics,
    ROADMAP queue 3 "not faults"; measured 1.7e-9).  The callables' casts
    to float32 round each rhs on both sides (without them the solve moves
    by 3.7e-8)."""
    j = jax_fused_f32
    jys = np.asarray(j.ys)
    assert j.tier == "fused_small" and jys.dtype == np.float64
    p32 = robertson.problem_ode(rtol=1e-4, atol=1e-6, dtype=F32)
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, p32, FUSED_T_EVAL, _fused_params(),
                                   mode=mode, device="cpu")
    assert sol.tier == "fused_small_reference" and sol.ys.dtype == torch.float64
    assert sol.stop_reason == errors.TSTOP_REACHED
    assert sol.tile_steps.tolist() == np.asarray(j.tile_steps).tolist()
    np.testing.assert_allclose(sol.ys.numpy(), jys, rtol=1e-6)


@pytest.mark.parametrize("model", ["robertson", "robertson_diffsl", "heat1d", "heat1d_diffsl"])
def test_fused_trace_rounds_as_the_callables(model):
    """The fused kernels' trace of a float32 problem keeps the callables'
    casts as float32 roundings (value and tangent): the traced rhs, its
    dual-number Jacobian and the traced init equal the eager callables and
    torch.func.jacfwd bit for bit at float64 states (the card's K1 and K2
    run this trace; their plain versions run the callables).  The
    float64 problem's trace holds no rounding."""
    from diffsol_tpu_torch.models import diffsl_sources
    from diffsol_tpu_torch.ops.eqn_codegen import (emit_cuda_header, eval_init, eval_rhs,
                                                   jacobian, trace_model)

    def make(dtype):
        b = dtt.OdeBuilder().rtol(1e-4).atol(1e-6)
        b = b if dtype is None else b.dtype(dtype)
        return {
            "robertson": lambda: robertson.problem_ode(rtol=1e-4, atol=1e-6, dtype=dtype),
            "robertson_diffsl": lambda: b.build_from_diffsl(diffsl_sources.robertson_ode()),
            "heat1d": lambda: heat1d.make(15, rtol=1e-4, atol=1e-6, banded=True,
                                          dtype=dtype)[0],
            "heat1d_diffsl": lambda: b.build_from_diffsl(diffsl_sources.heat1d(15)),
        }[model]()

    traced_init = model.startswith("robertson")  # K2 takes its y0 from the host
    rng = np.random.default_rng(5)
    for dtype in (F32, None):
        e = make(dtype).eqn
        n, npar = e.nstates, e.nparams
        m = trace_model(e.rhs, e.init if traced_init else None, n, npar)
        rounds = sum(node[0] == "f32" for node in m.rhs.nodes)
        if dtype is None:
            assert rounds == 0
            continue
        assert rounds == n and "dsol_f32(" in emit_cuda_header(m)
        p0 = make(dtype).params.double()
        t = torch.tensor(0.3, dtype=torch.float64)
        y = torch.tensor(rng.random((4, n)))
        p = p0 * torch.tensor(1.0 + 0.1 * rng.random((4, npar)))
        eager = torch.stack([e.rhs(t, y[i], p[i]) for i in range(4)]).double()
        jac = torch.stack([torch.func.jacfwd(e.rhs, argnums=1)(t, y[i], p[i])
                           for i in range(4)]).double()
        assert torch.equal(eval_rhs(m.rhs, t, y, p), eager)
        assert torch.equal(jacobian(m.rhs, t, y, p), jac)
        if traced_init:
            assert torch.equal(eval_init(m.init, t, p),
                               torch.stack([e.init(t, p[i]) for i in range(4)]).double())


def test_problem_from_jax_carries_float32():
    """A float32 JAX problem comes across as a float32 problem: params,
    t0 and tolerances float32 and equal to JAX's, and its lockstep solve
    as the port's own float32 Robertson."""
    jp = jrob.problem_ode(rtol=1e-4, atol=1e-6, dtype=jnp.float32)
    tp = problem_from_jax(jp, robertson.rhs_ode, robertson.init)
    assert tp.dtype == F32
    for name in ("params", "t0", "rtol", "atol"):
        v = getattr(tp, name)
        assert v.dtype == F32
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jp, name)))
    own = robertson.problem_ode(rtol=1e-4, atol=1e-6, dtype=F32)
    a, b = (dtt.solve_dense(dtt.BdfSolver(p), [0.4, 4.0], device="cpu") for p in (tp, own))
    assert torch.equal(a.ys, b.ys)
