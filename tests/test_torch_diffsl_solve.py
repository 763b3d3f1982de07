"""DiffSL problems solved by the port against the JAX package solving the
same DiffSL text: the ``solve_dense`` / ``solve`` twins of
tests/test_diffsl.py, with equal stop reasons and accepted steps and ys
within TRAJ_RTOL, TRAJ_ATOL = 1e-6, 1e-14 (tests/test_torch_bdf.py), and
the tests that wait for later modules; the gradient through the adjoint
against central differences and the JAX package's.  The ensembles and the fused tiers
are in tests/test_torch_diffsl_ensemble.py.  No JAX kernel runs here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from test_torch_diffsl import (EXP_DECAY, FOODWEB_BLOCKS, LOGISTIC, MODEL_INDEX, ROBERTSON,
                               STOP_RESET, TIME_STOP, foodweb_text, heat1d_text, heat2d_text)

torch.set_num_threads(1)
TRAJ_RTOL, TRAJ_ATOL = 1e-6, 1e-14

# (text, builder settings, params or None, solver, t_eval or final time)
CASES = {
    "logistic": (LOGISTIC, (1e-8, 1e-10), [1.0, 10.0], "bdf", [0.4]),
    "robertson_dae": (ROBERTSON, (1e-8, 1e-10), [0.04, 1.0e4, 3.0e7], "bdf",
                      [0.4, 4.0, 40.0]),
    "heat1d": (heat1d_text(), (1e-6, 1e-6), None, "bdf", [0.5]),
    "foodweb_blocks": (FOODWEB_BLOCKS, (1e-8, 1e-10), None, "bdf", [0.5, 1.0]),
    "stop_reset_erk": (STOP_RESET, (1e-8, 1e-10), None, "erk", 1.5),
    "time_stop": (TIME_STOP, (1e-8, 1e-10), None, "bdf", 2.0),
    "exp_decay": (EXP_DECAY, (1e-8, 1e-10), None, "bdf", [1.0]),
    "heat2d_mass": (heat2d_text(), (1e-7, 1e-7), None, "bdf", [0.01, 0.05]),
    "foodweb_nx4": (foodweb_text(), (1e-6, 1e-6), None, "bdf", [0.001, 0.01]),
    "model_index": (MODEL_INDEX, (1e-8, 1e-10), None, "bdf", [0.25, 0.5, 0.75, 1.0]),
}


def _build(lib, text, tols, params=None, coloring=False):
    b = lib.OdeBuilder().rtol(tols[0]).atol(tols[1])
    if params is not None:
        b = b.p(params)
    if coloring:
        b = b.use_coloring()
    return b.build_from_diffsl(text)


def _steps(sol):
    return int(sol.state.stats.steps)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches_jax(name):
    text, tols, params, method, times = CASES[name]
    jp, tp = _build(dt, text, tols, params), _build(dtt, text, tols, params)
    jsolver = dt.ErkSolver if method == "erk" else dt.BdfSolver
    tsolver = dtt.ErkSolver if method == "erk" else dtt.BdfSolver
    if isinstance(times, list):
        ref = dt.solve_dense(jsolver(jp), jnp.asarray(times), max_steps=5000)
        got = dtt.solve_dense(tsolver(tp), times, max_steps=5000, device="cpu")
        ys_ref, ys_got = np.asarray(ref.ys), got.ys.numpy()
    else:
        ref = dt.solve(jsolver(jp), times, max_steps=4000)
        got = dtt.solve(tsolver(tp), times, max_steps=4000, device="cpu")
        assert got.n_points == int(ref.n_points)
        n = got.n_points
        np.testing.assert_allclose(got.ts[:n].numpy(), np.asarray(ref.ts[:n]), rtol=TRAJ_RTOL)
        ys_ref, ys_got = np.asarray(ref.ys[:n]), got.ys[:n].numpy()
        if name == "time_stop":
            assert got.stop_reason == errors.ROOT_FOUND
            np.testing.assert_allclose(got.root_t, float(ref.root_t), rtol=1e-10)
            assert abs(got.root_t - 0.5) < 1e-8
    assert got.stop_reason == int(ref.stop_reason) >= 0
    assert _steps(got) == _steps(ref)
    np.testing.assert_allclose(ys_got, ys_ref, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
    if name == "model_index":  # N <- 0 at the t = 0.5 reset: y restarts at 0.1
        def logistic(y0, t):
            return y0 * np.exp(t) / (1.0 - y0 + y0 * np.exp(t))

        np.testing.assert_allclose(ys_got[:, 0], [logistic(0.1, 0.25), logistic(0.1, 0.5),
                                                  logistic(0.1, 0.25), logistic(0.1, 0.5)],
                                   rtol=1e-6)
    if name == "stop_reset_erk":  # 1 -> 0.5 at ln 2, reset to 1.5, decays again
        ts = got.ts[:got.n_points].numpy()
        after = ts > np.log(2.0) + 1e-9
        np.testing.assert_allclose(ys_got[after, 0], 1.5 * np.exp(-(ts[after] - np.log(2.0))),
                                   rtol=1e-5)


def test_grad_through_diffsl_problem():
    """The adjoint through a DiffSL-built solve (tests/test_diffsl.py:214-224):
    against central differences at that test's tolerance, and against the
    JAX package's gradient on the same model text (the same algorithm, equal
    steps: 1e-9 of the largest component)."""
    import jax

    from diffsol_tpu.adjoint import make_differentiable_solve as jax_mds

    t_eval = np.linspace(0.0, 2.0, 4)
    problem = dtt.OdeBuilder().rtol(1e-9).atol(1e-11).p([1.0, 10.0]) \
        .build_from_diffsl(LOGISTIC)
    ys_of = dtt.make_differentiable_solve(problem, t_eval, device="cpu")
    p = problem.params.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(ys_of(p).sum(), p)
    eps = 1e-6
    for i in range(2):
        e = torch.zeros(2, dtype=torch.float64)
        e[i] = eps
        fd = (float(ys_of(problem.params + e).sum())
              - float(ys_of(problem.params - e).sum())) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), fd, rtol=1e-4, atol=1e-8)
    jp = dt.OdeBuilder().rtol(1e-9).atol(1e-11).p([1.0, 10.0]).build_from_diffsl(LOGISTIC)
    jys_of = jax_mds(jp, jnp.asarray(t_eval))
    g_jax = np.asarray(jax.grad(lambda pp: jnp.sum(jys_of(pp)))(jp.params))
    assert np.abs(g.numpy() - g_jax).max() / np.abs(g_jax).max() < 1e-9, (g, g_jax)


def test_diffsl_f32_traces_f32_arithmetic():
    """Twin of tests/test_diffsl.py:374-383: under OdeBuilder.dtype(float32)
    the DiffSL callables compute in float32, folded constants and literals
    included, so the traced rhs holds no float64 tensor; the values are
    the JAX package's."""
    from torch.fx.experimental.proxy_tensor import make_fx

    code = """
    A_ij { (0,0): 1.0, (0,1): 2.0, (1,0): 3.0, (1,1): 4.0 }
    c { 0.5 }
    u_i { a = 1.0, b = 2.0 }
    F_i { c * A_ij * u_j + 1.5 }
    """
    problem = dtt.OdeBuilder().dtype(torch.float32).build_from_diffsl(code)
    assert problem.params.dtype == torch.float32
    y = torch.ones(2, dtype=torch.float32)
    t = torch.zeros((), dtype=torch.float32)
    f = problem.eqn.rhs(t, y, problem.params)
    assert f.dtype == torch.float32
    np.testing.assert_allclose(f.numpy(), 0.5 * np.array([3.0, 7.0]) + 1.5)
    jp = dt.OdeBuilder().dtype(jnp.float32).build_from_diffsl(code)
    jf = jp.eqn.rhs(jnp.asarray(0.0, jnp.float32), jnp.ones((2,), jnp.float32), jp.params)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    # the callables themselves, not only the builder's cast, compute in
    # float32: every operation of the traced rhs gives float32 (the folded
    # constants' float64 host copies are cast once, on first use)
    fns = problem.diffsl_model.make_callables()
    graph = make_fx(fns["rhs"])(t, y, problem.params)
    dtypes = {n.meta["val"].dtype for n in graph.graph.nodes
              if n.op == "call_function" and isinstance(n.meta.get("val"), torch.Tensor)}
    assert dtypes == {torch.float32}, dtypes
    y0 = fns["init"](t, problem.params)
    assert y0.dtype == torch.float32


def test_spm_and_dfn_battery_models():
    pytest.skip("the pybamm SPM and DFN model files are not in the repository (ROADMAP.md "
                "queue 1 item 10), as in tests/test_diffsl.py")
