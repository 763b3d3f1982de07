"""The port's bounded-memory adjoint (``checkpoint_interval=K``), twins of
the six tests of tests/test_adjoint_checkpointing.py: the full solver state
every K accepted steps, each segment re-solved in the backward pass, and
gradients held to the dense-table mode at the JAX tests' tolerances.

The storage twin counts the port's own rows: the port records the steps it
took (one row a step and the initial one, an event's step giving its pre-
and post-event knots instead of its end), where the JAX package
preallocates ``max_steps + 2 max_events + 1``.

Against the JAX package: the bounded quadrature (JAX_RTOL, equal steps:
the forward's and the re-solves' together, and the backward's; 2.4e-10
measured on the CPU).  JAX's tables leave an unwritten +inf row after
every event's double knot (ROADMAP.md queue 3), and its bisection over
them returns the post-event knot, not the interpolant, for part of the
first step after an event; the last test shows the row and that the
port's bounded reset gradient meets JAX's once the port interpolates that
way (2.1e-6 apart as it stands, within the JAX test's 1e-5 of the dense
mode either way).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsol_tpu.adjoint import _record_segment as jax_record_segment
from diffsol_tpu.adjoint import forward_with_checkpoints as jax_forward_with_checkpoints
from diffsol_tpu.adjoint import hermite_interp as jax_hermite
from diffsol_tpu.adjoint import make_differentiable_quadrature as jax_mdq
from diffsol_tpu.adjoint import make_differentiable_solve as jax_mds
from diffsol_tpu.models import exponential_decay as jed
from diffsol_tpu.solvers.bdf import BdfSolver as JaxBdf

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import adjoint as tadj
from diffsol_tpu_torch.adjoint import forward_with_checkpoints, forward_with_table
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import exponential_decay as ted
from diffsol_tpu_torch.models import logistic as tlog
from diffsol_tpu_torch.models import robertson as trob

from test_torch_adjoint import JAX_RTOL, grad_of, jax_grad

torch.set_num_threads(1)
F64 = torch.float64


def _grads(problem, t_eval, loss, K, **kw):
    """(dense gradient, bounded gradient), with the outputs of the two modes
    held together first."""
    dense = dtt.make_differentiable_solve(problem, t_eval, device="cpu", **kw)
    bounded = dtt.make_differentiable_solve(problem, t_eval, checkpoint_interval=K,
                                            device="cpu", **kw)
    p = problem.params
    np.testing.assert_allclose(bounded(p).numpy(), dense(p).numpy(), rtol=1e-9, atol=1e-12)
    return grad_of(dense, p, loss), grad_of(bounded, p, loss)


def test_bounded_matches_dense_logistic():
    w = torch.arange(1.0, 6.0, dtype=F64)[:, None]
    g_dense, g_bnd = _grads(tlog.problem(rtol=1e-9, atol=1e-11), np.linspace(0.0, 5.0, 5),
                            lambda ys: torch.sum(w * ys**2), K=8)
    np.testing.assert_allclose(g_bnd, g_dense, rtol=1e-5)


def test_bounded_long_horizon_neural_ode():
    """A long horizon of a tanh-layer rhs: K = 16 over hundreds of steps,
    dozens of segment re-solves, the gradient as the dense table's."""
    n = 3

    def rhs(t, y, p):
        W = p[: n * n].reshape(n, n)
        b = p[n * n: n * n + n]
        return torch.tanh(W @ y + b) - 0.1 * y

    def init(t, p):
        return p[n * n + n:].clone()

    rng = np.random.default_rng(7)
    W0 = 0.4 * rng.standard_normal((n, n))
    params = np.concatenate([W0.ravel(), [0.1, -0.2, 0.05], [1.0, -0.5, 0.25]])
    problem = dtt.OdeBuilder().rhs(rhs).init(init).p(params).rtol(1e-8).atol(1e-10).build()
    g_dense, g_bnd = _grads(problem, np.linspace(0.0, 40.0, 6),
                            lambda ys: torch.sum(ys**2), K=16, max_steps=4096)
    np.testing.assert_allclose(g_bnd, g_dense, rtol=2e-4, atol=1e-9)


def test_bounded_storage_is_sublinear():
    """The dense table holds the steps taken (+1, and +1 an event); the
    bounded record at most steps // K + 2 states."""
    problem = tlog.problem()
    solver = dtt.BdfSolver(problem)
    t_eval = np.linspace(0.0, 5.0, 5)
    max_steps, K = 4096, 64
    _ys, _g, table, _ev, state = forward_with_table(solver, t_eval, problem.params, max_steps)
    steps = state.stats.steps
    assert len(table.ts) == table.ys.shape[0] == steps + 1
    _ys2, _g2, (ck_ts, ck_states, n_ck), _ev2, state2 = forward_with_checkpoints(
        solver, t_eval, problem.params, max_steps, K)
    assert state2.stats.steps == steps
    assert 2 <= n_ck == len(ck_ts) == len(ck_states) <= steps // K + 2
    prr = ted.problem_with_reset()
    _ys, _g, table, ev, state = forward_with_table(dtt.BdfSolver(prr), [2.0, 6.0, 10.0],
                                                   prr.params, 2048)
    assert ev["count"] == 1
    assert len(table.ts) == state.stats.steps + 1 + ev["count"]
    assert table.ts == sorted(table.ts)


def test_bounded_dae_mass_matrix():
    """Singular mass: the algebraic lambda rows and the partitioned output
    jump survive the segment re-solve."""
    problem = trob.problem_dae(rtol=1e-8, atol=1e-10)
    w = torch.tensor([1.0, 1e4, 1.0], dtype=F64)
    g_dense, g_bnd = _grads(problem, [0.1, 1.0, 10.0], lambda ys: torch.sum(w * ys), K=16,
                            max_steps=4096)
    np.testing.assert_allclose(g_bnd, g_dense, rtol=1e-4)


def test_bounded_reset_events():
    """Reset events inside a segment are re-found by the re-solve (double
    knots) and corrected in the segment that holds them."""
    g_dense, g_bnd = _grads(ted.problem_with_reset(), [2.0, 6.0, 10.0],
                            lambda ys: torch.sum(ys**2), K=8, max_steps=2048)
    np.testing.assert_allclose(g_bnd, g_dense, rtol=1e-5)


def test_bounded_quadrature():
    pq = ted.problem(integrate_out=True)
    dense = dtt.make_differentiable_quadrature(pq, 4.0, device="cpu")
    bounded = dtt.make_differentiable_quadrature(pq, 4.0, checkpoint_interval=8, device="cpu")
    p = pq.params
    np.testing.assert_allclose(bounded(p).numpy(), dense(p).numpy(), rtol=1e-9)
    np.testing.assert_allclose(grad_of(bounded, p, torch.sum), grad_of(dense, p, torch.sum),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

RESET_T_EVAL = [2.0, 6.0, 10.0]
RESET_K = 8


@pytest.fixture(scope="module")
def jax_bounded():
    return {
        "quad": jax_grad(jax_mdq, jed.problem(integrate_out=True), 4.0, jnp.sum,
                         checkpoint_interval=8),
        "reset": jax_grad(jax_mds, jed.problem_with_reset(), jnp.asarray(RESET_T_EVAL),
                          lambda ys: jnp.sum(ys**2), checkpoint_interval=RESET_K,
                          max_steps=2048),
    }


def test_bounded_quadrature_matches_jax(jax_bounded):
    jp = jed.problem(integrate_out=True)
    g_of = dtt.make_differentiable_quadrature(problem_from_jax(jp, ted.rhs, ted.init), 4.0,
                                              checkpoint_interval=8, device="cpu")
    got = grad_of(g_of, jp.params, torch.sum)
    g, fsteps, bsteps = jax_bounded["quad"]
    # JAX's forward solver also takes the segment re-solves
    assert g_of.info["forward"].steps + g_of.info["resolve_steps"] == fsteps
    assert g_of.info["backward"].steps == bsteps
    assert np.abs(got - g).max() / np.abs(g).max() < JAX_RTOL


def _jax_layout_interp(rows, interp2=tadj.hermite_interp):
    """``hermite_interp`` over the JAX package's table layout: an unwritten
    (+inf, 0) row after each event's double knot, +inf padding to ``rows``,
    and jnp.searchsorted's fixed-depth bisection (side="right")."""

    def interp(table, t):
        ts, ys, dys = [], [], []
        zero = torch.zeros_like(table.ys[0])
        for i, tk in enumerate(table.ts):
            ts.append(tk)
            ys.append(table.ys[i])
            dys.append(table.dys[i])
            if i > 0 and table.ts[i - 1] == tk:
                ts.append(math.inf)
                ys.append(zero)
                dys.append(zero)
        ts += [math.inf] * (rows - len(ts))
        ys += [zero] * (rows - len(ys))
        dys += [zero] * (rows - len(dys))
        lo, hi = 0, len(ts)
        for _ in range(math.ceil(math.log2(len(ts) + 1))):
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if mid >= len(ts) or t < ts[mid] else (mid, hi)
        k = min(max(hi, 1), len(ts) - 1)
        t0, t1 = ts[k - 1], ts[k]
        t1 = t1 if math.isfinite(t1) else t0
        if t1 == t0:
            return ys[k - 1]
        return interp2(tadj.Table([t0, t1], torch.stack([ys[k - 1], ys[k]]),
                                  torch.stack([dys[k - 1], dys[k]])), t)

    return interp


def test_jax_tables_leave_a_row_after_each_event(jax_bounded, monkeypatch):
    """The JAX package's fault (ROADMAP.md queue 3): its tables hold an
    unwritten +inf row after an event's two knots, so its ``hermite_interp``
    returns the post-event state for a time inside the next step, where the
    port interpolates.  The port's bounded reset gradient meets JAX's once
    the port interpolates over JAX's layout."""
    jp = jed.problem_with_reset()
    solver = JaxBdf(jp)
    _ys, _g, (ck_ts, ck_states, n_ck), ev, _st = jax_forward_with_checkpoints(
        solver, jnp.asarray(RESET_T_EVAL), jp.params, 2048, RESET_K)
    seg = next(s for s in range(int(n_ck) - 1)
               if float(ck_ts[s]) < float(ev["t"][0]) <= float(ck_ts[s + 1]))
    import jax

    state0 = jax.tree_util.tree_map(lambda b: b[seg], ck_states)
    jtab = jax_record_segment(solver, state0, ck_ts[seg + 1], jp.params, RESET_K + 4)
    jts = np.asarray(jtab[0])
    last = int(np.flatnonzero(np.isfinite(jts))[-1])
    gap = int(np.flatnonzero(np.isinf(jts[:last]))[0])
    # the event's two knots (the re-solve re-finds its root)
    assert jts[gap - 1] == jts[gap - 2]
    np.testing.assert_allclose(jts[gap - 1], float(ev["t"][0]), rtol=1e-6)
    t_mid = 0.5 * (jts[gap - 1] + jts[gap + 1])  # inside the first step after it
    tp = problem_from_jax(jp, ted.rhs, ted.init, root=ted.root, reset=ted.reset)
    _, _, (tck_ts, tck_states, _), _, _ = forward_with_checkpoints(
        dtt.BdfSolver(tp), RESET_T_EVAL, tp.params, 2048, RESET_K)
    ttab = tadj._record_segment(dtt.BdfSolver(tp), tck_states[seg], tck_ts[seg + 1],
                                tp.params, RESET_K + 4)
    np.testing.assert_allclose(ttab.ts, jts[np.isfinite(jts)], rtol=1e-13)
    x_port = tadj.hermite_interp(ttab, t_mid).numpy()
    np.testing.assert_array_equal(np.asarray(jax_hermite(jtab, t_mid)), jtab[1][gap - 1])
    assert np.abs(x_port - np.asarray(jtab[1][gap - 1])).max() > 1e-4

    def bounded_grad():
        ys_of = dtt.make_differentiable_solve(tp, RESET_T_EVAL, checkpoint_interval=RESET_K,
                                              max_steps=2048, device="cpu")
        return grad_of(ys_of, tp.params, lambda ys: torch.sum(ys**2))

    g_jax = jax_bounded["reset"][0]
    rel = np.abs(bounded_grad() - g_jax).max() / np.abs(g_jax).max()
    assert 1e-7 < rel < 1e-5
    monkeypatch.setattr(tadj, "hermite_interp", _jax_layout_interp(RESET_K + 4 + 2 * 32 + 1))
    assert np.abs(bounded_grad() - g_jax).max() / np.abs(g_jax).max() < 1e-8
