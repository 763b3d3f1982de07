"""The port's differentiable ensembles, twins of the ten tests of
tests/test_adjoint_ensemble.py: per-member gradients of lockstep and
independent solves, each held to the JAX test's oracle (the port's
single-instance adjoint, its forward sensitivities, or its dense-table
mode) at the JAX test's tolerance.

Against the JAX package (module fixture): the lockstep solve (logistic,
four members) and quadrature, a lockstep reset (the time-triggered root
of the reset twins) and the independent mode.  Lockstep runs the JAX
algorithm step for step, so the gradients agree to JAX_RTOL with equal
forward and backward step counts (measured on the CPU: 1.5e-11, 2.7e-11,
the reset case below that).  The independent mode is JAX's ``vmap`` of the
single-instance function against the port's loop over members: 7.4e-8
measured, held to IND_RTOL (the JAX test's own bound against the single
instance is 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.adjoint_ensemble import make_differentiable_quadrature_ensemble as jax_mdqe
from diffsol_tpu.adjoint_ensemble import make_differentiable_solve_ensemble as jax_mdse
from diffsol_tpu.models import logistic as jlog

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import exponential_decay as ted
from diffsol_tpu_torch.models import logistic as tlog
from diffsol_tpu_torch.models import robertson as trob

from test_torch_adjoint import JAX_RTOL, grad_of, jax_counted

torch.set_num_threads(1)
F64 = torch.float64
IND_RTOL = 1e-6


def _member_params(base, B, spread=0.2):
    """B distinct parameter rows around ``base``."""
    base = np.asarray(base, dtype=np.float64)
    return base[None, :] * (1.0 + spread * np.linspace(-1.0, 1.0, B)[:, None])


def _sum_sq(ys):
    return (ys**2).sum()


def test_lockstep_grad_matches_single_instance():
    problem = tlog.problem(rtol=1e-8, atol=1e-10)
    t_eval = np.linspace(0.5, 3.0, 4)
    B = 4
    pb = _member_params(problem.params, B)
    ys_of = dtt.make_differentiable_solve_ensemble(problem, t_eval, B, device="cpu")
    grad_b = grad_of(ys_of, pb, _sum_sq)
    assert grad_b.shape == (B, 3)
    one = dtt.make_differentiable_solve(problem, t_eval, device="cpu")
    for b in range(B):
        np.testing.assert_allclose(grad_b[b], grad_of(one, pb[b], _sum_sq), rtol=5e-5,
                                   atol=1e-10)


def test_lockstep_grad_matches_jacfwd():
    """Against forward mode straight through the solver
    (``solve_dense_fwd_sens``)."""
    problem = tlog.problem(rtol=1e-9, atol=1e-11)
    t_eval = np.linspace(0.5, 2.0, 3)
    B = 3
    pb = _member_params(problem.params, B)
    ys_of = dtt.make_differentiable_solve_ensemble(problem, t_eval, B, device="cpu")
    grad_b = grad_of(ys_of, pb, _sum_sq)
    solver = dtt.BdfSolver(problem)
    for b in range(B):
        ys, sens = dtt.solve_dense_fwd_sens(solver, t_eval, params=pb[b], max_steps=4096,
                                            device="cpu")
        g_fwd = (2.0 * torch.einsum("ij,kij->k", ys, sens)).numpy()
        np.testing.assert_allclose(grad_b[b], g_fwd, rtol=1e-4, atol=1e-10)


def test_lockstep_grad_dae_mass():
    """Singular mass (Robertson DAE): the per-member partitioned output
    jump and algebraic lambda rows."""
    problem = trob.problem_dae(rtol=1e-8, atol=(1e-10, 1e-10, 1e-10))
    t_eval = [0.1, 1.0, 10.0]
    B = 3
    pb = _member_params(problem.params, B, spread=0.1)
    w = torch.tensor([1.0, 1e4, 1.0], dtype=F64)
    ys_of = dtt.make_differentiable_solve_ensemble(problem, t_eval, B, device="cpu")
    grad_b = grad_of(ys_of, pb, lambda ys: torch.sum((w * ys) ** 2))
    one = dtt.make_differentiable_solve(problem, t_eval, device="cpu")
    for b in range(B):
        g1 = grad_of(one, pb[b], lambda ys: torch.sum((w * ys) ** 2))
        # lockstep shares one step sequence, the single solves take their own
        assert np.max(np.abs(grad_b[b] - g1) / np.max(np.abs(g1))) < 1e-3, (grad_b[b], g1)


def _quad_problem():
    return dataclasses.replace(tlog.problem(rtol=1e-8, atol=1e-10), integrate_out=True)


def test_lockstep_quadrature_grad():
    problem = _quad_problem()
    B = 3
    pb = _member_params(problem.params, B)
    g_of = dtt.make_differentiable_quadrature_ensemble(problem, 2.0, B, device="cpu")
    gb = g_of(torch.tensor(pb))
    assert tuple(gb.shape) == (B, 1)
    grad_b = grad_of(g_of, pb, torch.sum)
    one = dtt.make_differentiable_quadrature(problem, 2.0, device="cpu")
    for b in range(B):
        np.testing.assert_allclose(gb[b].numpy(), one(torch.tensor(pb[b])).numpy(), rtol=1e-6)
        np.testing.assert_allclose(grad_b[b], grad_of(one, pb[b], torch.sum), rtol=5e-5,
                                   atol=1e-10)


def test_independent_mode_grad():
    """mode="independent": the single-instance function once a member."""
    problem = tlog.problem(rtol=1e-8, atol=1e-10)
    t_eval = np.linspace(0.5, 3.0, 4)
    B = 3
    pb = _member_params(problem.params, B)
    ys_of = dtt.make_differentiable_solve_ensemble(problem, t_eval, B, mode="independent",
                                                   device="cpu")
    assert tuple(ys_of(torch.tensor(pb)).shape) == (4, B, 1)
    grad_b = grad_of(ys_of, pb, _sum_sq)
    one = dtt.make_differentiable_solve(problem, t_eval, device="cpu")
    for b in range(B):
        np.testing.assert_allclose(grad_b[b], grad_of(one, pb[b], _sum_sq), rtol=1e-6,
                                   atol=1e-12)


def _bounded_pair(problem, t_eval, B, **kw):
    dense = dtt.make_differentiable_solve_ensemble(problem, t_eval, B, max_steps=4096,
                                                   device="cpu", **kw)
    bounded = dtt.make_differentiable_solve_ensemble(problem, t_eval, B, max_steps=4096,
                                                     checkpoint_interval=16, device="cpu", **kw)
    return dense, bounded


def test_lockstep_bounded_memory_grad():
    problem = tlog.problem(rtol=1e-8, atol=1e-10)
    t_eval = np.linspace(0.5, 3.0, 4)
    pb = torch.tensor(_member_params(problem.params, 3))
    dense, bounded = _bounded_pair(problem, t_eval, 3)
    np.testing.assert_allclose(bounded(pb).numpy(), dense(pb).numpy(), rtol=1e-10)
    np.testing.assert_allclose(grad_of(bounded, pb, _sum_sq), grad_of(dense, pb, _sum_sq),
                               rtol=2e-4, atol=1e-10)


def test_lockstep_bounded_quadrature_grad():
    problem = _quad_problem()
    pb = torch.tensor(_member_params(problem.params, 3))
    dense = dtt.make_differentiable_quadrature_ensemble(problem, 2.0, 3, max_steps=4096,
                                                        device="cpu")
    bounded = dtt.make_differentiable_quadrature_ensemble(problem, 2.0, 3, max_steps=4096,
                                                          checkpoint_interval=16, device="cpu")
    np.testing.assert_allclose(bounded(pb).numpy(), dense(pb).numpy(), rtol=1e-10)
    np.testing.assert_allclose(grad_of(bounded, pb, torch.sum), grad_of(dense, pb, torch.sum),
                               rtol=2e-4, atol=1e-10)


def _time_reset_problem(builder=dtt.OdeBuilder, xp=torch):
    """Decay with a time-triggered reset: a root at t = 2 (shared by every
    member), reset y -> p[1]."""
    if xp is torch:
        init = lambda t, p: torch.ones(2, dtype=F64, device=p.device)  # noqa: E731
        root = lambda t, y, p: torch.stack([t - 2.0])  # noqa: E731
        reset = lambda t, y, p: p[1] * torch.ones_like(y)  # noqa: E731
    else:
        init = lambda t, p: jnp.full((2,), 1.0)  # noqa: E731
        root = lambda t, y, p: jnp.array([t - 2.0])  # noqa: E731
        reset = lambda t, y, p: jnp.full_like(y, p[1])  # noqa: E731
    return (builder().rhs(lambda t, y, p: -p[0] * y).init(init).root(root).reset(reset)
            .p([0.1, 0.7]).rtol(1e-8).atol(1e-10).build())


def test_lockstep_reset_grad_matches_independent():
    """Through a reset event, every member's gradient as its single-instance
    one, the reset-target parameter's included."""
    problem = _time_reset_problem()
    t_eval = [1.0, 3.0, 4.0]
    B = 4
    pb = _member_params(problem.params, B, spread=0.15)
    ys_of = dtt.make_differentiable_solve_ensemble(problem, t_eval, B, max_steps=4096,
                                                   device="cpu")
    grad_b = grad_of(ys_of, pb, _sum_sq)
    one = dtt.make_differentiable_solve(problem, t_eval, max_steps=4096, device="cpu")
    for b in range(B):
        np.testing.assert_allclose(grad_b[b], grad_of(one, pb[b], _sum_sq), rtol=1e-4,
                                   atol=1e-10)
    assert np.all(np.abs(grad_b[:, 1]) > 1e-3)


def test_lockstep_reset_grad_state_root():
    """A state-dependent root with identical members: the event-time terms
    batched, each member as the single instance."""
    prr = ted.problem_with_reset()
    t_eval = [2.0, 6.0, 10.0]
    B = 3
    pb = prr.params.expand(B, -1).clone()
    ys_of = dtt.make_differentiable_solve_ensemble(prr, t_eval, B, max_steps=4096,
                                                   device="cpu")
    grad_b = grad_of(ys_of, pb, _sum_sq)
    one = dtt.make_differentiable_solve(prr, t_eval, max_steps=4096, device="cpu")
    g1 = grad_of(one, prr.params, _sum_sq)
    for b in range(B):
        np.testing.assert_allclose(grad_b[b], g1, rtol=1e-5, atol=1e-12)


def test_lockstep_reset_grad_bounded_memory():
    """The bounded lockstep pass through a reset: the re-solve re-finds the
    event and its correction fires in its segment."""
    problem = _time_reset_problem()
    t_eval = [1.0, 3.0, 4.0]
    pb = torch.tensor(_member_params(problem.params, 3, spread=0.15))
    dense, bounded = _bounded_pair(problem, t_eval, 3)
    np.testing.assert_allclose(bounded(pb).numpy(), dense(pb).numpy(), rtol=1e-10)
    np.testing.assert_allclose(grad_of(bounded, pb, _sum_sq), grad_of(dense, pb, _sum_sq),
                               rtol=2e-4, atol=1e-10)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

LOG_T_EVAL = np.linspace(0.5, 3.0, 4).tolist()


@pytest.fixture(scope="module")
def jax_ensembles():
    """The JAX package's per-member gradients and step counts, once."""
    out = {}
    jp = jlog.problem(rtol=1e-8, atol=1e-10)
    pb4, pb3 = _member_params(jp.params, 4), _member_params(jp.params, 3)
    jreset = _time_reset_problem(dt.OdeBuilder, jnp)
    for name, make, prob, arg, B, pb, loss in (
            ("lockstep", jax_mdse, jp, jnp.asarray(LOG_T_EVAL), 4, pb4, _sum_sq),
            ("quad", jax_mdqe, dataclasses.replace(jp, integrate_out=True), 2.0, 3, pb3,
             jnp.sum),
            ("reset", jax_mdse, jreset, jnp.asarray([1.0, 3.0, 4.0]), 4,
             _member_params(jreset.params, 4, spread=0.15), _sum_sq)):
        counts = {"f": 0, "b": 0}
        fn = make(prob, arg, B, solver_cls=jax_counted(counts, "f"),
                  bwd_solver_cls=jax_counted(counts, "b"), max_steps=4096)
        g = np.asarray(jax.grad(lambda p: loss(fn(p)))(jnp.asarray(pb)))
        out[name] = (g, counts["f"], counts["b"], pb)
    ind = jax_mdse(jp, jnp.asarray(LOG_T_EVAL), 3, mode="independent")
    out["independent"] = (np.asarray(jax.grad(lambda p: _sum_sq(ind(p)))(jnp.asarray(pb3))),
                          pb3)
    return out


@pytest.mark.parametrize("case", ["lockstep", "quad", "reset"])
def test_lockstep_gradients_match_jax(jax_ensembles, case):
    g, fsteps, bsteps, pb = jax_ensembles[case]
    B = pb.shape[0]
    if case == "reset":
        problem = _time_reset_problem()
        fn = dtt.make_differentiable_solve_ensemble(problem, [1.0, 3.0, 4.0], B,
                                                    max_steps=4096, device="cpu")
        loss = _sum_sq
    else:
        jp = jlog.problem(rtol=1e-8, atol=1e-10)
        tp = problem_from_jax(jp, tlog.rhs, tlog.init)
        if case == "lockstep":
            fn = dtt.make_differentiable_solve_ensemble(tp, LOG_T_EVAL, B, max_steps=4096,
                                                        device="cpu")
            loss = _sum_sq
        else:
            fn = dtt.make_differentiable_quadrature_ensemble(
                dataclasses.replace(tp, integrate_out=True), 2.0, B, max_steps=4096,
                device="cpu")
            loss = torch.sum
    got = grad_of(fn, pb, loss)
    assert fn.info["forward"].steps == fsteps
    assert fn.info["backward"].steps == bsteps
    assert np.abs(got - g).max() / np.abs(g).max() < JAX_RTOL


def test_independent_mode_matches_jax(jax_ensembles):
    g, pb = jax_ensembles["independent"]
    tp = problem_from_jax(jlog.problem(rtol=1e-8, atol=1e-10), tlog.rhs, tlog.init)
    fn = dtt.make_differentiable_solve_ensemble(tp, LOG_T_EVAL, 3, mode="independent",
                                                device="cpu")
    got = grad_of(fn, pb, _sum_sq)
    assert np.abs(got - g).max() / np.abs(g).max() < IND_RTOL
