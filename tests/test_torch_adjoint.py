"""The port's adjoint gradients, twins of the eight tests of
tests/test_adjoint.py: each runs the same problem through
``diffsol_tpu_torch.make_differentiable_solve`` (or ``_quadrature``) on the
CPU and holds it to the JAX test's own oracle at its tolerance, computed
with the port (the analytic gradient, ``solve_dense_fwd_sens``, central
differences of ``solve_dense``).

The JAX comparisons send the same problems (carried across with
``problem_from_jax``) through the JAX package's functions, once each in a
module fixture: the same float64 algorithm, so the gradients agree to
JAX_RTOL of their largest component with equal forward and backward step
counts (the JAX solvers count their steps through a debug callback).
Measured on the CPU: the Robertson DAE (singular mass) 2.9e-10, the reset
model 6.2e-13, the quadrature 3.9e-12.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.adjoint import make_differentiable_quadrature as jax_mdq
from diffsol_tpu.adjoint import make_differentiable_solve as jax_mds
from diffsol_tpu.models import exponential_decay as jed
from diffsol_tpu.models import robertson as jrob

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.adjoint import forward_with_table
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import exponential_decay as ted
from diffsol_tpu_torch.models import logistic as tlog
from diffsol_tpu_torch.models import robertson as trob

torch.set_num_threads(1)
F64 = torch.float64

# the port's gradient against the JAX package's on the same problem,
# relative to the largest component
JAX_RTOL = 1e-9


def value_and_grad_of(fn, params, loss):
    """``(fn(p), dL/dp)`` of ``loss(fn(p))`` by torch.autograd, as numpy:
    the output of the same call whose gradient is taken."""
    p = torch.as_tensor(params, dtype=F64).clone().requires_grad_(True)
    out = fn(p)
    (g,) = torch.autograd.grad(loss(out), p)
    return out.detach().numpy(), g.numpy()


def grad_of(fn, params, loss):
    """dL/dp of ``loss(fn(p))`` by torch.autograd, as numpy."""
    return value_and_grad_of(fn, params, loss)[1]


def jax_counted(counts, tag):
    """A JAX BdfSolver that counts its steps into ``counts[tag]``."""

    class Counted(dt.BdfSolver):
        def step(self, state, params=None):
            jax.debug.callback(lambda: counts.__setitem__(tag, counts[tag] + 1))
            return super().step(state, params)

    return Counted


def jax_grad(make, problem, arg, loss, params=None, **kw):
    """(gradient, forward steps, backward steps) of the JAX package's
    ``make(problem, arg, ...)`` under ``loss``."""
    counts = {"f": 0, "b": 0}
    fn = make(problem, arg, solver_cls=jax_counted(counts, "f"),
              bwd_solver_cls=jax_counted(counts, "b"), **kw)
    p = problem.params if params is None else jnp.asarray(params)
    g = np.asarray(jax.grad(lambda pp: loss(fn(pp)))(p))
    return g, counts["f"], counts["b"]


def assert_matches_jax(got, info, ref):
    g, fsteps, bsteps = ref
    assert info["forward"].steps == fsteps
    assert info["backward"].steps == bsteps
    err = np.abs(got - g).max() / np.abs(g).max()
    assert err < JAX_RTOL, (got, g, err)


# ---------------------------------------------------------------------------
# twins of tests/test_adjoint.py
# ---------------------------------------------------------------------------


def test_grad_exponential_decay():
    """G = sum of y over all outputs; analytic dG/da, dG/dy0."""
    problem = ted.problem(rtol=1e-8, atol=1e-10)
    t_eval = np.linspace(0.0, 1.0, 6)
    ys_of = dtt.make_differentiable_solve(problem, t_eval, device="cpu")
    g = grad_of(ys_of, problem.params, torch.sum)
    a, y0 = 0.1, 1.0
    dda = np.sum(2.0 * (-t_eval) * y0 * np.exp(-a * t_eval))  # 2 states
    ddy0 = np.sum(2.0 * np.exp(-a * t_eval))
    np.testing.assert_allclose(g, [dda, ddy0], rtol=1e-5)


def test_grad_matches_jacfwd():
    """The adjoint gradient against the forward-sensitivity one (logistic)."""
    problem = tlog.problem(rtol=1e-9, atol=1e-11)
    t_eval = np.linspace(0.0, 5.0, 5)
    w = torch.arange(1.0, 6.0, dtype=F64)[:, None]
    ys_of = dtt.make_differentiable_solve(problem, t_eval, device="cpu")
    g_adj = grad_of(ys_of, problem.params, lambda ys: torch.sum(w * ys**2))
    ys, sens = dtt.solve_dense_fwd_sens(dtt.BdfSolver(problem), t_eval, device="cpu")
    g_fwd = torch.stack([torch.sum(2.0 * w * ys * sens[i]) for i in range(3)]).numpy()
    np.testing.assert_allclose(g_adj, g_fwd, rtol=1e-4)


def test_grad_fit_loop_descends():
    """Gradient descent on the logistic rate reduces the misfit."""
    problem = tlog.problem(rtol=1e-8, atol=1e-10)
    t_eval = np.linspace(0.0, 5.0, 8)
    target = torch.tensor(tlog.soln(t_eval, [1.3, 1.0, 0.1]))
    ys_of = dtt.make_differentiable_solve(problem, t_eval, device="cpu")

    def loss(p):
        return torch.sum((ys_of(p) - target) ** 2)

    p = torch.tensor([1.0, 1.0, 0.1], dtype=F64)
    l0 = float(loss(p))
    for _ in range(12):
        p = p.requires_grad_(True)
        lv = loss(p)
        (g,) = torch.autograd.grad(lv, p)
        p = (p - 0.05 * g).detach()
    assert float(lv.detach()) < 0.2 * l0
    assert abs(float(p[0]) - 1.3) < abs(1.0 - 1.3)


def test_grad_with_mass_matrix():
    """A constant nonsingular mass: diag(2, 4) y' = -a y."""
    m_diag = torch.tensor([2.0, 4.0], dtype=F64)
    problem = (
        dtt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * y)
        .init(lambda t, p: torch.stack([p[1], p[1]]))
        .mass(lambda t, p: torch.diag(m_diag))
        .p([0.3, 1.0])
        .rtol(1e-10)
        .atol(1e-12)
        .build()
    )
    t_eval = np.linspace(0.0, 2.0, 5)
    ys_of = dtt.make_differentiable_solve(problem, t_eval, device="cpu")
    g = grad_of(ys_of, problem.params, torch.sum)
    a, y0, m = 0.3, 1.0, m_diag.numpy()
    dda = sum(np.sum(-(t_eval / m[i]) * y0 * np.exp(-a * t_eval / m[i])) for i in range(2))
    ddy0 = sum(np.sum(np.exp(-a * t_eval / m[i])) for i in range(2))
    np.testing.assert_allclose(g, [dda, ddy0], rtol=1e-5)


def test_dae_adjoint_vs_forward_sens():
    """Singular mass (the Robertson DAE): the adjoint gradient against the
    forward sensitivities."""
    problem = trob.problem_dae()
    t_eval = [0.4, 4.0, 40.0]
    ys_of = dtt.make_differentiable_solve(problem, t_eval, device="cpu")
    g_adj = grad_of(ys_of, problem.params, lambda ys: torch.sum(ys**2))
    ys, sens = dtt.solve_dense_fwd_sens(dtt.BdfSolver(trob.problem_dae()), t_eval,
                                        device="cpu")
    g_fwd = (2.0 * torch.einsum("tn,ptn->p", ys, sens)).numpy()
    assert np.max(np.abs(g_adj - g_fwd) / np.max(np.abs(g_fwd))) < 5e-3, (g_adj, g_fwd)


def _central(f, p0, eps=1e-6):
    p0 = np.asarray(p0, np.float64)
    return np.array([(f(p0 + eps * e) - f(p0 - eps * e)) / (2 * eps) for e in np.eye(len(p0))])


def test_quadrature_gradient_vs_fd():
    """G = int u dt through the continuous adjoint with the u_y^T forcing
    term, against central differences."""
    pq = ted.problem(integrate_out=True)
    g_of = dtt.make_differentiable_quadrature(pq, 4.0, device="cpu")
    grad = grad_of(g_of, pq.params, torch.sum)

    def G(p):
        sol = dtt.solve_dense(dtt.BdfSolver(ted.problem(integrate_out=True)), [4.0],
                              params=p, max_steps=4000, device="cpu")
        return float(sol.gs[-1].sum())

    fd = _central(G, pq.params.numpy())
    assert np.max(np.abs(grad - fd)) < 1e-4, (grad, fd)


def test_reset_adjoint_vs_fd():
    """Through root + reset events: the event-boundary correction gives the
    gradients in the event-moving and the reset-value parameters."""
    prr = ted.problem_with_reset()
    t_eval = [2.0, 6.0, 10.0]
    ys_of = dtt.make_differentiable_solve(prr, t_eval, device="cpu")
    grad = grad_of(ys_of, prr.params, lambda ys: torch.sum(ys**2))

    def L(p):
        sol = dtt.solve_dense(dtt.BdfSolver(ted.problem_with_reset()), t_eval, params=p,
                              max_steps=4000, device="cpu")
        return float(torch.sum(sol.ys**2))

    fd = _central(L, prr.params.numpy())
    assert np.max(np.abs(grad - fd) / np.max(np.abs(fd))) < 1e-3, (grad, fd)


def test_event_capacity_overflow_fails_loudly():
    """Overflowing the reset-event record fails loudly: the status is
    EVENT_CAPACITY_EXCEEDED and outputs and gradients are NaN."""
    prr = ted.problem_with_reset()
    t_eval = [2.0, 8.0, 16.0]  # three events, near t = 5.108 k
    _ys, _g, table, ev, state = forward_with_table(dtt.BdfSolver(prr), t_eval, prr.params,
                                                   4096, max_events=8)
    assert state.status >= 0
    assert ev["count"] == 3
    ys, _g, _tab, ev, state = forward_with_table(dtt.BdfSolver(prr), t_eval, prr.params,
                                                 4096, max_events=1)
    assert state.status == errors.EVENT_CAPACITY_EXCEEDED
    assert bool(torch.isnan(ys).all())
    ys_of = dtt.make_differentiable_solve(prr, t_eval, max_events=1, device="cpu")
    grad = grad_of(ys_of, prr.params, lambda ys: torch.sum(ys**2))
    assert np.all(np.isnan(grad))
    assert ys_of.info["status"] == errors.EVENT_CAPACITY_EXCEEDED


def test_backward_failure_fails_loudly():
    """Robertson ODE to t = 4e8: the backward solve spends the BDF's 50
    Newton failures (counted over the whole solve; each output jump's
    restart takes some) and fails.  The gradient is NaN with the status in
    ``info``, where the JAX package steps past the failure and returns a
    finite gradient 2.7e-2 off the forward sensitivities (ROADMAP.md queue
    3, scripts/torch_adjoint_cpu.py horizons --jax).  To 4e6 the same solve
    succeeds."""
    problem = trob.problem_ode()
    te = [t for t in trob.T_EVAL_4E10 if t <= 4e8]
    ys_of = dtt.make_differentiable_solve(problem, te, device="cpu")
    g = grad_of(ys_of, problem.params, lambda ys: (ys**2).sum())
    assert np.all(np.isnan(g))
    assert ys_of.info["status"] == errors.TSTOP_REACHED
    assert ys_of.info["backward_status"] == errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES
    short = dtt.make_differentiable_solve(problem, te[:8], device="cpu")
    g6 = grad_of(short, problem.params, lambda ys: (ys**2).sum())
    assert short.info["backward_status"] == errors.TSTOP_REACHED
    ys, sens = dtt.solve_dense_fwd_sens(dtt.BdfSolver(problem), te[:8], device="cpu")
    g_fwd = (2.0 * torch.einsum("tn,ptn->p", ys, sens)).numpy()
    assert np.max(np.abs(g6 - g_fwd)) / np.max(np.abs(g_fwd)) < 5e-3


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _sum_sq(ys):
    return (ys**2).sum()


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's gradients and step counts, once for the module."""
    jdae = jrob.problem_dae()
    return {
        "dae": jax_grad(jax_mds, jdae, jnp.asarray([0.4, 4.0, 40.0]), _sum_sq),
        "reset": jax_grad(jax_mds, jed.problem_with_reset(), jnp.asarray([2.0, 6.0, 10.0]),
                          _sum_sq),
        "quad": jax_grad(jax_mdq, jed.problem(integrate_out=True), 4.0, jnp.sum),
    }


@pytest.mark.parametrize("case", ["dae", "reset"])
def test_solve_gradient_matches_jax(jax_grads, case):
    """make_differentiable_solve against the JAX package's: the Robertson
    DAE (singular mass: the partitioned output jump, algebraic lambda rows,
    the consistent re-initialisation) and the reset model (event
    corrections)."""
    if case == "dae":
        jp, te = jrob.problem_dae(), [0.4, 4.0, 40.0]
        tp = problem_from_jax(jp, trob.rhs_dae, trob.init, mass=trob.mass)
    else:
        jp, te = jed.problem_with_reset(), [2.0, 6.0, 10.0]
        tp = problem_from_jax(jp, ted.rhs, ted.init, root=ted.root, reset=ted.reset)
    ys_of = dtt.make_differentiable_solve(tp, te, device="cpu")
    assert_matches_jax(grad_of(ys_of, jp.params, _sum_sq), ys_of.info, jax_grads[case])


def test_quadrature_gradient_matches_jax(jax_grads):
    jp = jed.problem(integrate_out=True)
    tp = problem_from_jax(jp, ted.rhs, ted.init)
    g_of = dtt.make_differentiable_quadrature(tp, 4.0, device="cpu")
    assert_matches_jax(grad_of(g_of, jp.params, torch.sum), g_of.info, jax_grads["quad"])


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------


def test_adjoint_tolerances_reach_the_backward_solve():
    """param_atol (scaled by param_scales) is the g_p rows' absolute
    tolerance; without it the mean state atol; problem_from_jax copies all
    three."""
    from diffsol_tpu_torch.adjoint import _adjoint_problem

    base = ted.problem()
    tuned = (dtt.OdeBuilder().rhs(ted.rhs).init(ted.init).p([0.1, 1.0])
             .param_rtol(1e-5).param_atol(1e-7).param_scales([2.0, 3.0]).build())
    assert float(tuned.param_rtol) == 1e-5
    np.testing.assert_array_equal(tuned.param_atol.numpy(), [1e-7, 1e-7])
    adj = _adjoint_problem(tuned, 1.0, 2, [None])
    np.testing.assert_allclose(adj.atol.numpy(), [1e-6, 1e-6, 2e-7, 3e-7])
    np.testing.assert_allclose(_adjoint_problem(base, 1.0, 2, [None]).atol.numpy(), [1e-6] * 4)
    assert adj.linear_solver.name == "dense" and adj.t0.device.type == "cpu"
    jp = dt.OdeBuilder().rhs(jed.rhs).init(jed.init).p([0.1, 1.0]).param_rtol(1e-5) \
        .param_atol(1e-7).param_scales([2.0, 3.0]).build()
    tp = problem_from_jax(jp, ted.rhs, ted.init)
    assert float(tp.param_rtol) == 1e-5
    np.testing.assert_array_equal(tp.param_scales.numpy(), [2.0, 3.0])
    ys_of = dtt.make_differentiable_solve(tuned, [1.0], device="cpu")
    g = grad_of(ys_of, tuned.params, torch.sum)
    np.testing.assert_allclose(g, [-2.0 * math.exp(-0.1), 2.0 * math.exp(-0.1)], rtol=1e-4)


def test_torch_func_runs_inside_backward_and_no_grad():
    """The backward pass runs with grad mode off: torch.func.vjp and
    jacfwd ignore an outer no_grad (they are function transforms), so the
    adjoint rhs and Jacobian work there, and so does a gradient taken
    under no_grad's sibling, inference of the forward alone."""
    x = torch.tensor([0.3, 0.7], dtype=F64)
    with torch.no_grad():
        _, vjp = torch.func.vjp(lambda z: z * z.sum(), x)
        jac = torch.func.jacfwd(lambda z: z * z.sum())(x)
    np.testing.assert_allclose(vjp(torch.ones(2, dtype=F64))[0].numpy(), jac.sum(0).numpy())
    problem = ted.problem(rtol=1e-8, atol=1e-10)
    ys_of = dtt.make_differentiable_solve(problem, [1.0], device="cpu")
    with torch.no_grad():
        ys = ys_of(problem.params)
    assert ys.grad_fn is None and "backward" not in ys_of.info
    g = grad_of(ys_of, problem.params, torch.sum)
    np.testing.assert_allclose(g, [-2.0 * math.exp(-0.1), 2.0 * math.exp(-0.1)], rtol=1e-6)


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    """Without ``device`` the four entry points take the card and raise
    where there is none; params on another device raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    problem = ted.problem()
    quad = ted.problem(integrate_out=True)
    for make in (lambda: dtt.make_differentiable_solve(problem, [1.0]),
                 lambda: dtt.make_differentiable_quadrature(quad, 1.0),
                 lambda: dtt.make_differentiable_solve_ensemble(problem, [1.0], 2),
                 lambda: dtt.make_differentiable_quadrature_ensemble(quad, 1.0, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    ys_of = dtt.make_differentiable_solve(problem, [1.0], device="cpu")
    with pytest.raises(TypeError, match="float64"):
        ys_of(torch.ones(2))
    with pytest.raises(ValueError, match="lie on meta"):
        ys_of(torch.ones(2, dtype=F64, device="meta"))
    ens = dtt.make_differentiable_solve_ensemble(problem, [1.0], 2, device="cpu")
    with pytest.raises(ValueError, match="nbatch=2"):
        ens(torch.ones(3, 2, dtype=F64))
