"""``mode="independent"``: every member with its own step control.

A ``BdfSolver`` over the dense or banded tier runs batched
(:mod:`diffsol_tpu_torch.solvers.bdf_independent`: one loop, each member
its own step size, order, Newton iteration, Jacobian policy, events and
stop); the other solvers' routing is checked here too (SDIRK, ERK,
sens=True, the Krylov tier and the adjoint's independent mode, all
batched), and their batched loops in tests/test_torch_independent_rk.py,
tests/test_torch_independent_krylov.py and
tests/test_torch_independent_adjoint.py.  Each member of a
batched solve is held to the port's own single solve of that member: the
same accepted steps, Newton iterations and Jacobian evaluations (its
whole ``Stats``), the same stop, and ys within 1e-12 + 1e-10 |ref|.  The
single solves are the twins the other files hold to JAX; two cases go to
JAX's ``vmap`` independent mode directly (one module fixture): the
stop-at-root and the bouncing balls over three gravities
(tests/test_ensemble.py:300-331's case), root times within 1e-8 and ys
within the bouncing-ball twin's 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.drivers import solve_dense
from diffsol_tpu_torch.models import fused_cases as fc
from diffsol_tpu_torch.models import heat1d
from diffsol_tpu_torch.models import robertson as rob
from diffsol_tpu_torch.solvers.bdf_independent import IndependentState

torch.set_num_threads(1)
F64 = torch.float64
GRAVITIES = [[6.0], [9.81], [15.0]]
BALL_T_EVAL = [0.5, 1.5, 2.5]
ROOT_T_TOL = 1e-8
JAX_RTOL, JAX_ATOL = 1e-6, 1e-7  # the bouncing-ball twins' bound


def _ball(builder, xp, reset: bool):
    ones = (lambda v: jnp.ones_like(v)) if xp is jnp else torch.ones_like
    if xp is jnp:
        init = lambda t, p: jnp.array([10.0, 0.0])  # noqa: E731
        rst = lambda t, y, p: jnp.stack([jnp.full_like(y[0], 1e-9), -0.8 * y[1]])  # noqa: E731
    else:
        init = lambda t, p: torch.tensor([10.0, 0.0], dtype=F64, device=p.device)  # noqa: E731
        rst = lambda t, y, p: torch.stack([torch.full_like(y[0], 1e-9), -0.8 * y[1]])  # noqa: E731
    b = (builder().rhs(lambda t, y, p: xp.stack([y[1], -p[0] * ones(y[1])]))
         .init(init).root(lambda t, y, p: y[0:1]).p([9.81]).rtol(1e-8).atol(1e-10))
    if reset:
        b = b.reset(rst)
    return b.build()


@pytest.fixture(scope="module")
def jax_balls():
    """JAX's independent mode (vmap) on both ball problems, B = 3."""
    out = {}
    for reset in (False, True):
        sol = dt.solve_dense_ensemble(dt.BdfSolver, _ball(dt.OdeBuilder, jnp, reset),
                                      jnp.asarray(BALL_T_EVAL), jnp.asarray(GRAVITIES),
                                      mode="independent", max_steps=4000)
        out[reset] = dict(ys=np.asarray(sol.ys), stop=np.asarray(sol.stop_reason),
                          root_t=np.asarray(sol.root_t), root_idx=np.asarray(sol.root_idx))
    return out


def _batched(problem, t_eval, pb, max_steps=100_000):
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval, pb, mode="independent",
                                   max_steps=max_steps, device="cpu")
    assert sol.tier == "independent" and isinstance(sol.state, IndependentState)
    return sol


def _members_match(sol, problem, t_eval, pb, max_steps=100_000):
    """Each member against its own single solve: Stats, stop, root, ys
    (and gs) within 1e-12 + 1e-10 |ref|."""
    pb = torch.as_tensor(pb, dtype=F64)
    for b in range(pb.shape[0]):
        one = solve_dense(dtt.BdfSolver(problem), t_eval, params=pb[b], max_steps=max_steps,
                          device="cpu")
        assert dataclasses.asdict(sol.state.member_stats(b)) == dataclasses.asdict(
            one.state.stats), b
        assert int(sol.stop_reason[b]) == one.stop_reason, b
        assert int(sol.root_idx[b]) == one.root_idx
        if one.root_idx >= 0:
            assert float(sol.root_t[b]) == pytest.approx(one.root_t, rel=1e-12)
        pairs = [(sol.ys[:, b], one.ys)]
        if one.gs is not None:
            pairs.append((sol.gs[:, b], one.gs))
        for got, ref in pairs:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)
    return sol


def test_solution_fields_per_member_stop_at_root(jax_balls):
    """Each member's own root_t/root_idx/stop_reason as (B,)
    tensors, one batched state, and the root times of JAX's vmap."""
    problem = _ball(dtt.OdeBuilder, torch, reset=False)
    sol = _members_match(_batched(problem, BALL_T_EVAL, GRAVITIES), problem, BALL_T_EVAL,
                         GRAVITIES)
    ref = jax_balls[False]
    assert sol.stop_reason.dtype == torch.int64 and tuple(sol.stop_reason.shape) == (3,)
    assert sol.stop_reason.tolist() == ref["stop"].tolist() == [errors.ROOT_FOUND] * 3
    assert tuple(sol.root_t.shape) == tuple(sol.root_idx.shape) == (3,)
    np.testing.assert_allclose(sol.root_t.numpy(), ref["root_t"], rtol=0, atol=ROOT_T_TOL)
    assert sol.root_idx.tolist() == ref["root_idx"].tolist() == [0, 0, 0]
    # each ball lands at sqrt(2 h / g), and stops there
    np.testing.assert_allclose(sol.root_t.numpy(), np.sqrt(20.0 / np.ravel(GRAVITIES)),
                               rtol=1e-6)
    np.testing.assert_allclose(sol.state.t.numpy(), sol.root_t.numpy(), rtol=1e-15)
    assert sol.raise_for_status() is sol


def test_bouncing_balls_with_resets_match_jax_vmap(jax_balls):
    """tests/test_ensemble.py:300-331: each ball bounces at its own times."""
    problem = _ball(dtt.OdeBuilder, torch, reset=True)
    sol = _members_match(_batched(problem, BALL_T_EVAL, GRAVITIES, max_steps=4000), problem,
                         BALL_T_EVAL, GRAVITIES, max_steps=4000)
    ref = jax_balls[True]
    assert sol.stop_reason.tolist() == ref["stop"].tolist() == [errors.TSTOP_REACHED] * 3
    np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=JAX_RTOL, atol=JAX_ATOL)
    # the members crossed at different times: the restarts came per member
    assert len(set(sol.state.stats.steps.tolist())) == 3


def _robertson_params(B):
    k1 = 0.04 * np.geomspace(0.5, 4.0, B)
    return np.stack([k1, np.full(B, 1e4), np.full(B, 3e7)], axis=1)


def test_robertson_members_take_their_single_solves_steps():
    t_eval = rob.T_EVAL_4E10[:8]
    sol = _members_match(_batched(rob.problem_ode(), t_eval, _robertson_params(4)),
                         rob.problem_ode(), t_eval, _robertson_params(4))
    assert sol.stop_reason.tolist() == [errors.TSTOP_REACHED] * 4
    assert len(set(sol.state.stats.steps.tolist())) > 1  # own step sequences
    np.testing.assert_allclose(sol.ys[-1, 1].numpy(), rob.SOLN[8, 1:], rtol=5e-2, atol=1e-9)


@pytest.mark.parametrize("B", [2, 8])
def test_host_reads_per_round_do_not_grow_with_the_batch(B):
    """Rounds, host reads and Newton sweeps counted on the state: at most
    2 + (Newton iterations) + 1 reads a round, whatever B."""
    sol = _batched(rob.problem_ode(), rob.T_EVAL_4E10[:4], _robertson_params(B))
    st = sol.state
    max_newton = dtt.SolverConfig.from_options(rob.problem_ode().options, "bdf") \
        .maximum_newton_iterations
    assert st.rounds >= int(st.stats.steps.max())
    assert st.host_reads <= st.rounds * (3 + max_newton)
    assert st.newton_sweeps <= st.rounds * max_newton


def test_control_powers_are_the_single_solves_floats():
    """The batched step control computes its powers on the host: bit for
    bit the single solve's Python floats (``pi_controller_raw`` on
    numbers, ``x ** y``), whatever PyTorch's own pow would round."""
    from diffsol_tpu_torch.ops.controller import _raw_of_numbers
    from diffsol_tpu_torch.solvers.bdf_independent import _Batched

    problem = rob.problem_ode()
    run = _Batched(dtt.BdfSolver(problem), torch.tensor(_robertson_params(2)))
    rng = np.random.default_rng(5)
    m = 4000
    err = 10.0 ** rng.uniform(-35.0, 35.0, m)
    prev = np.where(rng.random(m) < 0.2, np.nan, 10.0 ** rng.uniform(-12.0, 3.0, m))
    order = rng.integers(1, 7, m)
    mask = rng.random(m) < 0.9
    got = run.pi_raw(torch.tensor(err), torch.tensor(prev), torch.tensor(order),
                     torch.tensor(mask)).numpy()
    opts = problem.options
    want = [_raw_of_numbers(e, p, opts.pi_control_integral, opts.pi_control_proportional, k)
            if mk else 1.0 for e, p, k, mk in zip(err, prev, order, mask)]
    assert got.tolist() == want
    base, expo = rng.uniform(0.0, 2.0, m), rng.uniform(-2.0, 2.0, m)
    got = run.pow(torch.tensor(base), torch.tensor(expo), torch.tensor(mask)).numpy()
    assert got.tolist() == [float(b) ** float(e) if mk else 1.0
                            for b, e, mk in zip(base, expo, mask)]
    assert run.reads == 2


def test_diagonal_mass_dae_members():
    """Robertson DAE (mass diag(1, 1, 0)): consistent initial conditions
    solved member by member, then each member's own steps."""
    t_eval = rob.T_EVAL_4E10[:5]
    pb = _robertson_params(3)
    problem = rob.problem_dae()
    sol = _members_match(_batched(problem, t_eval, pb), problem, t_eval, pb)
    np.testing.assert_allclose(sol.ys.sum(-1).numpy(), 1.0, atol=1e-6)


def test_dense_mass_members():
    """M = [[1, .5], [0, 1]], M y' = -a y (tests/test_torch_mass.py's case)."""
    m2 = [[1.0, 0.5], [0.0, 1.0]]
    problem = (dtt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y)
               .init(lambda t, p: torch.ones(2, dtype=F64, device=p.device))
               .mass(lambda t, p: torch.tensor(m2, dtype=F64, device=p.device))
               .p([1.0]).rtol(1e-8).atol(1e-10).build())
    assert problem.eqn.mass_diag_fn is None
    t_eval = [0.5, 1.0, 2.0]
    pb = [[0.5], [1.0], [2.0]]
    sol = _members_match(_batched(problem, t_eval, pb), problem, t_eval, pb)
    a = np.ravel(pb)[None, :]
    te = np.asarray(t_eval)[:, None]
    np.testing.assert_allclose(sol.ys[..., 1].numpy(), np.exp(-a * te), rtol=1e-6)


def test_quadrature_members():
    """fc.quadrature_problem(): gD beside D, per member."""
    pb = [[0.1, 1.0], [0.5, 2.0], [2.0, 0.5]]
    problem = fc.quadrature_problem()
    sol = _members_match(_batched(problem, fc.QUAD_T_EVAL, pb), problem, fc.QUAD_T_EVAL, pb)
    a, y0 = np.asarray(pb)[:, 0], np.asarray(pb)[:, 1]
    te = np.asarray(fc.QUAD_T_EVAL)[:, None]
    np.testing.assert_allclose(sol.gs[:, :, 0].numpy(), y0 * (1.0 - np.exp(-a * te)) / a,
                               rtol=1e-5)


def test_stop_between_t_eval_points():
    """Decay stopping at its root y = 0.5 (t = ln 2 / a) between output
    points, each member at its own; the points past a member's stop stay
    zero."""
    pb = [[0.5], [1.0], [2.0], [4.0]]
    problem = fc.root_stop_problem()
    t_eval = fc.ROOT_STOP_T_EVAL
    sol = _members_match(_batched(problem, t_eval, pb), problem, t_eval, pb)
    np.testing.assert_allclose(sol.root_t.numpy(), np.log(2.0) / np.ravel(pb), rtol=1e-6)
    past = np.asarray(t_eval)[:, None] > sol.root_t.numpy()[None, :]
    assert past.any() and (~past).any()
    assert float(sol.ys[torch.as_tensor(past)].abs().max()) == 0.0


def test_banded_heat1d_members():
    """heat1d n = 16 on the banded tier, four diffusivities: the band LU's
    plain versions factor the refreshed members' bands and solve every
    member against its own factors."""
    problem, soln = heat1d.make(mgrid=15, banded=True)
    assert problem.linear_solver.name.startswith("banded")
    t_eval = [0.01, 0.05, 0.1]
    pb = [[0.5], [1.0], [1.5], [2.0]]
    sol = _members_match(_batched(problem, t_eval, pb), problem, t_eval, pb)
    # the series solves the PDE: at 16 points the grid's own error, ~1e-3
    for b, (d,) in enumerate(pb):
        np.testing.assert_allclose(sol.ys[:, b].numpy(), soln(t_eval, d), atol=2e-3)


def test_max_steps_member_and_raise_for_status():
    """One member runs out of steps while the others finish; the ensemble
    raises naming it."""
    pb = [[0.5], [1.0], [5.0]]  # 60, 85 and 174 steps
    problem = (dtt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y * (1.0 + torch.sin(p[0] * t)))
               .init(lambda t, p: torch.ones(1, dtype=F64, device=p.device))
               .p([1.0]).rtol(1e-6).atol(1e-8).build())
    t_eval = [1.0, 2.0, 4.0]
    sol = _members_match(_batched(problem, t_eval, pb, max_steps=120), problem, t_eval, pb,
                         max_steps=120)
    assert sol.stop_reason.tolist() == [errors.TSTOP_REACHED, errors.TSTOP_REACHED,
                                        errors.MAX_STEPS_REACHED]
    with pytest.raises(errors.DiffsolError, match="member 2") as exc:
        sol.raise_for_status()
    assert exc.value.code == errors.MAX_STEPS_REACHED and exc.value.member == 2
    assert exc.value.t == pytest.approx(float(sol.state.t[2]))


@pytest.mark.parametrize("method", ["tr_bdf2", "tsit45", "bdf_sens", "krylov", "adjoint"])
def test_other_solvers_keep_the_member_loop(method):
    """The routing of the other solvers: SDIRK, ERK, sens=True and the
    Krylov tier run the batched loops (solvers/rk_independent.py,
    solvers/bdf_independent.py), each member its single solve's steps and
    root; the adjoint's independent mode runs one batched forward and one
    batched backward (adjoint_independent.py), each member its single
    differentiable solve's outputs, forward Stats and gradient."""
    from diffsol_tpu_torch.adjoint import make_differentiable_solve
    from diffsol_tpu_torch.adjoint_ensemble import make_differentiable_solve_ensemble
    from diffsol_tpu_torch.solvers.rk_independent import RkIndependentState

    pb = [[0.5], [1.0], [2.0]]
    problem = fc.root_stop_problem()
    if method == "adjoint":
        decay = (dtt.OdeBuilder().rhs(fc.decay_rhs).init(fc.decay_init).p([1.0])
                 .rtol(1e-6).atol(1e-8).build())
        te = [0.5, 1.0]
        ys_of = make_differentiable_solve_ensemble(decay, te, 3, mode="independent",
                                                   device="cpu")
        params = torch.tensor(pb, dtype=F64, requires_grad=True)
        ys = ys_of(params)
        (grad,) = torch.autograd.grad((ys**2).sum(), params)
        fwd = ys_of.info["forward"]
        for b in range(3):
            one = make_differentiable_solve(decay, te, device="cpu")
            pb_b = params[b].detach().clone().requires_grad_(True)
            ys_b = one(pb_b)
            (grad_b,) = torch.autograd.grad((ys_b**2).sum(), pb_b)
            assert {f.name: int(getattr(fwd, f.name)[b]) for f in dataclasses.fields(fwd)} \
                == dataclasses.asdict(one.info["forward"])
            np.testing.assert_allclose(ys[:, b].detach().numpy(), ys_b.detach().numpy(),
                                       rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(grad[b].numpy(), grad_b.numpy(), rtol=1e-10,
                                       atol=1e-12)
        return
    if method == "bdf_sens":
        make = lambda pr: dtt.BdfSolver(pr, sens=True)  # noqa: E731
    elif method == "krylov":
        problem = (dtt.OdeBuilder().rhs(fc.decay_rhs).init(fc.decay_init).root(fc.decay_root)
                   .p([1.0]).rtol(1e-6).atol(1e-8).linear_solver("krylov").build())
        make = dtt.BdfSolver
    else:
        make = lambda pr: dtt.solver(pr, method)  # noqa: E731
    sol = dtt.solve_dense_ensemble(make, problem, fc.ROOT_STOP_T_EVAL, pb,
                                   mode="independent", device="cpu")
    assert sol.tier == "independent"
    assert isinstance(sol.state, (IndependentState, RkIndependentState))
    assert sol.stop_reason.tolist() == [errors.ROOT_FOUND] * 3
    assert sol.root_idx.tolist() == [0, 0, 0]
    # the root on each method's own interpolant (TR-BDF2's is 2e-5 off)
    np.testing.assert_allclose(sol.root_t.numpy(), np.log(2.0) / np.ravel(pb), rtol=1e-4)
    assert tuple(sol.state.y.shape) == (3, 1) and tuple(sol.state.t.shape) == (3,)
    for b in range(3):
        one = solve_dense(make(problem), fc.ROOT_STOP_T_EVAL, params=torch.tensor(pb[b]),
                          device="cpu")
        # the batched member takes its single solve's steps; its dense
        # output rounds apart (a (B,) theta's weights are a matrix
        # product, the single solve's a matrix-vector one)
        assert dataclasses.asdict(sol.state.member_stats(b)) == dataclasses.asdict(
            one.state.stats)
        assert float(sol.root_t[b]) == pytest.approx(one.root_t, rel=1e-12)
        np.testing.assert_allclose(sol.ys[:, b].numpy(), one.ys.numpy(), rtol=1e-10,
                                   atol=1e-12)
