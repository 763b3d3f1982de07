"""Root events and resets: the port against the JAX package.

Module by module on the same inputs: ``ops.rootfind.check_root`` (exact
flags, root time to 1e-12), the eager ``solve_dense`` and ``solve``
with a root that stops and one that resets (equal stop reasons, root time
to 1e-8 relative, ys to 1e-6), lockstep ensembles, and the fused tier's
plain version against the Pallas kernel in interpret mode at the
configurations of tests/test_pallas_stepper.py:196 (root stop), :239
(bouncing ball) and :346 (inconsistent crossing), B = 4 in one tile.  The
JAX kernel keeps its norms and controller in float32 and its state in
double-float pairs; the port is float64 throughout, so trajectories agree
to ~1e-7 relative (1e-6 is the bound) and polished root times likewise.
Each JAX solve runs once, in a module-scoped fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.ensemble import solve_dense_ensemble as jax_ensemble
from diffsol_tpu.models import exponential_decay as jed
from diffsol_tpu.ops import rootfind as jroot

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.drivers import solve as torch_solve
from diffsol_tpu_torch.interop import problem_from_jax, solution_to_numpy
from diffsol_tpu_torch.models import exponential_decay as ted
from diffsol_tpu_torch.models import fused_cases as fc
from diffsol_tpu_torch.ops import rootfind as troot

torch.set_num_threads(1)

B = 4
F64 = torch.float64
# fused tier, port (f64 heuristics) vs Pallas interpret (f32 heuristics)
FUSED_RTOL, FUSED_ATOL = 1e-6, 1e-9
ROOT_T_RTOL = 1e-6
# after the bounce both kernels restart at order 1 with small steps, where
# the float32 and float64 controllers part by two accepted steps of ~78
# (ROADMAP.md queue 3); every other case takes equal steps
BOUNCE_STEP_SLACK = 2


def _jax_problem(case):
    b = dt.OdeBuilder().rtol(1e-6).atol(1e-8)
    if case == "root_stop":
        return (b.rhs(lambda t, y, p: -p[0] * y).init(lambda t, p: jnp.array([1.0]))
                .root(lambda t, y, p: y[0:1] - 0.5).p([1.0]).build())
    return (b.rhs(lambda t, y, p: jnp.stack([y[1], -p[0] * jnp.ones_like(y[1])]))
            .init(lambda t, p: jnp.array([10.0, 0.0]))
            .root(lambda t, y, p: y[0:1])
            .reset(lambda t, y, p: jnp.stack([jnp.full_like(y[0], 1e-9), -p[1] * y[1]]))
            .p([9.81, 0.8]).build())


def _np_sol(sol):
    return dict(ys=np.asarray(sol.ys), stop=int(sol.stop_reason),
                root_t=float(sol.root_t), root_idx=int(sol.root_idx),
                steps=None if sol.tile_steps is None else np.asarray(sol.tile_steps))


CASES = {
    "root_stop": (fc.ROOT_STOP_T_EVAL, np.ones((B, 1))),
    "bounce": (fc.BALL_T_EVAL, np.tile(fc.BALL_P, (B, 1))),
    # test_pallas_stepper.py:346's rates, on the root-stop case's t_eval so
    # that the JAX side reuses its compiled kernel
    "inconsistent": (fc.ROOT_STOP_T_EVAL, np.array([[0.5], [1.0], [2.0], [4.0]])),
}


@pytest.fixture(scope="module")
def jax_fused():
    """Every fused case once through the Pallas kernel in interpret mode."""
    out = {}
    problems = {"root_stop": _jax_problem("root_stop"), "bounce": _jax_problem("bounce")}
    problems["inconsistent"] = problems["root_stop"]
    for case, (t_eval, params) in CASES.items():
        problem = problems[case]
        out[case] = _np_sol(jax_ensemble(dt.BdfSolver, problem, t_eval,
                                         jnp.asarray(params), mode="fused",
                                         interpret=True))
    return out


def _port_fused(case):
    t_eval, params = CASES[case]
    problem = (fc.bouncing_ball_problem() if case == "bounce"
               else fc.root_stop_problem())
    return dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval, params,
                                    mode="fused", tile=B, device="cpu")


def test_fused_root_stop_matches_pallas_interpret(jax_fused):
    ref = jax_fused["root_stop"]
    sol = _port_fused("root_stop")
    assert sol.tier == "fused_small_reference"
    assert sol.stop_reason == ref["stop"] == dtt.errors.ROOT_FOUND
    assert sol.root_idx == ref["root_idx"] == 0
    assert sol.tile_steps.tolist() == ref["steps"].tolist()
    np.testing.assert_allclose(sol.root_t, ref["root_t"], rtol=ROOT_T_RTOL)
    np.testing.assert_allclose(sol.root_t, np.log(2.0), rtol=1e-5)
    np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=FUSED_RTOL,
                               atol=FUSED_ATOL)
    assert sol.n_points == len(fc.ROOT_STOP_T_EVAL)
    assert bool((sol.ys[2:] == 0.0).all())  # zeros past the root


def test_fused_bounce_matches_pallas_interpret(jax_fused):
    ref = jax_fused["bounce"]
    sol = _port_fused("bounce")
    assert sol.stop_reason == ref["stop"] == dtt.errors.TSTOP_REACHED
    assert abs(int(sol.tile_steps[0]) - int(ref["steps"][0])) <= BOUNCE_STEP_SLACK
    # different step sequences: agreement at the solver's tolerance
    np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=2e-4, atol=1e-6)
    # and the closed form of the height, at the solver's tolerance
    np.testing.assert_allclose(sol.ys[:, 0, 0].numpy(), fc.ball_height(fc.BALL_T_EVAL),
                               rtol=2e-4, atol=1e-6)
    assert np.isnan(sol.root_t) and sol.root_idx == -1  # no root is reported


def test_fused_inconsistent_crossing_fails_loudly(jax_fused):
    sol = _port_fused("inconsistent")
    assert sol.stop_reason == jax_fused["inconsistent"]["stop"]
    assert sol.stop_reason == dtt.errors.ROOT_BATCH_INCONSISTENT
    assert not bool(torch.isfinite(sol.ys).any())


def test_fused_tiles_must_stop_together():
    """Two tiles that each agree within themselves but of which only one
    reaches its root: ROOT_BATCH_INCONSISTENT (JAX ensemble.py:385-398)."""
    rates = np.array([[0.1], [0.1], [2.0], [2.0]])
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, fc.root_stop_problem(), [0.5, 1.0],
                                   rates, mode="fused", tile=2, device="cpu")
    assert sol.stop_reason == dtt.errors.ROOT_BATCH_INCONSISTENT


def test_fused_rejects_roots_with_a_mass():
    from diffsol_tpu_torch.ops.eqn_codegen import UnsupportedForKernel

    problem = (
        dtt.OdeBuilder()
        .rhs(lambda t, y, p: torch.stack([-p[0] * y[0], y[0] - y[1]]))
        .init(lambda t, p: torch.ones(2, dtype=F64))
        .mass(lambda t, p: torch.diag(torch.tensor([1.0, 0.0], dtype=F64)))
        .root(lambda t, y, p: y[0:1] - 0.5)
        .p([1.0])
        .build()
    )
    with pytest.raises(UnsupportedForKernel, match="events with a mass"):
        dtt.solve_dense_ensemble(dtt.BdfSolver, problem, [1.0], np.ones((4, 1)),
                                 mode="fused", device="cpu")
    # auto goes lockstep, where the root stops the batch
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, [0.5, 1.0], np.ones((4, 1)),
                                   mode="auto", device="cpu")
    assert sol.tier == "lockstep" and sol.stop_reason == dtt.errors.ROOT_FOUND
    np.testing.assert_allclose(sol.root_t, np.log(2.0), rtol=1e-5)


# ---------------------------------------------------------------------------
# ops/rootfind.check_root
# ---------------------------------------------------------------------------

def _interp_pair(rates):
    """Exact 'interpolants' y(t) = exp(-a t) for the rates given, and the
    root function y - 0.5, in both packages' lockstep layouts."""
    a_j = jnp.asarray(rates)
    a_t = torch.tensor(rates, dtype=F64)
    if len(rates) == 1:
        return ((lambda t, y: y - 0.5), (lambda t: jnp.exp(-a_j * t)),
                (lambda t, y: y - 0.5), (lambda t: torch.exp(-a_t * t)))
    return ((lambda t, y: y - 0.5), (lambda t: jnp.exp(-a_j * t)[None, :]),
            (lambda t, y: y - 0.5), (lambda t: torch.exp(-a_t * t)[:, None]))


@pytest.mark.parametrize("case,rates,t0,t1", [
    ("crossing", [1.0], 0.5, 0.9),
    ("non_crossing", [1.0], 0.1, 0.4),
    ("batch_crossing", [1.0, 1.0, 1.0], 0.5, 0.9),
    ("batch_inconsistent", [1.0, 0.2, 1.0], 0.5, 0.9),
    ("batch_non_crossing", [1.0, 1.1, 0.9], 0.1, 0.4),
])
def test_check_root_matches_jax(case, rates, t0, t1):
    jroot_fn, jinterp, troot_fn, tinterp = _interp_pair(rates)
    nb = len(rates)
    ref = jroot.check_root(jroot_fn, jinterp, jroot_fn(t0, jinterp(t0)), jnp.asarray(t0),
                           jinterp(t1), jnp.asarray(t1), nbatch=nb)
    got = troot.check_root(troot_fn, tinterp, troot_fn(t0, tinterp(t0)), t0,
                           tinterp(t1), t1, nbatch=nb)
    assert got.found == bool(ref.found)
    assert got.inconsistent == bool(ref.inconsistent)
    if got.found:
        assert got.root_idx == int(ref.root_idx)
        np.testing.assert_allclose(got.t_root, float(ref.t_root), rtol=1e-12)
        np.testing.assert_allclose(got.t_root, np.log(2.0), rtol=1e-12)
    g_ref = np.asarray(ref.g0_next)
    np.testing.assert_allclose(got.g0_next.numpy(), g_ref.T if nb > 1 else g_ref,
                               rtol=1e-15)


def test_root_finding_picks_the_strongest_crossing():
    g0, g1 = [1.0, 1.0, -1.0], [-1.0, -3.0, 0.0]
    ref = jroot.root_finding(jnp.asarray(g0), jnp.asarray(g1))
    got = troot.root_finding(g0, g1)
    assert got[0] == bool(ref[0]) and got[2] == int(ref[2]) == 1
    np.testing.assert_allclose(got[1], float(ref[1]), rtol=1e-15)
    assert troot.root_finding([1.0, 2.0], [0.5, 1.0]) == (False, 0.0, -1)


# ---------------------------------------------------------------------------
# solve_dense and solve
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_eager():
    t_eval = jnp.asarray([1.0, 4.0, 6.0, 10.0])
    root = dt.solve_dense(dt.BdfSolver(jed.problem_with_root()), t_eval)
    reset = dt.solve_dense(dt.BdfSolver(jed.problem_with_reset()), t_eval)
    adaptive = dt.solve(dt.BdfSolver(jed.problem_with_root()), 10.0, max_steps=500)
    lp = dt.ensemble.make_lockstep_problem(jed.problem_with_root(), B)
    lock = dt.solve_dense(dt.BdfSolver(lp), t_eval,
                          params=jnp.tile(jnp.asarray([0.1, 1.0]), (B, 1)))
    n = int(adaptive.n_points)
    return dict(
        root=_np_sol(root), reset=_np_sol(reset), lock=_np_sol(lock),
        adaptive=dict(n=n, ts=np.asarray(adaptive.ts)[:n], ys=np.asarray(adaptive.ys)[:n],
                      stop=int(adaptive.stop_reason), root_t=float(adaptive.root_t)),
    )


T_EAGER = [1.0, 4.0, 6.0, 10.0]


def test_solve_dense_root_stop_matches_jax(jax_eager):
    ref = jax_eager["root"]
    problem = problem_from_jax(jed.problem_with_root(), ted.rhs, ted.init, root=ted.root)
    sol = dtt.solve_dense(dtt.BdfSolver(problem), T_EAGER, device="cpu")
    assert sol.stop_reason == ref["stop"] == dtt.errors.ROOT_FOUND
    assert sol.root_idx == ref["root_idx"] == 0
    np.testing.assert_allclose(sol.root_t, ref["root_t"], rtol=1e-8)
    np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=1e-6, atol=1e-12)
    assert sol.n_points == 4 and bool((sol.ys[2:] == 0.0).all())
    np.testing.assert_allclose(sol.state.t, sol.root_t)  # pinned to the root
    got = solution_to_numpy(sol)
    assert got["root_idx"] == 0 and got["gs"] is None
    np.testing.assert_allclose(got["root_t"], ref["root_t"], rtol=1e-8)


def test_solve_dense_reset_and_continue_matches_jax(jax_eager):
    ref = jax_eager["reset"]
    problem = problem_from_jax(jed.problem_with_reset(), ted.rhs, ted.init,
                               root=ted.root, reset=ted.reset)
    sol = dtt.solve_dense(dtt.BdfSolver(problem), T_EAGER, device="cpu")
    assert sol.stop_reason == ref["stop"] == dtt.errors.TSTOP_REACHED
    assert np.isnan(sol.root_t) and np.isnan(ref["root_t"])
    np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=1e-6, atol=1e-12)
    # back at 1 after the reset at t = -ln(0.6)/0.1 ~ 5.108
    np.testing.assert_allclose(sol.ys[2, 0].item(), np.exp(-0.1 * (6.0 + np.log(0.6) / 0.1)),
                               rtol=1e-5)


def test_solve_records_every_step_up_to_the_root(jax_eager):
    ref = jax_eager["adaptive"]
    sol = torch_solve(dtt.BdfSolver(ted.problem_with_root()), 10.0, max_steps=500,
                      device="cpu")
    assert sol.stop_reason == ref["stop"] == dtt.errors.ROOT_FOUND
    assert sol.n_points == ref["n"]
    n = sol.n_points
    np.testing.assert_allclose(sol.ts[:n].numpy(), ref["ts"], rtol=1e-6)
    np.testing.assert_allclose(sol.ys[:n].numpy(), ref["ys"], rtol=1e-6)
    np.testing.assert_allclose(sol.root_t, ref["root_t"], rtol=1e-8)
    assert bool(torch.isnan(sol.ts[n:]).all()) and sol.ts.shape[0] == 502
    np.testing.assert_allclose(sol.ys[n - 1, 0].item(), 0.6, rtol=1e-6)


def test_lockstep_root_matches_jax(jax_eager):
    ref = jax_eager["lock"]
    params = np.tile([0.1, 1.0], (B, 1))
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, ted.problem_with_root(), T_EAGER,
                                   params, mode="lockstep", device="cpu")
    assert sol.stop_reason == ref["stop"] == dtt.errors.ROOT_FOUND
    np.testing.assert_allclose(sol.root_t, ref["root_t"], rtol=1e-8)
    np.testing.assert_allclose(sol.ys.numpy(), np.moveaxis(ref["ys"], -1, 1),
                               rtol=1e-6, atol=1e-12)
    # members that cross at different times fail the batch
    params[1, 0] = 0.3
    bad = dtt.solve_dense_ensemble(dtt.BdfSolver, ted.problem_with_root(), T_EAGER,
                                   params, mode="lockstep", device="cpu")
    assert bad.stop_reason == dtt.errors.ROOT_BATCH_INCONSISTENT


def test_bounce_steps_with_the_pallas_cpu_product_rounding(jax_fused, monkeypatch):
    """With the rounding the Pallas kernel shows in interpret mode on the
    CPU (fused_cases.pallas_cpu_tile_product) on the plain version's
    tile-scalar products, the bouncing ball comes within one accepted step
    of the JAX kernel (78 against 77; 79 without it)."""
    from diffsol_tpu_torch.ops import fused_stepper as fs

    monkeypatch.setattr(fs, "_tile_mul", fc.pallas_cpu_tile_product)
    sol = _port_fused("bounce")
    ref = jax_fused["bounce"]
    assert sol.stop_reason == ref["stop"] == dtt.errors.TSTOP_REACHED
    assert abs(int(sol.tile_steps[0]) - int(ref["steps"][0])) <= 1
    np.testing.assert_allclose(sol.ys.numpy(), ref["ys"], rtol=2e-4, atol=1e-6)
