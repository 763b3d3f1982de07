"""The rest of the port's sharding (``diffsol_tpu_torch/sharding.py``) on
the CPU: the Krylov tier's lockstep GMRES over a mesh, a lockstep ERK
solve whose every member's states are sharded over a second mesh axis
(``StateAxis``), and the independent gradient over a mesh.

One module fixture spawns a 2-rank gloo mesh ("dp") for the Krylov and
gradient cases of tests/torch_sharding_ranks.py, then a 4-rank (dp=2,
sp=2) mesh for the state-sharded ERK; the ranks run in the background
while this process computes the references.  Each rank's result is held

* to every other rank's, bit for bit;
* to the port's unsharded call: the Krylov tier's ys within 1e-10
  relative (its sensitivity rows within 1e-9) with equal steps, Newton
  iterations and GMRES counts (its sums over the mesh reorder the
  unsharded ones); the state-sharded ERK's five
  steps and ``solve_dense`` ``torch.equal`` to the unsharded ones on the
  rank's block; every member's independent gradient, ys, forward and
  backward ``Stats`` and statuses equal to the unsharded call's;
* and to the JAX package's sharded call on the 8 virtual CPU devices
  (tests/conftest.py): the lockstep Krylov solve over 2 of them within
  the Krylov twins' 1e-8 (tests/test_torch_krylov_lockstep.py), the
  (dp=2, sp=2) five ERK steps over 4 within the RK twins' 1e-6 relative,
  1e-14 absolute (tests/test_torch_rk.py), and the independent gradients
  of Robertson and of the banded heat1d under ``jit(in_shardings=)`` over
  2 within the independent mode's 1e-6
  (tests/test_torch_adjoint_ensemble.py).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import diffsol_tpu as dt
from diffsol_tpu.adjoint_ensemble import make_differentiable_solve_ensemble as jax_mdse
from diffsol_tpu.ensemble import make_lockstep_problem as jax_lockstep
from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.models import robertson as jrob
from diffsol_tpu.ops.banded import make_banded_jac, make_banded_solver
from diffsol_tpu.solvers.erk import ErkSolver as JaxErk

import diffsol_tpu_torch as dtt
import torch_sharding_ranks as ranks
from diffsol_tpu_torch.ensemble import make_lockstep_problem
from diffsol_tpu_torch.models import heat1d, robertson

torch.set_num_threads(1)
KRYLOV = ["heat1d_krylov_lockstep", "heat1d_krylov_sens_lockstep"]
GRADS = ["robertson_ind_grad", "heat1d_ind_grad"]
KRYLOV_REL = 1e-10  # the Krylov tier's sums over the mesh reorder
# the sensitivity rows: each row's own joint GMRES, out of the error test,
# stops at gmres_tol = 1e-6 of its residual, and the reordered sums move
# its iterate further than the state's (1.4e-10 measured at n = 5)
SENS_REL = 1e-9
TWIN_RTOL = 1e-8  # tests/test_torch_krylov_lockstep.py
TRAJ_RTOL, TRAJ_ATOL = 1e-6, 1e-14  # tests/test_torch_rk.py
IND_RTOL = 1e-6  # tests/test_torch_adjoint_ensemble.py


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The 2-rank and then the 4-rank group, run one after the other in a
    background thread: (future of the 2-rank results, of the 4-rank's)."""
    with ThreadPoolExecutor(max_workers=1) as ex:
        yield (ex.submit(ranks.spawn, [(c, 1) for c in KRYLOV + GRADS],
                         str(tmp_path_factory.mktemp("mesh2"))),
               ex.submit(ranks.spawn, [("heat1d_erk_state", 1), ("state_errors", 1)],
                         str(tmp_path_factory.mktemp("mesh2x2")), shape=(2, 2),
                         names=("dp", "sp")))


@pytest.fixture(scope="module")
def unsharded():
    return {c: ranks.run_case(c) for c in KRYLOV + GRADS + ["heat1d_erk_state"]}


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's sharded calls, each once: the lockstep Krylov solves and the
    independent gradients over 2 virtual devices, five ERK steps over a
    (dp=2, sp=2) mesh of 4."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    ref, _ = jheat.make(mgrid=ranks.KRYLOV_MGRID)
    jkry = (dt.OdeBuilder().rhs(ref.eqn.rhs).init(ref.eqn.init).p(np.asarray(ref.params))
            .rtol(1e-4).atol(1e-6).linear_solver("krylov").build())
    out = {}
    for case, sens in zip(KRYLOV, (False, True)):
        sol = dt.solve_dense_ensemble(lambda p, s=sens: dt.BdfSolver(p, sens=s), jkry,
                                      jnp.asarray(ranks.KRYLOV_T_EVAL),
                                      jnp.asarray(ranks.KRYLOV_D), mode="lockstep",
                                      mesh=mesh, max_steps=2000)
        out[case] = dict(ys=np.asarray(sol.ys), steps=int(sol.state.stats.steps),
                         newton=int(sol.state.stats.newton_iterations),
                         sens=None if sol.sens is None else np.asarray(sol.sens))
    # five ERK steps, members over "dp" and states over "sp" (tests/test_ensemble.py:123-167)
    mesh4 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    problem, _ = jheat.make(mgrid=ranks.ERK_MGRID)
    solver = JaxErk(jax_lockstep(problem, ranks.ERK_D.shape[0]))
    params = jnp.asarray(ranks.ERK_D)
    state0 = solver.init_state(params)
    y_shard = NamedSharding(mesh4, P("sp", "dp"))
    state_sh = state0.replace(y=jax.device_put(state0.y, y_shard),
                              dy=jax.device_put(state0.dy, y_shard))
    five = jax.jit(lambda st, p: jax.lax.fori_loop(0, 5, lambda i, s: solver.step(s, p), st))
    got = five(state_sh, jax.device_put(params, NamedSharding(mesh4, P("dp", None))))
    out["erk"] = dict(y=np.asarray(got.y).T, steps=int(got.stats.steps))
    # the independent gradients under jit(in_shardings=): Robertson's, and
    # the banded heat1d's (its forward Newton solves on JAX's band tier)
    heat, _ = jheat.make(mgrid=ranks.HEAT_GRAD_MGRID, rtol=1e-6, atol=1e-8)
    heat = dataclasses.replace(
        heat, linear_solver=make_banded_solver(1, 1),
        eqn=dataclasses.replace(heat.eqn, rhs_jac=make_banded_jac(heat.eqn.rhs, 1, 1)))
    shard = NamedSharding(mesh, P("dp"))
    for case, problem, t_eval, params in (
            ("robertson_ind_grad", jrob.problem_ode(), ranks.ROB_GRAD_T_EVAL,
             ranks.ROB_GRAD_PARAMS),
            ("heat1d_ind_grad", heat, ranks.HEAT_GRAD_T_EVAL, ranks.HEAT_GRAD_PARAMS)):
        ind = jax_mdse(problem, jnp.asarray(t_eval), params.shape[0], mode="independent")
        grad = jax.jit(jax.grad(lambda p, f=ind: jnp.sum(f(p) ** 2)), in_shardings=(shard,))
        out[case] = np.asarray(grad(jax.device_put(jnp.asarray(params), shard)))
    return out


@pytest.fixture(scope="module")
def mesh2(spawned, jax_sharded, unsharded):
    # the references first, while the ranks run
    return spawned[0].result()


@pytest.fixture(scope="module")
def mesh2x2(spawned, mesh2):
    return spawned[1].result()


def _same(a, b):
    """Equal bit for bit: arrays (NaN where NaN), dicts of them, numbers."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b)  # a NaN root time is its own


@pytest.mark.parametrize("case", KRYLOV + GRADS)
def test_ranks_hold_the_same_bits(mesh2, case):
    for res in mesh2[1:]:
        _same(res[case], mesh2[0][case])


@pytest.mark.parametrize("case", KRYLOV)
def test_krylov_lockstep_matches_unsharded(mesh2, unsharded, case):
    """One GMRES over both ranks' members: the unsharded solve's steps,
    Newton iterations, GMRES calls, restarts and Arnoldi iterations; ys
    within 1e-10 relative, the sensitivity rows within 1e-9."""
    ref = unsharded[case]
    for res in mesh2:
        got = res[case]
        assert got["tier"] == "lockstep" and got["stop"] == ref["stop"] == 2
        for key in ("steps", "newton_iterations"):
            assert int(got["stats"][key]) == int(ref["stats"][key]), key
        assert got["gmres"] == ref["gmres"]
        np.testing.assert_allclose(got["ys"], ref["ys"], rtol=KRYLOV_REL, atol=0.0)
        if "sens" in ref:
            np.testing.assert_allclose(got["sens"], ref["sens"], rtol=SENS_REL, atol=0.0)
    # the joint GMRES: one call a Newton iteration (and a row's), one host
    # read before the restarts and one after each
    gm = ref["gmres"]
    assert gm["host_reads"] == gm["calls"] + gm["restarts"]


@pytest.mark.parametrize("case", KRYLOV)
def test_krylov_lockstep_matches_jax_sharded(mesh2, jax_sharded, case):
    ref = jax_sharded[case]
    for res in mesh2:
        got = res[case]
        assert int(got["stats"]["steps"]) == ref["steps"]
        assert int(got["stats"]["newton_iterations"]) == ref["newton"]
        np.testing.assert_allclose(got["ys"], ref["ys"], rtol=TWIN_RTOL, atol=1e-14)
        if ref["sens"] is not None:
            np.testing.assert_allclose(got["sens"], np.swapaxes(ref["sens"], 2, 3),
                                       rtol=TWIN_RTOL, atol=1e-14)


def _block(x, coords, B=2, n=128):
    """The rank's (members over dp, states over sp) block of a whole (B, n)
    or (neval, B, n) array."""
    i, j = coords
    return x[..., B * i:B * (i + 1), n * j:n * (j + 1)]


def test_state_sharded_erk_equals_unsharded(mesh2x2, unsharded):
    """Five ERK steps and a short solve_dense over (dp=2, sp=2): every
    rank's block of y and dy, its time, step and Stats are the unsharded
    solve's bit for bit; solve_dense's ys, gathered over "sp", are its
    members' whole rows."""
    ref = unsharded["heat1d_erk_state"]
    assert sorted(res["heat1d_erk_state"]["coords"] for res in mesh2x2) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for res in mesh2x2:
        got = res["heat1d_erk_state"]
        c = got["coords"]
        for key in ("y", "dy", "final_y"):
            assert torch.equal(torch.from_numpy(got[key]), torch.from_numpy(_block(ref[key], c)))
        assert (got["t"], got["h"]) == (ref["t"], ref["h"])
        _same(got["stats"], ref["stats"])
        _same(got["sol_stats"], ref["sol_stats"])
        assert got["stats"]["steps"] == 5 and got["stop"] == ref["stop"] == 2
        i = c[0]
        assert torch.equal(torch.from_numpy(got["ys"]),
                           torch.from_numpy(ref["ys"][:, 2 * i:2 * i + 2]))


def test_state_sharded_erk_collectives_a_step(mesh2x2):
    """Each step gathers over the mesh (the rhs's states over "sp" at every
    stage, the norms' terms over "sp" and the members' maxima over "dp"):
    the port's counterpart of the JAX test's collectives in the HLO."""
    for res in mesh2x2:
        assert res["heat1d_erk_state"]["step_gathers"] >= 5


def test_state_sharded_erk_matches_jax(mesh2x2, jax_sharded):
    ref = jax_sharded["erk"]
    assert ref["steps"] == 5
    for res in mesh2x2:
        got = res["heat1d_erk_state"]
        np.testing.assert_allclose(got["y"], _block(ref["y"], got["coords"]), rtol=TRAJ_RTOL,
                                   atol=TRAJ_ATOL)


def test_state_axis_refuses(mesh2x2):
    """An n the "sp" axis does not divide raises ValueError, as JAX's
    device_put does; what a sharded state does not run yet names ROADMAP
    20f: sens=True on each solver, the Krylov and block-diagonal tiers and
    the member-time lift."""
    for res in mesh2x2:
        got = res["state_errors"]
        assert "should be divisible by 2, but it is equal to 255" in got["uneven"]
        for key, what in (("bdf_sens", "a BdfSolver with sensitivities"),
                          ("sdirk_sens", "an SdirkSolver with sensitivities"),
                          ("erk_sens", "an ErkSolver with sensitivities"),
                          ("independent", "a member-time lift"),
                          ("krylov", "the matrix-free Krylov tier"),
                          ("blockdiag", "the block-diagonal tier")):
            assert got[key].startswith(what) and "over a sharded state" in got[key], key
            assert "ROADMAP 20f" in got[key], key


def test_state_axis_refuses_what_the_solve_would_miss():
    """The member-time lift and the Krylov and block-diagonal tiers raise
    before the axis is touched; each solver with sensitivities raises at
    construction, naming ROADMAP 20f."""
    axis = object()
    problem, _ = heat1d.make(7)
    with pytest.raises(NotImplementedError, match="member-time lift.*ROADMAP 20f"):
        make_lockstep_problem(problem, 2, member_t=True, state_axis=axis)
    with pytest.raises(NotImplementedError, match="Krylov tier over a sharded state.*20f"):
        make_lockstep_problem(ranks._krylov_heat1d(7, 1e-4, 1e-6), 2, state_axis=axis)
    with pytest.raises(NotImplementedError, match="block-diagonal tier.*ROADMAP 20f"):
        make_lockstep_problem(robertson.problem_ode_groups(4), 2, state_axis=axis)
    lp = dataclasses.replace(make_lockstep_problem(problem, 2), state_axis=axis)
    for cls in (dtt.BdfSolver, dtt.SdirkSolver, dtt.ErkSolver):
        with pytest.raises(NotImplementedError,
                           match=f"{cls.__name__} with sensitivities.*ROADMAP 20f"):
            cls(lp, sens=True)


@pytest.mark.parametrize("case", GRADS)
def test_independent_gradient_equals_unsharded(mesh2, unsharded, case):
    """Each rank runs both batched passes on its block with no collective;
    ys, the gradient, the (B,) forward and backward Stats and statuses
    gathered on every rank equal the unsharded call's bit for bit."""
    ref = unsharded[case]
    for res in mesh2:
        got = res[case]
        _same(got, ref)
        assert np.isfinite(got["grad"]).all() and np.all(got["grad"] != 0.0)
        assert got["status"].tolist() == [dtt.errors.TSTOP_REACHED] * 4
    assert len(set(ref["backward"]["steps"].tolist())) > 1  # own backward sequences
    # the gathers of the results only, as many for either problem: none a step
    gathers = [mesh2[0][c + ":all_gathers"] for c in GRADS]
    assert gathers[0] == gathers[1] < int(ref["forward"]["steps"].min())


def _grad_matches_jax(mesh2, jax_sharded, case):
    for res in mesh2:
        np.testing.assert_allclose(res[case]["grad"], jax_sharded[case], rtol=IND_RTOL,
                                   atol=0.0)


def test_independent_gradient_matches_jax_sharded(mesh2, jax_sharded):
    _grad_matches_jax(mesh2, jax_sharded, "robertson_ind_grad")


def test_banded_independent_gradient_matches_jax_sharded(mesh2, jax_sharded):
    """heat1d on the banded tier: JAX's forward Newton solves run its band
    LU, the port's its plain version (K3/K4 on the card)."""
    _grad_matches_jax(mesh2, jax_sharded, "heat1d_ind_grad")
