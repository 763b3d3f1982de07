"""Multi-device sharding (``diffsol_tpu_torch/sharding.py``):
``solve_dense_ensemble(..., mesh=, axis=)`` in its three modes and the
lockstep gradient over a torch ``DeviceMesh``, on the CPU.

One module fixture spawns a 2-rank gloo mesh ("dp") once and runs every
case of tests/torch_sharding_ranks.py there, then 4 ranks as a (dp=2,
sp=2) mesh, sharded on "dp" with "sp" as replicas; the ranks run in the
background while this process computes the references.  Each rank gets
the whole result, and each is held

* to the port's unsharded call: lockstep bit for bit in its step sequence
  (equal ``Stats``, stop and root) with ys within 1e-13 relative; a fused
  shard to the unsharded fused call on the same block of members (equal
  statuses and tile steps, ys within 1e-12 + 1e-9 |ref|); an independent
  member's whole ``Stats`` to its own single solve's; the gradient within
  1e-10 relative;
* and to the JAX package's sharded call on 2 of the 8 virtual CPU devices
  (tests/conftest.py): lockstep at the lockstep twins' bound (1e-6
  relative, 1e-14 absolute, steps within 2, as tests/test_torch_ensemble.py),
  the fused tier at the interpret-mode kernel's (5e-3 relative, 1e-8
  absolute) and the independent members at the vmap twins' (1e-6
  relative, 1e-7 absolute, as tests/test_torch_independent.py).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import diffsol_tpu as dt
from diffsol_tpu.models import exponential_decay as jed
from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.models import robertson as jrob
from diffsol_tpu.ops.banded import make_banded_jac, make_banded_solver

import diffsol_tpu_torch as dtt
import torch_sharding_ranks as ranks
from diffsol_tpu_torch.drivers import solve_dense
from diffsol_tpu_torch.ensemble import make_lockstep_problem
from diffsol_tpu_torch.models import exponential_decay as ted

torch.set_num_threads(1)
F64 = torch.float64

LOCKSTEP = ["decay_lockstep", "decay_sdirk_lockstep", "decay_sens_lockstep",
            "decay_root_lockstep", "heat1d_lockstep", "blockdiag_lockstep", "dae_lockstep"]
FUSED = ["robertson_fused", "heat1d_fused"]
INDEPENDENT = ["decay_independent", "decay_sdirk_independent", "decay_loop_independent"]
INDEPENDENT_SENS = ["decay_sens_independent", "decay_sdirk_sens_independent"]
CASES = LOCKSTEP + FUSED + INDEPENDENT + INDEPENDENT_SENS + ["oscillator_grad", "errors"]
REL = 1e-13  # sharded lockstep against unsharded: the same arithmetic
JAX_RTOL, JAX_ATOL, STEP_SLACK = 1e-6, 1e-14, 2
FUSED_JAX_RTOL, FUSED_JAX_ATOL = 5e-3, 1e-8
IND_JAX_RTOL, IND_JAX_ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The 2-rank and then the 4-rank group, run one after the other in a
    background thread: (future of the 2-rank results, of the 4-rank's)."""
    with ThreadPoolExecutor(max_workers=1) as ex:
        yield (ex.submit(ranks.spawn, [(c, 1) for c in CASES],
                         str(tmp_path_factory.mktemp("mesh2"))),
               ex.submit(ranks.spawn, [("decay_lockstep", 1), ("robertson_fused", 1)],
                         str(tmp_path_factory.mktemp("mesh2x2")), shape=(2, 2),
                         names=("dp", "sp")))


@pytest.fixture(scope="module")
def mesh2(spawned, jax_sharded, unsharded):
    # the references first, while the ranks run
    return spawned[0].result()


@pytest.fixture(scope="module")
def mesh2x2(spawned, mesh2):
    return spawned[1].result()


@pytest.fixture(scope="module")
def unsharded():
    # the fused cases are held to the unsharded calls on their blocks
    return {c: ranks.run_case(c) for c in CASES if c not in FUSED + ["errors"]}


def _jax_heat1d():
    problem, _ = jheat.make(mgrid=12)
    eqn = dataclasses.replace(problem.eqn, rhs_jac=make_banded_jac(problem.eqn.rhs, 1, 1))
    return dataclasses.replace(problem, eqn=eqn, linear_solver=make_banded_solver(1, 1))


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's sharded calls, each once, over 2 virtual CPU devices."""
    from diffsol_tpu.ensemble import solve_dense_ensemble

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    calls = dict(
        decay_lockstep=(jed.problem(rtol=1e-6, atol=1e-8), jnp.linspace(0.0, 1.0, 5),
                        ranks._decay_params(32), "lockstep", {}),
        heat1d_lockstep=(_jax_heat1d(), jnp.asarray([0.51, 0.53]),
                         np.asarray([1.0, 1.0, 0.5, 2.0])[:, None], "lockstep", {}),
        robertson_fused=(jrob.problem_ode(rtol=1e-4, atol=(1e-8, 1e-6, 1e-6)), [0.4, 4.0],
                         ranks._rob_params(4), "fused", dict(interpret=True)),
        decay_independent=(jed.problem_with_root(rtol=1e-6, atol=1e-8),
                           jnp.linspace(0.0, 10.0, 6), ranks._decay_params(8),
                           "independent", {}),
    )
    out = {}
    for name, (problem, t_eval, params, mode, kw) in calls.items():
        sol = solve_dense_ensemble(dt.BdfSolver, problem, t_eval, jnp.asarray(params),
                                   mode=mode, mesh=mesh, **kw)
        out[name] = dict(ys=np.asarray(sol.ys), stop=np.asarray(sol.stop_reason),
                         root_t=np.asarray(sol.root_t))
        if mode == "lockstep":
            out[name]["steps"] = int(sol.state.stats.steps)
    return out


def _same_stats(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", LOCKSTEP)
def test_lockstep_equals_unsharded(mesh2, unsharded, case):
    """One joint solve: every rank takes the unsharded solve's steps (equal
    Stats, worst member as a global index, stop and root) and gets the
    whole ys, within 1e-13 relative."""
    ref = unsharded[case]
    for res in mesh2:
        got = res[case]
        assert got["tier"] == "lockstep"
        _same_stats(got["stats"], ref["stats"])
        assert got["stop"] == ref["stop"] and got["root_idx"] == ref["root_idx"]
        np.testing.assert_array_equal(got["root_t"], ref["root_t"])
        assert got["ys"].shape == ref["ys"].shape
        np.testing.assert_allclose(got["ys"], ref["ys"], rtol=REL, atol=0.0)
        if "sens" in ref:
            np.testing.assert_allclose(got["sens"], ref["sens"], rtol=REL, atol=0.0)
    if case == "decay_root_lockstep":
        assert ref["stop"] == dtt.errors.ROOT_FOUND  # member 0's polish ran
    if case == "decay_lockstep":
        assert ref["stats"]["worst_member"] >= 16  # the worst member is rank 1's


@pytest.mark.parametrize("case", ["decay_lockstep", "heat1d_lockstep"])
def test_lockstep_matches_jax_sharded(mesh2, jax_sharded, case):
    ref = jax_sharded[case]
    for res in mesh2:
        got = res[case]
        assert got["stop"] == int(ref["stop"]) == dtt.errors.TSTOP_REACHED
        np.testing.assert_allclose(got["ys"], ref["ys"], rtol=JAX_RTOL, atol=JAX_ATOL)
        assert abs(int(got["stats"]["steps"]) - ref["steps"]) <= STEP_SLACK


@pytest.mark.parametrize("case", FUSED)
def test_fused_shards_equal_unsharded_blocks(mesh2, case):
    """Each rank's block is the unsharded fused call on those members (its
    tiles are tiles of the block, as under JAX's shard_map): equal tile
    statuses and steps, ys within 1e-12 + 1e-9 |ref|; the whole batch's
    stop is the worst block's."""
    blocks = [ranks.run_case(case, members=slice(0, 2)),
              ranks.run_case(case, members=slice(2, 4))]
    for res in mesh2:
        got = res[case]
        assert got["tier"].endswith("_reference")
        steps = np.concatenate([b["tile_steps"] for b in blocks])
        np.testing.assert_array_equal(got["tile_steps"], steps)
        assert got["stop"] == min(b["stop"] for b in blocks)
        ref = np.concatenate([b["ys"] for b in blocks], axis=1)
        np.testing.assert_allclose(got["ys"], ref, rtol=1e-9, atol=1e-12)


def test_fused_matches_jax_sharded(mesh2, jax_sharded):
    ref = jax_sharded["robertson_fused"]
    for res in mesh2:
        got = res["robertson_fused"]
        assert got["stop"] == int(ref["stop"]) == dtt.errors.TSTOP_REACHED
        np.testing.assert_allclose(got["ys"], ref["ys"], rtol=FUSED_JAX_RTOL,
                                   atol=FUSED_JAX_ATOL)


@pytest.mark.parametrize("case", INDEPENDENT)
def test_independent_members_keep_their_single_solves(mesh2, unsharded, case):
    """Each member's whole Stats, stop and root are its single solve's,
    gathered to every rank; the batched state (the member loop's stacked
    one for a solver class the batched loop does not take) comes back
    whole."""
    ref = unsharded[case]
    root = case != "decay_sdirk_independent"
    problem = (ted.problem_with_root(rtol=1e-6, atol=1e-8) if root
               else ted.problem(rtol=1e-6, atol=1e-8))
    make = dtt.BdfSolver if root else dtt.SdirkSolver
    t_eval = np.linspace(0.0, 10.0, 6) if root else np.linspace(0, 1, 5)
    params = torch.tensor(ranks._decay_params(8), dtype=F64)
    singles = [solve_dense(make(problem), t_eval, params=params[b], device="cpu")
               for b in range(8)]
    for res in mesh2:
        got = res[case]
        _same_stats(got["stats"], ref["stats"])
        np.testing.assert_array_equal(got["stop"], [s.stop_reason for s in singles])
        np.testing.assert_array_equal(got["root_idx"], [s.root_idx for s in singles])
        np.testing.assert_array_equal(got["t"], ref["t"])
        for b, one in enumerate(singles):
            stats = {k: int(v[b]) for k, v in got["stats"].items()}
            assert stats == dataclasses.asdict(one.state.stats), b
            np.testing.assert_allclose(got["ys"][:, b], one.ys.numpy(), rtol=1e-10,
                                       atol=1e-12)


@pytest.mark.parametrize("case", INDEPENDENT + INDEPENDENT_SENS)
def test_independent_state_gathers_whole(mesh2, unsharded, case):
    """Every tensor of the batched state, each gathered along the member
    dimension its class declares (the member loop's stacked state along
    its leading one), equals the unsharded batch's within 1e-13 relative;
    only the Newton matrices, whose layout is the tier's, come back None.
    With sens=True the rows' fields (BDF's s and sD, SDIRK's s, ds, s_prev
    and sdiff) and the sensitivities themselves are among them."""
    ref = unsharded[case]
    rows = {"decay_sens_independent": {"s", "sD"},
            "decay_sdirk_sens_independent": {"s", "ds", "s_prev", "sdiff"}}.get(case, set())
    for res in mesh2:
        got = res[case]
        _same_stats(got["stats"], ref["stats"])
        np.testing.assert_allclose(got["ys"], ref["ys"], rtol=REL, atol=0.0)
        if rows:
            np.testing.assert_allclose(got["sens"], ref["sens"], rtol=REL, atol=0.0)
        assert rows <= set(got["state"])
        assert set(ref["state"]) - set(got["state"]) <= {"jac"}
        for k, v in got["state"].items():
            assert v.shape == ref["state"][k].shape, k
            np.testing.assert_allclose(v, ref["state"][k], rtol=REL, atol=0.0, err_msg=k)


def test_independent_matches_jax_sharded(mesh2, jax_sharded):
    ref = jax_sharded["decay_independent"]
    for res in mesh2:
        got = res["decay_independent"]
        np.testing.assert_array_equal(got["stop"], ref["stop"])
        np.testing.assert_allclose(got["ys"], ref["ys"], rtol=IND_JAX_RTOL, atol=IND_JAX_ATOL)
        np.testing.assert_allclose(got["root_t"], ref["root_t"], rtol=1e-6)


def test_gradient_equals_unsharded(mesh2, unsharded):
    """The lockstep gradient: forward and backward adjoint solves each one
    joint solve (equal Stats), the gradient within 1e-10 relative."""
    ref = unsharded["oscillator_grad"]
    for res in mesh2:
        got = res["oscillator_grad"]
        _same_stats(got["forward"], ref["forward"])
        _same_stats(got["backward"], ref["backward"])
        np.testing.assert_allclose(got["ys"], ref["ys"], rtol=1e-10, atol=0.0)
        np.testing.assert_allclose(got["grad"], ref["grad"], rtol=1e-10, atol=0.0)
        assert np.all(got["grad"] != 0.0)


def test_dp_sp_mesh_shards_dp_and_replicates_sp(mesh2x2, mesh2, unsharded):
    """On a (dp=2, sp=2) mesh with axis="dp" the two sp replicas of a dp
    block solve it alike: all four ranks match the unsharded lockstep solve
    and the 2-rank mesh's fused blocks."""
    for res in mesh2x2:
        _same_stats(res["decay_lockstep"]["stats"], unsharded["decay_lockstep"]["stats"])
        np.testing.assert_allclose(res["decay_lockstep"]["ys"],
                                   unsharded["decay_lockstep"]["ys"], rtol=REL, atol=0.0)
        np.testing.assert_array_equal(res["robertson_fused"]["ys"],
                                      mesh2[0]["robertson_fused"]["ys"])
        np.testing.assert_array_equal(res["robertson_fused"]["tile_steps"],
                                      mesh2[0]["robertson_fused"]["tile_steps"])


def test_errors_name_the_fault(mesh2):
    for res in mesh2:
        got = res["errors"]
        assert got["fused_uneven"] == "fused+mesh needs nbatch divisible by mesh axis 'dp' (5 % 2)"
        assert "should be divisible by 2, but it is equal to 5" in got["lockstep_uneven"]
        assert got["device"] == "device='cuda:3' contradicts the mesh: this rank solves on cpu"


def test_collectives_a_step(mesh2):
    """Sharded lockstep reads its norms together: per accepted step at most
    a few all-gathers (Newton's norm each iteration, the error test's
    norms and worst member in one, the order selection's in one)."""
    for res in mesh2:
        got = res["decay_lockstep"]
        steps = int(got["stats"]["steps"])
        per_step = res["decay_lockstep:all_gathers"] / steps
        iters = int(got["stats"]["newton_iterations"]) / steps
        assert per_step <= iters + 2.5


def test_unsharded_lockstep_makes_no_collective(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a collective in an unsharded solve")

    monkeypatch.setattr(torch.distributed, "all_gather", refuse)
    monkeypatch.setattr(torch.distributed, "all_gather_object", refuse)
    got = ranks.run_case("decay_root_lockstep")
    assert got["stop"] == dtt.errors.ROOT_FOUND


def test_implicit_solver_over_a_sharded_state_raises():
    """BdfSolver over a state sharded on a second mesh axis runs
    (tests/test_torch_sharding_state.py); with sensitivity rows it raises,
    since their jvp through the sharded rhs is ROADMAP 20f."""
    problem = dtt.OdeBuilder().rhs(ted.rhs).init(ted.init).p([0.1, 1.0]).build()
    lp = dataclasses.replace(make_lockstep_problem(problem, 2), state_axis=object())
    with pytest.raises(NotImplementedError, match="BdfSolver with sensitivities.*ROADMAP 20f"):
        dtt.BdfSolver(lp, sens=True)
