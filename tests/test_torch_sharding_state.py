"""Implicit solves over a sharded state (``diffsol_tpu_torch/sharding.py``'s
``StateAxis`` with ``BdfSolver`` and ``SdirkSolver``) on the CPU.

One module fixture spawns a 4-rank (dp = 2, sp = 2) gloo mesh that runs the
state-sharded cases of tests/torch_sharding_ranks.py: every member's states
split over "sp", the members over "dp".  The Newton matrix is built and
factored whole on every rank from the gathered state, each linear solve
gathers its right-hand side and keeps its block.  Each rank's result is held

* to every other rank's, bit for bit;
* to the port's unsharded solve, ``torch.equal`` on the rank's block: the
  heat1d (n = 64, B = 2) BDF and TR-BDF2 steps on the dense and banded
  tiers (y, dy, BDF's D, the RK stage values, t, h, order and Stats) and
  their ``solve_dense``; the heat2d DAE (diagonal mass, n = 36) with its
  consistent initial conditions and its ``out()``, and heat1d (n = 16)
  with a dense consistent mass; roots with a reset,
  ``out()`` and its quadrature, a solve stopping at a root, and the
  quadrature of the state itself;
* and to the JAX package's state-sharded call: five banded heat1d steps of
  ``BdfSolver`` and ``SdirkSolver`` under ``jit`` with ``y`` and ``dy`` on
  ``P("sp", "dp")`` over 4 of the 8 virtual CPU devices (tests/conftest.py),
  within the banded BDF twin's 1e-9 relative (tests/test_torch_banded.py)
  and the RK twins' 1e-6 relative (tests/test_torch_rk.py), 1e-14 absolute.

What stays refused (``sens=True``, the Krylov and block-diagonal tiers, the
member-time lift) is tests/test_torch_sharding_rest.py's.
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

from diffsol_tpu.ensemble import make_lockstep_problem as jax_lockstep
from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.ops.banded import make_banded_jac, make_banded_solver
from diffsol_tpu.solvers.bdf import BdfSolver as JaxBdf
from diffsol_tpu.solvers.sdirk import SdirkSolver as JaxSdirk

import diffsol_tpu_torch as dtt
import torch_sharding_ranks as ranks

torch.set_num_threads(1)
CASES = ["implicit_state", "dae_state", "events_state"]
TIERS = [f"{s}_{t}" for t in ("dense", "banded") for s in ("bdf", "sdirk")]
EVENTS = ["bdf_reset", "sdirk_reset", "bdf_stop", "erk_stop", "bdf_state_quad"]
BDF_TWIN_RTOL = 1e-9  # tests/test_torch_banded.py
RK_TWIN_RTOL = 1e-6  # tests/test_torch_rk.py
TWIN_ATOL = 1e-14


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The (dp = 2, sp = 2) group, run in a background thread."""
    with ThreadPoolExecutor(max_workers=1) as ex:
        yield ex.submit(ranks.spawn, [(c, 1) for c in CASES],
                        str(tmp_path_factory.mktemp("mesh2x2")), shape=(2, 2),
                        names=("dp", "sp"))


@pytest.fixture(scope="module")
def unsharded():
    return {c: ranks.run_case(c) for c in CASES}


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's five banded heat1d steps of each solver, members over "dp"
    and states over "sp" (tests/test_ensemble.py:123-167), each compiled
    once."""
    mesh4 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    problem, _ = jheat.make(mgrid=ranks.STATE_MGRID, rtol=1e-6, atol=1e-8)
    problem = dataclasses.replace(
        problem, linear_solver=make_banded_solver(1, 1, kernel="xla"),
        eqn=dataclasses.replace(problem.eqn, rhs_jac=make_banded_jac(problem.eqn.rhs, 1, 1)))
    lp = jax_lockstep(problem, ranks.STATE_D.shape[0])
    params = jnp.asarray(ranks.STATE_D)
    y_shard = NamedSharding(mesh4, P("sp", "dp"))
    p_shard = jax.device_put(params, NamedSharding(mesh4, P("dp", None)))
    out = {}
    for name, cls in (("bdf", JaxBdf), ("sdirk", JaxSdirk)):
        solver = cls(lp)
        state0 = solver.init_state(params)
        state_sh = state0.replace(y=jax.device_put(state0.y, y_shard),
                                  dy=jax.device_put(state0.dy, y_shard))
        five = jax.jit(lambda st, p, s=solver: jax.lax.fori_loop(
            0, ranks.STATE_JAX_STEPS, lambda i, x: s.step(x, p), st))
        got = five(state_sh, p_shard)
        out[name] = dict(y=np.asarray(got.y).T, t=float(got.t), h=float(got.h),
                         steps=int(got.stats.steps), sharding=got.y.sharding)
    return out


@pytest.fixture(scope="module")
def mesh2x2(spawned, unsharded, jax_sharded):
    # the references first, while the ranks run
    return spawned.result()


def _block(x, coords, B=2):
    """The rank's (members over dp, states over sp) block of a whole (B, n)
    or (..., B, n) array."""
    i, j = coords
    b, k = B // 2, x.shape[-1] // 2
    return x[..., b * i:b * (i + 1), k * j:k * (j + 1)]


def _members(x, coords, B=2):
    """The rank's members of a (neval, B, ...) output: the gathered ys and
    gs (whole over the states)."""
    b = B // 2
    return x[:, b * coords[0]:b * (coords[0] + 1)]


def _equal(got, ref, what):
    assert torch.equal(torch.from_numpy(np.asarray(got)), torch.from_numpy(np.asarray(ref))), what


def _same_state(got, ref, coords, what):
    """A state's blocks, scalars and Stats: the unsharded state's bits."""
    for key in ("y", "dy", "D", "diff"):
        if key in ref:
            _equal(got[key], _block(ref[key], coords), f"{what}: {key}")
    for key in ("t", "h", "order"):
        if key in ref:
            assert np.array_equal(got[key], ref[key]), f"{what}: {key}"
    if "g" in ref and ref["g"].size:  # a quadrature: out()'s whole, or the state's block
        g = ref["g"]
        b = got["g"].shape[0]
        want = g[b * coords[0]:b * (coords[0] + 1)] if got["g"].shape[-1] == g.shape[-1] else (
            _block(g, coords))
        _equal(got["g"], want, f"{what}: g")
    for key, v in ref["stats"].items():
        assert np.array_equal(got["stats"][key], v), f"{what}: Stats.{key}"


def _same_solution(got, ref, what):
    """A solve_dense: its gathered ys and whole gs on the rank's members,
    stop, root and final state."""
    c = got["coords"]
    _equal(got["ys"], _members(ref["ys"], c), f"{what}: ys")
    if "gs" in ref:
        _equal(got["gs"], _members(ref["gs"], c), f"{what}: gs")
    assert got["stop"] == ref["stop"], what
    assert np.array_equal(got["root_t"], ref["root_t"], equal_nan=True), what
    assert got["root_idx"] == ref["root_idx"], what
    _same_state(got["final"], ref["final"], c, f"{what}: final state")


def _same_bits(a, b):
    """Equal bit for bit: arrays (NaN where NaN), dicts of them, numbers."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_bits(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_bits(x, y)
    else:
        assert a == b or (a != a and b != b)


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_the_same_bits(mesh2x2, case):
    """Ranks with the same "sp" coordinate hold the same members' blocks;
    whatever is whole (ys, gs, times, Stats) is the same on all four."""
    by_coords = {r[case]["bdf_dense" if case != "events_state" else "bdf_reset"]["coords"]: r
                 for r in mesh2x2}
    assert sorted(by_coords) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for key in mesh2x2[0][case]:
        runs = [r[case][key] for r in mesh2x2]
        for got in runs[1:]:
            for part in ("stats", "t", "stop", "root_t", "root_idx"):
                _same_bits(got[part], runs[0][part])
        for dp in (0, 1):  # the two "sp" ranks of a member gather the same ys
            _same_bits(by_coords[(dp, 0)][case][key]["ys"], by_coords[(dp, 1)][case][key]["ys"])


@pytest.mark.parametrize("key", TIERS)
def test_implicit_steps_equal_unsharded(mesh2x2, unsharded, key):
    """heat1d n = 64, B = 2: init_state, five steps, STATE_STEPS steps and
    solve_dense of BdfSolver and TR-BDF2 on the dense and banded tiers:
    every rank's blocks of y, dy, D (BDF) and the stage values (SDIRK),
    t, h, order and Stats are the unsharded solve's bits."""
    ref = unsharded["implicit_state"][key]
    for res in mesh2x2:
        got = res["implicit_state"][key]
        for part in ("init", "five", "steps"):
            _same_state(got[part], ref[part], got["coords"], f"{key} {part}")
        _same_solution(got, ref, key)
        # the rhs's state, the norms' terms and every Newton iteration's
        # right-hand side gather over "sp" at least once a step
        assert got["step_gathers"] >= 2 * ranks.STATE_STEPS
    st = ref["steps"]["stats"]
    assert st["steps"] == ranks.STATE_STEPS and ref["stop"] == dtt.errors.TSTOP_REACHED
    assert st["newton_iterations"] >= st["steps"] and st["linear_solver_setups"] >= 2
    if key.startswith("bdf"):
        assert ref["steps"]["order"] > 1  # an order change within the steps


@pytest.mark.parametrize("key", TIERS)
def test_dae_equals_unsharded(mesh2x2, unsharded, key):
    """The heat2d DAE (diagonal mass, algebraic edge rows, out()), n = 36:
    the consistent initial conditions (the packed Jacobian built whole from
    the gathered unknowns), steps and solve_dense with out() whole on every
    rank, equal to the unsharded solve."""
    ref = unsharded["dae_state"][key]
    for res in mesh2x2:
        got = res["dae_state"][key]
        for part in ("init", "five", "steps"):
            _same_state(got[part], ref[part], got["coords"], f"{key} {part}")
        _same_solution(got, ref, key)
    assert ref["stop"] == dtt.errors.TSTOP_REACHED and ref["gs"].shape == (2, 2, 1)
    assert np.all(ref["init"]["y"].reshape(2, 6, 6)[:, 0] == 0.0)  # the edge rows


@pytest.mark.parametrize("name", ["bdf", "sdirk"])
def test_dense_mass_equals_unsharded(mesh2x2, unsharded, name):
    """heat1d n = 16 as M y' = M f(y) with the finite-element consistent
    mass, dense (n, n), on the dense tier: the mass enters the Newton
    matrix whole and multiplies a block as the block of the whole
    product; steps and solve_dense equal to the unsharded solve, and
    close to heat1d's own solve (the same solution)."""
    from diffsol_tpu_torch.models import heat1d

    key = f"{name}_dense_mass"
    ref = unsharded["dae_state"][key]
    for res in mesh2x2:
        got = res["dae_state"][key]
        for part in ("init", "five", "steps"):
            _same_state(got[part], ref[part], got["coords"], f"{key} {part}")
        _same_solution(got, ref, key)
    assert ref["stop"] == dtt.errors.TSTOP_REACHED
    assert ref["steps"]["stats"]["steps"] == ranks.STATE_STEPS
    plain = dtt.solve_dense(dtt.BdfSolver(heat1d.make(ranks.DENSE_MASS_MGRID, rtol=1e-6,
                                                      atol=1e-8)[0]),
                            ranks.DAE_T_EVAL, device="cpu")
    np.testing.assert_allclose(ref["ys"][:, 0], plain.ys.numpy(), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("key", EVENTS)
def test_events_equal_unsharded(mesh2x2, unsharded, key):
    """Roots on the gathered state: BDF and TR-BDF2 resetting at each
    crossing (out() and its quadrature in the error test, whole on every
    rank), BDF and TSIT45 stopping at the first root (its time and index
    on every rank), and the quadrature of the state itself (gathered)."""
    ref = unsharded["events_state"][key]
    for res in mesh2x2:
        _same_solution(res["events_state"][key], ref, key)
    if key.endswith("_stop"):
        assert ref["stop"] == dtt.errors.ROOT_FOUND and 0.05 < ref["root_t"] < 0.06
    else:
        assert ref["stop"] == dtt.errors.TSTOP_REACHED
    if key.endswith("_reset"):
        # two resets: mean(y) back above 0.3 after each
        m = ref["ys"].mean(-1)
        assert m[1].min() > 0.3 and m[2].min() > 0.3
    if key == "bdf_state_quad":
        assert ref["gs"].shape == ref["ys"].shape


def test_implicit_steps_match_jax_sharded(mesh2x2, jax_sharded):
    """Five banded heat1d steps of BdfSolver and TR-BDF2 against the JAX
    package's, its y and dy on P("sp", "dp") over a (dp = 2, sp = 2) mesh
    of 4 devices under jit (its y stays sharded so)."""
    for name, rtol in (("bdf", BDF_TWIN_RTOL), ("sdirk", RK_TWIN_RTOL)):
        ref = jax_sharded[name]
        assert ref["steps"] == ranks.STATE_JAX_STEPS
        assert ref["sharding"].spec == P("sp", "dp")
        for res in mesh2x2:
            got = res["implicit_state"][f"{name}_banded"]
            np.testing.assert_allclose(got["five"]["y"], _block(ref["y"], got["coords"]),
                                       rtol=rtol, atol=TWIN_ATOL)
            np.testing.assert_allclose(got["five"]["t"], ref["t"], rtol=rtol)
            assert got["five"]["stats"]["steps"] == ranks.STATE_JAX_STEPS
