"""DiffSL problems in the port's ensembles and fused tiers, against the
JAX package solving the same DiffSL text: ``use_coloring`` routing, the
lockstep ensemble against single solves and JAX's lockstep, the
index-aware reset in lockstep, and the fused tiers' plain versions on
DiffSL Robertson and heat1d against JAX's lockstep solve (1e-6 + 5e-4
|ref|), with a ``reset_n`` model refused by the fused tier.

JAX's lockstep problem drops ``reset_n`` (diffsol_tpu/ensemble.py:171-185),
so its members of a model whose reset reads ``N`` reset with the current
index, not the fired root's: with two roots they part from the single
solves (ROADMAP.md queue 3).  The port's lockstep lifts ``reset_n`` over
the members, and its members are held to JAX's single solves.  No JAX
kernel runs here: JAX's side is its eager and lockstep solvers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.ensemble import make_lockstep_problem as jax_lockstep

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.models import diffsl_sources
from diffsol_tpu_torch.ops.eqn_codegen import UnsupportedForKernel
from test_torch_diffsl import MODEL_INDEX, ROBERTSON, coloring_heat1d_text
from test_torch_diffsl_solve import TRAJ_ATOL, TRAJ_RTOL, _build, _steps

torch.set_num_threads(1)

# fused tier (tiled lockstep) and lockstep: two step sequences at the
# solver's tolerance
MODES_RTOL, MODES_ATOL = 5e-4, 1e-6

# a model of two roots whose reset reads N: y reaches 0.5 (root 1) near
# t = 2.2, long before t = 5 (root 0), and resets to 0.1 + 0.2 N
TWO_ROOTS = """
in_i { r = 1.0 }
u_i { y = 0.1 }
F_i { r * y * (1.0 - y) }
stop_i { t - 5.0, y - 0.5 }
reset_i { 0.1 + 0.2 * N }
out_i { y }
"""


def test_use_coloring_routes_diffsl_heat1d_to_the_band():
    """tests/test_diffsl.py::test_diffsl_use_coloring_routes_to_banded: the
    traced DiffSL rhs routes to banded(1,1) in both packages, and the
    banded solves agree."""
    text, tols = coloring_heat1d_text(), (1e-6, 1e-8)
    jp, tp = _build(dt, text, tols, coloring=True), _build(dtt, text, tols, coloring=True)
    assert tp.linear_solver.name == "banded(1,1)"
    assert jp.linear_solver.name.startswith("banded(1,1")
    t_eval = [0.02, 0.05]
    ref = dt.solve_dense(dt.BdfSolver(jp), jnp.asarray(t_eval), max_steps=2000)
    got = dtt.solve_dense(dtt.BdfSolver(tp), t_eval, max_steps=2000, device="cpu")
    assert _steps(got) == _steps(ref)
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)


def test_lockstep_ensemble_matches_single_solves_and_jax():
    """tests/test_diffsl.py::test_diffsl_lockstep_ensemble at 64 members: the
    Robertson DAE with k1 spread +-5 %; members 0 and 63 against their own
    single solves (rtol 1e-4, the JAX test's), and the whole ensemble
    against JAX's lockstep solve."""
    nb = 64
    jp, tp = _build(dt, ROBERTSON, (1e-6, 1e-8)), _build(dtt, ROBERTSON, (1e-6, 1e-8))
    k1 = 0.04 * (1.0 + 0.05 * np.linspace(-1.0, 1.0, nb))
    params = np.stack([k1, np.full(nb, 1.0e4), np.full(nb, 3.0e7)], axis=1)
    t_eval = [0.4, 4.0]
    got = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, t_eval, params, mode="lockstep",
                                   max_steps=5000, device="cpu")
    assert got.tier == "lockstep" and got.stop_reason == errors.TSTOP_REACHED
    for m in (0, nb - 1):
        single = dtt.solve_dense(dtt.BdfSolver(tp), t_eval, params=params[m], max_steps=5000,
                                 device="cpu")
        np.testing.assert_allclose(got.ys[:, m].numpy(), single.ys.numpy(), rtol=1e-4,
                                   atol=1e-10)
    ref = dt.solve_dense(dt.BdfSolver(jax_lockstep(jp, nb)), jnp.asarray(t_eval),
                         params=jnp.asarray(params), max_steps=5000)
    assert _steps(got) == _steps(ref)
    np.testing.assert_allclose(got.ys.numpy(), np.moveaxis(np.asarray(ref.ys), -1, 1),
                               rtol=TRAJ_RTOL, atol=TRAJ_ATOL)


def test_lockstep_index_aware_reset():
    """Two roots, the second fires first: a single solve sets N = 1 and
    resets y to 0.3.  JAX's lockstep members reset with N = 0 (to 0.1) and
    part from JAX's single solve; the port's lockstep members follow the
    single solve, with the hidden index 1."""
    nb, t_eval = 4, [1.0, 2.0, 3.0, 4.0]
    tols = (1e-8, 1e-10)
    jp, tp = _build(dt, TWO_ROOTS, tols), _build(dtt, TWO_ROOTS, tols)
    single = dt.solve_dense(dt.BdfSolver(jp), jnp.asarray(t_eval), max_steps=4000)
    ys_single = np.asarray(single.ys)
    assert ys_single[2, 1] == 1.0  # N = 1 after the y = 0.5 root
    params = np.ones((nb, 1))
    jlock = dt.solve_dense(dt.BdfSolver(jax_lockstep(jp, nb)), jnp.asarray(t_eval),
                           params=jnp.asarray(params), max_steps=4000)
    jys = np.asarray(jlock.ys)  # (neval, n, B)
    assert np.all(jys[2:, 1, :] == 0.0)  # the index stayed 0
    assert np.all(np.abs(jys[2, 0, :] - ys_single[2, 0]) > 0.2)  # 0.199 vs 0.489
    got = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, t_eval, params, mode="lockstep",
                                   max_steps=4000, device="cpu")
    assert got.stop_reason == errors.TSTOP_REACHED
    for m in range(nb):
        np.testing.assert_allclose(got.ys[:, m].numpy(), ys_single, rtol=TRAJ_RTOL,
                                   atol=TRAJ_ATOL)
    alone = dtt.solve_dense(dtt.BdfSolver(tp), t_eval, max_steps=4000, device="cpu")
    assert _steps(alone) == _steps(single)
    np.testing.assert_allclose(alone.ys.numpy(), ys_single, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)


def test_reset_n_models_leave_the_fused_tier():
    """A model with reset_n: mode="fused" raises UnsupportedForKernel (as
    the JAX kernel's pallas_stepper.py:509-511), mode="auto" solves it
    lockstep, with the N model's reset values."""
    tp = _build(dtt, MODEL_INDEX, (1e-8, 1e-10))
    params = np.ones((3, 1))
    t_eval = [0.25, 0.75]
    with pytest.raises(UnsupportedForKernel, match="reset_n"):
        dtt.solve_dense_ensemble(dtt.BdfSolver, tp, t_eval, params, mode="fused",
                                 device="cpu")
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, t_eval, params, mode="auto",
                                   device="cpu")
    assert sol.tier == "lockstep" and sol.stop_reason == errors.TSTOP_REACHED
    y = 0.1 * np.exp(0.25) / (0.9 + 0.1 * np.exp(0.25))
    np.testing.assert_allclose(sol.ys[:, :, 0].numpy(), y, rtol=1e-6)
    assert np.all(sol.ys[1, :, 1].numpy() == 0.0)  # N = 0, the one root's index


def _modes_close(got, ref):
    diff = np.abs(got - ref)
    assert np.all(diff <= MODES_ATOL + MODES_RTOL * np.abs(ref)), float(diff.max())


def test_fused_plain_version_on_diffsl_robertson():
    """The small-n fused tier's plain version on the DiffSL Robertson ODE,
    16 members with k1 spread +-10 % in one tile, t_eval to 4e2, against
    JAX's lockstep solve of the same text."""
    text = diffsl_sources.robertson_ode()
    tols = (1e-4, [1e-8, 1e-6, 1e-6])
    jp, tp = _build(dt, text, tols), _build(dtt, text, tols)
    rng = np.random.default_rng(0)
    nb = 16
    params = np.stack([0.04 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, nb)), np.full(nb, 1.0e4),
                       np.full(nb, 3.0e7)], axis=1)
    t_eval = [0.4, 4.0, 40.0, 400.0]
    got = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, t_eval, params, mode="fused",
                                   device="cpu")
    assert got.tier == "fused_small_reference" and got.stop_reason == errors.TSTOP_REACHED
    ref = dt.solve_dense(dt.BdfSolver(jax_lockstep(jp, nb)), jnp.asarray(t_eval),
                         params=jnp.asarray(params), max_steps=5000)
    _modes_close(got.ys.numpy(), np.moveaxis(np.asarray(ref.ys), -1, 1))


def test_fused_plain_version_on_diffsl_heat1d():
    """The banded fused tier's plain version on DiffSL heat1d (mgrid = 12,
    use_coloring -> banded(1,1)), four diffusivities, against JAX's
    lockstep solve of the same text."""
    text = diffsl_sources.heat1d(12)
    tols = (1e-6, 1e-8)
    jp = _build(dt, text, tols, coloring=True)
    tp = _build(dtt, text, tols, coloring=True)
    assert tp.linear_solver.name == "banded(1,1)"
    params = np.linspace(0.5, 2.0, 4)[:, None]
    t_eval = [0.001, 0.01, 0.05]
    got = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, t_eval, params, mode="fused",
                                   device="cpu")
    assert got.tier == "fused_band_reference" and got.stop_reason == errors.TSTOP_REACHED
    ref = dt.solve_dense(dt.BdfSolver(jax_lockstep(jp, 4)), jnp.asarray(t_eval),
                         params=jnp.asarray(params), max_steps=5000)
    _modes_close(got.ys.numpy(), np.moveaxis(np.asarray(ref.ys), -1, 1))
