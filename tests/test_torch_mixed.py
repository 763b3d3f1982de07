"""``precision="mixed"`` of the fused small-n tier (K1 sub-slice (f)): the
port's plain version against its own float64 run and against the Pallas
kernel in interpret mode, as tests/test_pallas_stepper.py:451 and :483.

The mixed tier keeps the Newton MATRIX path (Jacobian probes, LU, linear
solve) in float32 and everything else in float64.  Inexact Newton: the
matrix's accuracy gates the convergence rate, not the solution, so the
trajectories agree at the error test's tolerance, measured in units of the
error weight atol + rtol |y|: below 5 over all points of Robertson to
t = 4e10 and below 0.1 up to t = 4e4.  The JAX kernel's mixed run is held
to the port's by the same measure (both are rtol = 1e-4 solves with
different float32 roundings, so they part like two such solves).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsol_tpu.models import robertson as jrob
from diffsol_tpu.ops.pallas_stepper import make_pallas_bdf_solve

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.models import robertson as trob
from diffsol_tpu_torch.ops import eqn_codegen as cg
from diffsol_tpu_torch.ops import fused_stepper as fs

torch.set_num_threads(1)
TE = [0.4, 4.0, 400.0, 4e4, 4e6, 4e8, 4e10]
B = 4
PARAMS = np.tile(np.array([0.04, 1e4, 3e7]), (B, 1))
ATOL = (1e-8, 1e-6, 1e-6)


def _weights(ys_ref):
    """(neval, B, n) error weights of the solves here."""
    return np.asarray(ATOL)[None, None, :] + 1e-4 * np.abs(ys_ref)


@pytest.fixture(scope="module")
def port_runs():
    problem = trob.problem_ode(rtol=1e-4, atol=ATOL)
    return {
        prec: dtt.solve_dense_ensemble(dtt.BdfSolver, problem, TE, PARAMS, mode="fused",
                                       tile=B, device="cpu", precision=prec)
        for prec in ("df", "mixed", "fast")
    }


def test_mixed_agrees_with_df_in_error_weights(port_runs):
    df, mixed = port_runs["df"], port_runs["mixed"]
    assert df.tier == "fused_small_reference"
    assert mixed.tier == "fused_small_mixed_reference"
    assert df.stop_reason == mixed.stop_reason == dtt.errors.TSTOP_REACHED
    yf, ym = df.ys.numpy(), mixed.ys.numpy()
    w = _weights(yf)
    assert np.max(np.abs(ym - yf) / w) < 5.0
    assert np.max(np.abs(ym[:4] - yf[:4]) / w[:4]) < 0.1
    assert not np.array_equal(ym, yf)  # the float32 matrix path did run
    # an inexact matrix costs iterations and steps, not accuracy
    assert int(mixed.tile_steps[0]) >= int(df.tile_steps[0])
    rows = [int(np.argmin(np.abs(trob.SOLN[:, 0] - t))) for t in TE[:4]]
    np.testing.assert_allclose(trob.SOLN[rows, 0], TE[:4])
    np.testing.assert_allclose(ym[:4, 0], trob.SOLN[rows, 1:4], rtol=5e-3, atol=1e-7)


def test_fast_runs_the_df_build_and_unknown_names_raise(port_runs):
    assert port_runs["fast"].tier == "fused_small_fast_reference"
    assert torch.equal(port_runs["fast"].ys, port_runs["df"].ys)
    problem = trob.problem_ode()
    header = fs.make_fused_bdf_solve(problem, TE, B, precision="fast").header
    assert "#define MODEL_MIXED 0" in header
    assert header == fs.make_fused_bdf_solve(problem, TE, B).header
    mixed = fs.make_fused_bdf_solve(problem, TE, B, precision="mixed")
    assert mixed.cfg.mixed and "#define MODEL_MIXED 1" in mixed.header
    assert mixed.header.replace("MODEL_MIXED 1", "MODEL_MIXED 0") == header
    with pytest.raises(ValueError, match="precision"):
        fs.make_fused_bdf_solve(problem, TE, B, precision="f16")
    with pytest.raises(ValueError, match="precision"):
        dtt.solve_dense_ensemble(dtt.BdfSolver, problem, TE, PARAMS, mode="fused",
                                 device="cpu", precision="f16")


def test_mixed_is_a_small_n_option():
    """A problem the small-n tier refuses has no mixed build: the banded
    tier is not tried (JAX ensemble.py:258-263)."""
    from diffsol_tpu_torch.models import heat1d

    problem, _ = heat1d.make(15, banded=True)
    with pytest.raises(cg.UnsupportedForKernel, match="small-n-tier option"):
        dtt.solve_dense_ensemble(dtt.BdfSolver, problem, [0.01], np.ones((2, 1)),
                                 mode="fused", device="cpu", precision="mixed")


def test_mixed_matches_pallas_mixed_interpret(port_runs):
    """The Pallas kernel with ``precision="mixed"`` in interpret mode on the
    same members: both end TSTOP, and the port's mixed run sits from it as
    from the float64 run, below 5 error weights overall and 0.1 up to
    t = 4e4; the accepted steps agree within a tenth."""
    problem = jrob.problem_ode(rtol=1e-4, atol=ATOL)
    ys_j, status_j, steps_j = make_pallas_bdf_solve(
        problem, TE, nbatch=B, tile=B, interpret=True, precision="mixed")(jnp.asarray(PARAMS))
    assert int(jnp.min(status_j)) >= 0
    yj = np.moveaxis(np.asarray(ys_j), -1, 1)  # (neval, B, n)
    mixed = port_runs["mixed"]
    ym = mixed.ys.numpy()
    w = _weights(port_runs["df"].ys.numpy())
    assert np.max(np.abs(ym - yj) / w) < 5.0
    assert np.max(np.abs(ym[:4] - yj[:4]) / w[:4]) < 0.1
    assert abs(int(mixed.tile_steps[0]) - int(steps_j[0])) <= 0.1 * int(steps_j[0])
