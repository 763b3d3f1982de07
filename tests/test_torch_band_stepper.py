"""The fused banded BDF tier (ops/fused_band_stepper.py): its plain
PyTorch version against the JAX Pallas kernel in interpret mode on
tests/test_pallas_band.py:44's configuration, and the remaining cases of
tests/test_pallas_band.py (heterogeneous members, a wide band, a Dirichlet
DAE, scope rejections, routing, LU growth) against the port's own lockstep
path.  (The CUDA kernel against its plain version is
tests/test_torch_cuda.py.)
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.ops import banded as jb
from diffsol_tpu.ops.pallas_stepper_band import make_pallas_band_bdf_solve

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import heat1d as theat
from diffsol_tpu_torch.models import robertson
from diffsol_tpu_torch.ops import eqn_codegen as cg
from diffsol_tpu_torch.ops import fused_band_stepper as fb
from diffsol_tpu_torch.ops import fused_stepper as fs
from diffsol_tpu_torch.ops.banded import make_banded_solver

torch.set_num_threads(1)
F64 = torch.float64
# the tier against the port's own lockstep and single-instance solves:
# different step sequences at rtol 1e-6, so agreement at
# test_pallas_band.py's solver tolerance
SOLVER_RTOL, SOLVER_ATOL = 5e-4, 1e-6


def _jax_banded(problem):
    return dataclasses.replace(problem,
                               linear_solver=jb.make_banded_solver(1, 1, kernel="xla"))


def test_plain_version_matches_jax_interpret():
    """The plain version against the Pallas kernel in interpret mode at
    test_pallas_band.py:44's configuration: heat1d mgrid=15, B=4, tile=4.
    Equal accepted steps and ys to 1e-6 relative: the Pallas kernel keeps
    its state in double-float pairs and its heuristics in float32, the
    port everything in float64."""
    t_eval = [0.01, 0.05, 0.2]
    params = np.ones((4, 1))
    jp, _ = jheat.make(mgrid=15, rtol=1e-6, atol=1e-8)
    jp = _jax_banded(jp)
    ys_j, st_j, steps_j = make_pallas_band_bdf_solve(
        jp, t_eval, nbatch=4, tile=4, interpret=True)(jnp.asarray(params))
    tp, _ = theat.make(mgrid=15)
    pt = problem_from_jax(jp, tp.eqn.rhs, tp.eqn.init)
    solve = fb.make_fused_band_bdf_solve(pt, t_eval, 4, tile=4)
    ys, status, steps = solve(torch.tensor(params))
    assert status.tolist() == np.asarray(st_j).tolist() == [fs.OK]
    assert steps.tolist() == np.asarray(steps_j).tolist()
    assert int(steps[0]) > 10
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=1e-6, atol=1e-12)


def test_default_tile_is_the_jax_rule():
    """heat1d n=128, B=1024: the JAX kernel's tile rule gives 128 on both
    sides (the Pallas call is built, not run)."""
    t_eval = [0.001, 0.01, 0.05, 0.1, 0.2]
    jp, _ = jheat.make(mgrid=127, rtol=1e-6, atol=1e-8)
    jsolve = make_pallas_band_bdf_solve(_jax_banded(jp), t_eval, nbatch=1024)
    tp, _ = theat.make(mgrid=127, rtol=1e-6, atol=1e-8, banded=True)
    solve = fb.make_fused_band_bdf_solve(tp, t_eval, 1024)
    assert solve.tile == jsolve.tile == 128
    assert solve.ntiles == jsolve.ntiles == 8


def test_heterogeneous_members_and_tiles():
    """Per-member diffusivities: each member matches its own
    single-instance solve, faster diffusion decays faster, and a tile
    steps exactly as it does alone (tiled lockstep)."""
    tp, _ = theat.make(mgrid=11, rtol=1e-6, atol=1e-8, banded=True)
    t_eval = [0.02, 0.1]
    d = [0.5, 1.0, 2.0, 1.5]
    params = torch.tensor(d, dtype=F64)[:, None]
    ys, status, steps = fb.make_fused_band_bdf_solve(tp, t_eval, 4, tile=2)(params)
    assert status.tolist() == [fs.OK] * 2
    for m in range(4):
        ref = dtt.solve_dense(dtt.BdfSolver(tp), t_eval, params=params[m], device="cpu")
        np.testing.assert_allclose(ys[:, :, m].numpy(), ref.ys.numpy(),
                                   rtol=SOLVER_RTOL, atol=SOLVER_ATOL)
    mid = ys[-1, ys.shape[1] // 2, :3].numpy()
    assert mid[0] > mid[1] > mid[2]
    ys2, _, steps2 = fb.make_fused_band_bdf_solve(tp, t_eval, 2, tile=2)(params[2:])
    assert int(steps2[0]) == int(steps[1])
    np.testing.assert_array_equal(ys2.numpy(), ys[:, :, 2:].numpy())


def _stencil5_problem(n=17):
    h = 1.0 / (n + 1)

    def rhs(t, y, p):
        z2, z1 = torch.zeros_like(y[:2]), torch.zeros_like(y[:1])
        ym2, ym1 = torch.cat([z2, y[:-2]]), torch.cat([z1, y[:-1]])
        yp1, yp2 = torch.cat([y[1:], z1]), torch.cat([y[2:], z2])
        return p[0] * (-ym2 + 16.0 * ym1 - 30.0 * y + 16.0 * yp1 - yp2) / (12.0 * h * h)

    def init(t, p):
        x = (torch.arange(n, dtype=F64, device=p.device) + 1.0) * h
        return 4.0 * x * (1.0 - x)

    return (dtt.OdeBuilder().rhs(rhs).init(init).p([1.0]).rtol(1e-6).atol(1e-8)
            .linear_solver(make_banded_solver(2, 2)).build())


def test_wide_band():
    """ml = mu = 2 (test_pallas_band.py:95): the multi-column update
    windows of the band LU and five colored probes."""
    problem = _stencil5_problem()
    t_eval = [0.02, 0.1]
    ys, status, _ = fb.make_fused_band_bdf_solve(problem, t_eval, 2)(torch.ones(2, 1,
                                                                                dtype=F64))
    assert status.tolist() == [fs.OK]
    ref = dtt.solve_dense(dtt.BdfSolver(problem), t_eval, device="cpu")
    np.testing.assert_allclose(ys[:, :, 0].numpy(), ref.ys.numpy(),
                               rtol=SOLVER_RTOL, atol=SOLVER_ATOL)


def test_dae_dirichlet_rows():
    """Constant diagonal mass with algebraic Dirichlet rows at both ends
    (test_pallas_band.py:137): the rows stay at 0, and the interior is the
    11-state heat ODE with zero boundary values, solved by the port's
    lockstep path."""
    n = 13
    h = 1.0 / (n - 1)

    def rhs(t, y, p):
        interior = p[0] * (y[:-2] - 2.0 * y[1:-1] + y[2:]) / (h * h)
        return torch.cat([y[:1], interior, y[-1:]])

    def init(t, p):
        x = torch.arange(n, dtype=F64, device=p.device) * h
        return 4.0 * x * (1.0 - x)

    mass_diag = torch.cat([torch.zeros(1, dtype=F64), torch.ones(n - 2, dtype=F64),
                           torch.zeros(1, dtype=F64)])
    problem = (dtt.OdeBuilder().rhs(rhs).init(init)
               .mass(lambda t, p: torch.diag(mass_diag)).p([1.0]).rtol(1e-6).atol(1e-8)
               .linear_solver(make_banded_solver(1, 1)).build())
    t_eval = [0.02, 0.1]
    params = torch.tensor([[1.0], [1.3]], dtype=F64)
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval, params, mode="fused",
                                   device="cpu")
    assert sol.tier == "fused_band_reference"
    assert sol.stop_reason == dtt.errors.TSTOP_REACHED
    ys = sol.ys.numpy()  # (neval, B, n)
    np.testing.assert_allclose(ys[:, :, 0], 0.0, atol=1e-9)
    np.testing.assert_allclose(ys[:, :, -1], 0.0, atol=1e-9)

    def rhs_i(t, y, p):
        z = torch.zeros_like(y[:1])
        return p[0] * (torch.cat([z, y[:-1]]) - 2.0 * y + torch.cat([y[1:], z])) / (h * h)

    ode = (dtt.OdeBuilder().rhs(rhs_i).init(lambda t, p: init(t, p)[1:-1]).p([1.0])
           .rtol(1e-6).atol(1e-8).linear_solver(make_banded_solver(1, 1)).build())
    ref = dtt.solve_dense_ensemble(dtt.BdfSolver, ode, t_eval, params, mode="lockstep",
                                   device="cpu")
    np.testing.assert_allclose(ys[:, :, 1:-1], ref.ys.numpy(), rtol=SOLVER_RTOL,
                               atol=SOLVER_ATOL)


def test_scope_rejections():
    with pytest.raises(cg.UnsupportedForKernel, match="banded"):
        fb.make_fused_band_bdf_solve(robertson.problem_ode(), [1.0], 4)
    tp, _ = theat.make(mgrid=7, banded=True)
    with pytest.raises(ValueError, match="block limit"):
        fb.make_fused_band_bdf_solve(tp, [1.0], 512, tile=fb.MAX_TILE + 1)
    # an algebraic row that init does not satisfy is no rejection any more:
    # the host-side initial state runs the consistent-IC solve
    # (pallas_stepper_band.py:190-199, :968-984), which moves y[0] to 1
    n = 6
    md = torch.tensor([0.0] + [1.0] * (n - 1), dtype=F64)
    bad = (dtt.OdeBuilder().rhs(lambda t, y, p: y - 1.0)
           .init(lambda t, p: torch.zeros(n, dtype=F64))
           .mass(lambda t, p: torch.diag(md)).p([1.0])
           .linear_solver(make_banded_solver(1, 1)).build())
    solve = fb.make_fused_band_bdf_solve(bad, [1.0], 2)
    assert solve.cfg.needs_ic_solve
    ys, status, _ = solve(torch.ones(2, 1, dtype=F64))
    assert status.tolist() == [0]
    np.testing.assert_allclose(ys[0, 0].numpy(), 1.0, atol=1e-9)
    np.testing.assert_allclose(ys[0, 1:].numpy(), 1.0 - np.e, rtol=1e-4)
    # roots and quadrature are outside the banded kernel (:120-123)
    rooted = (dtt.OdeBuilder().rhs(tp.eqn.rhs).init(tp.eqn.init).p([1.0])
              .root(lambda t, y, p: y[:1] - 0.5)
              .linear_solver(make_banded_solver(1, 1)).build())
    with pytest.raises(cg.UnsupportedForKernel, match="root"):
        fb.make_fused_band_bdf_solve(rooted, [1.0], 2)
    quad = (dtt.OdeBuilder().rhs(tp.eqn.rhs).init(tp.eqn.init).p([1.0]).integrate_out()
            .linear_solver(make_banded_solver(1, 1)).build())
    with pytest.raises(cg.UnsupportedForKernel, match="quadrature"):
        fb.make_fused_band_bdf_solve(quad, [1.0], 2)
    # a mass that changes with t is outside the tier
    timed = (dtt.OdeBuilder().rhs(lambda t, y, p: -y)
             .init(lambda t, p: torch.ones(n, dtype=F64))
             .mass(lambda t, p: torch.diag(torch.ones(n, dtype=F64) * (1.0 + t)))
             .p([1.0]).linear_solver(make_banded_solver(1, 1)).build())
    with pytest.raises(cg.UnsupportedForKernel, match="constant-diagonal"):
        fb.make_fused_band_bdf_solve(timed, [1.0], 2)


def test_ensemble_routes_banded_through_fused():
    """n > 8: mode="fused" (and "auto") falls through the small-n tier to
    the band kernel's plain version on the CPU, which agrees with lockstep
    at the solver tolerance (test_pallas_band.py:188)."""
    tp, _ = theat.make(mgrid=11, rtol=1e-6, atol=1e-8, banded=True)
    t_eval = [0.02, 0.1]
    params = np.array([[0.5], [1.0], [2.0]])
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, t_eval, params, mode="fused",
                                   device="cpu")
    assert sol.tier == "fused_band_reference"
    assert sol.stop_reason == dtt.errors.TSTOP_REACHED
    assert sol.ys.shape == (2, 3, 12) and sol.tile_steps.shape == (1,)
    auto = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, t_eval, params, mode="auto",
                                    device="cpu")
    assert auto.tier == "fused_band_reference"
    lock = dtt.solve_dense_ensemble(dtt.BdfSolver, tp, t_eval, params, mode="lockstep",
                                    device="cpu")
    np.testing.assert_allclose(sol.ys.numpy(), lock.ys.numpy(), rtol=SOLVER_RTOL,
                               atol=SOLVER_ATOL)
    # a dense problem of n > 8 is in no kernel's scope: auto goes lockstep
    dense, _ = theat.make(mgrid=11, rtol=1e-6, atol=1e-8)
    assert dtt.solve_dense_ensemble(dtt.BdfSolver, dense, t_eval, params, mode="auto",
                                    device="cpu").tier == "lockstep"
    with pytest.raises(cg.UnsupportedForKernel, match="small-n tier.*banded tier"):
        dtt.solve_dense_ensemble(dtt.BdfSolver, dense, t_eval, params, mode="fused",
                                 device="cpu")


def test_lu_growth_fails_loudly():
    """The no-pivot band LU on a nonsingular matrix it cannot factor
    (test_pallas_band.py:212): every algebraic row meets an exactly zero
    Schur pivot, the growth guard fails the tile with FAIL_LU_GROWTH and
    NaN ys, and the ensemble reports the lockstep tier's typed failure."""
    n = 12
    M0 = torch.tensor(np.arange(n) % 3 == 0, dtype=F64)
    M1 = torch.tensor(np.arange(n) % 3 == 1, dtype=F64)
    M2 = torch.tensor(np.arange(n) % 3 == 2, dtype=F64)

    def rhs(t, y, p):
        left = torch.cat([torch.zeros_like(y[:1]), y[:-1]])
        right = torch.cat([y[1:], torch.zeros_like(y[:1])])
        return p[0] * (M0 * y + M1 * (left - right) + M2 * (left - y))

    problem = (dtt.OdeBuilder().rhs(rhs).init(lambda t, p: M0 + M2)
               .mass(lambda t, p: torch.diag(1.0 - M1)).p([1.0]).rtol(1e-6).atol(1e-8)
               .linear_solver(make_banded_solver(1, 1)).build())
    params = torch.ones(4, 1, dtype=F64)
    ys, status, _ = fb.make_fused_band_bdf_solve(problem, [0.5, 1.0], 4, tile=4,
                                                 max_steps=200)(params)
    assert status.tolist() == [fs.FAIL_LU_GROWTH]
    assert not bool(torch.isfinite(ys).any())
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, [0.5, 1.0], params,
                                   mode="fused", max_steps=200, device="cpu")
    assert sol.stop_reason == dtt.errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES


def test_rhs_header_for_the_band_kernel():
    """The band kernel's model header holds the rhs only (init is not
    traced: heat1d's torch.where init is outside the scalar IR), and the
    traced rhs evaluates like the callable at n = 128."""
    tp, _ = theat.make(mgrid=127, banded=True)
    with pytest.raises(cg.UnsupportedForKernel):
        cg.trace_model(tp.eqn.rhs, tp.eqn.init, 128, 1)
    model = cg.trace_model(tp.eqn.rhs, None, 128, 1)
    src = cg.emit_cuda_header(model, "heat1d")
    assert "#define MODEL_N 128" in src and "model_init" not in src
    rng = np.random.default_rng(2)
    y = torch.tensor(rng.standard_normal((3, 128)))
    p = torch.tensor(rng.uniform(0.5, 2.0, (3, 1)))
    want = torch.func.vmap(tp.eqn.rhs, in_dims=(None, 0, 0))(torch.tensor(0.0, dtype=F64),
                                                             y, p)
    np.testing.assert_allclose(cg.eval_rhs(model.rhs, 0.0, y, p).numpy(), want.numpy(),
                               rtol=1e-13, atol=1e-9)
    # five operations a state, less the last state's "+ 0" of the zero pad
    # on the right, which the IR folds away
    assert cg.op_count(model.rhs) == 5 * 128 - 1


def test_band_kernel_rhs_is_emitted_output_by_output():
    """The band kernel's header stores each output of the rhs right after
    the nodes it needs (few values live at once), every node defined
    before it is read and every output stored once; the small-n kernel's
    header keeps the IR order with the outputs last."""
    tp, _ = theat.make(mgrid=15, banded=True)
    solve = fb.make_fused_band_bdf_solve(tp, [0.1], 4)
    body = solve.header[solve.header.index("model_rhs"):]
    defined, stored, first_store, last_def = set(), [], None, 0
    for k, line in enumerate(body.splitlines()):
        m = re.match(r"  const T v(\d+) = (.*);$", line)
        o = re.match(r"  out\[(\d+)\] = v(\d+);$", line)
        if m:
            assert set(re.findall(r"\bv(\d+)\b", m.group(2))) <= defined, line
            defined.add(m.group(1))
            last_def = k
        elif o:
            assert o.group(2) in defined, line
            stored.append(int(o.group(1)))
            first_store = k if first_store is None else first_store
    assert sorted(stored) == list(range(16))
    assert first_store < last_def  # outputs interleaved with the nodes
    model = cg.trace_model(tp.eqn.rhs, None, 16, 1)
    plain = cg.emit_cuda_header(model, "heat1d")
    outs = [k for k, ln in enumerate(plain.splitlines()) if ln.startswith("  out[")]
    defs = [k for k, ln in enumerate(plain.splitlines()) if ln.startswith("  const T v")]
    assert min(outs) > max(defs)
    streamed = cg.emit_cuda_header(model, "rhs", stream_outputs=True)
    assert body == streamed[streamed.index("model_rhs"):]


def test_band_config_mirrors_the_cuda_struct():
    """The wrapper's ctypes CBandConfig lists the kernel's BandConfig
    fields in the same order and with the same scalar types."""
    src = (Path(fb.__file__).resolve().parent.parent / "csrc"
           / "fused_band_bdf.cuh").read_text()
    body = re.search(r"struct BandConfig \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in body.split(";"):
        decl = re.sub(r"//[^\n]*", "", decl).strip()
        if decl:
            ctype, names = decl.split(None, 1)
            fields += [(ctype, re.match(r"\w+", v.strip()).group(0))
                       for v in names.split(",")]

    def scalar(ct):
        while hasattr(ct, "_type_") and hasattr(ct, "_length_"):
            ct = ct._type_
        return {ctypes.c_double: "double", ctypes.c_int: "int"}[ct]

    assert fields == [(scalar(ct), name) for name, ct in fb.CBandConfig._fields_]
