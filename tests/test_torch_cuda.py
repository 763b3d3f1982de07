"""The fused BDF kernel (csrc/fused_bdf.cuh) against its plain PyTorch
version, on a CUDA card; every test here skips without one.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
"""

import numpy as np
import pytest
import torch

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.models import robertson as trob
from diffsol_tpu_torch.ops import fused_stepper as fs

torch.set_num_threads(1)

STEP_SLACK = 2
# kernel vs plain version: both float64, one algorithm, so equal steps in
# every tile and ys to within f64 operation-order noise (1e-13 measured on
# the H100); a kernel with float32 heuristics sits ~1e-7 relative off
YS_RTOL, YS_ATOL = 1e-9, 1e-12


def _params(nbatch):
    k1 = 0.04 * (1.0 + 0.1 * np.linspace(-1.0, 1.0, nbatch))
    return np.stack([k1, np.full(nbatch, 1e4), np.full(nbatch, 3e7)], axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("jac_reuse,nbatch,tile", [
    pytest.param(True, 256, None, id="True"),
    pytest.param(False, 256, None, id="False"),
    # tiles above 256 members run the kernel's 1024-thread build
    pytest.param(True, 600, 512, id="tile512"),
])
def test_fused_kernel_matches_plain_version_cuda(jac_reuse, nbatch, tile):
    """The CUDA kernel against its plain version on the card: the same
    float64 algorithm, so equal step counts and trajectories to
    rtol=1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem = trob.problem_ode()
    solve = fs.make_fused_bdf_solve(problem, trob.T_EVAL_4E10, nbatch, tile=tile,
                                    jac_reuse=jac_reuse)
    params = torch.tensor(_params(nbatch), device="cuda")
    before = fs.launch_fused_bdf.launches
    ys, status, steps = solve(params)
    torch.cuda.synchronize()
    assert fs.launch_fused_bdf.launches == before + 1
    ys_p, status_p, steps_p = solve.reference(params)
    assert status.tolist() == status_p.tolist() == [fs.OK] * solve.ntiles
    assert torch.equal(steps, steps_p)
    torch.testing.assert_close(ys, ys_p, rtol=YS_RTOL, atol=YS_ATOL)


def _chain8(t, y, p):
    """An 8-state stiff linear-nonlinear chain, to exercise the kernel at
    its largest size."""
    rows = [-p[0] * y[0] + p[1] * y[7] * y[1]]
    for i in range(1, 8):
        rows.append(p[0] * y[i - 1] - (1.0 + i) * y[i] - p[1] * y[i] * y[(i + 1) % 8])
    return torch.stack(rows)


@pytest.mark.cuda
def test_fused_kernel_n8_matches_plain_version_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem = (dtt.OdeBuilder().rhs(_chain8)
               .init(lambda t, p: torch.ones(8, dtype=torch.float64, device=p.device))
               .p([50.0, 1e3]).rtol(1e-6).atol(1e-9).build())
    solve = fs.make_fused_bdf_solve(problem, [0.1, 1.0, 10.0], 300, tile=128)
    rng = np.random.default_rng(8)
    params = torch.tensor(np.stack([rng.uniform(40, 60, 300), np.full(300, 1e3)], 1),
                          device="cuda")
    ys, status, steps = solve(params)
    ys_p, status_p, steps_p = solve.reference(params)
    assert status.tolist() == status_p.tolist() == [fs.OK] * 3
    assert torch.equal(steps, steps_p)
    torch.testing.assert_close(ys, ys_p, rtol=YS_RTOL, atol=YS_ATOL)


@pytest.mark.cuda
def test_lockstep_and_auto_modes_on_cuda():
    """Lockstep on CUDA tensors stays on the card and agrees with the same
    solve on the CPU (float64 both, so to rtol=1e-6 with the step slack of
    test_torch_bdf.py); auto on CUDA tensors takes the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem = trob.problem_ode()
    t_eval = [0.4, 4.0, 40.0, 400.0]
    params = torch.tensor(_params(8))
    cpu = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval, params,
                                   mode="lockstep")
    gpu = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval, params.cuda(),
                                   mode="lockstep")
    assert gpu.ys.is_cuda and gpu.tier == "lockstep"
    assert gpu.stop_reason == cpu.stop_reason == dtt.errors.TSTOP_REACHED
    torch.testing.assert_close(gpu.ys.cpu(), cpu.ys, rtol=1e-6, atol=1e-14)
    assert abs(gpu.state.stats.steps - cpu.state.stats.steps) <= STEP_SLACK
    before = fs.launch_fused_bdf.launches
    auto = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval, params.cuda(),
                                    mode="auto")
    assert auto.tier == "fused_small"
    assert fs.launch_fused_bdf.launches == before + 1
    assert auto.stop_reason == dtt.errors.TSTOP_REACHED
