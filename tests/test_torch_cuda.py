"""The CUDA kernels against their plain PyTorch versions, on a CUDA card:
the fused BDF kernel (csrc/fused_bdf.cuh), the band LU (csrc/band_lu.cuh)
and the fused band BDF kernel (csrc/fused_band_bdf.cuh), and the public
paths through them.  Every test here skips without a card.

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
    # a warp a block: the tile reductions combine one warp's slot with the
    # empty ones, and order selection takes its three powers in one thread
    pytest.param(True, 5, 1, id="tile1"),
    # two warps a block, the last tile ragged (44 of 64 members)
    pytest.param(True, 300, 64, id="tile64_ragged"),
    # pad threads past the tile in every block (100 members, 128 threads),
    # the last tile ragged
    pytest.param(True, 250, 100, id="tile100_ragged"),
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
@pytest.mark.parametrize("tile", [128, 256])
def test_fused_kernel_n8_matches_plain_version_cuda(tile):
    """K1 at its largest size, 300 members in tiles of 128 (three, the last
    ragged) and of 256 (two: 256 threads, the build's widest block below
    the 1024-thread one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem = (dtt.OdeBuilder().rhs(_chain8)
               .init(lambda t, p: torch.ones(8, dtype=torch.float64, device=p.device))
               .p([50.0, 1e3]).rtol(1e-6).atol(1e-9).build())
    solve = fs.make_fused_bdf_solve(problem, [0.1, 1.0, 10.0], 300, tile=tile)
    rng = np.random.default_rng(8)
    params = torch.tensor(np.stack([rng.uniform(40, 60, 300), np.full(300, 1e3)], 1),
                          device="cuda")
    ys, status, steps = solve(params)
    ys_p, status_p, steps_p = solve.reference(params)
    assert status.tolist() == status_p.tolist() == [fs.OK] * solve.ntiles
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
                                   mode="lockstep", device="cpu")
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


# ---------------------------------------------------------------------------
# the rest of K1: diagonal mass, roots and resets, quadrature, transcendentals
# ---------------------------------------------------------------------------

def _close(name, got, ref):
    torch.testing.assert_close(got, ref, rtol=YS_RTOL, atol=YS_ATOL,
                               msg=lambda m: f"{name}: {m}")


def _same_solve(solve, params):
    """Kernel and plain version on the same CUDA params: equal statuses,
    steps, root counts and indices; ys and gs to rtol=1e-9 and the root
    time to 1e-12 relative.  Returns the kernel's result as a dict."""
    before = fs.launch_fused_bdf.launches
    got = solve(params)
    torch.cuda.synchronize()
    assert fs.launch_fused_bdf.launches == before + 1
    ref = solve.reference(params)
    if not isinstance(got, dict):
        got = dict(zip(("ys", "status", "steps"), got))
        ref = dict(zip(("ys", "status", "steps"), ref))
    assert got.keys() == ref.keys()
    for key in ("status", "steps", "n_points", "n_roots", "root_idx"):
        if key in got:
            assert got[key].tolist() == ref[key].tolist(), key
    for key in ("ys", "gs"):
        if key in got:
            _close(key, got[key], ref[key])
    if "root_t" in got:
        torch.testing.assert_close(got["root_t"], ref["root_t"], rtol=1e-12, atol=0.0,
                                   equal_nan=True)
    return got


def _variant(name, nbatch):
    """(problem, t_eval, params (nbatch, np) numpy) of a K1 variant; every
    member of a root problem has the same parameters, since a tile's
    members must cross together."""
    from diffsol_tpu_torch.models import fused_cases as fc

    lin = np.linspace(-1.0, 1.0, nbatch)
    if name == "dae":
        return trob.problem_dae(), trob.T_EVAL_4E10, _params(nbatch)
    if name == "root_stop":
        return fc.root_stop_problem(), fc.ROOT_STOP_T_EVAL, np.ones((nbatch, 1))
    if name == "root_reset":
        return (fc.bouncing_ball_problem(), fc.BALL_T_EVAL,
                np.tile(fc.BALL_P, (nbatch, 1)))
    if name == "quad":
        return (fc.quadrature_problem(), fc.QUAD_T_EVAL,
                np.stack([0.1 * (1.0 + 0.05 * lin), np.ones(nbatch)], 1))
    if name == "quad_err":
        return (fc.quadrature_err_problem(), fc.QUAD_ERR_T_EVAL,
                0.5 * (1.0 + 0.05 * lin)[:, None])
    if name == "transcendental":
        return (fc.transcendental_problem(), fc.TRANSCENDENTAL_T_EVAL,
                np.stack([1.0 + 0.5 * lin, np.ones(nbatch)], 1))
    raise ValueError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dae", "root_stop", "root_reset", "quad", "quad_err",
                                  "transcendental"])
def test_fused_kernel_variants_match_plain_version_cuda(name):
    """Each further build of K1 against its plain version: 300 members in
    two tiles of 128 and a ragged one of 44."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem, t_eval, params = _variant(name, 300)
    solve = fs.make_fused_bdf_solve(problem, t_eval, 300, tile=128)
    assert solve.ntiles == 3
    got = _same_solve(solve, torch.tensor(params, device="cuda"))
    want = fs.ROOT_STOP if name == "root_stop" else fs.OK
    assert got["status"].tolist() == [want] * 3
    if name == "dae":
        torch.testing.assert_close(got["ys"].sum(1), torch.ones_like(got["ys"][:, 0]),
                                   rtol=0.0, atol=1e-6)
    if name == "root_stop":
        assert got["root_idx"].tolist() == [0] * 3
        torch.testing.assert_close(got["root_t"], torch.full_like(got["root_t"], np.log(2.0)),
                                   rtol=1e-5, atol=0.0)
        assert bool((got["ys"][2:] == 0.0).all())  # zeros past the root
    if name == "root_reset":
        assert got["n_roots"].tolist() == [1] * 3


def _chain8_dae(t, y, p):
    """The 8-state chain with its last row algebraic: 0 = y7 - y6^2."""
    rows = [-p[0] * y[0] + p[1] * y[7] * y[1]]
    for i in range(1, 7):
        rows.append(p[0] * y[i - 1] - (1.0 + i) * y[i] - p[1] * y[i] * y[i + 1])
    rows.append(y[7] - y[6] * y[6])
    return torch.stack(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("mass", ["constant", "time_dependent"])
def test_fused_kernel_n8_mass_matches_plain_version_cuda(mass):
    """K1 at its largest size with a diagonal mass: a constant one with an
    algebraic row (folded into the kernel), and one that grows with t
    (replayed at every step), with quadrature of the state beside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f64 = torch.float64
    b = dtt.OdeBuilder().p([50.0, 1e3]).rtol(1e-6).atol(1e-9)
    ones = lambda t, p: torch.ones(8, dtype=f64, device=p.device)  # noqa: E731
    if mass == "constant":
        md = torch.tensor([1.0] * 7 + [0.0], dtype=f64)
        b = b.rhs(_chain8_dae).init(ones).mass(lambda t, p: torch.diag(md.to(p.device)))
    else:
        b = (b.rhs(_chain8).init(ones).integrate_out()
             .mass(lambda t, p: torch.diag(torch.stack([1.0 + 0.5 * t + 0.0 * p[0]] * 8))))
    solve = fs.make_fused_bdf_solve(b.build(), [0.1, 1.0, 10.0], 300, tile=128)
    assert (solve.cfg.mass_const is not None) == (mass == "constant")
    rng = np.random.default_rng(8)
    params = torch.tensor(np.stack([rng.uniform(40, 60, 300), np.full(300, 1e3)], 1),
                          device="cuda")
    got = _same_solve(solve, params)
    assert got["status"].tolist() == [fs.OK] * 3


@pytest.mark.cuda
def test_fused_kernel_root_inconsistent_fails_loudly_cuda():
    """Members of one tile that cross at different times end the tile, and
    the solve, in ROOT_BATCH_INCONSISTENT; tiles that each agree within
    themselves but stop at different times do too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import fused_cases as fc

    problem = fc.root_stop_problem()
    rates = np.repeat([0.5, 1.0, 2.0, 4.0], 64)[:, None]
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, [1.0, 3.0], rates,
                                   mode="fused", tile=128)
    assert sol.stop_reason == dtt.errors.ROOT_BATCH_INCONSISTENT
    assert not bool(torch.isfinite(sol.ys).any())
    # tile 0 never reaches 0.5 before t = 1, tile 1 stops at ln 2 / 2
    rates = np.repeat([0.1, 2.0], 128)[:, None]
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, [0.5, 1.0], rates,
                                   mode="fused", tile=128)
    assert sol.stop_reason == dtt.errors.ROOT_BATCH_INCONSISTENT


@pytest.mark.cuda
def test_kernel_config_size_matches_cuda():
    """sizeof(Config) of the built library equals the ctypes mirror's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes

    from diffsol_tpu_torch import _build

    solve = fs.make_fused_bdf_solve(trob.problem_dae(), [1.0], 4)
    lib = _build.load_fused_bdf(solve.header)
    assert lib.fused_bdf_config_size() == ctypes.sizeof(fs.CConfig)


@pytest.mark.cuda
def test_solve_and_solve_dense_with_a_root_on_the_card_by_default():
    """``solve_dense`` and ``solve`` with a root function run on the card without
    ``device`` and agree with the CPU: the same stop, root time and ys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.drivers import solve
    from diffsol_tpu_torch.models import exponential_decay as ted

    problem = ted.problem_with_root()
    gpu = dtt.solve_dense(dtt.BdfSolver(problem), [1.0, 10.0])
    cpu = dtt.solve_dense(dtt.BdfSolver(problem), [1.0, 10.0], device="cpu")
    assert gpu.ys.is_cuda and not problem.params.is_cuda
    assert gpu.stop_reason == cpu.stop_reason == dtt.errors.ROOT_FOUND
    assert gpu.root_idx == cpu.root_idx == 0
    np.testing.assert_allclose(gpu.root_t, -np.log(0.6) / 0.1, rtol=1e-5)
    np.testing.assert_allclose(gpu.root_t, cpu.root_t, rtol=1e-9)
    torch.testing.assert_close(gpu.ys.cpu(), cpu.ys, rtol=1e-6, atol=1e-14)
    reset = ted.problem_with_reset()
    g2 = solve(dtt.BdfSolver(reset), 10.0)
    c2 = solve(dtt.BdfSolver(reset), 10.0, device="cpu")
    assert g2.ys.is_cuda and g2.stop_reason == c2.stop_reason == dtt.errors.TSTOP_REACHED
    assert abs(g2.n_points - c2.n_points) <= STEP_SLACK
    np.testing.assert_allclose(float(g2.ys[g2.n_points - 1, 0]),
                               float(c2.ys[c2.n_points - 1, 0]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the banded tier: band LU (K3, K4) and the fused band stepper (K2)
# ---------------------------------------------------------------------------

# band LU kernel vs plain version: both float64, the same operations on
# each element (the back substitution sums each row in the reverse order),
# so they part by FMA contraction and that order, about one rounding per
# column step of a diagonally dominant band
LU_RTOL = 1e-12


def _heat1d_iteration_band(nbatch, n=128, c=1e-3, device="cuda"):
    """M - cJ of heat1d (n states) for diffusivities linspace(0.5, 2.0),
    as a (B, 3, n) member-major band."""
    from diffsol_tpu_torch.models import heat1d

    problem, _ = heat1d.make(n - 1, banded=True)
    d = torch.linspace(0.5, 2.0, nbatch, dtype=torch.float64, device=device)[:, None]
    y = torch.zeros(nbatch, n, dtype=torch.float64, device=device)
    jac = torch.func.vmap(problem.eqn.jac, in_dims=(None, 0, 0))(
        torch.tensor(0.0, dtype=torch.float64, device=device), y, d)
    return problem.linear_solver.assemble(None, jac, c)


def _random_dominant_band(nbatch, n, ml, mu, seed=0, device="cuda"):
    from diffsol_tpu_torch.ops.banded import _band_index

    rng = np.random.default_rng(seed)
    band = rng.standard_normal((nbatch, ml + mu + 1, n))
    band[:, mu] += 2.0 * (ml + mu + 1)
    band *= _band_index(n, ml, mu)[1]
    return torch.tensor(band, device=device)


def _band_matvec(band, x, ml, mu):
    """A x for a (B, nb, n) member-major band and x (B, n)."""
    n = x.shape[-1]
    y = torch.zeros_like(x)
    for d in range(ml + mu + 1):
        lo, hi = max(0, mu - d), min(n, n + mu - d)  # 0 <= j + d - mu < n
        if lo < hi:
            y[:, lo + d - mu: hi + d - mu] += band[:, d, lo:hi] * x[:, lo:hi]
    return y


def _check_band_lu(band, b, ml, mu, residual_tol):
    """K3 and K4 against their plain versions: one launch a call, factors
    and x within LU_RTOL, and A x = b member by member within residual_tol.
    A (1, nb, n) band with a (B, n) b is one factorization for every
    right-hand side."""
    from diffsol_tpu_torch.ops import band_lu

    f0, s0 = band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches
    fac = band_lu.band_lu_factor(band, ml, mu)
    x = band_lu.band_lu_solve(fac, b, ml, mu)
    F = fac.lu
    torch.cuda.synchronize()
    assert band_lu.launch_band_lu_factor.launches == f0 + 1
    assert band_lu.launch_band_lu_solve.launches == s0 + 1
    F_p = band_lu.band_lu_factor_reference(band, ml, mu)
    x_p = band_lu.band_lu_solve_reference(F_p.expand(-1, -1, b.shape[0]), b, ml, mu)
    assert F.shape == F_p.shape and x.shape == b.shape
    torch.testing.assert_close(F, F_p, rtol=LU_RTOL, atol=LU_RTOL * float(F_p.abs().max()))
    torch.testing.assert_close(x, x_p, rtol=LU_RTOL, atol=LU_RTOL * float(x_p.abs().max()))
    ax = _band_matvec(band.expand(b.shape[0], -1, -1), x, ml, mu)
    torch.testing.assert_close(ax, b, rtol=residual_tol, atol=residual_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case,ml,mu,n,nbatch,residual_tol", [
    pytest.param("heat1d", 1, 1, 128, 1024, 1e-10, id="heat1d"),
    pytest.param("random", 3, 2, 128, 1024, 1e-10, id="random_ml3_mu2"),
    pytest.param("random", 1, 1, 128, 1, 1e-10, id="random_ml1_mu1_B1"),
    pytest.param("random", 0, 3, 128, 1024, 1e-10, id="random_ml0_mu3"),
    pytest.param("random", 3, 0, 128, 1024, 1e-10, id="random_ml3_mu0"),
    pytest.param("random", 20, 5, 400, 1, 1e-10, id="random_ml20_mu5_B1"),
    pytest.param("random", 20, 5, 200, 1000, 1e-10, id="random_ml20_mu5_B1000"),
    # past the shared memory at four members a block: the factor's window
    # (ml = mu > 45), and x over ~7,000 doubles a member, in device memory
    pytest.param("random", 60, 60, 300, 5, 1e-9, id="window_in_device_memory_ml60"),
    pytest.param("random", 130, 130, 300, 3, 1e-9, id="window_in_device_memory"),
    pytest.param("random", 1, 1, 10_000, 5, 1e-9, id="x_in_device_memory_n10k"),
    pytest.param("random", 1, 1, 30_000, 5, 1e-9, id="x_in_device_memory"),
])
def test_band_lu_kernels_match_plain_version_cuda(case, ml, mu, n, nbatch, residual_tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if case == "heat1d":
        band = _heat1d_iteration_band(nbatch, n)
    else:
        band = _random_dominant_band(nbatch, n, ml, mu)
    rng = np.random.default_rng(1)
    b = torch.tensor(rng.standard_normal((nbatch, n)), device="cuda")
    _check_band_lu(band, b, ml, mu, residual_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("nbatch,tile,ntiles", [
    pytest.param(256, None, 2, id="B256"),  # two tiles of 128: 16 blocks of 8
    pytest.param(200, None, 2, id="ragged"),  # the last tile padded with copies
    pytest.param(200, 100, 2, id="tile100"),  # 13 blocks of 8: four replica slots
    pytest.param(10, 4, 3, id="tile4"),  # one block of 4 warps a tile, ragged
])
def test_fused_band_kernel_matches_plain_version_cuda(nbatch, tile, ntiles):
    """K2 against its plain version on heat1d n=128 at tiles the launch
    plan lays out differently: equal steps in every tile and ys to
    rtol=1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import heat1d
    from diffsol_tpu_torch.ops import fused_band_stepper as fb

    problem, _ = heat1d.make(127, rtol=1e-6, atol=1e-8, banded=True)
    t_eval = [0.001, 0.01, 0.05, 0.1, 0.2]
    solve = fb.make_fused_band_bdf_solve(problem, t_eval, nbatch, tile=tile)
    assert solve.ntiles == ntiles and solve.tile == (tile or 128)
    params = torch.linspace(0.5, 2.0, nbatch, dtype=torch.float64, device="cuda")[:, None]
    before = fb.launch_fused_band_bdf.launches
    ys, status, steps = solve(params)
    torch.cuda.synchronize()
    assert fb.launch_fused_band_bdf.launches == before + 1
    ys_p, status_p, steps_p = solve.reference(params)
    assert status.tolist() == status_p.tolist() == [fs.OK] * ntiles
    assert torch.equal(steps, steps_p)
    torch.testing.assert_close(ys, ys_p, rtol=YS_RTOL, atol=YS_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heat1d", "heat2d", "wide_band"])
def test_fused_band_plan_matches_the_kernel_cuda(name):
    """The kernel's build takes the wrapper's launch plan: its own count of
    shared doubles a member equals band_plan's, the card holds at least one
    cluster of it at once, and a plan that passes the shared memory is
    refused at launch with a raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes

    from diffsol_tpu_torch import _build
    from diffsol_tpu_torch.models import heat1d, heat2d
    from diffsol_tpu_torch.ops import fused_band_stepper as fb

    if name == "heat2d":
        problem = heat2d.make(20)
    elif name == "heat1d":
        problem, _ = heat1d.make(127, banded=True)
    else:
        problem, _, _ = _band_case("wide_band")
    solve = fb.make_fused_band_bdf_solve(problem, [0.1], 1024)
    cfg, plan = solve.cfg, solve.plan
    assert (plan.fchunk == 0) == (name == "wide_band")
    lib = _build.load_fused_band_bdf(solve.header, cfg.ml, cfg.mu)
    assert lib.fused_band_bdf_member_doubles(plan.fchunk, plan.schunk) == plan.stride
    out = (ctypes.c_int * 5)()
    assert lib.fused_band_bdf_report(ctypes.addressof(fb._c_config(cfg)), out) == 0
    print(name, plan, "clusters held at once", out[0], "registers", out[1], "local bytes",
          out[2], "shared bytes", out[3], "+", out[4])
    assert out[0] >= 1 and out[3] == plan.shared_bytes
    c = fb.CBandConfig.from_buffer_copy(fb._c_config(cfg))
    c.stride = fb.SMEM_DYNAMIC // 8  # members x stride doubles past the block's limit
    assert lib.fused_band_bdf_report(ctypes.addressof(c), out) != 0


@pytest.mark.cuda
def test_band_paths_on_cuda():
    """heat1d n=128, B=256 on the card through both public modes: fused
    (one K2 launch) and lockstep (K3 and K4 on every Newton matrix); each
    tracks the analytic series and they agree at the solver tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import heat1d
    from diffsol_tpu_torch.ops import band_lu
    from diffsol_tpu_torch.ops import fused_band_stepper as fb

    problem, soln = heat1d.make(127, rtol=1e-6, atol=1e-8, banded=True)
    t_eval = [0.001, 0.01, 0.05, 0.1, 0.2]
    d = np.linspace(0.5, 2.0, 256)
    params = d[:, None]
    k2 = fb.launch_fused_band_bdf.launches
    fused = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval, params, mode="fused")
    assert fused.tier == "fused_band" and fused.ys.is_cuda
    assert fb.launch_fused_band_bdf.launches == k2 + 1
    k3, k4 = band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches
    lock = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval, params,
                                    mode="lockstep")
    assert lock.tier == "lockstep" and lock.ys.is_cuda
    assert band_lu.launch_band_lu_factor.launches > k3
    assert band_lu.launch_band_lu_solve.launches > k4
    for sol in (fused, lock):
        assert sol.stop_reason == dtt.errors.TSTOP_REACHED
        m = int(np.argmin(np.abs(d - 1.0)))
        err = np.abs(sol.ys[:, m].cpu().numpy() - soln(t_eval, d[m])).max()
        assert err < 1e-4, err
    torch.testing.assert_close(fused.ys, lock.ys, rtol=5e-4, atol=1e-6)


@pytest.mark.cuda
def test_solve_dense_runs_on_the_card_by_default():
    """A single-instance solve of a problem the builder left on the CPU
    runs on the card without ``device`` (the band LU kernels on every
    Newton matrix) and agrees with the same solve on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import heat1d
    from diffsol_tpu_torch.ops import band_lu

    problem, soln = heat1d.make(127, rtol=1e-6, atol=1e-8, banded=True)
    t_eval = [0.001, 0.01, 0.05, 0.1, 0.2]
    k3, k4 = band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches
    gpu = dtt.solve_dense(dtt.BdfSolver(problem), t_eval)
    assert gpu.ys.is_cuda and gpu.stop_reason == dtt.errors.TSTOP_REACHED
    assert band_lu.launch_band_lu_factor.launches > k3
    assert band_lu.launch_band_lu_solve.launches > k4
    assert not problem.params.is_cuda  # the caller's problem is left as it was
    cpu = dtt.solve_dense(dtt.BdfSolver(problem), t_eval, device="cpu")
    assert abs(gpu.state.stats.steps - cpu.state.stats.steps) <= STEP_SLACK
    torch.testing.assert_close(gpu.ys.cpu(), cpu.ys, rtol=1e-6, atol=1e-14)
    assert np.abs(gpu.ys.cpu().numpy() - soln(t_eval, 1.0)).max() < 1e-4


def _band_case(case):
    """(problem, t_eval, params) of the band kernel's other paths: a
    constant diagonal mass with algebraic rows, the ml = mu = 2 build, a
    matrix the no-pivot LU cannot factor (test_pallas_band.py:137, :95,
    :212), and heat1d n = 100 through a band of ml = mu = 42 (85
    diagonals), too wide for the factor's window on chip at tile 80."""
    from diffsol_tpu_torch.ops.banded import make_banded_solver

    f64 = torch.float64
    b = dtt.OdeBuilder().rtol(1e-6).atol(1e-8).p([1.0])
    if case == "wide_band":
        from diffsol_tpu_torch.models import heat1d

        heat, _ = heat1d.make(99)
        b = (b.rhs(heat.eqn.rhs).init(heat.eqn.init)
             .linear_solver(make_banded_solver(42, 42)))
        return b.build(), [0.01, 0.05], np.linspace(0.5, 2.0, 160)[:, None]
    if case == "dirichlet_dae":
        n, h = 13, 1.0 / 12

        def rhs(t, y, p):
            interior = p[0] * (y[:-2] - 2.0 * y[1:-1] + y[2:]) / (h * h)
            return torch.cat([y[:1], interior, y[-1:]])

        md = torch.ones(n, dtype=f64)
        md[0] = md[-1] = 0.0
        x = torch.arange(n, dtype=f64) * h
        b = (b.rhs(rhs).init(lambda t, p: 4.0 * x.to(p.device) * (1.0 - x.to(p.device)))
             .mass(lambda t, p: torch.diag(md.to(p.device)))
             .linear_solver(make_banded_solver(1, 1)))
        return b.build(), [0.02, 0.1], np.linspace(0.8, 1.2, 160)[:, None]
    if case == "stencil5":
        n, h = 17, 1.0 / 18

        def rhs(t, y, p):
            z2, z1 = torch.zeros_like(y[:2]), torch.zeros_like(y[:1])
            return p[0] * (-torch.cat([z2, y[:-2]]) + 16.0 * torch.cat([z1, y[:-1]])
                           - 30.0 * y + 16.0 * torch.cat([y[1:], z1])
                           - torch.cat([y[2:], z2])) / (12.0 * h * h)

        x = (torch.arange(n, dtype=f64) + 1.0) * h
        b = (b.rhs(rhs).init(lambda t, p: 4.0 * x.to(p.device) * (1.0 - x.to(p.device)))
             .linear_solver(make_banded_solver(2, 2)))
        return b.build(), [0.02, 0.1], np.linspace(0.5, 2.0, 160)[:, None]
    n = 12
    m0, m1, m2 = (torch.tensor(np.arange(n) % 3 == k, dtype=f64) for k in range(3))

    def rhs(t, y, p):
        left = torch.cat([torch.zeros_like(y[:1]), y[:-1]])
        right = torch.cat([y[1:], torch.zeros_like(y[:1])])
        dev = y.device
        return p[0] * (m0.to(dev) * y + m1.to(dev) * (left - right)
                       + m2.to(dev) * (left - y))

    b = (b.rhs(rhs).init(lambda t, p: (m0 + m2).to(p.device))
         .mass(lambda t, p: torch.diag((1.0 - m1).to(p.device)))
         .linear_solver(make_banded_solver(1, 1)))
    return b.build(), [0.5, 1.0], np.ones((160, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dirichlet_dae", "stencil5", "lu_growth", "wide_band"])
def test_fused_band_kernel_other_paths_cuda(case):
    """K2 against its plain version where heat1d does not reach: the mass
    diagonal in the residual and the matrix, a wider band build, the
    growth guard's typed failure, and a band whose factor runs in device
    memory (two tiles of 80 each: clusters of 10 blocks of 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.ops import fused_band_stepper as fb

    problem, t_eval, params = _band_case(case)
    solve = fb.make_fused_band_bdf_solve(problem, t_eval, 160, tile=80, max_steps=2000)
    assert (solve.plan.fchunk == 0) == (case == "wide_band")
    p = torch.tensor(params, device="cuda")
    ys, status, steps = solve(p)
    ys_p, status_p, steps_p = solve.reference(p)
    want = fs.FAIL_LU_GROWTH if case == "lu_growth" else fs.OK
    assert status.tolist() == status_p.tolist() == [want] * 2
    assert torch.equal(steps, steps_p)
    if case == "lu_growth":
        assert not bool(torch.isfinite(ys).any())
    else:
        torch.testing.assert_close(ys, ys_p, rtol=YS_RTOL, atol=YS_ATOL)


# ---------------------------------------------------------------------------
# the 2-D method-of-lines DAEs, wide bands, and precision="mixed"
# ---------------------------------------------------------------------------

def _mol2d(name):
    from diffsol_tpu_torch.models import foodweb, heat2d

    if name == "heat2d":  # n = 64, ml = mu = 8
        return heat2d.make(8), [0.01, 0.03, 0.1], 100_000
    if name == "heat2d_full":  # n = 400, ml = mu = 20: 41 diagonals
        return heat2d.make(20), [0.01, 0.03, 0.1], 100_000
    return foodweb.make(4), [1e-3, 1e-2, 1e-1], 3000  # n = 32, ml = mu = 8


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heat2d", "foodweb", "heat2d_full"])
def test_fused_band_kernel_mol2d_matches_plain_version_cuda(name):
    """K2 against its plain version on heat2d mgrid = 8 and foodweb nx = 4
    (whose inconsistent ``init`` goes through the banded consistent-IC
    solve, K3/K4, before the launch), B = 160 in two tiles of 80, and on
    heat2d at its full width (mgrid = 20: n = 400, nb = 41), B = 256 in two
    tiles of 128: heat2d with equal steps in every tile and ys to rtol =
    1e-9, foodweb within 10 error weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.ops import band_lu
    from diffsol_tpu_torch.ops import fused_band_stepper as fb

    problem, t_eval, max_steps = _mol2d(name)
    nbatch, tile = (256, None) if name == "heat2d_full" else (160, 80)
    solve = fb.make_fused_band_bdf_solve(problem, t_eval, nbatch, tile=tile,
                                         max_steps=max_steps)
    assert solve.ntiles == 2
    assert solve.cfg.needs_ic_solve == (name == "foodweb")
    params = torch.ones(nbatch, 1, dtype=torch.float64, device="cuda")
    before, k3 = fb.launch_fused_band_bdf.launches, band_lu.launch_band_lu_factor.launches
    ys, status, steps = solve(params)
    torch.cuda.synchronize()
    assert fb.launch_fused_band_bdf.launches == before + 1
    assert (band_lu.launch_band_lu_factor.launches > k3) == (name == "foodweb")
    ys_p, status_p, steps_p = solve.reference(params)
    assert status.tolist() == status_p.tolist() == [fs.OK] * 2
    print(name, "steps kernel", steps.tolist(), "plain", steps_p.tolist(), "max rel",
          float(((ys - ys_p).abs() / ys_p.abs().clamp(min=1e-300)).max()))
    if name != "foodweb":
        assert torch.equal(steps, steps_p)
        torch.testing.assert_close(ys, ys_p, rtol=YS_RTOL, atol=YS_ATOL)
        if name == "heat2d_full":
            assert steps.tolist() == [47, 47]
    else:
        # foodweb's step sequence follows the last bit of its rhs (the CPU
        # test test_foodweb_steps_are_sensitive_to_roundoff_and_heat2d_is_not
        # shows it on the plain version alone): two orders of the same
        # float64 operations part by ~1e-5, so the gate is 10 error weights
        # and nearly equal steps
        w = 1e-5 * ys_p.abs() + 1e-5
        assert float(((ys - ys_p).abs() / w).max()) < 10.0
        assert int((steps - steps_p).abs().max()) <= 0.2 * int(steps_p.max())
    # against the lockstep path (K3/K4) at the solver's tolerance
    lock = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval, params[:4].cpu().numpy(),
                                    mode="lockstep", max_steps=max_steps)
    assert lock.stop_reason == dtt.errors.TSTOP_REACHED
    torch.testing.assert_close(ys[:, :, :4].movedim(-1, 1), lock.ys, rtol=5e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nbatch,nrhs", [
    pytest.param(200, 256, 256, id="n200_B256"),
    pytest.param(400, 1000, 1000, id="n400_B1000"),
    pytest.param(12, 5, 5, id="n12_B5"),  # n smaller than the band
    pytest.param(400, 1, 1, id="n400_B1"),
    pytest.param(400, 1, 256, id="one_factorization_256_rhs"),
])
def test_band_lu_kernels_nb41_match_plain_version_cuda(n, nbatch, nrhs):
    """K3 and K4 at the 2-D models' width, ml = mu = 20 (nb = 41), against
    their plain versions: member groups that do not fill a block, a band
    wider than the matrix, and one factorization for many right-hand
    sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ml = mu = 20
    band = _random_dominant_band(nbatch, n, ml, mu)
    b = torch.tensor(np.random.default_rng(2).standard_normal((nrhs, n)), device="cuda")
    _check_band_lu(band, b, ml, mu, 1e-9)


@pytest.mark.cuda
def test_fused_kernel_mixed_precision_cuda():
    """K1 with ``precision="mixed"`` (float32 Jacobian, LU and Newton solve)
    on Robertson to t = 4e10, B = 300: against its plain version, whose
    float32 operations run in another order (LAPACK's LU, no FMA
    contraction), so the two are held to the error test's weights and to
    nearly equal steps; and against the float64 build as
    tests/test_pallas_stepper.py:451 holds the Pallas kernel (< 5 weights
    overall, < 0.1 up to t = 4e4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem = trob.problem_ode()
    nbatch = 300
    # identical nominal members, as the JAX test's: in the last decade to
    # t = 4e10 float32 cannot resolve 1 - cJ (c |J| ~ 1e14), Newton fails
    # often, and a tile of spread members runs into the kernel's limit of 50
    # failures (FAIL_NEWTON, in the plain version too)
    params = torch.tensor(np.tile(np.array(trob.P_DEFAULT), (nbatch, 1)), device="cuda")
    te = trob.T_EVAL_4E10
    mixed = fs.make_fused_bdf_solve(problem, te, nbatch, precision="mixed")
    assert mixed.cfg.mixed and "#define MODEL_MIXED 1" in mixed.header
    before = fs.launch_fused_bdf.launches
    ys, status, steps = mixed(params)
    torch.cuda.synchronize()
    assert fs.launch_fused_bdf.launches == before + 1
    ys_p, status_p, steps_p = mixed.reference(params)
    assert status.tolist() == status_p.tolist() == [fs.OK] * mixed.ntiles
    print("mixed steps kernel", steps.tolist(), "plain", steps_p.tolist())
    ys_d, status_d, steps_d = fs.make_fused_bdf_solve(problem, te, nbatch)(params)
    assert status_d.tolist() == [fs.OK] * mixed.ntiles
    atol = torch.tensor([1e-8, 1e-6, 1e-6], device="cuda")[None, :, None]
    w = atol + 1e-4 * ys_d.abs()
    vs_plain = float(((ys - ys_p).abs() / w).max())
    vs_df = float(((ys - ys_d).abs() / w).max())
    n_early = sum(t <= 4e4 for t in te)
    early = float(((ys[:n_early] - ys_d[:n_early]).abs() / w[:n_early]).max())
    print(f"mixed vs plain {vs_plain:.3e} weights, vs df {vs_df:.3e}, early {early:.3e}; "
          f"df steps {steps_d.tolist()}")
    assert vs_plain < 5.0 and vs_df < 5.0 and early < 0.1
    assert int((steps - steps_p).abs().max()) <= max(10, int(0.1 * steps_p.max()))
    with pytest.raises(ValueError, match="precision"):
        fs.make_fused_bdf_solve(problem, te, nbatch, precision="f16")
    # spread members: every tile ends OK or fails loudly on the Newton limit
    _, status_s, steps_s = mixed(torch.tensor(_params(nbatch), device="cuda"))
    print("mixed, k1 spread +-10%: status", status_s.tolist(), "steps", steps_s.tolist())
    assert set(status_s.tolist()) <= {fs.OK, fs.FAIL_NEWTON}


@pytest.mark.cuda
def test_foodweb_solve_dense_on_the_card_by_default():
    """``solve_dense(BdfSolver(foodweb))`` with no device argument runs on
    the card: the consistent-IC solve and every Newton matrix go through
    K3/K4, and the corner values meet IDA's (tests/test_models.py:55)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import foodweb
    from diffsol_tpu_torch.ops import band_lu

    nx = 10
    solver = dtt.BdfSolver(foodweb.make(nx))
    k3 = band_lu.launch_band_lu_factor.launches
    sol = dtt.solve_dense(solver, foodweb.SOLN[1:4, 0], max_steps=20_000)
    assert sol.ys.is_cuda and sol.stop_reason == dtt.errors.TSTOP_REACHED
    assert band_lu.launch_band_lu_factor.launches > k3
    corners = foodweb.corner_values(sol.ys.cpu().numpy(), nx)
    np.testing.assert_allclose(corners, foodweb.SOLN[1:4, 1:], rtol=2e-3)


@pytest.mark.cuda
def test_fused_kernel_n8_mixed_precision_cuda():
    """The mixed build at the kernel's largest size, n = 8 (its ptxas line
    prints beside the float64 build's): it, the float64 build and its
    plain version end TSTOP, and it agrees with both within 5 error
    weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem = (dtt.OdeBuilder().rhs(_chain8)
               .init(lambda t, p: torch.ones(8, dtype=torch.float64, device=p.device))
               .p([50.0, 1e3]).rtol(1e-6).atol(1e-9).build())
    rng = np.random.default_rng(8)
    params = torch.tensor(np.stack([50.0 * (1.0 + 0.2 * rng.uniform(-1, 1, 300)),
                                    np.full(300, 1e3)], axis=1), device="cuda")
    te = [0.1, 1.0, 10.0]
    ys_d, status_d, _ = fs.make_fused_bdf_solve(problem, te, 300, tile=128)(params)
    mixed = fs.make_fused_bdf_solve(problem, te, 300, tile=128, precision="mixed")
    ys_m, status_m, _ = mixed(params)
    ys_p, status_p, _ = mixed.reference(params)
    assert status_d.tolist() == status_m.tolist() == status_p.tolist() == [fs.OK] * 3
    w = 1e-9 + 1e-6 * ys_d.abs()
    assert float(((ys_m - ys_d).abs() / w).max()) < 5.0
    # and against its own plain version, whose float32 operations run in
    # another order
    assert float(((ys_m - ys_p).abs() / w).max()) < 5.0


# ---------------------------------------------------------------------------
# the eager paths of the other methods, the block tier and a dense mass:
# no kernel of the port's own, so the card's solve is held to the CPU's
# (float64 both, the same step decisions)

EAGER_RTOL = 1e-8


def _card_vs_cpu(run):
    """``run(device)`` on the card and on the CPU: steps within 2, ys
    within 1e-8 relative (and 1e-14 absolute, for states at zero)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got, ref = run("cuda"), run("cpu")
    assert got.ys.device.type == "cuda"
    assert got.stop_reason == ref.stop_reason == dtt.errors.TSTOP_REACHED
    assert abs(got.state.stats.steps - ref.state.stats.steps) <= STEP_SLACK
    torch.testing.assert_close(got.ys.cpu(), ref.ys, rtol=EAGER_RTOL, atol=1e-14)
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["tr_bdf2", "tsit45"])
def test_rk_lockstep_on_the_card_matches_cpu(method):
    """B = 64 lockstep members through an RK method: Robertson ODE with k1
    spread +-10 % (tr_bdf2) and the logistic equation with r spread +-10 %
    (tsit45)."""
    from diffsol_tpu_torch.models import logistic

    if method == "tr_bdf2":
        problem, params, t_eval = trob.problem_ode(), _params(64), trob.SOLN[1:9, 0]
    else:
        r = 1.0 + 0.1 * np.linspace(-1.0, 1.0, 64)
        problem = logistic.problem(rtol=1e-6, atol=1e-8)
        params, t_eval = np.stack([r, np.ones(64), np.full(64, 0.1)], axis=1), [1.0, 5.0, 10.0]
    _card_vs_cpu(lambda dev: dtt.solve_dense_ensemble(
        lambda pr: dtt.solver(pr, method), problem, t_eval, params, mode="lockstep",
        max_steps=20_000, device=dev))


@pytest.mark.cuda
def test_blockdiag_on_the_card_matches_cpu():
    """problem_ode_groups(5) on the block tier, one solve and a lockstep
    ensemble of 8 (one (40, 3, 3) LU stack)."""
    problem = trob.problem_ode_groups(5)
    assert problem.linear_solver.name == "blockdiag(3,5)"
    t_eval = [0.4, 4.0, 40.0, 400.0]
    _card_vs_cpu(lambda dev: dtt.solve_dense(dtt.BdfSolver(problem), t_eval,
                                             max_steps=5000, device=dev))
    _card_vs_cpu(lambda dev: dtt.solve_dense_ensemble(
        dtt.BdfSolver, problem, t_eval, _params(8), mode="lockstep", max_steps=5000,
        device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bdf", "tr_bdf2"])
def test_dense_mass_on_the_card_matches_cpu(method):
    """The heat DAE of models/heat2d_mass.py with its dense consistent mass
    and the user Jacobian of ``rhs_implicit``."""
    from diffsol_tpu_torch.models import heat2d_mass

    problem = heat2d_mass.problem(4, consistent=True)
    assert problem.eqn.mass_diag_fn is None
    _card_vs_cpu(lambda dev: dtt.solve_dense(dtt.solver(problem, method), [0.01, 0.05],
                                             max_steps=2000, device=dev))


# ---------------------------------------------------------------------------
# models written as DiffSL text, and the codegen's abs / maximum / minimum /
# sign, through the kernels
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["robertson_ode", "robertson_dae"])
def test_fused_kernel_on_diffsl_robertson_cuda(name):
    """K1 built from DiffSL text (models/diffsl_sources.py) against its
    plain version: 300 members with k1 spread in two tiles of 128 and a
    ragged one, to t = 4e10; the ODE traces to the hand-written model's IR,
    the DAE's mass diag(1, 1, 0) comes from its dudt labels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import diffsl_sources

    problem = (dtt.OdeBuilder().rtol(1e-4).atol([1e-8, 1e-6, 1e-6])
               .build_from_diffsl(getattr(diffsl_sources, name)()))
    solve = fs.make_fused_bdf_solve(problem, trob.T_EVAL_4E10, 300, tile=128)
    if name == "robertson_ode":
        hand = fs.make_fused_bdf_solve(trob.problem_ode(), trob.T_EVAL_4E10, 300, tile=128)
        assert solve.model.rhs == hand.model.rhs
    else:
        assert solve.cfg.mass_const == (1.0, 1.0, 0.0)
    got = _same_solve(solve, torch.tensor(_params(300), device="cuda"))
    assert got["status"].tolist() == [fs.OK] * 3
    torch.testing.assert_close(got["ys"].sum(1), torch.ones_like(got["ys"][:, 0]), rtol=0.0,
                               atol=1e-6)


@pytest.mark.cuda
def test_fused_band_kernel_on_diffsl_heat1d_cuda():
    """K2 built from the DiffSL heat1d (n = 128; use_coloring routes it to
    banded(1,1)) against its plain version: 256 diffusivities in two tiles,
    equal steps and ys to rtol=1e-9, and within the solver's tolerance of
    the hand-written heat1d's kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import diffsl_sources, heat1d
    from diffsol_tpu_torch.ops import fused_band_stepper as fb

    problem = (dtt.OdeBuilder().rtol(1e-6).atol(1e-8).use_coloring()
               .build_from_diffsl(diffsl_sources.heat1d(127)))
    assert problem.linear_solver.name == "banded(1,1)"
    t_eval = [0.001, 0.01, 0.05, 0.1, 0.2]
    solve = fb.make_fused_band_bdf_solve(problem, t_eval, 256)
    params = torch.linspace(0.5, 2.0, 256, dtype=torch.float64, device="cuda")[:, None]
    before = fb.launch_fused_band_bdf.launches
    ys, status, steps = solve(params)
    torch.cuda.synchronize()
    assert fb.launch_fused_band_bdf.launches == before + 1
    ys_p, status_p, steps_p = solve.reference(params)
    assert status.tolist() == status_p.tolist() == [fs.OK] * 2
    assert torch.equal(steps, steps_p)
    torch.testing.assert_close(ys, ys_p, rtol=YS_RTOL, atol=YS_ATOL)
    hand, _ = heat1d.make(127, rtol=1e-6, atol=1e-8, banded=True)
    ys_h = fb.make_fused_band_bdf_solve(hand, t_eval, 256)(params)[0]
    torch.testing.assert_close(ys, ys_h, rtol=5e-4, atol=1e-6)


def _piecewise(t, y, p):
    """abs, maximum, minimum and sign in one rhs: kinks where y1 crosses 0
    and where y1 and y2 / 2 cross; the sign's argument stays positive."""
    return torch.stack([
        -p[0] * y[0] + 0.5 * torch.abs(y[1]),
        -torch.maximum(y[1], 0.5 * y[2]) + 0.1 * torch.sign(y[0] + 2.0),
        -p[1] * torch.minimum(y[2], y[0] + 0.25),
    ])


@pytest.mark.cuda
def test_fused_kernel_abs_max_min_sign_cuda():
    """K1 with the device functions dsol_abs, dsol_maximum, dsol_minimum and
    dsol_sign (csrc/dual.cuh) against its plain version: 200 members in two
    tiles, equal steps and ys to rtol=1e-9; and the IR the kernel runs
    evaluates like the callable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.ops import eqn_codegen as cg

    problem = (dtt.OdeBuilder().rhs(_piecewise)
               .init(lambda t, p: torch.tensor([1.0, -0.5, 0.8], dtype=torch.float64,
                                               device=p.device))
               .p([1.0, 2.0]).rtol(1e-6).atol(1e-9).build())
    t_eval = [0.25, 0.5, 1.0, 2.0, 4.0]
    solve = fs.make_fused_bdf_solve(problem, t_eval, 200, tile=128)
    ops = {node[0] for node in solve.model.rhs.nodes}
    assert {"abs", "maximum", "minimum", "sign"} <= ops
    k = np.linspace(-1.0, 1.0, 200)
    params = torch.tensor(np.stack([1.0 + 0.2 * k, 2.0 - 0.3 * k], 1), device="cuda")
    got = _same_solve(solve, params)
    assert got["status"].tolist() == [fs.OK] * 2
    y = got["ys"][-1].T.contiguous()  # (200, 3) at t = 4
    t = torch.full((200,), 4.0, dtype=torch.float64, device="cuda")
    want = torch.func.vmap(_piecewise)(t, y, params)
    torch.testing.assert_close(cg.eval_rhs(solve.model.rhs, t, y, params), want, rtol=0.0,
                               atol=0.0)


# ---------------------------------------------------------------------------
# forward sensitivities: K4 with rows per factorization, the banded
# lockstep sensitivity path, and the refusal of forward mode through the
# band kernels
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("naug", [1, 3, 5])
@pytest.mark.parametrize("fb", ["one", "members"])
def test_band_lu_solve_rows_per_factorization_cuda(naug, fb):
    """K4 with R = naug B right-hand sides against fb = 1 or B
    factorizations, row r with factorization r mod fb, one launch and no
    copy of the factors: against the plain version within LU_RTOL and A x
    = b row by row within 1e-10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.ops import band_lu

    n, B, ml, mu = 128, 64, 3, 2
    band = _random_dominant_band(1 if fb == "one" else B, n, ml, mu, seed=2)
    fac = band_lu.band_lu_factor(band, ml, mu)
    rng = np.random.default_rng(3)
    b = torch.tensor(rng.standard_normal((naug * B, n)), device="cuda")
    s0 = band_lu.launch_band_lu_solve.launches
    x = band_lu.band_lu_solve(fac, b, ml, mu)
    torch.cuda.synchronize()
    assert band_lu.launch_band_lu_solve.launches == s0 + 1
    x_p = band_lu.band_lu_solve_reference(fac.lu, b, ml, mu)
    torch.testing.assert_close(x, x_p, rtol=LU_RTOL, atol=LU_RTOL * float(x_p.abs().max()))
    members = torch.arange(naug * B, device="cuda") % band.shape[0]
    ax = _band_matvec(band[members], x, ml, mu)
    torch.testing.assert_close(ax, b, rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
def test_banded_lockstep_sensitivities_on_the_card_match_cpu():
    """heat1d n=33, B=8 diffusivities, BdfSolver(sens=True) lockstep on the
    banded tier: K3/K4 on the card (the sensitivity rows through K4 with
    rows per factorization) against the plain versions on the CPU."""
    from diffsol_tpu_torch.models import heat1d
    from diffsol_tpu_torch.ops import band_lu

    problem, _ = heat1d.make(32, rtol=1e-6, atol=1e-8, banded=True)
    params = np.linspace(0.5, 2.0, 8)[:, None]
    s0 = band_lu.launch_band_lu_solve.launches
    got, ref = _card_vs_cpu(lambda dev: dtt.solve_dense_ensemble(
        lambda pr: dtt.BdfSolver(pr, sens=True), problem, [0.01, 0.05, 0.2], params,
        mode="lockstep", device=dev))
    assert band_lu.launch_band_lu_solve.launches > s0
    assert got.sens.shape == (3, 1, 8, 33)
    torch.testing.assert_close(got.sens.cpu(), ref.sens, rtol=EAGER_RTOL,
                               atol=1e-14 + EAGER_RTOL * float(ref.sens.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("nbatch", [None, 4])
def test_fwd_sens_through_the_band_kernels_raises_cuda(nbatch):
    """Forward mode through the band LU kernels: solve_dense_fwd_sens of a
    banded heat1d problem (n = 16; one instance and a lockstep ensemble of
    4 diffusivities) runs K3 and K4 on the card, the tangent solves as K4
    launches, where it once raised; it matches the CPU (the plain versions
    under the same forward-mode rule) within 1e-10 relative.  The raw
    launch wrappers still refuse a transformed tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import heat1d
    from diffsol_tpu_torch.ops import band_lu

    problem, _ = heat1d.make(15, rtol=1e-6, atol=1e-8, banded=True)
    t_eval = [0.01, 0.05]
    params = None if nbatch is None else np.linspace(0.5, 2.0, nbatch)[:, None]
    if nbatch is not None:
        problem = dtt.make_lockstep_problem(problem, nbatch)

    def run(dev):
        return dtt.solve_dense_fwd_sens(dtt.BdfSolver(problem), t_eval, params=params,
                                        device=dev)

    f0, s0 = band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches
    ys, sens = run("cuda")
    torch.cuda.synchronize()
    assert band_lu.launch_band_lu_factor.launches > f0
    assert band_lu.launch_band_lu_solve.launches > s0
    ys_c, sens_c = run("cpu")
    assert sens.is_cuda and sens.shape == sens_c.shape
    torch.testing.assert_close(ys.cpu(), ys_c, rtol=1e-10, atol=1e-14)
    torch.testing.assert_close(sens.cpu(), sens_c, rtol=1e-10,
                               atol=1e-10 * float(sens_c.abs().max()))
    band = _heat1d_iteration_band(2, 16)
    F = band_lu.band_lu_factor(band, 1, 1).lu
    with pytest.raises(RuntimeError, match=r"BdfSolver\(problem, sens=True\)"):
        torch.func.jvp(lambda x: band_lu.launch_band_lu_solve(F, x, 1, 1),
                       (band[:, 1],), (band[:, 1],))


# the float build of K3/K4 against its float plain version: one algorithm
# in float32, parting by FMA contraction and the back sweep's order, about
# one float32 rounding (6e-8) a column step; A x = b within F32_RESIDUAL of
# max |b| (measured on the H100, see PERF.md)
F32_LU_RTOL = 1e-5
F32_RESIDUAL = 1e-4
# a float32 solve on the card against the CPU's: 5 % of Robertson's ~190
F32_STEP_SLACK = 10


@pytest.mark.cuda
@pytest.mark.parametrize("case,ml,mu,n,nbatch,nrhs,plan", [
    pytest.param("heat1d", 1, 1, 128, 1024, 1024, None, id="heat1d"),
    pytest.param("random", 3, 2, 128, 1024, 1024, None, id="random_ml3_mu2"),
    pytest.param("random", 20, 20, 400, 1000, 1000, None, id="nb41_B1000"),
    pytest.param("random", 20, 20, 400, 1, 256, None, id="nb41_one_factorization_256_rhs"),
    pytest.param("random", 20, 20, 12, 5, 5, None, id="nb41_n12"),
    # the float window takes half the bytes: on chip to ml = mu = 71 (the
    # double one to 45), x on chip to n ~ 14,200 at heat1d's width
    pytest.param("random", 60, 60, 300, 5, 5, ("factor", True), id="window_on_chip_ml60"),
    pytest.param("random", 80, 80, 300, 3, 3, ("factor", False),
                 id="window_in_device_memory_ml80"),
    pytest.param("random", 1, 1, 10_000, 5, 5, ("solve", True), id="x_on_chip_n10k"),
    pytest.param("random", 1, 1, 30_000, 5, 5, ("solve", False), id="x_in_device_memory_n30k"),
])
def test_band_lu_f32_kernels_match_plain_version_cuda(case, ml, mu, n, nbatch, nrhs, plan):
    """K3 and K4's float builds against their float32 plain versions at
    the shapes of the double tests (heat1d, nb = 41, both memory paths),
    each launch counted as a float launch; mixed dtypes are refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch._build import load_band_lu
    from diffsol_tpu_torch.ops import band_lu

    if case == "heat1d":
        band = _heat1d_iteration_band(nbatch, n).float()
    else:
        band = _random_dominant_band(nbatch, n, ml, mu).float()
    b = torch.tensor(np.random.default_rng(1).standard_normal((nrhs, n)), device="cuda").float()
    if plan is not None:
        # the device-memory plans keep only a chunk's reciprocals (factor)
        # or its buffers (solve) on chip
        which, on_chip = plan
        solve = which == "solve"
        per_member = 5 * 64 + n if solve else (mu + 32) * (ml + mu + 1) + 16
        got = load_band_lu().band_lu_shared_bytes(n, ml, mu, int(solve), 4)
        assert (got == 4 * 4 * (per_member | 1)) == on_chip, got
    f0, s0 = band_lu.launch_band_lu_factor.launches_f32, band_lu.launch_band_lu_solve.launches_f32
    fac = band_lu.band_lu_factor(band, ml, mu)
    x = band_lu.band_lu_solve(fac, b, ml, mu)
    F = fac.lu
    torch.cuda.synchronize()
    assert F.dtype == x.dtype == torch.float32
    assert band_lu.launch_band_lu_factor.launches_f32 == f0 + 1
    assert band_lu.launch_band_lu_solve.launches_f32 == s0 + 1
    F_p = band_lu.band_lu_factor_reference(band, ml, mu)
    x_p = band_lu.band_lu_solve_reference(F_p.expand(-1, -1, nrhs) if nbatch == 1 else F_p,
                                          b, ml, mu)
    assert F_p.dtype == x_p.dtype == torch.float32
    torch.testing.assert_close(F, F_p, rtol=F32_LU_RTOL,
                               atol=F32_LU_RTOL * float(F_p.abs().max()))
    torch.testing.assert_close(x, x_p, rtol=F32_LU_RTOL,
                               atol=F32_LU_RTOL * float(x_p.abs().max()))
    ax = _band_matvec(band.expand(nrhs, -1, -1) if nbatch == 1 else band, x, ml, mu)
    torch.testing.assert_close(ax, b, rtol=F32_RESIDUAL, atol=F32_RESIDUAL * float(b.abs().max()))
    with pytest.raises(TypeError, match="one dtype"):
        band_lu.band_lu_solve(fac, b.double(), ml, mu)
    with pytest.raises(TypeError, match="one dtype"):
        band_lu.launch_band_lu_solve(F.double(), b, ml, mu)


@pytest.mark.cuda
def test_banded_lockstep_adjoint_on_the_card_matches_cpu():
    """heat1d n=33, B=8 diffusivities, the gradient of sum ys^2 through
    make_differentiable_solve_ensemble on the banded tier: K3/K4 launch in
    the forward pass and never in the dense-table backward pass; the
    gradient as the CPU's (the band LU's plain version) within 1e-8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import heat1d
    from diffsol_tpu_torch.ops import band_lu

    problem, _ = heat1d.make(32, rtol=1e-6, atol=1e-8, banded=True)
    params = np.linspace(0.5, 2.0, 8)[:, None]
    t_eval = [0.01, 0.05, 0.2]

    def grad(dev):
        fn = dtt.make_differentiable_solve_ensemble(problem, t_eval, 8, device=dev)
        p = torch.tensor(params, device=dev).requires_grad_(True)
        ys = fn(p)
        torch.cuda.synchronize()
        mid = (band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches)
        (g,) = torch.autograd.grad((ys**2).sum(), p)
        torch.cuda.synchronize()
        return g, fn.info, mid

    k0 = (band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches)
    g, info, mid = grad("cuda")
    end = (band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches)
    assert g.is_cuda and g.shape == (8, 1)
    assert mid[0] > k0[0] and mid[1] > k0[1]  # the forward pass
    assert end == mid  # the backward pass: the dense adjoint only
    g_cpu, info_cpu, _ = grad("cpu")
    assert abs(info["forward"].steps - info_cpu["forward"].steps) <= STEP_SLACK
    torch.testing.assert_close(g.cpu(), g_cpu, rtol=EAGER_RTOL, atol=0.0)


@pytest.mark.cuda
def test_adjoint_entry_points_run_on_the_card_by_default():
    """Without ``device`` the differentiable solve runs on the card and
    wants its params there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import exponential_decay

    problem = exponential_decay.problem(rtol=1e-8, atol=1e-10)
    ys_of = dtt.make_differentiable_solve(problem, [0.5, 1.0])
    with pytest.raises(ValueError, match="lie on cpu"):
        ys_of(problem.params)
    p = problem.params.cuda().requires_grad_(True)
    ys = ys_of(p)
    (g,) = torch.autograd.grad(ys.sum(), p)
    assert ys.is_cuda and g.is_cuda
    t = np.array([0.5, 1.0])
    np.testing.assert_allclose(g.cpu().numpy(), [np.sum(-2.0 * t * np.exp(-0.1 * t)),
                                                 np.sum(2.0 * np.exp(-0.1 * t))], rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["dense", "banded", "blockdiag"])
def test_f32_lockstep_on_the_card_matches_cpu(tier):
    """Float32 lockstep ensembles on the card against the same solve on the
    CPU: Robertson (dense tier, B = 64), heat1d n = 33 (banded tier, the
    float K3/K4, B = 8) and robertson_ode 4 groups (block tier, B = 4).
    Both float32 and one algorithm, but the card's LU rounds otherwise
    than LAPACK and float32 roundoff steers the step sequence (Robertson to
    4e5: 4 steps apart of ~190 on the H100), so steps within F32_STEP_SLACK
    and ys within tests/test_ensemble.py's float32 bound, 2e-4 absolute."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import heat1d
    from diffsol_tpu_torch.ops import band_lu

    f32 = torch.float32
    if tier == "dense":
        problem, params, t_eval = trob.problem_ode(rtol=1e-4, atol=1e-6, dtype=f32), \
            _params(64), [0.4, 40.0, 4e5]
    elif tier == "banded":
        problem = heat1d.make(32, rtol=1e-4, atol=1e-6, banded=True, dtype=f32)[0]
        params, t_eval = np.linspace(0.5, 2.0, 8)[:, None], [0.01, 0.05, 0.2]
    else:
        problem, params, t_eval = trob.problem_ode_groups(4, dtype=f32), _params(4), [0.4, 40.0]
    f0 = band_lu.launch_band_lu_factor.launches_f32

    def run(dev):
        return dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval, params,
                                        mode="lockstep", max_steps=5000, device=dev)

    got, ref = run("cuda"), run("cpu")
    torch.cuda.synchronize()
    assert got.ys.dtype == ref.ys.dtype == f32 and got.ys.is_cuda
    assert got.stop_reason == ref.stop_reason == dtt.errors.TSTOP_REACHED
    assert abs(got.state.stats.steps - ref.state.stats.steps) <= F32_STEP_SLACK
    assert (band_lu.launch_band_lu_factor.launches_f32 > f0) == (tier == "banded")
    torch.testing.assert_close(got.ys.cpu(), ref.ys, rtol=0.0, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_fused_kernels_on_a_float32_problem_cuda(kernel):
    """A float32 problem on the fused tiers: the float64 kernels, params
    cast up, float64 out, with the callables' casts to float32 kept as
    roundings in the generated model (dsol_f32), so kernel and plain
    version compute the same thing: Robertson to 4e5 (K1, 300 members in
    three tiles) and heat1d n = 33 (K2, 64 diffusivities).  Float32 gates,
    as test_f32_lockstep_on_the_card_matches_cpu's: where the two sides'
    float64 rhs straddle a float32 rounding boundary they round one
    float32 ulp apart, which carries through the steps (on the H100: 2.8e-7
    relative for K1, 1.8e-8 for K2, equal steps here; at B = 10,000 one
    tile of 79 one step apart, chip_smoke.py phase 23 g), so steps within
    STEP_SLACK a tile and ys within the float32 bound 2e-4.  Then
    solve_dense_ensemble(mode="fused") on the card launches the kernel
    and equals the call above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.models import heat1d
    from diffsol_tpu_torch.ops import fused_band_stepper as fb

    f32 = torch.float32
    if kernel == "K1":
        problem, t_eval = trob.problem_ode(rtol=1e-4, atol=1e-6, dtype=f32), [0.4, 40.0, 4e5]
        params = _params(300)
        solve = fs.make_fused_bdf_solve(problem, t_eval, 300, tile=128)
        counter = fs.launch_fused_bdf
    else:
        problem = heat1d.make(32, rtol=1e-4, atol=1e-6, banded=True, dtype=f32)[0]
        t_eval, params = [0.01, 0.05, 0.2], np.linspace(0.5, 2.0, 64)[:, None]
        solve = fb.make_fused_band_bdf_solve(problem, t_eval, 64)
        counter = fb.launch_fused_band_bdf
    assert solve.model.rhs is not None and "f32" in {node[0] for node in solve.model.rhs.nodes}
    # the entry point casts the problem's float32 params up
    p64 = torch.tensor(params, dtype=f32, device="cuda").double()
    before = counter.launches
    ys, status, steps = solve(p64)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ys_p, status_p, steps_p = solve.reference(p64)
    assert status.tolist() == status_p.tolist() == [fs.OK] * solve.ntiles
    assert int((steps - steps_p).abs().max()) <= STEP_SLACK
    torch.testing.assert_close(ys, ys_p, rtol=0.0, atol=2e-4)
    before = counter.launches
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval,
                                   torch.tensor(params, dtype=f32, device="cuda"), mode="fused",
                                   tile=128 if kernel == "K1" else None)
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and sol.ys.dtype == torch.float64
    assert torch.equal(sol.tile_steps, steps)
    assert torch.equal(sol.ys, ys.movedim(-1, 1))


@pytest.mark.cuda
def test_sde_solvers_on_the_card():
    """The SDE solvers with a generator on the card: an Ornstein-Uhlenbeck
    ensemble of 16,384 paths meets sigma^2/2theta within 10 % and mean 0
    within 0.02 (tests/test_sde.py's gates); Milstein beats EM on geometric
    Brownian motion (4,096 paths, 400 steps, the exact solution from the
    same increments) and stays within 0.01; on the increments the card's
    generator drew, the card's steps match the CPU's within 1e-12; a CPU
    generator for a card solve is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsol_tpu_torch.solvers import sde

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    theta, sigma = 1.5, 0.4
    ou = sde.solve_em_ensemble(lambda t, y, p: -p[0] * y, lambda t, y, p: torch.ones_like(y) * p[1],
                               torch.zeros(1, dtype=torch.float64), 0.0, 8.0, 2000,
                               [theta, sigma], gen(0), 16_384)
    assert ou.ys.is_cuda and ou.ys.shape == (16_384, 2001, 1)
    tail = ou.ys[:, -500:, 0]
    want = sigma**2 / (2 * theta)
    assert abs(float(tail.var()) - want) < 0.1 * want and abs(float(tail.mean())) < 0.02
    mu, sg, nsteps = 0.05, 0.5, 400
    y0 = torch.ones((4096, 1), dtype=torch.float64, device="cuda")
    dws = torch.randn((nsteps, 4096, 1), generator=gen(1), dtype=torch.float64,
                      device="cuda") * np.sqrt(1.0 / nsteps)
    exact = torch.exp((mu - 0.5 * sg**2) + sg * dws.sum(0))
    rhs, diff = (lambda t, y, p: p[0] * y), (lambda t, y, p: p[1] * y)
    em = sde.solve_em(rhs, diff, y0, 0.0, 1.0, nsteps, [mu, sg], gen(1))
    mil = sde.solve_milstein(rhs, diff, y0, 0.0, 1.0, nsteps, [mu, sg], gen(1))
    err_em = float((em.ys[-1] - exact).abs().mean())
    err_mil = float((mil.ys[-1] - exact).abs().mean())
    assert err_mil < err_em and err_mil < 0.01
    h = torch.tensor(1.0 / nsteps, dtype=torch.float64)
    ts = mil.ts.cpu()
    cpu = sde._milstein_steps(rhs, diff, y0.cpu(), ts, dws.cpu(),
                              torch.tensor([mu, sg], dtype=torch.float64), h)
    torch.testing.assert_close(mil.ys.cpu(), cpu, rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="generator"):
        sde.solve_em(rhs, diff, y0, 0.0, 1.0, 10, [mu, sg], torch.Generator())
