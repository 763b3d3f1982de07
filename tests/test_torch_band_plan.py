"""The fused band kernel's launch plan and scratch layout
(ops/fused_band_stepper.py band_plan, scratch_doubles), checked against
the card's limits and against the kernel source (csrc/fused_band_bdf.cuh,
csrc/band_lu.cuh) at the three models' shapes and at the plan's edges.
(The kernel's own report of the plan, and the kernel against its plain
version at these shapes, are tests/test_torch_cuda.py.)
"""

import re
from pathlib import Path

import pytest
import torch

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.models import heat1d
from diffsol_tpu_torch.ops import fused_band_stepper as fb
from diffsol_tpu_torch.ops.banded import make_banded_solver
from diffsol_tpu_torch.ops.eqn_codegen import UnsupportedForKernel

torch.set_num_threads(1)

CSRC = Path(fb.__file__).resolve().parent.parent / "csrc"
# the H100's limits: shared memory a block (sm_90), threads a block,
# blocks a cluster (non-portable size), SMs
SMEM_BLOCK, THREADS_BLOCK, CLUSTER_MAX, SMS = 232448, 1024, 16, 132


def _check_limits(p, tile):
    assert 1 <= p.cluster <= CLUSTER_MAX and 1 <= p.members <= fb.MAX_MEMBERS
    assert p.threads == 32 * p.members <= 512 <= THREADS_BLOCK
    assert p.slots >= tile and p.slots - tile < p.cluster  # at most one short a block
    assert p.shared_bytes + 1024 <= SMEM_BLOCK
    assert p.grid == p.ntiles * p.cluster


@pytest.mark.parametrize("name,n,ml,mu,want", [
    # (members, cluster, fchunk, schunk, stride): tile 128 is 16 blocks of
    # 8 members, B = 1,024 (8 tiles) a grid of 128 blocks
    ("heat1d", 128, 1, 1, (8, 16, 32, 64, 448)),
    ("heat2d", 400, 20, 20, (8, 16, 8, 24, 1484)),
    ("foodweb", 200, 20, 20, (8, 16, 8, 24, 1484)),
])
def test_plan_at_the_models_shapes(name, n, ml, mu, want):
    p = fb.band_plan(n, ml, mu, 128, 8)
    assert (p.members, p.cluster, p.fchunk, p.schunk, p.stride) == want
    assert (p.threads, p.grid) == (256, 128)
    assert 128 < SMS
    _check_limits(p, 128)
    # two blocks fit an SM's shared memory, so the card can place a
    # 16-block cluster on 8 SMs
    assert 2 * (p.shared_bytes + 1024) <= SMEM_BLOCK
    assert p.stride == fb.member_doubles(n, ml, mu, p.fchunk, p.schunk)


@pytest.mark.parametrize("tile,members,cluster", [
    (1, 1, 1),          # tile 1: one warp, one block a tile
    (4, 4, 1),          # a tile smaller than one block of 8
    (9, 5, 2),          # not a multiple of the cluster: 10 slots, one replica
    (80, 8, 10),        # tile 80: 10 blocks of 8
    (100, 8, 13),       # 104 slots: four replicas of the last member
    (128, 8, 16),
    (200, 13, 16),
    (256, 16, 16),      # the largest tile: 16 blocks of 16 members
])
def test_plan_edges_of_the_tile(tile, members, cluster):
    for n, ml, mu in ((128, 1, 1), (400, 20, 20), (200, 20, 20)):
        p = fb.band_plan(n, ml, mu, tile, 3)
        assert (p.members, p.cluster) == (members, cluster)
        _check_limits(p, tile)
        assert p.fchunk >= 1 and p.schunk >= 1


def test_every_tile_fits_the_card():
    for n, ml, mu in ((128, 1, 1), (400, 20, 20), (200, 20, 20), (17, 2, 2), (64, 8, 8)):
        for tile in range(1, fb.MAX_TILE + 1):
            _check_limits(fb.band_plan(n, ml, mu, tile, 1), tile)
    with pytest.raises(ValueError):
        fb.band_plan(128, 1, 1, fb.MAX_TILE + 1)


def test_band_too_wide_for_the_window_and_state_too_long():
    # ml = mu = 42 at tile 128: even a one-column window, 44 x 85 doubles
    # a member, passes the shared memory of 8 members, so the factor runs
    # in device memory (fchunk 0); ml = mu = 41 still fits on chip
    p = fb.band_plan(400, 42, 42, 128, 8)
    assert p.fchunk == 0 and p.schunk >= 1
    _check_limits(p, 128)
    assert fb.band_plan(400, 41, 41, 128, 8).fchunk >= 1
    # a narrow band at a small tile keeps the window on chip
    assert fb.band_plan(400, 42, 42, 4, 8).fchunk >= 1
    # the rhs's 2n doubles must stay on chip: n = 1,808 fits 8 members a
    # block, n = 1,809 does not
    _check_limits(fb.band_plan(1808, 1, 1, 128, 8), 128)
    with pytest.raises(UnsupportedForKernel, match="shared memory"):
        fb.band_plan(1809, 1, 1, 128, 8)


def test_make_refuses_what_the_kernel_cannot_hold():
    """The solve's plan rides on it; a problem too long for the kernel is
    out of the tier's scope (so mode="auto" goes lockstep) before its rhs
    is traced."""
    problem, _ = heat1d.make(127, banded=True)
    solve = fb.make_fused_band_bdf_solve(problem, [0.1], 1000)
    assert solve.plan == fb.band_plan(128, 1, 1, 128, 8)
    assert solve.cfg.pad_b == 1024 and solve.ntiles == 8  # B not a multiple of the tile
    long_problem, _ = heat1d.make(2999, banded=True)
    with pytest.raises(UnsupportedForKernel):
        fb.make_fused_band_bdf_solve(long_problem, [0.1], 1024)


def _kernel_constants():
    src = (CSRC / "fused_band_bdf.cuh").read_text()
    return src, {name: int(v) for name, v in
                 re.findall(r"constexpr (?:int|size_t) (\w+) = (\d+);", src)}


def test_plan_constants_mirror_the_kernel():
    src, consts = _kernel_constants()
    assert consts["MAX_TILE"] == fb.MAX_TILE
    assert consts["MAX_MEMBERS"] == fb.MAX_MEMBERS
    assert consts["MAX_CLUSTER"] == fb.MAX_CLUSTER
    assert "constexpr size_t SMEM_DYNAMIC = 232448 - 1024;" in src
    assert fb.SMEM_DYNAMIC == 232448 - 1024
    assert "__launch_bounds__(MAX_MEMBERS * WARP)" in src
    # the shared doubles a member: the kernel's member_doubles over
    # band_lu.cuh's factor_doubles and solve_doubles
    lu = (CSRC / "band_lu.cuh").read_text()
    assert "return (MU + 2 * C) * (ML + MU + 1) + C;" in lu
    assert "return N + C + 2 * C * (ML > MU + 1 ? ML : MU + 1);" in lu
    assert "fchunk > 0 ? diffsol_band::factor_doubles<ML, MU>(fchunk) : 0" in src
    assert "return fs > 2 * N ? fs : 2 * N;" in src


@pytest.mark.parametrize("n,ml,mu", [(128, 1, 1), (400, 20, 20), (200, 20, 20), (17, 2, 0)])
def test_scratch_layout_mirrors_the_kernel(n, ml, mu):
    """scratch_doubles is the kernel's PER: D, the J band, the factors and
    three state vectors a member slot, member-major; the wrapper allocates
    one slot for every slot of every tile's cluster."""
    src, _ = _kernel_constants()
    body = src[src.index("constexpr int OFF_J"):src.index("extern __shared__")]
    env = {"ND": 8, "N": n, "NB": ml + mu + 1, "MU": mu}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", body):
        env[name] = eval(expr, {}, env)
    cfg = fb.BandConfig(
        n=n, nparams=1, t0=0.0, rtol=1e-5, atol=(1e-5,) * n, t_eval=(0.1,), nbatch=1000,
        tile=128, ntiles=8, max_steps=10, max_newton_iter=10, max_newton_fails=50,
        max_error_test_fails=40, min_timestep=1e-32, nl_tol=0.2, ki=0.5, kp=0.0,
        update_jacobian_after_steps=20, update_rhs_jacobian_after_steps=50,
        threshold_to_update_jacobian=0.3, jac_reuse=True, ml=ml, mu=mu)
    assert fb.scratch_doubles(cfg) == env["PER"]
    assert env["OFF_J"] == 8 * n and env["OFF_F"] == env["OFF_J"] + n * (ml + mu + 1)
    # the C config carries the plan
    c = fb._c_config(cfg)
    p = fb.band_plan(n, ml, mu, 128, 8)
    assert (c.members, c.cluster, c.fchunk, c.schunk, c.stride) == (
        p.members, p.cluster, p.fchunk, p.schunk, p.stride)


def test_wide_band_problem_takes_the_device_memory_factor():
    """A tridiagonal heat1d routed through a band of ml = mu = 42 (85
    diagonals, the extra ones zero) at the default tile 128: the plan
    factors in device memory (the card's test holds that path to its plain
    version); the same problem at ml = mu = 1 keeps the window on chip."""
    problem, _ = heat1d.make(99, rtol=1e-6, atol=1e-8, banded=True)
    wide = (dtt.OdeBuilder().rhs(problem.eqn.rhs).init(problem.eqn.init).p([1.0])
            .rtol(1e-6).atol(1e-8).linear_solver(make_banded_solver(42, 42)).build())
    solve = fb.make_fused_band_bdf_solve(wide, [0.01, 0.05], 256)
    assert solve.tile == 128 and solve.plan.fchunk == 0
    assert solve.plan.shared_bytes + 1024 <= SMEM_BLOCK
    assert fb.make_fused_band_bdf_solve(problem, [0.01, 0.05], 256).plan.fchunk == 32
