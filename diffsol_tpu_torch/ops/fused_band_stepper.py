"""Fused whole-solve BDF tier for banded medium-n ensembles (counterpart
of ``diffsol_tpu/ops/pallas_stepper_band.py::make_pallas_band_bdf_solve``).

The method-of-lines class (heat1d at n ~ 128) is too wide for the small-n
kernel, which keeps a member's dense J and LU in registers.  This tier
runs the same adaptive NDF machinery as :mod:`.fused_stepper` (tiled
lockstep, stale-Jacobian Newton, error test, PI controller, R.U rescale,
order selection, dense output) with three changes from the JAX kernel:

* the Jacobian is the (n, nb) band from ml+mu+1 cyclically colored dual
  probes of the rhs (``jac_band``, pallas_stepper_band.py:349);
* Newton's matrix M - cJ is factored by the no-pivot band LU of
  :mod:`.band_lu`, guarded by the tile-wide element growth
  max|LU update| / max|A|: beyond 1e4 the tile fails with
  ``FAIL_LU_GROWTH`` (:391-456, :637-639);
* the initial state, y0 and ``h y0'`` with a per-member step size whose
  minimum over the tile starts the tile, is computed in float64 outside
  the kernel (:956-1010), so ``init`` needs no tracing.

Two implementations of the same algorithm with the same tile partition:

* the CUDA kernel ``csrc/fused_band_bdf.cuh`` (a warp per member, a
  thread block cluster per tile, every tile in one launch, laid out by
  :func:`band_plan`), built with ``nvcc`` for ``sm_90a`` at first use from
  the repository's sources plus the rhs header that :mod:`.eqn_codegen`
  generates, launched by :func:`launch_fused_band_bdf` for CUDA tensors;
* the plain PyTorch version :func:`fused_band_bdf_reference`, the shared
  loop :func:`.fused_stepper.tiled_bdf` with the band pieces, for CPU
  tensors and as the kernel's yardstick on the card.

A CUDA tensor always goes to the kernel: nothing falls back to the plain
version or to the CPU.  Everything is float64.  Scope: identity or
constant-diagonal mass (initial conditions that the algebraic rows do not
satisfy, the foodweb class, go through the consistent-IC solve of
:mod:`..solvers.consistent_ic` on the host side before the launch), no
roots, resets or quadrature (an ``out`` function that is not integrated is
ignored, as the JAX kernel ignores it), and a banded-routed problem.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..solvers.bdf import MAX_ORDER, ND, _ALPHA, _ERROR_CONST2, _GAMMA
from .band_lu import factor_columns, npadx, solve_columns
from .banded import make_banded_jac
from .eqn_codegen import UnsupportedForKernel, emit_cuda_header, trace_model
from .fused_stepper import (
    DEAD_HI,
    DEAD_LO,
    ETA_FLOOR,
    ETA_RESET_JACOBIAN,
    ETA_RESET_TIMESTEP,
    MAX_ERROR_TEST_FAILS,
    MAX_GROWTH,
    MAX_NEWTON_FAILS,
    MAX_NEWTON_ITER,
    MIN_SHRINK,
    MIN_TIMESTEP,
    FusedConfig,
    _U64,
    _bcast,
    _finish,
    _pad_params,
    tiled_bdf,
)

F64 = torch.float64

# the largest tile: one thread block cluster of the kernel, at most 16
# blocks of 16 warps, a warp per member
MAX_TILE = 256
# element growth beyond this fails the tile (pallas_stepper_band.py:639)
MAX_LU_GROWTH = 1e4
# the JAX kernel's VMEM budget for its tile sizing rule (:201-222)
_VMEM_BUDGET = 10 * 2**20


WARP = 32
MAX_MEMBERS = 16  # warps (members) a block: the kernel's __launch_bounds__(512)
MAX_CLUSTER = 16  # blocks a cluster: the H100's limit (8 is the portable one)
# dynamic shared memory a block may take: the sm_90 limit of 232,448 bytes
# less the kernel's reserve for its static part (csrc/fused_band_bdf.cuh
# SMEM_DYNAMIC)
SMEM_DYNAMIC = 232448 - 1024


@dataclass(frozen=True)
class BandConfig(FusedConfig):
    """Static numbers of one fused banded solve (host side)."""

    ml: int = 1
    mu: int = 1
    mass_diag: Optional[tuple] = None  # constant diagonal mass, None = identity
    # the algebraic rows do not hold at ``init``: solve for consistent
    # initial conditions before stepping
    needs_ic_solve: bool = False

    @property
    def nb(self) -> int:
        return self.ml + self.mu + 1


def default_tile(n: int, nb: int, mu: int, npad: int, neval: int) -> int:
    """The JAX kernel's tile rule (pallas_stepper_band.py:201-222): the
    members whose in-kernel state fits a 10 MiB budget, at least 128, in
    multiples of 128 (128 at heat1d's n = 128); capped at the kernel's
    block limit."""
    ncols = n + mu
    per_lane = (3 * ND * n + 3 * n * nb + 2 * ncols * nb + 2 * npad
                + neval * n + 24 * n) * 8
    tile = max(128, min(4096, _VMEM_BUDGET // max(per_lane, 1)))
    return min(max(128, (tile // 128) * 128), MAX_TILE)


@dataclass(frozen=True)
class BandPlan:
    """How the CUDA kernel lays out a solve (csrc/fused_band_bdf.cuh): a
    warp per member, ``members`` members a block, ``cluster`` blocks (one
    thread block cluster) a tile of ``slots = members * cluster >= tile``
    slots, the ones past the tile replicating its last member; per member
    ``stride`` doubles of shared memory, in turn the rhs's input and output
    (2n), the band factor's window of mu + 2 ``fchunk`` columns (and
    ``fchunk`` reciprocals; ``fchunk = 0``: a band too wide for it is
    factored in device memory), or the solve's x, ``schunk`` reciprocals
    and two chunks of ``schunk`` columns by max(ml, mu + 1) factor rows."""

    members: int
    cluster: int
    fchunk: int
    schunk: int
    stride: int
    ntiles: int

    @property
    def threads(self) -> int:
        return WARP * self.members

    @property
    def grid(self) -> int:
        return self.ntiles * self.cluster

    @property
    def slots(self) -> int:
        return self.members * self.cluster

    @property
    def shared_bytes(self) -> int:
        return 8 * self.members * self.stride


def member_doubles(n: int, ml: int, mu: int, fchunk: int, schunk: int) -> int:
    """Shared doubles a member takes at these chunk sizes (the kernel's
    ``member_doubles``; ``fchunk = 0``: the factor's window lies in device
    memory)."""
    nb = ml + mu + 1
    factor = (mu + 2 * fchunk) * nb + fchunk if fchunk > 0 else 0
    solve = n + schunk + 2 * schunk * max(ml, mu + 1)
    return max(2 * n, factor, solve)


@functools.lru_cache(maxsize=256)
def band_plan(n: int, ml: int, mu: int, tile: int, ntiles: int = 1) -> BandPlan:
    """The kernel's launch plan for a tile of ``tile`` members.

    A tile is one cluster of ``ceil(tile / 8)`` blocks, at most 16, each of
    ``ceil(tile / cluster)`` warps (tile 128: 16 blocks of 8 members, so
    B = 1,024 in 8 tiles spreads over 128 SMs).  The chunks start at the
    band LU kernels' (the factor's 16 columns at wide bands, 32 at narrow
    ones; the solve's ~8 KB of factor rows) and halve, the larger part
    first, until a block fits half the shared memory (two blocks an SM,
    which leaves the card room to place a 16-block cluster) with chunks of
    at least 8 columns, else all of it with chunks of at least one; a band
    whose window does not fit even then is factored in device memory.
    Raises :class:`UnsupportedForKernel` when the rhs's 2n doubles or the
    solve's x and one column of factor rows do not fit."""
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile {tile} outside 1 .. {MAX_TILE}")
    cluster = min(MAX_CLUSTER, -(-tile // 8))
    members = -(-tile // cluster)
    nb, rows = ml + mu + 1, max(ml, mu + 1)
    f0 = 32 if nb <= 8 else 16
    s0 = 64 if rows <= 16 else max(1, 1024 // rows)
    # half the shared memory if the chunks keep 8 columns, else all of it
    for budget, least in ((SMEM_DYNAMIC // 2, 8), (SMEM_DYNAMIC, 1)):
        fc, sc = f0, s0
        while 8 * members * member_doubles(n, ml, mu, fc, sc) > budget:
            factor = (mu + 2 * fc) * nb + fc
            solve = n + sc + 2 * sc * rows
            if factor >= solve and fc > least:
                fc //= 2
            elif sc > least:
                sc //= 2
            elif fc > least:
                fc //= 2
            else:
                break
        stride = member_doubles(n, ml, mu, fc, sc)
        if 8 * members * stride <= budget:
            return BandPlan(members, cluster, fc, sc, stride, ntiles)
    # a band too wide for the factor's window: factor in device memory
    sc = s0
    while sc > 1 and 8 * members * member_doubles(n, ml, mu, 0, sc) > SMEM_DYNAMIC:
        sc //= 2
    stride = member_doubles(n, ml, mu, 0, sc)
    if 8 * members * stride <= SMEM_DYNAMIC:
        return BandPlan(members, cluster, 0, sc, stride, ntiles)
    raise UnsupportedForKernel(
        f"the band kernel keeps 2n = {2 * n} doubles and the band solve's x "
        f"for each of {members} members a block on chip: more than "
        f"{SMEM_DYNAMIC} bytes of shared memory")


# ---------------------------------------------------------------------------
# the host-side initial state, shared by the kernel and its plain version
# ---------------------------------------------------------------------------

def initial_state(cfg: BandConfig, problem, P: torch.Tensor):
    """y0 (T, tile, n), D1 = h_tile y0' (T, tile, n) and h_tile (T,) in
    float64 for the padded params ``P`` (pallas_stepper_band.py:956-1010):
    each member's starting step by the reference's heuristic
    (solvers/state.py), the tile taking the smallest.  With
    ``cfg.needs_ic_solve`` the members first go, as one lockstep batch,
    through ``make_consistent`` under the problem's banded solver (the
    band LU kernels on the card); if it fails y0 is NaN, so the solve fails
    loudly."""
    T, tile, n = cfg.ntiles, cfg.tile, cfg.n
    dev = P.device
    rhs, init = problem.eqn.rhs, problem.eqn.init
    vmap = torch.func.vmap
    t0 = torch.tensor(cfg.t0, dtype=F64, device=dev)
    y0 = vmap(init, in_dims=(None, 0))(t0, P).contiguous()
    rhs_m = vmap(rhs, in_dims=(0, 0, 0))
    tm = t0.expand(P.shape[0])
    f0 = rhs_m(tm, y0, P)
    if cfg.mass_diag is not None:
        md = torch.tensor(cfg.mass_diag, dtype=F64, device=dev)
        dy0 = torch.where(md == 0.0, 0.0, f0 / torch.where(md == 0.0, 1.0, md))
        if cfg.needs_ic_solve:
            from ..ensemble import make_lockstep_problem
            from ..solvers.consistent_ic import make_consistent

            lp = make_lockstep_problem(problem.to(dev), P.shape[0])
            y0, dy0, ic_status = make_consistent(lp, P, y0, dy0, md == 0.0)
            if ic_status < 0:
                y0 = torch.full_like(y0, torch.nan)
            f0 = rhs_m(tm, y0, P)
    else:
        dy0 = f0
    atol = torch.tensor(cfg.atol, dtype=F64, device=dev)
    scale = y0.abs() * cfg.rtol + atol
    d0 = torch.sqrt(((y0 / scale) ** 2).mean(1))
    d1 = torch.sqrt(((dy0 / scale) ** 2).mean(1))
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * (d0 / d1))
    y1 = y0 + h0[:, None] * dy0
    f1 = rhs_m(tm + h0, y1, P)
    d2 = torch.sqrt((((f1 - f0) / scale) ** 2).mean(1)) / h0
    max_d = torch.maximum(d1, d2)
    h1 = torch.where(max_d < 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / max_d) ** 0.5)
    h_t = torch.minimum(100.0 * h0, h1).reshape(T, tile).amin(1)
    y0 = y0.reshape(T, tile, n)
    return y0, _bcast(h_t, y0) * dy0.reshape(T, tile, n), h_t


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def fused_band_bdf_reference(cfg: BandConfig, problem, params_b: torch.Tensor):
    """The plain PyTorch version of the fused band kernel: the same
    algorithm on the same tile partition, eager float64, on the device of
    ``params_b``.  Returns ``(ys (neval, n, B), info (ntiles, 4))`` with
    info = status, accepted steps, attempts, next eval index per tile."""
    dev = params_b.device
    rhs = problem.eqn.rhs
    T, tile, n, ml, mu, nb = cfg.ntiles, cfg.tile, cfg.n, cfg.ml, cfg.mu, cfg.nb
    Mb = T * tile
    P = _pad_params(cfg, params_b)
    atol = torch.tensor(cfg.atol, dtype=F64, device=dev)
    md = (None if cfg.mass_diag is None
          else torch.tensor(cfg.mass_diag, dtype=F64, device=dev))
    vmap = torch.func.vmap
    rhs_m = vmap(rhs, in_dims=(0, 0, 0))
    jac_m = vmap(make_banded_jac(rhs, ml, mu), in_dims=(0, 0, 0))

    def f(t_tile, y):  # per-tile t (T,), y (T, tile, n)
        tm = t_tile.repeat_interleave(tile)
        return rhs_m(tm, y.reshape(Mb, n), P).reshape(T, tile, n)

    def jac(t_tile, y):  # (T, tile, nb, n) band
        tm = t_tile.repeat_interleave(tile)
        return jac_m(tm, y.reshape(Mb, n), P).reshape(T, tile, nb, n)

    def factor(J, c, t_pred):
        # A = M - cJ on the band, column-leading (n+mu, nb, Mb)
        m_band = torch.zeros(nb, n, dtype=F64, device=dev)
        m_band[mu] = 1.0 if md is None else md
        A = m_band - _bcast(c, J) * J
        a0 = torch.clamp(A.abs().amax((1, 2, 3)), min=1e-30)
        F = torch.empty((n + mu, nb, Mb), dtype=F64, device=dev)
        F[:n] = A.reshape(Mb, nb, n).permute(2, 1, 0)
        upd = factor_columns(F, n, ml, mu, growth=True).reshape(T, tile).amax(1)
        # tiles leading, (T, n+mu, nb, tile), for the loop's per-tile select
        F = F.reshape(n + mu, nb, T, tile).permute(2, 0, 1, 3)
        return (F,), torch.maximum(a0, upd) / a0

    def lsolve(factors, b):
        F = factors[0].permute(1, 2, 0, 3).reshape(n + mu, nb, Mb)
        x = torch.empty((n + npadx(ml, mu), Mb), dtype=F64, device=dev)
        x[:n] = b.reshape(Mb, n).t()
        solve_columns(F, x, n, ml, mu)
        return x[:n].t().reshape(T, tile, n)

    def residual(x, t_pred, y_pred, psi, cval):
        tmp = (x - y_pred) + psi
        if md is not None:
            tmp = md * tmp
        return tmp - _bcast(cval, x) * f(t_pred, x)

    y0, D1, h = initial_state(cfg, problem, P)
    return tiled_bdf(cfg, atol, y0, D1, h, f, jac, factor, lsolve, residual,
                     max_lu_growth=MAX_LU_GROWTH)


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

_D, _I = ctypes.c_double, ctypes.c_int


class CBandConfig(ctypes.Structure):
    """The kernel's ``BandConfig`` (csrc/fused_band_bdf.cuh), field for
    field."""

    _fields_ = [
        ("t0", _D), ("rtol", _D), ("nl_tol", _D), ("ki", _D), ("kp", _D),
        ("min_timestep", _D), ("thresh_update_jac", _D), ("eta_floor", _D),
        ("max_lu_growth", _D),
        ("alpha", _D * (MAX_ORDER + 1)), ("gamma", _D * (MAX_ORDER + 1)),
        ("ec2", _D * (MAX_ORDER + 1)),
        ("U", (_D * ND) * ND),
        ("min_shrink", _D), ("max_growth", _D), ("dead_lo", _D), ("dead_hi", _D),
        ("eta_reset_jac", _D), ("eta_reset_step", _D),
        ("max_steps", _I), ("max_newton_iter", _I), ("max_newton_fails", _I),
        ("max_err_fails", _I),
        ("update_jac_after", _I), ("update_rhs_jac_after", _I),
        ("neval", _I), ("nbatch", _I), ("tile", _I), ("ntiles", _I),
        ("members", _I), ("cluster", _I), ("fchunk", _I), ("schunk", _I),
        ("stride", _I),
    ]


@functools.lru_cache(maxsize=64)
def _c_config(cfg: BandConfig) -> CBandConfig:
    plan = band_plan(cfg.n, cfg.ml, cfg.mu, cfg.tile, cfg.ntiles)
    return CBandConfig(
        t0=cfg.t0, rtol=cfg.rtol, nl_tol=cfg.nl_tol, ki=cfg.ki, kp=cfg.kp,
        min_timestep=cfg.min_timestep,
        thresh_update_jac=cfg.threshold_to_update_jacobian, eta_floor=ETA_FLOOR,
        max_lu_growth=MAX_LU_GROWTH,
        alpha=(_D * (MAX_ORDER + 1))(*map(float, _ALPHA)),
        gamma=(_D * (MAX_ORDER + 1))(*map(float, _GAMMA)),
        ec2=(_D * (MAX_ORDER + 1))(*map(float, _ERROR_CONST2)),
        U=((_D * ND) * ND)(*((_D * ND)(*map(float, row)) for row in _U64)),
        min_shrink=MIN_SHRINK, max_growth=MAX_GROWTH, dead_lo=DEAD_LO,
        dead_hi=DEAD_HI, eta_reset_jac=ETA_RESET_JACOBIAN,
        eta_reset_step=ETA_RESET_TIMESTEP,
        max_steps=cfg.max_steps, max_newton_iter=cfg.max_newton_iter,
        max_newton_fails=cfg.max_newton_fails,
        max_err_fails=cfg.max_error_test_fails,
        update_jac_after=cfg.update_jacobian_after_steps,
        update_rhs_jac_after=cfg.update_rhs_jacobian_after_steps,
        neval=cfg.neval, nbatch=cfg.nbatch, tile=cfg.tile, ntiles=cfg.ntiles,
        members=plan.members, cluster=plan.cluster, fchunk=plan.fchunk,
        schunk=plan.schunk, stride=plan.stride,
    )


def scratch_doubles(cfg: BandConfig) -> int:
    """Doubles of device-memory scratch a member slot of the kernel
    takes, contiguous and in this order: D (ND, n), the J band (n, nb),
    the factored band (n + mu, nb) and three state vectors (y_pred, psi,
    the Newton iterate).  The rhs's output and the Newton correction live
    in shared memory."""
    n = cfg.n
    return ND * n + n * cfg.nb + (n + cfg.mu) * cfg.nb + 3 * n


def launch_fused_band_bdf(cfg: BandConfig, rhs_header: str, params_b: torch.Tensor,
                          init: torch.Tensor, h_tile: torch.Tensor,
                          consts: dict):
    """Launch the fused band kernel on ``torch.cuda.current_stream()``,
    every tile in one launch (a cluster of blocks per tile, as
    :func:`band_plan` lays it out).

    ``params_b`` is a contiguous (nbatch, nparams) float64 CUDA tensor;
    ``init`` the (ntiles*tile, 2n) rows [y0, h_tile y0'] of each padded
    member; ``h_tile`` (ntiles,); ``consts`` the t_eval, atol and mass
    diagonal tensors on the same device.  Returns ``(ys (neval, n, B),
    info (ntiles, 4))``.  Builds the kernel at first use; raises on a
    build error and on a refused launch (plan, shared memory, cluster)."""
    from .._build import load_fused_band_bdf

    if not params_b.is_cuda:
        raise ValueError("launch_fused_band_bdf needs a CUDA tensor")
    if params_b.dtype != F64:
        raise TypeError(f"params must be float64, got {params_b.dtype}")
    if tuple(params_b.shape) != (cfg.nbatch, cfg.nparams) or not params_b.is_contiguous():
        raise ValueError(
            f"params must be contiguous {(cfg.nbatch, cfg.nparams)}, got "
            f"{tuple(params_b.shape)}")
    dev = params_b.device
    for name, arr, shape in (("init", init, (cfg.pad_b, 2 * cfg.n)),
                             ("h_tile", h_tile, (cfg.ntiles,))):
        if (arr.device != dev or arr.dtype != F64 or tuple(arr.shape) != shape
                or not arr.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {shape} float64 on "
                             "the params' device")
    lib = load_fused_band_bdf(rhs_header, cfg.ml, cfg.mu)
    if lib.fused_band_bdf_config_size() != ctypes.sizeof(CBandConfig):
        raise RuntimeError("CBandConfig does not match the kernel's BandConfig layout")
    plan = band_plan(cfg.n, cfg.ml, cfg.mu, cfg.tile, cfg.ntiles)
    md = consts["mass_diag"]
    with torch.cuda.device(dev):
        ys = torch.empty(cfg.neval, cfg.n, cfg.nbatch, dtype=F64, device=dev)
        info = torch.empty(cfg.ntiles, 4, dtype=torch.int32, device=dev)
        scratch = torch.empty(cfg.ntiles * plan.slots * scratch_doubles(cfg),
                              dtype=F64, device=dev)
        ccfg = _c_config(cfg)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_band_bdf_launch(
            params_b.data_ptr(), init.data_ptr(), h_tile.data_ptr(),
            consts["t_eval"].data_ptr(), consts["atol"].data_ptr(),
            None if md is None else md.data_ptr(),
            ys.data_ptr(), info.data_ptr(), scratch.data_ptr(),
            ctypes.addressof(ccfg), stream,
        )
        launch_fused_band_bdf.launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_band_bdf kernel launch failed: CUDA error {rc}")
    return ys, info


launch_fused_band_bdf.launches = 0


def _mass_diag(problem, eqn):
    """``(diagonal, needs_ic_solve)``: the constant mass diagonal (None for
    identity), probed at t0, t0+1 and perturbed params as
    pallas_stepper_band.py:169-199 does (raises out of scope), and whether
    the algebraic rows fail at ``init``, so that the host-side initial
    state must run the consistent-IC solve."""
    if eqn.mass is None:
        return None, False
    if eqn.mass_diag_fn is None:
        raise UnsupportedForKernel("non-diagonal mass is not in the banded kernel tier")
    t0, p0 = problem.t0, problem.params
    md0 = eqn.mass_diag_fn(t0, p0)
    md_t = eqn.mass_diag_fn(t0 + 1.0, p0)
    md_p = eqn.mass_diag_fn(t0, p0 * (1.0 + 1e-3) + 1e-3)
    if not (bool(torch.isfinite(md_t).all()) and bool(torch.isfinite(md_p).all())
            and torch.allclose(md_t, md0) and torch.allclose(md_p, md0)):
        raise UnsupportedForKernel("the banded kernel tier supports constant-diagonal "
                                   "mass only")
    f0 = eqn.rhs(t0, eqn.init(t0, p0), p0)
    alg = md0 == 0.0
    scale = 1.0 + float(f0.abs().max()) if f0.numel() else 1.0
    needs_ic_solve = bool((f0[alg].abs() > 1e-6 * scale).any())
    return tuple(float(v) for v in md0), needs_ic_solve


def make_fused_band_bdf_solve(problem, t_eval, nbatch: int, tile=None,
                              max_steps: int = 100_000):
    """Build ``solve(params_b (B, np) f64) -> (ys (neval, n, B) f64,
    status (ntiles,) int32, steps (ntiles,) int32)`` running the whole
    adaptive banded BDF solve per member tile (tiled-lockstep semantics).

    The band ``(ml, mu)`` is the problem's banded linear-solver spec's.
    CUDA tensors launch the kernel, CPU tensors run the plain version;
    ``solve.reference(params_b)`` runs the plain version on any device.
    Raises :class:`UnsupportedForKernel` out of scope.
    """
    eqn = problem.eqn
    if eqn.root is not None or eqn.reset is not None:
        raise UnsupportedForKernel("root and reset events are not in the banded "
                                   "kernel tier")
    if problem.integrate_out:
        raise UnsupportedForKernel("quadrature output is not in the banded kernel "
                                   "tier")
    if problem.lockstep_nbatch != 1:
        raise UnsupportedForKernel("pass the single-member problem")
    spec = problem.linear_solver
    if not (spec.name.startswith("banded") and spec.meta):
        raise UnsupportedForKernel("the banded kernel tier needs a banded-routed problem")
    ml, mu = int(spec.meta[0]), int(spec.meta[1])
    if tile is not None and int(tile) > MAX_TILE:
        raise ValueError(f"tile {int(tile)} > {MAX_TILE}, the band kernel's block limit")
    mass_diag, needs_ic_solve = _mass_diag(problem, eqn)
    n, nparams = eqn.nstates, eqn.nparams
    te = np.asarray(torch.as_tensor(t_eval, dtype=F64).cpu(), np.float64).reshape(-1)
    if te.size == 0 or np.any(np.diff(te) < 0.0):
        raise ValueError("t_eval must be non-empty and ascending")
    atol = np.asarray(problem.atol.cpu(), np.float64).reshape(-1)
    if atol.size == 1:
        atol = np.repeat(atol, n)
    nb = ml + mu + 1
    if tile is None:
        tile = default_tile(n, nb, mu, npadx(ml, mu), te.size)
    tile = max(1, min(int(tile), nbatch))
    ntiles = -(-nbatch // tile)
    plan = band_plan(n, ml, mu, tile, ntiles)  # raises if the kernel cannot hold it
    # the rhs only: init and the first step are computed outside the kernel
    model = trace_model(eqn.rhs, None, n, nparams)
    # each output stored as soon as its operands are: the kernel's rhs
    # reads shared memory and writes elsewhere, and few values stay live
    header = emit_cuda_header(model, getattr(eqn.rhs, "__qualname__", "rhs"),
                              stream_outputs=True)
    opts = problem.options
    cfg = BandConfig(
        n=n, nparams=nparams, t0=float(problem.t0), rtol=float(problem.rtol),
        atol=tuple(float(a) for a in atol), t_eval=tuple(float(v) for v in te),
        nbatch=nbatch, tile=tile, ntiles=ntiles, max_steps=int(max_steps),
        max_newton_iter=MAX_NEWTON_ITER, max_newton_fails=MAX_NEWTON_FAILS,
        max_error_test_fails=MAX_ERROR_TEST_FAILS, min_timestep=MIN_TIMESTEP,
        nl_tol=float(opts.nonlinear_solver_tolerance),
        ki=float(opts.pi_control_integral),
        kp=float(opts.pi_control_proportional),
        update_jacobian_after_steps=int(opts.update_jacobian_after_steps),
        update_rhs_jacobian_after_steps=int(opts.update_rhs_jacobian_after_steps),
        threshold_to_update_jacobian=float(opts.threshold_to_update_jacobian),
        jac_reuse=True, ml=ml, mu=mu, mass_diag=mass_diag,
        needs_ic_solve=needs_ic_solve,
    )

    def _check(params_b):
        params_b = torch.as_tensor(params_b)
        if params_b.dtype != F64 or tuple(params_b.shape) != (nbatch, nparams):
            raise ValueError(
                f"params must be ({nbatch}, {nparams}) float64, got "
                f"{tuple(params_b.shape)} {params_b.dtype}")
        return params_b

    def reference(params_b):
        params_b = _check(params_b)
        return _finish(cfg, *fused_band_bdf_reference(cfg, problem, params_b))

    consts_on = {}  # device -> t_eval, atol and mass-diagonal tensors there

    def solve(params_b):
        params_b = _check(params_b)
        if not params_b.is_cuda:
            return _finish(cfg, *fused_band_bdf_reference(cfg, problem, params_b))
        dev = params_b.device
        if dev not in consts_on:
            consts_on[dev] = dict(
                t_eval=torch.tensor(cfg.t_eval, dtype=F64, device=dev),
                atol=torch.tensor(cfg.atol, dtype=F64, device=dev),
                mass_diag=(None if mass_diag is None
                           else torch.tensor(mass_diag, dtype=F64, device=dev)))
        params_b = params_b.contiguous()
        y0, D1, h_t = initial_state(cfg, problem, _pad_params(cfg, params_b))
        init = torch.cat([y0.reshape(cfg.pad_b, n), D1.reshape(cfg.pad_b, n)], dim=1)
        return _finish(cfg, *launch_fused_band_bdf(
            cfg, header, params_b, init.contiguous(), h_t.contiguous(), consts_on[dev]))

    solve.reference = reference
    solve.header = header
    solve.cfg = cfg
    solve.model = model
    solve.tile = tile
    solve.ntiles = ntiles
    solve.plan = plan
    return solve
