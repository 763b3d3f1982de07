"""Fused whole-solve BDF tier for small-n ensembles (counterpart of
``diffsol_tpu/ops/pallas_stepper.py::make_pallas_bdf_solve``).

The whole adaptive NDF(1-5) solve of a member TILE runs as one unit: the
tile's members share one step sequence ("tiled lockstep": every WRMS norm
is the max over the tile's members), while different tiles step
independently.  Per attempt: predict from the difference matrix D,
stale-Jacobian Newton on ``(x - y_pred + psi) - c f(t, x)`` with the
rate-based convergence test, the error test, the PI controller, the
difference update, order selection every order+1 equal steps, the R.U
rescale of D, and dense output at ``t_eval`` inside each accepted step.

Two implementations of the same algorithm with the same tile partition:

* the CUDA kernel ``csrc/fused_bdf.cuh`` (one thread block per tile, one
  thread per member), launched by :func:`launch_fused_bdf` for CUDA
  tensors.  It is built with ``nvcc`` for ``sm_90a`` at first use from the
  repository's sources plus the model header that :mod:`.eqn_codegen`
  generates from the user's equations;
* the plain PyTorch version :func:`fused_bdf_reference`, batched over
  (ntiles, tile, n) with per-tile control tensors, eager and float64.  It
  runs for CPU tensors (the counterpart of Pallas ``interpret=True``) and
  is what the kernel is checked against on the card.

A CUDA tensor always goes to the kernel: a build or launch failure raises,
and nothing falls back to the plain version or to the CPU.

Every quantity is float64, heuristics included: the H100 has native f64,
whereas the Pallas kernel keeps its WRMS norms, rates and controller in
f32 and its state in double-float pairs.  ``precision="mixed"``
(pallas_stepper.py:463-471) demotes the Newton MATRIX path alone to
float32: the Jacobian probes, the LU factorization and the linear solve,
with the residual rounded to float32 going in and the correction widened
coming out; state, difference matrix, residual, time and the error test
stay float64.  An inexact Newton matrix costs convergence rate, not
accuracy: the trajectories stay inside the step controller's tolerance.
``precision="fast"`` is accepted and runs the float64 build: the Pallas
kernel's sloppy double-float operations have no counterpart in native
float64.

Scope, n <= 8 throughout: identity mass or a diagonal one (a semi-explicit
DAE whose initial conditions are consistent: the tier has no
consistent-IC Newton, so a host probe refuses the others), root events
that stop the solve or reset and continue (not together with a mass),
quadrature of an output with or without error control, and every
equation the codegen can trace (DiffSL models too, whose callables are
plain torch).  Out of scope, and left to the lockstep path: dense mass
and index-aware resets (``reset_n``, the DiffSL ``N`` protocol).

Roots keep the reference's batch semantics per tile: every member of a
tile must cross the same root component in the same step, the crossing
is polished on member 0 of the tile by the modified secant to ONE shared
root time, and a tile whose members disagree fails with
FAIL_ROOT_INCONS.  After a reset the difference matrix restarts at order
1 from the post-reset state.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..solvers.bdf import MAX_ORDER, ND, _ALPHA, _ERROR_CONST2, _GAMMA, _r_mat
from .controller import pi_controller_raw
from .eqn_codegen import UnsupportedForKernel, emit_cuda_header, trace_model

F64 = torch.float64

# per-tile status codes (as pallas_stepper.py:82-89)
OK = 0
ROOT_STOP = 1  # a root without a reset operator: the solve stops there
FAIL_STEP_TOO_SMALL = -1
FAIL_MAX_STEPS = -2
FAIL_NEWTON = -3
FAIL_ERRTEST = -4
FAIL_ROOT_INCONS = -5  # the tile's members disagree on a root crossing
FAIL_LU_GROWTH = -6  # the banded tier's no-pivot LU growth guard

MAX_STATES = 8
# 128 members per tile: the main path's 10,000 members make 79 blocks, so
# each of them has an SM of the H100's 132 to itself, and a small tile keeps
# the tile-wide max (and hence the shared step size) close to each
# member's own.  The Pallas kernel's 1024-lane multiples were for the
# TPU's (8, 128) vector registers.
DEFAULT_TILE = 128
# the largest tile, one thread block of the kernel; the plain version takes
# the same tiles (tiles above 256 run a 64-register build that spills)
MAX_TILE = 1024

ETA_RESET_JACOBIAN = 20.0**1.25
ETA_RESET_TIMESTEP = 100.0**1.25
# the Pallas kernel's eta floor, 1e4 * float32 eps (pallas_stepper.py:1195)
ETA_FLOOR = 1e4 * float(np.finfo(np.float32).eps)
# the fused kernel's limits (make_pallas_bdf_solve's defaults,
# pallas_stepper.py:447-451) and step-size clamps (:652-654)
MAX_NEWTON_ITER, MAX_NEWTON_FAILS, MAX_ERROR_TEST_FAILS = 10, 50, 40
MIN_TIMESTEP = 1e-32
MIN_SHRINK, MAX_GROWTH = 0.1, 2.1
DEAD_LO, DEAD_HI = 0.9, 1.1
# the root polish: bracket tolerance 100 eps (|t1| + |t1 - t0|) and the
# iteration bound of ops/rootfind.py
_EPS = float(np.finfo(np.float64).eps)
MAX_SECANT_ITERS = 100

# U = R(1), the constant half of the step-size transform
_U64 = _r_mat(1.0)


@dataclass(frozen=True)
class FusedConfig:
    """Static numbers of one fused solve (host side)."""

    n: int
    nparams: int
    t0: float
    rtol: float
    atol: tuple
    t_eval: tuple
    nbatch: int
    tile: int
    ntiles: int
    max_steps: int
    max_newton_iter: int
    max_newton_fails: int
    max_error_test_fails: int
    min_timestep: float
    nl_tol: float
    ki: float
    kp: float
    update_jacobian_after_steps: int
    update_rhs_jacobian_after_steps: int
    threshold_to_update_jacobian: float
    jac_reuse: bool
    # a diagonal mass: its constant values when it depends on neither t
    # nor p (then the algebraic rows are static), else replayed per step
    has_mass: bool = False
    mass_const: Optional[tuple] = None
    nroot: int = 0
    has_reset: bool = False
    # quadrature rows (0: nothing is integrated; without an ``out``
    # function the state itself is), and their error control
    nquad: int = 0
    has_out: bool = False
    out_in_err: bool = False
    out_rtol: float = 0.0
    out_atol: tuple = ()
    # precision="mixed": Jacobian, LU and the Newton linear solve in float32
    mixed: bool = False

    @property
    def extended(self) -> bool:
        """The solve returns the extended result (a dict)."""
        return self.nroot > 0 or self.nquad > 0

    @property
    def neval(self) -> int:
        return len(self.t_eval)

    @property
    def pad_b(self) -> int:
        return self.ntiles * self.tile


def _pad_params(cfg: FusedConfig, params_b: torch.Tensor) -> torch.Tensor:
    """(nbatch, np) -> (ntiles*tile, np); pad members replicate the last
    member (pallas_stepper.py:2037-2039)."""
    if cfg.pad_b == cfg.nbatch:
        return params_b.contiguous()
    pad = params_b[-1:].expand(cfg.pad_b - cfg.nbatch, -1)
    return torch.cat([params_b, pad], dim=0).contiguous()


class TiledResult(NamedTuple):
    """What a fused solve writes: ``ys`` (neval, n, B), ``info`` (ntiles, 6)
    int32 with status, accepted steps, attempts, next eval index, roots
    found and the last root's index per tile, ``gs`` (neval, nquad, B) or
    None, and the last root time per tile (ntiles,), NaN for none."""

    ys: torch.Tensor
    info: torch.Tensor
    gs: Optional[torch.Tensor] = None
    root_t: Optional[torch.Tensor] = None


def _finish(cfg: FusedConfig, ys: torch.Tensor, info: torch.Tensor, gs=None,
            root_t=None):
    """Poison the members of failed tiles with NaN (loud failure,
    pallas_stepper.py:2099-2101) and split out status and steps; with
    roots or quadrature in scope, the extended dict of
    pallas_stepper.py:2105-2119."""
    status, steps = info[:, 0], info[:, 1]
    bad = (status < 0).repeat_interleave(cfg.tile)[: cfg.nbatch]
    ys = torch.where(bad[None, None, :], torch.nan, ys)
    if not cfg.extended:
        return ys, status, steps
    res = dict(ys=ys, status=status, steps=steps, n_points=info[:, 3])
    if cfg.nquad:
        res["gs"] = torch.where(bad[None, None, :], torch.nan, gs)
    if cfg.nroot:
        res.update(n_roots=info[:, 4], root_idx=info[:, 5], root_t=root_t)
    return res


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def _wrms_sq(x, y, rtol, atol):
    """Squared WRMS per tile: mean over states, max over the tile's
    members.  x, y (T, tile, n) -> (T,)."""
    q = x / (y.abs() * rtol + atol)
    return (q * q).mean(-1).amax(-1)


def _bcast(v, like):
    """(T,) per-tile values -> broadcastable against (T, tile, n)."""
    return v.reshape(v.shape + (1,) * (like.ndim - 1))


def _tile_mul(s, v):
    """A per-tile scalar ``s`` (T,) times the members' vectors ``v``
    (T, tile, n).  The three products of the step that the Pallas kernel
    forms as double-float ``scalar * lane vector`` go through here (h y0',
    psi alpha and c f(x)), so a test can swap in the rounding that kernel
    shows in interpret mode on the CPU (ROADMAP.md queue 3)."""
    return _bcast(s, v) * v


def _compute_ru(order, factor):
    """Per-tile (T, ND, ND) RU = R(factor) @ U, identity outside rows and
    columns <= order (pallas_stepper.py:309-345)."""
    T = factor.shape[0]
    dev = factor.device
    j = torch.arange(ND, dtype=F64, device=dev)
    m = torch.arange(1, ND, dtype=F64, device=dev)[:, None]
    terms = (m - 1.0 - factor[:, None, None] * j) / m  # (T, ND-1, ND)
    r = torch.cumprod(
        torch.cat([torch.ones(T, 1, ND, dtype=F64, device=dev), terms], 1), 1)
    ru = r @ torch.as_tensor(_U64, dtype=F64, device=dev)
    idx = torch.arange(ND, device=dev)
    valid = (idx[None, :, None] <= order[:, None, None]) & (
        idx[None, None, :] <= order[:, None, None])
    return torch.where(valid, ru, torch.eye(ND, dtype=F64, device=dev))


def _update_diff(D, d, order):
    """Accepted-step difference update for per-tile orders
    (pallas_stepper.py:416-438).  D (T, ND, tile, n), d (T, tile, n)."""
    T = D.shape[0]
    ar = torch.arange(T, device=D.device)
    d_old_op1 = D[ar, order + 1]
    acc = torch.zeros_like(d)
    rows = [None] * ND
    for i in range(ND - 1, -1, -1):
        le = _bcast(i <= order, d)
        acc = acc + torch.where(le, D[:, i], 0.0)
        v = torch.where(le, acc + d, D[:, i])
        v = torch.where(_bcast(order + 1 == i, d), d, v)
        v = torch.where(_bcast(order + 2 == i, d), d - d_old_op1, v)
        rows[i] = v
    return torch.stack(rows, dim=1)


def _interp(D, t_anchor, h, order, te):
    """Interpolation polynomial of the accepted step at per-tile times
    ``te`` (pallas_stepper.py:389-413)."""
    yv = D[:, 0]
    tf = torch.ones_like(h)
    for i in range(MAX_ORDER):
        tf_new = tf * ((te - (t_anchor - h * float(i))) / (h * float(1 + i)))
        use = i < order
        yv = yv + torch.where(_bcast(use, yv), _bcast(tf_new, yv) * D[:, i + 1], 0.0)
        tf = torch.where(use, tf_new, tf)
    return yv


def _root_scan(g0, g1):
    """Sign-change scan (ops/rootfind.root_finding) over the last axis:
    ``(found, zero, imax)``, imax the strongest crossing, first on ties."""
    crossed = g0 * g1 < 0.0
    fracs = torch.where(
        crossed, (g1 / torch.where(crossed, g1 - g0, 1.0)).abs(), 0.0)
    imax = torch.zeros(g1.shape[:-1], dtype=torch.int64, device=g1.device)
    best = fracs[..., 0]
    for r in range(1, g1.shape[-1]):
        imax = torch.where(fracs[..., r] > best, r, imax)
        best = torch.maximum(fracs[..., r], best)
    return crossed.any(-1), (g1 == 0.0).any(-1), imax


def fused_bdf_reference(cfg: FusedConfig, rhs, init, params_b: torch.Tensor, *,
                        mass_diag=None, root=None, reset=None, out=None):
    """The plain PyTorch version of the fused kernel: the same algorithm on
    the same tile partition, eager float64, on the device of ``params_b``.
    ``mass_diag(t, p)``, ``root``, ``reset`` and ``out`` ``(t, y, p)`` are
    the member callables cfg speaks of.  Returns a :class:`TiledResult`."""
    dev = params_b.device
    T, tile, n = cfg.ntiles, cfg.tile, cfg.n
    Mb = T * tile
    P = _pad_params(cfg, params_b)
    atol = torch.tensor(cfg.atol, dtype=F64, device=dev)
    vmap = torch.func.vmap
    rhs_m = vmap(rhs, in_dims=(0, 0, 0))
    jac_m = vmap(torch.func.jacfwd(rhs, argnums=1), in_dims=(0, 0, 0))
    init_m = vmap(init, in_dims=(0, 0))
    # the Newton matrix path's type (precision="mixed": float32)
    mt = torch.float32 if cfg.mixed else F64

    def f(t_tile, y):  # per-tile t (T,), y (T, tile, n)
        tm = t_tile.repeat_interleave(tile)
        return rhs_m(tm, y.reshape(Mb, n), P).reshape(T, tile, n)

    def jac(t_tile, y):
        tm = t_tile.repeat_interleave(tile)
        return jac_m(tm.to(mt), y.reshape(Mb, n).to(mt), P.to(mt)).to(mt).reshape(
            T, tile, n, n)

    def wrms_sq(x, y):
        return _wrms_sq(x, y, cfg.rtol, atol)

    def lift(fn, width):
        """A member callable (t, y, p) over the tiles: (T, tile, width)."""
        fn_m = vmap(fn, in_dims=(0, 0, 0))

        def lifted(t_tile, y):
            tm = t_tile.repeat_interleave(tile)
            return fn_m(tm, y.reshape(Mb, n), P).reshape(T, tile, width)

        return lifted

    if cfg.mass_const is not None:
        md_const = torch.tensor(cfg.mass_const, dtype=F64, device=dev)

        def mass(t_tile):
            return md_const
    elif cfg.has_mass:
        mass_m = vmap(mass_diag, in_dims=(0, 0))

        def mass(t_tile):
            return mass_m(t_tile.repeat_interleave(tile), P).reshape(T, tile, n)

    def factor(J, c, t_pred):
        m = (torch.diag_embed(mass(t_pred).to(mt)) if cfg.has_mass
             else torch.eye(n, dtype=mt, device=dev))
        return torch.linalg.lu_factor_ex(m - c.to(mt)[:, None, None, None] * J)[:2], None

    def lsolve(factors, b):
        lu, piv = factors
        return torch.linalg.lu_solve(lu, piv, b.to(mt).unsqueeze(-1)).squeeze(-1).to(F64)

    def residual(x, t_pred, y_pred, psi, cval):
        tmp = x + (psi - y_pred)
        if cfg.has_mass:
            tmp = mass(t_pred) * tmp
        return tmp - _tile_mul(cval, f(t_pred, x))

    # ---- initial state and step size (pallas_stepper.py:837-907)
    t = torch.full((T,), cfg.t0, dtype=F64, device=dev)
    y0 = init_m(t.repeat_interleave(tile), P).reshape(T, tile, n)
    dy0 = f(t, y0)
    if cfg.has_mass:
        # dy0 = f/m on the differential rows and 0 on the algebraic ones:
        # the host probe saw consistent initial conditions, and the first
        # step's Newton holds the constraints from there on
        m0 = mass(t) + torch.zeros_like(dy0)
        dy0 = torch.where(m0 != 0.0, dy0 / torch.where(m0 != 0.0, m0, 1.0), 0.0)
    out_l = root_l = reset_l = None  # the callables lifted over the tiles
    if cfg.nquad:
        out_l = lift(out, cfg.nquad) if cfg.has_out else (lambda t_tile, y: y)
    if cfg.nroot:
        root_l = lift(root, cfg.nroot)
        reset_l = lift(reset, n) if cfg.has_reset else None
    d0 = torch.sqrt(wrms_sq(y0, y0))
    d1 = torch.sqrt(wrms_sq(dy0, y0))
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * (d0 / d1))
    y1 = y0 + _bcast(h0, y0) * dy0
    f1 = f(t + h0, y1)
    d2 = torch.sqrt(wrms_sq(f1 - dy0, y0)) / h0.abs()
    max_d = torch.maximum(d1, d2)
    h1 = torch.where(max_d < 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / max_d) ** 0.5)
    h = torch.minimum(100.0 * h0, h1)
    return tiled_bdf(cfg, atol, y0, _tile_mul(h, dy0), h, f, jac, factor,
                     lsolve, residual, out=out_l, root=root_l, reset=reset_l)


def tiled_bdf(cfg, atol, y0, D1, h, f, jac, factor, lsolve, residual,
              max_lu_growth=None, out=None, root=None, reset=None) -> TiledResult:
    """The step loop the fused tiers share, batched over member tiles.

    ``y0`` and ``D1 = h y0'`` are (T, tile, n) and ``h`` (T,).  The
    tier's pieces: ``f(t, y)`` the rhs, ``jac(t, y)`` the Jacobian in the
    tier's representation, ``factor(J, c, t_pred) -> (factors, growth)``
    the factorization of M - cJ with its per-tile element growth (or
    None), ``lsolve(factors, b)`` and ``residual(x, t_pred, y_pred, psi,
    c)``.  With ``max_lu_growth``, a tile whose growth is not below it
    fails with FAIL_LU_GROWTH (pallas_stepper_band.py:637-639).  With
    ``out(t, y)`` (T, tile, cfg.nquad) a second difference matrix gD
    integrates it beside D (pallas_stepper.py:1268-1325); with
    ``root(t, y)`` (T, tile, cfg.nroot) every accepted step is checked for
    a root, which is polished and pinned and then stops the tile or, with
    ``reset(t, y)``, resets it (pallas_stepper.py:1436-1760)."""
    dev = y0.device
    T, tile, n, neval = cfg.ntiles, cfg.tile, cfg.n, cfg.neval
    te_all = torch.tensor(cfg.t_eval, dtype=F64, device=dev)
    alpha = torch.tensor(_ALPHA, dtype=F64, device=dev)
    gamma = [float(g) for g in _GAMMA]
    ec2 = torch.tensor(_ERROR_CONST2, dtype=F64, device=dev)

    def wrms_sq(x, y):
        return _wrms_sq(x, y, cfg.rtol, atol)

    def tiles(v, dtype=torch.int64):
        return torch.full((T,), v, dtype=dtype, device=dev)

    t = tiles(cfg.t0, F64)
    D = torch.zeros((T, ND) + tuple(y0.shape[1:]), dtype=F64, device=dev)
    D[:, 0] = y0
    D[:, 1] = D1
    k = tiles(0)
    steps = tiles(0)
    status = tiles(OK)
    nxt = tiles(0)
    order = tiles(1)
    n_equal = tiles(0)
    prev_err = tiles(math.nan, F64)
    conv_fail = tiles(0)
    newton_fails = tiles(0)
    err_fails = tiles(0)
    h_changed = tiles(0)
    J = factors = None
    growth = tiles(1.0, F64)
    c_last = tiles(0.0, F64)
    ssj = tiles(0)
    ssrj = tiles(0)
    eta_mem = tiles(ETA_RESET_JACOBIAN, F64)
    ys = torch.zeros(neval, n, T, tile, dtype=F64, device=dev)
    ar = torch.arange(T, device=dev)
    mnewt = float(cfg.max_newton_iter)
    gD = gs = rootg = None
    if out is not None:
        nq = cfg.nquad
        gD = torch.zeros(T, ND, tile, nq, dtype=F64, device=dev)
        gD[:, 1] = _bcast(h, y0) * out(t, y0)
        gs = torch.zeros(neval, nq, T, tile, dtype=F64, device=dev)
        if cfg.out_in_err:
            out_atol = torch.tensor(cfg.out_atol, dtype=F64, device=dev)
    if root is not None:
        rootg = root(t, y0)
        n_roots = tiles(0)
        root_idx = tiles(-1)
        root_t = tiles(math.nan, F64)

    def pick(mask, new, old):
        """Per-tile select; ``old`` None means nothing to keep yet."""
        return new if old is None else torch.where(_bcast(mask, new), new, old)

    while True:
        alive = (status == OK) & (k < cfg.max_steps) & (nxt < neval)
        if not bool(alive.any()):
            break
        alpha_k = alpha[order]
        cval = h * alpha_k
        t_pred = t + h

        # ---- predict + psi from D
        y_pred = D[:, 0]
        psi_raw = gamma[1] * D[:, 1]
        for i in range(1, MAX_ORDER + 1):
            le = _bcast(i <= order, y_pred)
            y_pred = y_pred + torch.where(le, D[:, i], 0.0)
            if i >= 2:
                psi_raw = psi_raw + torch.where(le, gamma[i] * D[:, i], 0.0)
        psi = _tile_mul(alpha_k, psi_raw)

        # ---- stale-Jacobian policy (pallas_stepper.py:1094-1174)
        if cfg.jac_reuse:
            rel = (cval / torch.where(c_last == 0.0, cval, c_last) - 1.0).abs()
            refresh_j = ((k == 0) | (conv_fail > 0)
                         | (ssrj >= cfg.update_rhs_jacobian_after_steps))
            refactor = (refresh_j | (rel > cfg.threshold_to_update_jacobian)
                        | (ssj >= cfg.update_jacobian_after_steps))
            if bool(refresh_j.any()):
                J = pick(refresh_j, jac(t_pred, y_pred), J)
            if bool(refactor.any()):
                fac_n, growth_n = factor(J, cval, t_pred)
                factors = tuple(pick(refactor, a, b) for a, b in
                                zip(fac_n, factors or (None,) * len(fac_n)))
                if growth_n is not None:
                    growth = torch.where(refactor, growth_n, growth)
            c_last_n = torch.where(refactor, cval, c_last)
            ssj_n = torch.where(refactor, 0, ssj + 1)
            ssrj_n = torch.where(refresh_j, 0, ssrj + 1)
            eta0 = torch.where(
                refactor, ETA_RESET_JACOBIAN,
                torch.where(h_changed == 1, ETA_RESET_TIMESTEP, eta_mem))
        else:
            J = jac(t_pred, y_pred)
            factors = factor(J, cval, t_pred)[0]
            eta0 = tiles(ETA_RESET_JACOBIAN, F64)
        # element growth beyond the limit means the no-pivot factorization
        # is meaningless (a NaN fails the test too)
        lu_bad = (None if max_lu_growth is None
                  else ~(growth <= max_lu_growth))

        # ---- Newton on the residual (pallas_stepper.py:1176-1265)
        x = y_pred
        first_nrm = tiles(0.0, F64)
        niter = tiles(0)
        nstat = tiles(0)
        eta_run = eta0
        while True:
            active = (nstat == 0) & (niter < cfg.max_newton_iter)
            if not bool(active.any()):
                break
            delta = lsolve(factors, residual(x, t_pred, y_pred, psi, cval))
            x_new = x - delta
            nrm = torch.sqrt(wrms_sq(delta, y_pred))
            niter = niter + active.long()
            is_first = niter == 1
            kk = torch.clamp(niter - 1, min=1).to(F64)
            rate = torch.maximum(nrm / torch.clamp(first_nrm, min=0.0),
                                 nrm.new_tensor(1e-30)) ** (1.0 / kk)
            rate = torch.where(torch.isfinite(rate), rate, math.inf)
            proj = (rate ** torch.clamp(cfg.max_newton_iter - niter, min=0).to(F64)
                    / (1.0 - rate) * nrm)
            eta_new = torch.where(
                is_first,
                torch.clamp(eta0, min=ETA_FLOOR) ** 0.8,
                rate / (1.0 - rate))
            diverged = ~is_first & ((rate > 0.9) | (proj > cfg.nl_tol))
            converged = (eta_new * nrm < cfg.nl_tol) & ~diverged
            nstat_new = torch.where(diverged, 2, torch.where(converged, 1, 0))
            x = torch.where(_bcast(active, x), x_new, x)
            first_nrm = torch.where(active & is_first, nrm, first_nrm)
            nstat = torch.where(active, nstat_new, nstat)
            eta_run = torch.where(active, eta_new, eta_run)
        solve_ok = nstat == 1
        d = x - y_pred

        # ---- quadrature delta (op/bdf.rs:45-57: d_g = c dg - psi_g)
        if out is not None:
            psi_g = gamma[1] * gD[:, 1]
            for i in range(2, MAX_ORDER + 1):
                psi_g = psi_g + torch.where(_bcast(i <= order, psi_g),
                                            gamma[i] * gD[:, i], 0.0)
            g_delta = (_bcast(cval, psi_g) * out(t_pred, y_pred)
                       - psi_g * _bcast(alpha_k, psi_g))

        # ---- error test and step-size control
        err = wrms_sq(d, y_pred) * ec2[order - 1]
        if out is not None and cfg.out_in_err:
            # the quadrature joins the max with the NEXT error constant
            err = torch.maximum(
                err, _wrms_sq(g_delta, gD[:, 0], cfg.out_rtol, out_atol) * ec2[order])
        accepted = solve_ok & (err <= 1.0)
        safety = 0.9 * (2.0 * mnewt + 1.0) / (2.0 * mnewt + niter.to(F64))
        second = ~solve_ok & (conv_fail == 1)
        err_fail = solve_ok & ~accepted
        newton_fails = newton_fails + (~solve_ok).long()
        raw = pi_controller_raw(err, prev_err, cfg.ki, cfg.kp, order + 1)
        rej_factor = torch.clamp(safety * raw, min=MIN_SHRINK)
        factor_r = torch.where(err_fail, rej_factor, 0.3)
        do_rescale = err_fail | second

        # ---- accepted-step difference update and order selection
        D_acc = _update_diff(D, d, order)
        y_new = D_acc[:, 0]
        if out is not None:
            gD_acc = _update_diff(gD, g_delta, order)
        n_equal_acc = torch.where((h_changed == 1) | do_rescale, 1, n_equal + 1)
        do_sel = accepted & (n_equal_acc > order)

        def pred_err(col, const_idx):
            return wrms_sq(D_acc[ar, col], y_new) * ec2[const_idx]

        em = torch.where(order > 1, pred_err(order, torch.clamp(order - 1, min=0)),
                         math.inf)
        ep = torch.where(order < MAX_ORDER,
                         pred_err(torch.clamp(order + 2, max=ND - 1),
                                  torch.clamp(order + 1, max=MAX_ORDER)),
                         math.inf)
        f_m = pi_controller_raw(em, err, cfg.ki, cfg.kp, order)
        f_0 = pi_controller_raw(err, err, cfg.ki, cfg.kp, order + 1)
        f_p = pi_controller_raw(ep, err, cfg.ki, cfg.kp, order + 2)
        best = torch.where((f_m >= f_0) & (f_m >= f_p), 0,
                           torch.where(f_0 >= f_p, 1, 2))
        best_f = torch.where(best == 0, f_m, torch.where(best == 1, f_0, f_p))
        sel_factor = torch.clamp(safety * best_f, MIN_SHRINK, MAX_GROWTH)
        do_change = do_sel & ((sel_factor >= DEAD_HI) | (sel_factor <= DEAD_LO)
                              | (best != 1))
        new_order = torch.clamp(order + best - 1, 1, MAX_ORDER)
        order_acc = torch.where(do_change, new_order, order)
        n_equal_new = torch.where(do_change, 0, n_equal_acc)

        # ---- one shared D rescale for the rejected and the accepted path
        ru_factor = torch.where(accepted, sel_factor, factor_r)
        ru_order = torch.where(accepted, new_order, order)
        do_ru = torch.where(accepted, do_change, do_rescale)
        D_out = torch.where(_bcast(accepted, D), D_acc, D)
        if out is not None:
            gD_out = torch.where(_bcast(accepted, gD), gD_acc, gD)
        if bool(do_ru.any()):
            ru = _compute_ru(ru_order, ru_factor)
            D_resc = torch.einsum("tij,ti...->tj...", ru, D_out)
            D_out = torch.where(_bcast(do_ru, D), D_resc, D_out)
            if out is not None:
                gD_resc = torch.einsum("tij,ti...->tj...", ru, gD_out)
                gD_out = torch.where(_bcast(do_ru, gD), gD_resc, gD_out)
        h_out = h * torch.where(do_ru, ru_factor, 1.0)

        # ---- root check on the accepted interpolant
        t_wr = t_pred
        if root is not None:
            g1 = root(t_pred, y_new)
            found_l, zero_l, imax_l = _root_scan(rootg, g1)
            f_any, f_all = found_l.any(1), found_l.all(1)
            z_any, z_all = zero_l.any(1), zero_l.all(1)
            imf = imax_l.to(F64)
            im_hi = torch.where(found_l, imf, -math.inf).amax(1)
            im_lo = torch.where(found_l, imf, math.inf).amin(1)
            live = alive & accepted
            incons = live & ((f_any & ~f_all) | (f_all & (im_hi != im_lo))
                             | (z_any & ~z_all & ~f_any))
            do_cross = live & f_all & (im_hi == im_lo)
            do_zero = live & ~f_any & z_all
            do_root = (do_cross | do_zero) & ~incons
            # a zero at the step's end: the smallest |g1| of member 0
            zi = tiles(0)
            zb = g1[:, 0, 0].abs()
            for r in range(1, cfg.nroot):
                mag = g1[:, 0, r].abs()
                zi = torch.where(mag < zb, r, zi)
                zb = torch.minimum(mag, zb)
            t_r, ridx = t_pred, tiles(-1)
            rootg_plus = g1
            if bool(do_root.any()):
                t_c, idx_c = t_pred, zi
                if bool(do_cross.any()):
                    t_c, idx_c = _polish(cfg, root, D_acc, t, t_pred, h,
                                         order, rootg[:, 0], g1[:, 0],
                                         imax_l[:, 0], do_cross)
                t_r = torch.where(do_root, torch.where(do_cross, t_c, t_pred), t_pred)
                ridx = torch.where(do_root, torch.where(do_cross, idx_c, zi), -1)
                # pin back to the root, reset, and restart at order 1
                # (drivers._pin_to, _apply_reset; bdf.reinit_after_reset)
                y_root = _interp(D_acc, t_pred, h, order, t_r)
                y_plus = y_root if reset is None else reset(t_r, y_root)
                dy_plus = f(t_r, y_plus)
                rootg_plus = torch.where(_bcast(do_root, g1),
                                         root(t_r, y_plus), g1)
                if out is not None:
                    g_root = _interp(gD_acc, t_pred, h, order, t_r)
                    dg_plus = out(t_r, y_plus)
            t_wr = t_r

        # ---- dense output at the t_eval points this accepted step passed
        # (a root ends the step at the root time)
        walive = alive & accepted
        ne = nxt
        while True:
            te = te_all[torch.clamp(ne, max=neval - 1)]
            wm = walive & (ne < neval) & (te <= t_wr)
            if not bool(wm.any()):
                break
            sel = wm.nonzero().squeeze(1)
            yv = _interp(D_acc, t_pred, h, order, te)
            ys[ne[sel], :, sel, :] = yv[sel].transpose(1, 2)
            if out is not None:
                gv = _interp(gD_acc, t_pred, h, order, te)
                gs[ne[sel], :, sel, :] = gv[sel].transpose(1, 2)
            ne = ne + wm.long()

        # ---- select between the accepted and rejected paths
        status_n = status
        err_fails_n = torch.where(accepted, 0, err_fails + err_fail.long())
        status_n = torch.where(
            err_fail & (err_fails_n >= cfg.max_error_test_fails),
            FAIL_ERRTEST, status_n)
        status_n = torch.where(
            ~solve_ok & (newton_fails > cfg.max_newton_fails), FAIL_NEWTON,
            status_n)
        status_n = torch.where(do_rescale & (h_out.abs() < cfg.min_timestep),
                               FAIL_STEP_TOO_SMALL, status_n)
        status_n = torch.where((k + 1 >= cfg.max_steps) & (ne < neval)
                               & (status_n == OK), FAIL_MAX_STEPS, status_n)
        if lu_bad is not None:
            status_n = torch.where(lu_bad, FAIL_LU_GROWTH, status_n)
        t_n = torch.where(accepted, t_pred, t)
        order_n = torch.where(accepted, order_acc, order)
        n_equal_n = torch.where(accepted, n_equal_new, n_equal)
        prev_err_n = torch.where(accepted, err, math.nan)
        if root is not None:
            # a crossing the tile's members disagree on is a hard error; a
            # root without a reset operator stops the tile
            status_n = torch.where(incons, FAIL_ROOT_INCONS, status_n)
            if reset is None:
                status_n = torch.where(do_root & (status_n == OK), ROOT_STOP,
                                       status_n)
            if bool(do_root.any()):
                def reinit(first, second, like):
                    re = torch.zeros_like(like)
                    re[:, 0] = first
                    re[:, 1] = _bcast(h_out, second) * second
                    return torch.where(_bcast(do_root, like), re, like)

                D_out = reinit(y_plus, dy_plus, D_out)
                if out is not None:
                    gD_out = reinit(g_root, dg_plus, gD_out)
                t_n = torch.where(do_root, t_r, t_n)
                order_n = torch.where(do_root, 1, order_n)
                n_equal_n = torch.where(do_root, 0, n_equal_n)
                prev_err_n = torch.where(do_root, math.nan, prev_err_n)
        new = dict(
            k=k + 1, steps=steps + accepted.long(), status=status_n, nxt=ne,
            t=t_n, h=h_out,
            order=order_n,
            n_equal=n_equal_n,
            prev_err=prev_err_n,
            conv_fail=torch.where(accepted, 0,
                                  torch.where(solve_ok, conv_fail, 1)),
            newton_fails=newton_fails, err_fails=err_fails_n,
            h_changed=torch.where(accepted, 0,
                                  torch.where(do_rescale, 1, h_changed)),
            D=D_out,
        )
        old = dict(k=k, steps=steps, status=status, nxt=nxt, t=t, h=h,
                   order=order, n_equal=n_equal, prev_err=prev_err,
                   conv_fail=conv_fail, newton_fails=newton_fails,
                   err_fails=err_fails, h_changed=h_changed, D=D)
        if cfg.jac_reuse:
            new.update(c_last=c_last_n, ssj=ssj_n, ssrj=ssrj_n, eta_mem=eta_run)
            old.update(c_last=c_last, ssj=ssj, ssrj=ssrj, eta_mem=eta_mem)
        if out is not None:
            new.update(gD=gD_out)
            old.update(gD=gD)
        if root is not None:
            new.update(
                rootg=torch.where(_bcast(accepted, g1), rootg_plus, rootg),
                n_roots=n_roots + do_root.long(),
                root_t=torch.where(do_root, t_r, root_t),
                root_idx=torch.where(do_root, ridx, root_idx))
            old.update(rootg=rootg, n_roots=n_roots, root_t=root_t,
                       root_idx=root_idx)
        # finished tiles keep the state they finished with
        fz = {key: torch.where(_bcast(alive, new[key]), new[key], old[key])
              for key in new}
        (k, steps, status, nxt, t, h, order, n_equal, prev_err, conv_fail,
         newton_fails, err_fails, h_changed, D) = (
            fz["k"], fz["steps"], fz["status"], fz["nxt"], fz["t"], fz["h"],
            fz["order"], fz["n_equal"], fz["prev_err"], fz["conv_fail"],
            fz["newton_fails"], fz["err_fails"], fz["h_changed"], fz["D"])
        if cfg.jac_reuse:
            c_last, ssj, ssrj, eta_mem = (fz["c_last"], fz["ssj"], fz["ssrj"],
                                          fz["eta_mem"])
        if out is not None:
            gD = fz["gD"]
        if root is not None:
            rootg, n_roots, root_t, root_idx = (fz["rootg"], fz["n_roots"],
                                                fz["root_t"], fz["root_idx"])

    status = torch.where((status == OK) & (nxt < neval), FAIL_MAX_STEPS, status)
    if root is None:
        n_roots, root_idx, root_t = tiles(0), tiles(-1), None
    info = torch.stack([status, steps, k, nxt, n_roots, root_idx],
                       dim=1).to(torch.int32)

    def members(v):
        return v.reshape(neval, -1, T * tile)[:, :, : cfg.nbatch].contiguous()

    return TiledResult(ys=members(ys), info=info,
                       gs=None if gs is None else members(gs), root_t=root_t)


def _polish(cfg, root, D_acc, t, t_new, h, order, g0, g1, im0, do_cross):
    """The modified secant (root.rs:60-165) of every crossing tile at once,
    on member 0's root values: ``g0``/``g1`` (T, nroot) at the step's ends
    and ``im0`` (T,) the crossing component.  Tiles outside ``do_cross``
    ride along frozen.  Returns per-tile ``(t_root, root_idx)``."""
    nroot = cfg.nroot
    tol = 100.0 * _EPS * (t_new.abs() + (t_new - t).abs())
    t0_, t1_ = t, t_new
    g0_, g1_ = g0, g1
    im = im0
    alpha = torch.ones_like(t)
    sc0 = torch.zeros_like(do_cross)
    sc1 = torch.ones_like(do_cross)
    res_t, res_i = t_new, im0
    it = torch.zeros_like(im0)
    done = torch.zeros_like(do_cross)
    while True:
        prog = (do_cross & ~done & ((t1_ - t0_).abs() > tol)
                & (it < MAX_SECANT_ITERS))
        if not bool(prog.any()):
            break
        g1v = g1_.gather(1, im[:, None])[:, 0]
        g0v = g0_.gather(1, im[:, None])[:, 0]
        dt_br = t1_ - t0_
        t_mid = t1_ - dt_br * (g1v / (g1v - alpha * g0v))
        # keep t_mid off the bracket's ends
        fracint = dt_br.abs() / tol
        fracsub = torch.where(fracint > 5.0, 0.1, 0.5 / fracint)
        t_mid = torch.where((t_mid - t0_).abs() < 0.5 * tol,
                            t0_ + fracsub * dt_br, t_mid)
        t_mid = torch.where((t1_ - t_mid).abs() < 0.5 * tol,
                            t1_ - fracsub * dt_br, t_mid)
        # frozen tiles may hold junk times: evaluate them at the step's end
        t_ev = torch.where(prog, t_mid, t_new)
        gmid = root(t_ev, _interp(D_acc, t_new, h, order, t_ev))[:, 0]
        lower, rootfnd, im2 = _root_scan(g0_, gmid)
        exact = ~lower & rootfnd
        keep_lo = lower | exact
        t1n = torch.where(lower, t_mid, t1_)
        imn = torch.where(lower, im2, im)
        g1n = torch.where(lower[:, None], gmid, g1_)
        t0n = torch.where(keep_lo, t0_, t_mid)
        g0n = torch.where(keep_lo[:, None], g0_, gmid)
        res_tn = torch.where(exact, t_mid, res_t)
        res_in = torch.where(exact, im, res_i)
        sc0n = torch.where(it % 2 == 0, lower, sc0)
        sc1n = torch.where(it % 2 == 1, lower, sc1)
        alpha_n = torch.where(
            it >= 2,
            torch.where(sc0n != sc1n, 1.0,
                        torch.where(sc0n, 0.5 * alpha, 2.0 * alpha)),
            alpha)
        t0_, t1_ = torch.where(prog, t0n, t0_), torch.where(prog, t1n, t1_)
        g0_ = torch.where(prog[:, None], g0n, g0_)
        g1_ = torch.where(prog[:, None], g1n, g1_)
        im = torch.where(prog, imn, im)
        alpha = torch.where(prog, alpha_n, alpha)
        sc0, sc1 = torch.where(prog, sc0n, sc0), torch.where(prog, sc1n, sc1)
        res_t = torch.where(prog, res_tn, res_t)
        res_i = torch.where(prog, res_in, res_i)
        it = it + prog.long()
        done = done | (prog & exact)
    return torch.where(done, res_t, t1_), torch.where(done, res_i, im)


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

_D, _I = ctypes.c_double, ctypes.c_int


class CConfig(ctypes.Structure):
    """The kernel's ``Config`` (csrc/fused_bdf.cuh), field for field."""

    _fields_ = [
        ("t0", _D), ("rtol", _D), ("nl_tol", _D), ("ki", _D), ("kp", _D),
        ("min_timestep", _D), ("thresh_update_jac", _D), ("eta_floor", _D),
        ("atol", _D * MAX_STATES),
        ("alpha", _D * (MAX_ORDER + 1)), ("gamma", _D * (MAX_ORDER + 1)),
        ("ec2", _D * (MAX_ORDER + 1)),
        ("U", (_D * ND) * ND),
        ("min_shrink", _D), ("max_growth", _D), ("dead_lo", _D), ("dead_hi", _D),
        ("eta_reset_jac", _D), ("eta_reset_step", _D),
        ("max_steps", _I), ("max_newton_iter", _I), ("max_newton_fails", _I),
        ("max_err_fails", _I),
        ("update_jac_after", _I), ("update_rhs_jac_after", _I), ("jac_reuse", _I),
        ("neval", _I), ("nbatch", _I), ("tile", _I), ("ntiles", _I),
        ("max_secant_iters", _I), ("pad_", _I),
        ("out_rtol", _D), ("out_atol", _D * MAX_STATES),
    ]


@functools.lru_cache(maxsize=64)
def _c_config(cfg: FusedConfig) -> CConfig:
    atol = list(cfg.atol) + [1.0] * (MAX_STATES - cfg.n)
    return CConfig(
        t0=cfg.t0, rtol=cfg.rtol, nl_tol=cfg.nl_tol, ki=cfg.ki, kp=cfg.kp,
        min_timestep=cfg.min_timestep,
        thresh_update_jac=cfg.threshold_to_update_jacobian, eta_floor=ETA_FLOOR,
        atol=(_D * MAX_STATES)(*atol),
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
        jac_reuse=int(cfg.jac_reuse), neval=cfg.neval, nbatch=cfg.nbatch,
        tile=cfg.tile, ntiles=cfg.ntiles,
        max_secant_iters=MAX_SECANT_ITERS, out_rtol=cfg.out_rtol,
        out_atol=(_D * MAX_STATES)(
            *(list(cfg.out_atol) + [1.0] * (MAX_STATES - len(cfg.out_atol)))),
    )


def launch_fused_bdf(cfg: FusedConfig, model_header: str,
                     params_b: torch.Tensor, t_eval: torch.Tensor):
    """Launch the fused BDF kernel on ``torch.cuda.current_stream()``.

    ``params_b`` is a contiguous (nbatch, nparams) float64 CUDA tensor and
    ``t_eval`` the (neval,) float64 output times on the same device; the
    kernel reads the last member's parameters for the pad members of the
    last tile.  Returns a :class:`TiledResult` on that device (``gs`` and
    ``root_t`` None unless cfg has quadrature rows or roots).  Builds the
    kernel for this model at first use; raises on a build or launch
    error."""
    from .._build import load_fused_bdf

    if not params_b.is_cuda:
        raise ValueError("launch_fused_bdf needs a CUDA tensor")
    if params_b.dtype != F64:
        raise TypeError(f"params must be float64, got {params_b.dtype}")
    if tuple(params_b.shape) != (cfg.nbatch, cfg.nparams) or not params_b.is_contiguous():
        raise ValueError(
            f"params must be contiguous {(cfg.nbatch, cfg.nparams)}, got "
            f"{tuple(params_b.shape)}")
    if (t_eval.device != params_b.device or t_eval.dtype != F64
            or tuple(t_eval.shape) != (cfg.neval,)):
        raise ValueError("t_eval must be (neval,) float64 on the params' device")
    lib = load_fused_bdf(model_header)
    if lib.fused_bdf_config_size() != ctypes.sizeof(CConfig):
        raise RuntimeError("CConfig does not match the kernel's Config layout")
    dev = params_b.device
    with torch.cuda.device(dev):
        # a tile that stops at a root leaves the later points unwritten:
        # they are zeros, as solve_dense's (pallas_stepper.py:931-951)
        alloc = torch.zeros if cfg.nroot else torch.empty
        ys = alloc(cfg.neval, cfg.n, cfg.nbatch, dtype=F64, device=dev)
        gs = (alloc(cfg.neval, cfg.nquad, cfg.nbatch, dtype=F64, device=dev)
              if cfg.nquad else None)
        info = torch.empty(cfg.ntiles, 6, dtype=torch.int32, device=dev)
        root_t = (torch.empty(cfg.ntiles, dtype=F64, device=dev)
                  if cfg.nroot else None)
        ccfg = _c_config(cfg)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_bdf_launch(
            params_b.data_ptr(), t_eval.data_ptr(), ys.data_ptr(),
            None if gs is None else gs.data_ptr(), info.data_ptr(),
            None if root_t is None else root_t.data_ptr(),
            ctypes.addressof(ccfg), stream,
        )
        launch_fused_bdf.launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_bdf kernel launch failed: CUDA error {rc}")
    return TiledResult(ys=ys, info=info, gs=gs, root_t=root_t)


launch_fused_bdf.launches = 0


def _probe_mass(problem, eqn):
    """The host probes of a diagonal mass (pallas_stepper.py:578-609):
    refuse initial conditions that the algebraic rows do not satisfy, since
    the tier starts stepping from ``init`` with no consistent-IC Newton,
    and return the diagonal's values when it depends on neither t nor p
    (else None, and the kernel replays it every step)."""
    t0, p0 = problem.t0, problem.params
    md0 = eqn.mass_diag_fn(t0, p0)
    f0 = eqn.rhs(t0, eqn.init(t0, p0), p0)
    alg = md0 == 0.0
    scale = 1.0 + (float(f0.abs().max()) if f0.numel() else 0.0)
    if bool((f0[alg].abs() > 1e-6 * scale).any()):
        raise UnsupportedForKernel(
            "the kernel tier needs consistent DAE initial conditions "
            f"(|g(y0)| up to {float(f0[alg].abs().max()):.2e})")
    md_t = eqn.mass_diag_fn(t0 + 1.0, p0)
    md_p = eqn.mass_diag_fn(t0, p0 * (1.0 + 1e-3) + 1e-3)
    if (bool(torch.isfinite(md_t).all()) and bool(torch.isfinite(md_p).all())
            and torch.allclose(md_t, md0) and torch.allclose(md_p, md0)):
        return tuple(float(v) for v in md0)
    return None


def make_fused_bdf_solve(problem, t_eval, nbatch: int, tile=None,
                         max_steps: int = 100_000, jac_reuse: bool = True,
                         precision: str = "df"):
    """Build ``solve(params_b (B, np) f64) -> (ys (neval, n, B) f64,
    status (ntiles,) int32, steps (ntiles,) int32)`` running the whole
    adaptive BDF solve per member tile (tiled-lockstep semantics).  For a
    problem with a root function or quadrature, ``solve`` returns a dict
    instead: ``ys``, ``status``, ``steps``, ``n_points`` and, as they
    apply, ``gs`` (neval, nquad, B), ``n_roots``, ``root_idx`` and
    ``root_t`` per tile.

    ``precision``: ``"df"`` (the default) is all float64; ``"mixed"`` keeps
    the Newton matrix path (Jacobian probes, LU, linear solve) in float32;
    ``"fast"`` is accepted for the JAX package's callers and runs the
    ``"df"`` build, since sloppy double-float operations have no
    counterpart in native float64.

    CUDA tensors launch the kernel, CPU tensors run the plain version;
    ``solve.reference(params_b)`` runs the plain version on any device.
    Raises :class:`UnsupportedForKernel` out of scope, so callers can fall
    back to the lockstep path.
    """
    if precision not in ("df", "mixed", "fast"):
        raise ValueError(f"precision must be 'df', 'mixed' or 'fast': {precision!r}")
    mixed = precision == "mixed"
    eqn = problem.eqn
    has_mass = eqn.mass is not None
    if has_mass and eqn.mass_diag_fn is None:
        raise UnsupportedForKernel(
            "non-diagonal mass is not in the kernel tier (ROADMAP.md queue 1 "
            "item 4)")
    if eqn.reset_n is not None:
        raise UnsupportedForKernel(
            "the index-aware reset_n is not in the kernel tier")
    has_root = eqn.root is not None
    if has_root and has_mass:
        raise UnsupportedForKernel(
            "events with a mass matrix are not in the kernel tier (the "
            "consistent-IC solve after a reset runs in the lockstep tier only)")
    if problem.lockstep_nbatch != 1:
        raise UnsupportedForKernel("pass the single-member problem")
    n, nparams = eqn.nstates, eqn.nparams
    if n > MAX_STATES:
        raise UnsupportedForKernel(f"n={n} > {MAX_STATES} states")
    if tile is not None and int(tile) > MAX_TILE:
        raise ValueError(f"tile {int(tile)} > {MAX_TILE}, the kernel's block limit")
    integrate_out = bool(problem.integrate_out)
    has_out = integrate_out and eqn.out is not None
    nquad = (eqn.nout if has_out else n) if integrate_out else 0
    out_in_err = problem.output_in_error_control()
    mass_const = _probe_mass(problem, eqn) if has_mass else None
    has_reset = has_root and eqn.reset is not None
    model = trace_model(
        eqn.rhs, eqn.init, n, nparams,
        mass_diag=eqn.mass_diag_fn if has_mass else None, mass_const=mass_const,
        root=eqn.root, reset=eqn.reset if has_reset else None,
        out=eqn.out if has_out else None)
    header = emit_cuda_header(model, getattr(eqn.rhs, "__qualname__", "rhs"),
                              nquad=nquad, out_in_err=out_in_err, mixed=mixed)

    te = np.asarray(torch.as_tensor(t_eval, dtype=F64).cpu(), np.float64).reshape(-1)
    if te.size == 0 or np.any(np.diff(te) < 0.0):
        raise ValueError("t_eval must be non-empty and ascending")

    def vec(v, nv):
        v = np.asarray(v.cpu(), np.float64).reshape(-1)
        return tuple(float(a) for a in (np.repeat(v, nv) if v.size == 1 else v))

    tile = DEFAULT_TILE if tile is None else int(tile)
    tile = max(1, min(tile, nbatch))
    ntiles = -(-nbatch // tile)
    opts = problem.options
    cfg = FusedConfig(
        n=n, nparams=nparams, t0=float(problem.t0), rtol=float(problem.rtol),
        atol=vec(problem.atol, n), t_eval=tuple(float(v) for v in te),
        nbatch=nbatch, tile=tile, ntiles=ntiles, max_steps=int(max_steps),
        max_newton_iter=MAX_NEWTON_ITER, max_newton_fails=MAX_NEWTON_FAILS,
        max_error_test_fails=MAX_ERROR_TEST_FAILS, min_timestep=MIN_TIMESTEP,
        nl_tol=float(opts.nonlinear_solver_tolerance),
        ki=float(opts.pi_control_integral),
        kp=float(opts.pi_control_proportional),
        update_jacobian_after_steps=int(opts.update_jacobian_after_steps),
        update_rhs_jacobian_after_steps=int(opts.update_rhs_jacobian_after_steps),
        threshold_to_update_jacobian=float(opts.threshold_to_update_jacobian),
        jac_reuse=bool(jac_reuse),
        has_mass=has_mass, mass_const=mass_const,
        nroot=eqn.nroots if has_root else 0, has_reset=has_reset,
        nquad=nquad, has_out=has_out, out_in_err=out_in_err,
        out_rtol=float(problem.out_rtol) if out_in_err else 0.0,
        out_atol=vec(problem.out_atol, nquad) if out_in_err else (),
        mixed=mixed,
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
        return _finish(cfg, *fused_bdf_reference(
            cfg, eqn.rhs, eqn.init, params_b, mass_diag=eqn.mass_diag_fn,
            root=eqn.root, reset=eqn.reset, out=eqn.out))

    t_eval_on = {}  # device -> t_eval tensor there

    def solve(params_b):
        params_b = _check(params_b)
        if params_b.is_cuda:
            dev = params_b.device
            if dev not in t_eval_on:
                t_eval_on[dev] = torch.tensor(cfg.t_eval, dtype=F64, device=dev)
            return _finish(cfg, *launch_fused_bdf(
                cfg, header, params_b.contiguous(), t_eval_on[dev]))
        return reference(params_b)

    solve.reference = reference
    solve.header = header
    solve.cfg = cfg
    solve.model = model
    solve.tile = tile
    solve.ntiles = ntiles
    return solve
