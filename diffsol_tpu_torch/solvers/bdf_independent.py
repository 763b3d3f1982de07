"""Independent-ensemble BDF: B members in one batched loop, each with its
own step control (counterpart of ``jax.vmap`` over
``diffsol_tpu.solvers.bdf.BdfSolver.step`` and
``diffsol_tpu.drivers.solve_dense``, as ``diffsol_tpu.ensemble``'s
``mode="independent"`` runs them).

The members' vectors are member-major (B, n) as in the lockstep lift, and
D is (ND, B, n).  Every scalar of :class:`~.bdf.BdfState` becomes a (B,)
tensor: the time, step size, order, the Jacobian policy's counters, eta,
the tstop, the status and the root found, and :class:`~.rk_common.Stats`
holds a (B,) counter a field.  The callables are the lockstep lift's
(:func:`~diffsol_tpu_torch.ensemble.make_lockstep_problem` with
``member_t=True``: each member at its own time), and the WRMS norms stop at
the mean over a member's states (:func:`~diffsol_tpu_torch.norms.scaled_per_member`).

A round is one step attempt of every unfinished member, in the order of
decisions of ``BdfSolver.step``: the restart after a root or a reset, the
prediction from D at the member's own order (the coefficient tables are
gathered by the (B,) order and the sums masked, never looped over
members), Newton masked per member (a member that converged or diverged
is frozen; the loop ends when none iterates), the error test, and then
the rejection (rescale, the failure ladder) or the acceptance (the
difference update, order selection, the root check on the accepted
interpolant, the tstop clamp) and the driver's part: the ``t_eval``
points the accepted step passed (a (neval, B) written mask), the pin to a
root and its reset, the member's stop.  A member's step sequence is its
single solve's.

The Jacobian and the factorization of ``M - c J`` are refreshed only for
the members whose own policy asks, on that subset (``index_select`` /
``index_copy_``): ``torch.linalg.lu_factor_ex`` on the dense tier, the
band LU (K3 factors the subset's bands, K4 solves every member against
its own factors on the card) on the banded tier.

The step control's powers run on the host: the single solve's control is
Python floats, whose ``**`` is C's pow, and a device's pow (or PyTorch's
vectorized one on the CPU) may round differently in the last bit, which
is enough to change a step.  So the Newton convergence test and the PI
controller read their (B,) operands, compute each member's powers with
:func:`math.pow` and the rest in numpy's float64 arithmetic, which rounds
as Python's, and send the results back.

The loop reads the host a bounded number of times a round, whatever B:
once for whether any member is unfinished (and whether one restarts), once
per Newton iteration (its convergence test), once for the step-size
controller, once per refresh of a subset and once per secant iteration of
a root search.  ``rounds`` and ``host_reads`` count them on the final
:class:`IndependentState`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Any, Optional

import numpy as np
import torch

from .. import errors
from ..norms import error_scale, scaled_per_member
from ..ops.band_lu import BandFactors
from ..ops.newton import ETA_RESET_JACOBIAN, ETA_RESET_TIMESTEP
from .bdf import (MAX_ORDER, ND, _ALPHA, _ERROR_CONST2, _EPS, _GAMMA, _r_mat,
                  BdfSolver)
from .consistent_ic import algebraic_mask
from .rk_common import Stats

F64 = torch.float64
I64 = torch.int64

_CAUSES = ("lu_from_checkpoint", "lu_from_first_fail", "lu_from_second_fail",
           "lu_from_error_test", "lu_from_step_success")
_MAX_SECANT_ITERS = 100


def takes(solver) -> bool:
    """Whether ``mode="independent"`` runs this solver batched: a plain
    :class:`~.bdf.BdfSolver` (no augmented rows) over the dense tier (any
    mass) or the banded tier."""
    name = solver.problem.linear_solver.name
    return (type(solver) is BdfSolver and not solver.has_sens
            and (name == "dense" or name.startswith("banded")))


@dataclass
class IndependentState:
    """The batched state of an independent ensemble: the fields of
    :class:`~.bdf.BdfState` with a leading member axis ((B,) for its
    scalars, (B, n) for vectors, (ND, B, n) for D), ``stats`` a
    :class:`~.rk_common.Stats` of (B,) counters, and the loop's own
    counts."""

    y: torch.Tensor
    dy: torch.Tensor
    t: torch.Tensor
    h: torch.Tensor
    D: torch.Tensor
    order: torch.Tensor
    n_equal_steps: torch.Tensor
    jac: torch.Tensor
    factors: Any
    eta: torch.Tensor
    prev_error_norm: torch.Tensor
    steps_since_jac: torch.Tensor
    steps_since_rhs_jac: torch.Tensor
    c_last: torch.Tensor
    newton_fails_total: torch.Tensor
    tstop: torch.Tensor
    status: torch.Tensor
    stats: Stats
    g: torch.Tensor
    gD: torch.Tensor
    root_g: torch.Tensor
    root_t: torch.Tensor
    root_idx: torch.Tensor
    state_modified: torch.Tensor
    # accepted steps plus fatal attempts, as solve_dense's counter k
    n_steps: Optional[torch.Tensor] = None
    rounds: int = 0
    host_reads: int = 0
    newton_sweeps: int = 0  # Newton iterations of the batch (any member)

    def member_stats(self, b: int) -> Stats:
        """Member ``b``'s counters as the single solve's :class:`Stats`."""
        return Stats(**{f.name: int(getattr(self.stats, f.name)[b])
                        for f in fields(Stats)})


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` rounded once, as Python's float division (``c / x`` on a
    tensor is ``x.reciprocal() * c``, a second rounding)."""
    return torch.full_like(x, c) / x


def _host_pows(a, b) -> np.ndarray:
    """``x ** y`` over two float64 arrays as Python computes it (C's pow,
    through :func:`math.pow`): the single solve's control is Python
    floats, and a device's pow or PyTorch's vectorized one may round
    differently.  Inf where the power overflows, NaN outside its domain."""
    a, b = (x.tolist() for x in np.broadcast_arrays(np.asarray(a, dtype=np.float64),
                                                    np.asarray(b, dtype=np.float64)))
    try:
        return np.fromiter(map(math.pow, a, b), dtype=np.float64, count=len(a))
    except (OverflowError, ValueError):
        return np.array([_fpow(x, y) for x, y in zip(a, b)], dtype=np.float64)


def _fpow(x: float, y: float) -> float:
    try:
        return math.pow(x, y)
    except OverflowError:
        return math.inf
    except ValueError:
        return math.nan


_TINY, _HUGE = 1e-30, 1e30


def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


def _f64(x: torch.Tensor) -> torch.Tensor:
    return _cast(x, F64)


def _where(mask, a, b):
    """``torch.where`` with a (B,) mask broadcast over trailing axes."""
    while mask.ndim < a.ndim:
        mask = mask.unsqueeze(-1)
    return torch.where(mask, a, b)


def _where_nd(mask, a, b):
    """The same for ND-leading tensors (ND, B, ...)."""
    m = mask.unsqueeze(0)
    while m.ndim < a.ndim:
        m = m.unsqueeze(-1)
    return torch.where(m, a, b)


class _Batched:
    """The loop of one independent ensemble solve; see the module
    docstring."""

    def __init__(self, solver: BdfSolver, params_b: torch.Tensor):
        from ..ensemble import make_lockstep_problem

        p = solver.problem
        self.p = p
        self.cfg = solver.config
        self.opts = p.options
        self.B = params_b.shape[0]
        self.eqn = make_lockstep_problem(p, self.B, member_t=True).eqn
        self.spec = p.linear_solver
        self.banded = self.spec.name.startswith("banded")
        self.params = params_b
        self.dev = params_b.device
        self.dtype = p.dtype
        self.eps = float(torch.finfo(self.dtype).eps)
        self.alg = algebraic_mask(p)
        self.jvp_probes = getattr(p.eqn.rhs_jac, "jvp_probes", p.eqn.nstates)
        tk = dict(dtype=F64, device=self.dev)
        self.alpha = torch.as_tensor(_ALPHA, **tk)
        self.gamma_d = torch.as_tensor(_GAMMA[1:], dtype=self.dtype, device=self.dev)
        self.ec2 = torch.as_tensor(_ERROR_CONST2, **tk)
        self.u1 = torch.as_tensor(_r_mat(1.0), **tk)
        self.eye = torch.eye(ND, **tk)
        self.idx = torch.arange(ND, device=self.dev)
        self.reads = 0
        self.newton_sweeps = 0

    # ------------------------------------------------------------------
    # host reads and small helpers
    def read(self, x):
        """One device -> host read (counted)."""
        self.reads += 1
        return x.tolist()

    def tt(self, t):
        """Member times as the callables take them (the problem's dtype)."""
        return t if t.dtype == self.dtype else t.to(self.dtype)

    def s(self, x):
        """(B,) control scalars onto (B, n) state tensors."""
        return self.tt(x).unsqueeze(-1)

    def out(self, t, y, params=None):
        params = self.params if params is None else params
        return y if self.eqn.out is None else self.eqn.out(self.tt(t), y, params)

    def wnorm2(self, x, y, atol, rtol):
        """Each member's squared WRMS norm, (B,) in float64."""
        return _f64(scaled_per_member(x, error_scale(y, atol, rtol)))

    # ------------------------------------------------------------------
    # the control's powers, on the host as the single solve takes them
    def to_host(self, *xs):
        """One read of float64 rows broadcast to a common shape -> a numpy
        (len(xs), size) array."""
        self.reads += 1
        rows = torch.broadcast_tensors(*[_f64(torch.as_tensor(x, device=self.dev)) for x in xs])
        return torch.stack(rows).reshape(len(xs), -1).cpu().numpy()

    def to_dev(self, a, shape=None):
        out = torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
        return out if shape is None else out.reshape(shape)

    def pow(self, a, b, mask):
        """``a ** b`` for the entries of ``mask`` (1.0 elsewhere), rounded as
        the single solve's Python floats (:func:`_host_pows`): one read."""
        a = _f64(a)
        h = self.to_host(a, b, mask)
        out = np.ones(h.shape[1])
        i = np.flatnonzero(h[2])
        out[i] = _host_pows(h[0, i], h[1, i])
        return self.to_dev(out, a.shape)

    def pi_raw(self, err, prev, eff_order, mask):
        """ops.controller.pi_controller_raw (its float form) of the entries
        of ``mask`` (1.0 elsewhere): one read for all of them."""
        ki_c, kp_c = self.opts.pi_control_integral, self.opts.pi_control_proportional
        e, pv, k, m = self.to_host(err, prev, eff_order, mask)
        out = np.ones(e.shape)
        inv = 1.0 / k
        ki, kp = inv * ki_c, inv * kp_c
        e = np.clip(e, _TINY, _HUGE)  # a NaN stays NaN
        both = (pv == pv) & (kp_c != 0.0)
        i = np.flatnonzero((m != 0) & both)
        out[i] = (_host_pows(e[i], -(ki[i] + kp[i]))
                  * _host_pows(np.clip(pv[i], _TINY, _HUGE), kp[i]))
        i = np.flatnonzero((m != 0) & ~both)
        out[i] = _host_pows(e[i], -ki[i])
        return self.to_dev(out, torch.broadcast_shapes(err.shape, prev.shape, eff_order.shape))

    def converge(self, niter, nrm, first, eta, live, max_iter: int, tol: float,
                 floor: float):
        """The Newton convergence test (convergence.rs:69-130) of the
        members of ``live`` after their ``niter``-th iteration, on the
        host in the single solve's float arithmetic (``floor`` is
        newton_solve's floor of the ratio, 1e-30; make_consistent's check
        has none, 0.0): one read -> ((status, eta) on the device, whether
        a member of ``live`` goes on).  Status 0 goes on (and outside
        ``live``), 1 converged, 2 diverged."""
        it, nv, fv, ev, lv = self.to_host(niter, nrm, first, eta, live)
        lv = lv != 0
        one = lv & (it == 1)
        more = lv & (it > 1)
        eta_new = ev.copy()
        i = np.flatnonzero(one)
        eta_new[i] = _host_pows(np.maximum(ev[i], 1e4 * self.eps), 0.8)
        i = np.flatnonzero(more)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(fv[i] > 0.0, nv[i] / fv[i], math.inf)
            ratio = np.where(ratio < floor, floor, ratio)
            rate = _host_pows(ratio, 1.0 / (it[i] - 1.0))
            rate = np.where(np.isfinite(rate), rate, math.inf)
            go = rate <= 0.9
            proj = np.zeros_like(rate)
            proj[go] = _host_pows(rate[go], np.maximum(max_iter - it[i][go], 0.0))
            eta_new[i] = np.where(rate != 1.0, rate / (1.0 - rate), math.inf)
            diverged = np.zeros_like(lv, dtype=bool)
            diverged[i] = ~go | (proj / (1.0 - rate) * nv[i] > tol)
            conv = (one | more) & (eta_new * nv < tol) & ~diverged
        status = np.where(diverged, 2, np.where(conv, 1, 0))
        return (self.to_dev(status), self.to_dev(eta_new)), bool((lv & (status == 0)).any())

    # ------------------------------------------------------------------
    # the difference matrix at per-member order (bdf.py's helpers with the
    # sums masked, so that each member's arithmetic is its single solve's)
    def masked(self, D, order):
        """D with the rows past each member's order zeroed."""
        m = self.idx[:, None] <= order[None, :]
        return torch.where(m.view(m.shape + (1,) * (D.ndim - 2)), D, 0.0)

    def predict(self, D, order, Dm=None):
        """sum_{i <= order} D[i], summed in predict_from_diff's order (the
        zeros past a member's order add nothing)."""
        Dm = self.masked(D, order) if Dm is None else Dm
        acc = Dm[0]
        for i in range(1, MAX_ORDER + 1):
            acc = acc + Dm[i]
        return acc

    def psi(self, D, order, Dm=None):
        """alpha[order] * sum_{1 <= i <= order} gamma[i] D[i] (psi_from_diff)."""
        Dm = self.masked(D, order) if Dm is None else Dm
        G = Dm[1:MAX_ORDER + 1] * self.gamma_d.view(
            (MAX_ORDER,) + (1,) * (D.ndim - 1))
        acc = G[0]
        for i in range(1, MAX_ORDER):
            acc = acc + G[i]
        return self.s(self.alpha[order]) * acc

    def update_diff(self, D, d, order):
        """update_diff at each member's order: D'[i] = sum_{k=i..order}
        D[k] + d for i <= order, D'[order+1] = d, D'[order+2] = d -
        D[order+1], the rest kept."""
        Dm = self.masked(D, order)
        acc = Dm[MAX_ORDER]
        rows = [acc]
        for i in range(MAX_ORDER - 1, -1, -1):
            acc = acc + Dm[i]
            rows.append(acc)
        A = torch.stack(rows[::-1]) + d
        shape = (ND, -1) + (1,) * (D.ndim - 2)
        idx = self.idx.view(shape[:1] + (1,) * (D.ndim - 1))
        o = order.view((1, -1) + (1,) * (D.ndim - 2))
        new = torch.cat([torch.where(idx[:MAX_ORDER + 1] <= o, A, D[:MAX_ORDER + 1]),
                         D[MAX_ORDER + 1:]])
        tail = torch.where(idx[1:] == o + 2, d - D[:-1], new[1:])
        tail = torch.where(idx[1:] == o + 1, d, tail)
        return torch.cat([new[:1], tail])

    def ru(self, order, factor):
        """(B, ND, ND) R(factor) U acting on rows 0..order (compute_ru)."""
        j = torch.arange(ND, dtype=F64, device=self.dev)[None, None, :]
        m = torch.arange(1, ND, dtype=F64, device=self.dev)[None, :, None]
        rows = (m - 1.0 - factor[:, None, None] * j) / m
        ones = torch.ones((factor.shape[0], 1, ND), dtype=F64, device=self.dev)
        r = torch.cumprod(torch.cat([ones, rows], dim=1), dim=1)
        valid = ((self.idx[None, :, None] <= order[:, None, None])
                 & (self.idx[None, None, :] <= order[:, None, None]))
        r = torch.where(valid, r, self.eye)
        u = torch.where(valid, self.u1, self.eye)
        return r @ u

    def rescale(self, mask, order, factor, *Ds):
        """Each D (ND, B, ...) under a step-size change by ``factor`` for
        the members of ``mask`` (rescale_all); the others untouched."""
        ru = self.ru(order, torch.where(mask, factor, 1.0))
        out = []
        for D in Ds:
            if D.shape[-1] == 0:
                out.append(D)
                continue
            r = _cast(ru, D.dtype)
            new = torch.einsum("bij,ib...->jb...", r, D)
            out.append(_where_nd(mask, new, D))
        return out

    def interp(self, t, D, t1, h, order):
        """Interpolant of the last step at per-member times ``t`` ((B,) or
        (neval, B)) -> (..., B, n) (interp_from_diff)."""
        y = D[0].expand(t.shape + D.shape[2:]) if t.ndim > 1 else D[0]
        tf = torch.ones_like(t)
        for i in range(MAX_ORDER):
            tf = tf * (t - (t1 - h * i)) / (h * (1.0 + i))
            term = _cast(tf, D.dtype).unsqueeze(-1) * D[i + 1]
            y = y + torch.where((i < order).unsqueeze(-1), term, 0.0)
        return y

    def interp_deriv(self, t, D, t1, h, order):
        dy = torch.zeros_like(D[0])
        pi = torch.ones_like(t)
        d_pi = torch.zeros_like(t)
        for i in range(MAX_ORDER):
            denom = h * (1.0 + i)
            w = (t - (t1 - h * i)) / denom
            d_pi_new = d_pi * w + pi / denom
            pi_new = pi * w
            live = i < order
            d_pi = torch.where(live, d_pi_new, d_pi)
            pi = torch.where(live, pi_new, pi)
            dy = dy + torch.where(live.unsqueeze(-1), _cast(d_pi, D.dtype).unsqueeze(-1) * D[i + 1],
                                  0.0)
        return dy

    # ------------------------------------------------------------------
    def refresh(self, st, mask, t, y, c, rhs_pred, cause):
        """The Jacobian policy's refresh (BdfSolver._jac_slim) for the
        members of ``mask``: a new Jacobian where ``rhs_pred``, then M - c J
        factored, on the subset alone.  ``cause`` is a (B,) index into
        _CAUSES."""
        rhs_pred = rhs_pred & mask
        idx = torch.nonzero(mask).squeeze(1)
        self.reads += 1  # nonzero's size
        if idx.numel() == 0:
            return
        stats = st.stats
        pb = self.params.index_select(0, idx)
        t_s = self.tt(t.index_select(0, idx))
        y_s = y.index_select(0, idx)
        jac_s = st.jac.index_select(0, idx)
        rj = rhs_pred.index_select(0, idx)
        jac_s = _where(rj, self.eqn.jac(t_s, y_s, pb), jac_s)
        st.jac.index_copy_(0, idx, jac_s)
        c_s = c.index_select(0, idx).to(self.dtype)
        a = self.spec.assemble(self.eqn.mass_repr(t_s, pb), jac_s,
                               c_s.view(-1, *([1] * (jac_s.ndim - 1))))
        _scatter_factors(st.factors, idx, self.spec.factor(a))
        st.steps_since_jac = torch.where(mask, 0, st.steps_since_jac)
        st.c_last = torch.where(mask, c, st.c_last)
        st.eta = torch.where(mask, ETA_RESET_JACOBIAN, st.eta)
        one = mask.to(I64)
        stats.linear_solver_setups += one
        if self.eqn.mass is not None:
            stats.mass_evals += one
        for k, name in enumerate(_CAUSES):
            getattr(stats, name).add_(one & (cause == k).to(I64))
        st.steps_since_rhs_jac = torch.where(rhs_pred, 0, st.steps_since_rhs_jac)
        stats.jacobian_evals += rhs_pred.to(I64)
        stats.jac_mul_evals += rhs_pred.to(I64) * self.jvp_probes

    # ------------------------------------------------------------------
    def init_state(self, t_final: float) -> IndependentState:
        """BdfSolver.init_state of every member, then the driver's
        set_stop_time(final_time)."""
        p, B = self.p, self.B
        params = self.params
        t0 = float(p.t0)
        t = torch.full((B,), t0, dtype=F64, device=self.dev)
        y = self.eqn.init(p.t0, params)
        dy = self.eqn.rhs(self.tt(t), y, params)
        if p.integrate_out:
            dg = self.out(t, y)
            g = torch.zeros_like(dg)
        else:
            dg = g = y.new_zeros((B, 0))
        status = torch.zeros(B, dtype=I64, device=self.dev)
        if self.alg is not None:
            y, dy, status = self.make_consistent(t, y, dy, torch.ones_like(status, dtype=torch.bool))
        h = self.initial_step_size(t, y, dy)
        D = y.new_zeros((ND, B) + tuple(y.shape[1:]))
        D[0] = y
        D[1] = self.s(h) * dy
        gD = g.new_zeros((ND,) + tuple(g.shape))
        if p.integrate_out:
            gD[0] = g
            gD[1] = self.s(h) * dg
        root_g = (self.eqn.root(self.tt(t), y, params) if self.eqn.root is not None
                  else y.new_zeros((B, 0)))
        c0 = h * float(_ALPHA[1])
        zl = torch.zeros(B, dtype=I64, device=self.dev)
        # the counters are rows of one (nstats, B) matrix, so that a step's
        # start and a fatal attempt's return take one copy of them
        self.stats_mat = torch.zeros((len(fields(Stats)), B), dtype=I64, device=self.dev)
        stats = Stats(**{f.name: self.stats_mat[i] for i, f in enumerate(fields(Stats))})
        jac = self.eqn.jac(self.tt(t), y, params)
        a = self.spec.assemble(self.eqn.mass_repr(self.tt(t), params), jac,
                               c0.to(self.dtype).view(-1, *([1] * (jac.ndim - 1))))
        factors = self.spec.factor(a)
        stats.linear_solver_setups += 1
        stats.lu_from_checkpoint += 1
        stats.jacobian_evals += 1
        stats.jac_mul_evals += self.jvp_probes
        if self.eqn.mass is not None:
            stats.mass_evals += 1
        nan = torch.full((B,), math.nan, dtype=F64, device=self.dev)
        st = IndependentState(
            y=y, dy=dy, t=t, h=h, D=D, order=torch.ones(B, dtype=I64, device=self.dev),
            n_equal_steps=zl.clone(), jac=jac, factors=factors,
            eta=torch.full((B,), ETA_RESET_JACOBIAN, dtype=F64, device=self.dev),
            prev_error_norm=nan.clone(), steps_since_jac=zl.clone(),
            steps_since_rhs_jac=zl.clone(), c_last=c0, newton_fails_total=zl.clone(),
            tstop=nan.clone(), status=status, stats=stats, g=g, gD=gD, root_g=root_g,
            root_t=nan.clone(), root_idx=zl - 1,
            state_modified=torch.zeros(B, dtype=torch.bool, device=self.dev),
            n_steps=zl.clone(),
        )
        # set_stop_time (bdf.py:347-369)
        st.tstop = torch.full((B,), float(t_final), dtype=F64, device=self.dev)
        tr = 100.0 * _EPS * (st.t.abs() + st.h.abs())
        reached = (st.t - st.tstop).abs() <= tr
        over = ~reached & torch.where(st.h > 0.0, st.t + st.h > st.tstop + tr,
                                      st.t + st.h < st.tstop - tr)
        factor = (st.tstop - st.t) / st.h
        st.D, st.gD = self.rescale(over, st.order, factor, st.D, st.gD)
        st.h = torch.where(over, st.h * factor, st.h)
        st.n_equal_steps = torch.where(over, 0, st.n_equal_steps)
        st.eta = torch.where(over, ETA_RESET_TIMESTEP, st.eta)
        st.status = torch.where(st.tstop < st.t - tr,
                                errors.STOP_TIME_BEFORE_CURRENT_TIME, st.status)
        return st

    def initial_step_size(self, t, y0, dy0):
        """state.initial_step_size for every member (order 1)."""
        p = self.p
        atol, rtol = p.atol, p.rtol
        d0 = torch.sqrt(self.wnorm2(y0, y0, atol, rtol))
        d1 = torch.sqrt(self.wnorm2(dy0, y0, atol, rtol))
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * (d0 / d1))
        sgn = -1.0 if float(p.h0) < 0.0 else 1.0
        t1 = t + sgn * h0
        y1 = y0 + self.s(sgn * h0) * dy0
        f1 = self.eqn.rhs(self.tt(t1), y1, self.params)
        d2 = torch.sqrt(self.wnorm2(f1 - dy0, y0, atol, rtol)) / h0.abs()
        max_d = torch.where(d2 > d1, d2, d1)
        h1 = torch.where(max_d < 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                         self.pow(_rdiv(0.01, max_d), 1.0 / 2.0, max_d >= 1e-15))
        return sgn * torch.minimum(100.0 * h0, h1)

    # ------------------------------------------------------------------
    def make_consistent(self, t, y, dy, active):
        """consistent_ic.make_consistent for the members of ``active`` at
        their times ``t``, one Newton or line-search evaluation a member a
        round: ``(y, dy, status)`` with status INTERNAL_TIMESTEP or
        INITIAL_CONDITION_DID_NOT_CONVERGE (the inputs kept) a member."""
        from ..ops.banded import make_banded_jac
        from ..ops.linsol import DENSE
        from .consistent_ic import _blockwise_jacfwd

        p, B = self.p, self.B
        is_alg = self.alg.to(self.dev)
        ic = p.ic_options
        tol = float(p.options.nonlinear_solver_tolerance)
        steptol = self.eps ** (2.0 / 3.0)
        tau, armijo_c = ic.step_reduction_factor, ic.armijo_constant
        max_newton = ic.max_newton_iterations
        zero = torch.zeros_like(y)
        tdt = self.tt(t)

        def residual(x, sel=None):
            yf, pb, tb = y, self.params, tdt
            if sel is not None:
                yf, pb, tb = yf.index_select(0, sel), pb.index_select(0, sel), tb.index_select(0, sel)
            y0 = torch.where(is_alg, x, yf)
            f = self.eqn.rhs(tb, y0, pb)
            du = torch.where(is_alg, torch.zeros_like(x), x)
            mdu = torch.where(is_alg, torch.zeros_like(x), self.eqn.mass_mul(tb, pb, du))
            return f - mdu

        if self.banded:
            ml, mu = self.spec.meta[:2]

            def factorize(x, sel):
                return self.spec.factor(make_banded_jac(
                    lambda t_, xx, p_: residual(xx, sel), ml, mu)(None, x, None))

            lin_solve = self.spec.solve
        else:
            def factorize(x, sel):
                return DENSE.factor(_blockwise_jacfwd(lambda xx: residual(xx, sel), x))

            lin_solve = DENSE.solve

        def nrm_of(delta):
            return torch.sqrt(self.wnorm2(delta, y, p.atol, p.rtol))

        def check(niter, nrm, first, eta, live):
            """convergence.rs:69-130 per member -> (status, eta)."""
            return self.converge(niter, nrm, first, eta, live, max_newton, tol, 0.0)[0]

        x = torch.where(is_alg, y, dy)
        factors = None
        fB = lambda: torch.zeros(B, dtype=F64, device=self.dev)  # noqa: E731
        iB = lambda: torch.zeros(B, dtype=I64, device=self.dev)  # noqa: E731
        eta = torch.full((B,), ETA_RESET_JACOBIAN, dtype=F64, device=self.dev)
        status = iB()  # 0 continue, 1 converged, 2 diverged
        setups, niter, ls_i = iB(), iB(), iB()
        nrm, first, alpha = fB(), fB(), fB()
        phi0, two_phi0, min_alpha = fB(), fB(), fB()
        delta = torch.zeros_like(y)
        start = active.clone()  # the next evaluation opens a campaign
        live = active.clone()
        while True:
            if not self.read(live.any()):
                break
            # open the campaigns of ``start``: factor at x
            idx = torch.nonzero(start & live).squeeze(1)
            self.reads += 1
            if idx.numel():
                sub = factorize(x.index_select(0, idx), idx)
                if factors is None:
                    factors = _expand_factors(sub, idx, B)
                else:
                    _scatter_factors(factors, idx, sub)
            st_ = start & live
            ls = live & ~start
            x_try = x - self.s(alpha) * delta
            z = torch.where(st_.unsqueeze(-1), x, x_try)
            d_new = lin_solve(factors, residual(z))
            n_new = nrm_of(d_new)
            # campaign start: the first Newton iterate
            s1, e1 = check(torch.ones_like(niter), n_new, n_new, eta, st_)
            conv1 = st_ & (s1 == 1)
            x = _where(conv1, x - d_new, x)
            delta = _where(st_, d_new, delta)
            nrm = torch.where(st_, n_new, nrm)
            first = torch.where(st_, n_new, first)
            eta = torch.where(st_, e1, eta)
            status = torch.where(st_, s1, status)
            niter = torch.where(st_, 1, niter)
            # a fresh line search
            fresh_ls = st_ & (status == 0) & (niter < max_newton)
            phi0 = torch.where(fresh_ls, 0.5 * nrm * nrm, phi0)
            two_phi0 = torch.where(fresh_ls, nrm * nrm, two_phi0)
            min_alpha = torch.where(fresh_ls, _rdiv(steptol, nrm), min_alpha)
            alpha = torch.where(fresh_ls, 1.0, alpha)
            ls_i = torch.where(fresh_ls, 0, ls_i)
            # line-search members: one trial
            ok = 0.5 * n_new * n_new <= phi0 - armijo_c * alpha * two_phi0
            failed = ~ok & (alpha < min_alpha)
            alpha = torch.where(ls, alpha * tau, alpha)
            ls_i = torch.where(ls, ls_i + 1, ls_i)
            ls_end = ls & (ok | failed | (ls_i >= ic.max_linesearch_iterations))
            niter = torch.where(ls_end, niter + 1, niter)
            sk, ek = check(niter, n_new, first, eta, ls_end & ok)
            good = ls_end & ok
            status = torch.where(good, sk, torch.where(ls_end, 2, status))
            eta = torch.where(good, ek, eta)
            x = _where(good, x_try, x)
            delta = _where(good, d_new, delta)
            nrm = torch.where(good, n_new, nrm)
            # a line search goes on, restarts, or the campaign ends
            again = ls_end & (status == 0) & (niter < max_newton)
            phi0 = torch.where(again, 0.5 * nrm * nrm, phi0)
            two_phi0 = torch.where(again, nrm * nrm, two_phi0)
            min_alpha = torch.where(again, _rdiv(steptol, nrm), min_alpha)
            alpha = torch.where(again, 1.0, alpha)
            ls_i = torch.where(again, 0, ls_i)
            camp_end = (st_ & ~fresh_ls) | (ls_end & ~again)
            setups = torch.where(camp_end, setups + 1, setups)
            done = camp_end & ((status == 1) | (setups >= ic.max_linear_solver_setups))
            live = live & ~done
            start = camp_end & ~done
        ok = active & (status == 1)
        new_y = _where(ok, torch.where(is_alg, x, y), y)
        new_dy = _where(ok, torch.where(is_alg, zero, x), dy)
        st = torch.where(active & ~ok, errors.INITIAL_CONDITION_DID_NOT_CONVERGE,
                         errors.INTERNAL_TIMESTEP)
        return new_y, new_dy, st

    # ------------------------------------------------------------------
    def newton(self, st, run, y_pred, psi, cval, t_pred):
        """newton_solve for every member of ``run``, each frozen once it
        converged or diverged -> (x, converged, niter, eta)."""
        p = self.p
        eqn, params = self.eqn, self.params
        tol = float(self.opts.nonlinear_solver_tolerance)
        max_iter = self.cfg.maximum_newton_iterations
        scale = error_scale(y_pred, p.atol, p.rtol)  # newton_solve(error_y=y_pred)
        cv = self.s(cval)
        tp = self.tt(t_pred)
        x = y_pred
        eta = st.eta.clone()
        first = torch.zeros_like(eta)
        niter = torch.zeros_like(st.order)
        conv = torch.zeros_like(run)
        it = run.clone()  # the caller has read that some member runs
        for sweep in range(1, max_iter + 1):
            self.newton_sweeps += 1
            fx = eqn.rhs(tp, x, params)
            r = eqn.mass_mul(tp, params, x - y_pred + psi) - cv * fx
            delta = self.spec.solve(st.factors, r)
            x = _where(it, x - delta, x)
            nrm = torch.sqrt(_f64(scaled_per_member(delta, scale)))
            niter = niter + it.to(I64)
            if sweep == 1:
                first = torch.where(it, nrm, first)
            (status, eta_new), going = self.converge(niter, nrm, first, eta, it,
                                                     max_iter, tol, 1e-30)
            conv = conv | (it & (status == 1))
            eta = torch.where(it, eta_new, eta)
            it = it & (status == 0)
            if not going:
                break
        return x, conv, niter, eta

    # ------------------------------------------------------------------
    def check_root(self, cand, g0, t0, y_new, t_new, D, h, order):
        """ops.rootfind.check_root of every member of ``cand`` ->
        (found, t_root, root_idx, g1), the secant polishing each member's
        own crossing."""
        eqn, params = self.eqn, self.params

        def g_at(t, y):
            return eqn.root(self.tt(t), y, params).to(F64)

        g1 = g_at(t_new, y_new)
        g0 = g0.to(F64)
        B = self.B
        ar = torch.arange(B, device=self.dev)

        def scan(a, b):
            zero = (b == 0.0).any(-1)
            cross = a * b < 0.0
            frac = torch.where(cross, (b / (b - a)).abs(), -math.inf)
            im = torch.where(cross.any(-1), torch.argmax(frac, dim=-1), -1)
            return zero, im

        found_zero, imax = scan(g0, g1)
        no_cross = imax < 0
        idx_nc = torch.argmin(g1.abs(), dim=-1) if g1.shape[-1] else torch.zeros_like(imax)
        found = torch.where(no_cross, found_zero, True) & cand
        res_t = t_new.clone()
        res_i = torch.where(no_cross, idx_nc, imax)
        sec = cand & ~no_cross
        any_sec, any_found = self.read(torch.stack([sec.any(), found.any()]))
        if not any_sec:
            return found, res_t, res_i, g1, any_found
        tol = 100.0 * _EPS * (t_new.abs() + (t_new - t0).abs())
        t0_, t1_ = t0.clone(), t_new.clone()
        g0_, g1_ = g0.clone(), g1.clone()
        im = imax.clamp(min=0)
        alpha = torch.ones(B, dtype=F64, device=self.dev)
        sc0 = torch.zeros(B, dtype=torch.bool, device=self.dev)
        sc1 = torch.ones_like(sc0)
        i = torch.zeros(B, dtype=I64, device=self.dev)
        done = torch.zeros_like(sc0)
        while True:
            run = sec & ~done & ((t1_ - t0_).abs() > tol) & (i < _MAX_SECANT_ITERS)
            if not self.read(run.any()):
                break
            g1v, g0v = g1_[ar, im], g0_[ar, im]
            t_mid = t1_ - (t1_ - t0_) * g1v / (g1v - alpha * g0v)
            fracint = (t1_ - t0_).abs() / tol
            fracsub = torch.where(fracint > 5.0, 0.1, 0.5 / fracint)
            t_mid = torch.where((t_mid - t0_).abs() < 0.5 * tol,
                                t0_ + fracsub * (t1_ - t0_), t_mid)
            t_mid = torch.where((t1_ - t_mid).abs() < 0.5 * tol,
                                t1_ - fracsub * (t1_ - t0_), t_mid)
            t_q = torch.where(run, t_mid, t1_)
            gmid = g_at(t_q, self.interp(t_q, D, t_new, h, order))
            rootfnd, im2 = scan(g0_, gmid)
            lower = im2 >= 0
            up = run & lower
            hit = run & ~lower & rootfnd
            low = run & ~lower & ~rootfnd
            t1_ = torch.where(up, t_mid, t1_)
            g1_ = _where(up, gmid, g1_)
            im = torch.where(up, im2, im)
            res_t = torch.where(hit & sec, t_mid, res_t)
            res_i = torch.where(hit & sec, im, res_i)
            done = done | hit
            t0_ = torch.where(low, t_mid, t0_)
            g0_ = _where(low, gmid, g0_)
            even = (i % 2) == 0
            sc0 = torch.where(run & even, lower, sc0)
            sc1 = torch.where(run & ~even, lower, sc1)
            alpha = torch.where(run & (i >= 2),
                                torch.where(sc0 != sc1, 1.0,
                                            torch.where(sc0, 0.5 * alpha, 2.0 * alpha)),
                                alpha)
            i = torch.where(run, i + 1, i)
        res_t = torch.where(sec & ~done, t1_, res_t)
        res_i = torch.where(sec & ~done, im, res_i)
        return found, res_t, res_i, g1, any_found

    # ------------------------------------------------------------------
    def solve_dense(self, t_eval, max_steps: int):
        """drivers.solve_dense of every member, one step attempt of each
        unfinished member a round -> (ts, ys, gs, stop, root_t, root_idx,
        state)."""
        p, eqn, params, B, cfg, opts = self.p, self.eqn, self.params, self.B, self.cfg, self.opts
        te_host = [float(v) for v in torch.as_tensor(t_eval, dtype=F64).reshape(-1).tolist()]
        te = torch.as_tensor(te_host, dtype=F64, device=self.dev)
        neval, final_time = len(te_host), te_host[-1]
        integrate_out = p.integrate_out
        out_direct = eqn.out is not None and not integrate_out
        out_in_err = p.output_in_error_control()
        has_root = eqn.root is not None
        atol, rtol = p.atol, p.rtol
        m_newton = float(cfg.maximum_newton_iterations)
        dev = self.dev
        ar = torch.arange(B, device=dev)

        st = self.init_state(final_time)
        ys = st.y.new_zeros((neval,) + tuple(st.y.shape))
        gs = None
        if integrate_out:
            gs = st.g.new_zeros((neval,) + tuple(st.g.shape))
        elif out_direct:
            g0 = self.out(st.t, st.y)
            gs = g0.new_zeros((neval,) + tuple(g0.shape))
        written = torch.zeros((neval, B), dtype=torch.bool, device=dev)
        done = st.status < 0
        stop = torch.where(done, st.status, errors.TSTOP_REACHED)
        sol_root_t = torch.full((B,), math.nan, dtype=F64, device=dev)
        sol_root_idx = torch.full((B,), -1, dtype=I64, device=dev)
        k = st.n_steps
        fresh = torch.ones(B, dtype=torch.bool, device=dev)
        # a step's own variables (BdfSolver.step's locals), per member
        conv_fail = torch.zeros_like(fresh)
        h_changed = torch.zeros_like(fresh)
        err_fails = torch.zeros_like(k)
        safety = torch.ones(B, dtype=F64, device=dev)
        err = torch.full_like(safety, math.inf)
        prev_err = st.prev_error_norm.clone()
        n_equal0 = st.n_equal_steps.clone()
        root_g0 = st.root_g
        snap_names = ("h", "D", "gD", "order", "n_equal_steps", "eta", "prev_error_norm",
                      "steps_since_jac", "steps_since_rhs_jac", "c_last",
                      "newton_fails_total", "state_modified")
        snap = {nm: getattr(st, nm) for nm in snap_names}
        snap_stats = self.stats_mat.clone()
        fatal = torch.zeros_like(fresh)
        rounds = 0
        while True:
            run = ~done & (k < max_steps)
            fr = run & fresh
            mod = fr & st.state_modified
            any_run, any_mod, any_fatal = self.read(
                torch.stack([run.any(), mod.any(), fatal.any()]))
            if any_fatal:
                # last round's fatal attempts return to their step's start
                # (BdfSolver.step keeps the old state); they are done, so
                # nothing read them since
                self.restore(st, fatal, snap, snap_stats)
                fatal = torch.zeros_like(fatal)
            if not any_run:
                break
            rounds += 1
            # the state a fatal attempt returns to (the step's own start)
            for nm in snap_names:
                cur = getattr(st, nm)
                snap[nm] = (_where_nd(fr, cur, snap[nm]) if nm in ("D", "gD")
                            else _where(fr, cur, snap[nm]))
            snap_stats = torch.where(fr, self.stats_mat, snap_stats)
            if any_mod:
                # restart the difference matrices at order 1 from (y, dy)
                # (bdf.py's state_modified block)
                tr0 = 100.0 * _EPS * (st.t.abs() + st.h.abs())
                ov0 = mod & ~torch.isnan(st.tstop) & ((st.t - st.tstop).abs() > tr0) & torch.where(
                    st.h > 0.0, st.t + st.h > st.tstop + tr0, st.t + st.h < st.tstop - tr0)
                h_m = torch.where(ov0, st.tstop - st.t, st.h)
                Dm = torch.zeros_like(st.D)
                Dm[0] = st.y
                Dm[1] = self.s(h_m) * st.dy
                st.D = _where_nd(mod, Dm, st.D)
                if integrate_out:
                    gDm = torch.zeros_like(st.gD)
                    gDm[0] = st.g
                    gDm[1] = self.s(h_m) * self.out(st.t, st.y)
                    st.gD = _where_nd(mod, gDm, st.gD)
                st.order = torch.where(mod, 1, st.order)
                st.n_equal_steps = torch.where(mod, 0, st.n_equal_steps)
                st.prev_error_norm = torch.where(mod, math.nan, st.prev_error_norm)
                c1 = st.h * float(_ALPHA[1])
                rel1 = (c1 / st.c_last - 1.0).abs()
                rp = mod & (st.steps_since_rhs_jac >= opts.update_rhs_jacobian_after_steps)
                jp = mod & ((st.steps_since_jac >= opts.update_jacobian_after_steps)
                            | (rel1 > opts.threshold_to_update_jacobian))
                self.refresh(st, rp | jp, st.t, st.y, c1, rp, torch.zeros_like(k))
                st.eta = torch.where(ov0, ETA_RESET_TIMESTEP, st.eta)
                st.h = torch.where(mod, h_m, st.h)
                st.state_modified = st.state_modified & ~mod
            if has_root:
                root_g0 = _where(fr, eqn.root(self.tt(st.t), st.y, params), root_g0)
            conv_fail = conv_fail & ~fr
            h_changed = h_changed & ~fr
            err_fails = torch.where(fr, 0, err_fails)
            safety = torch.where(fr, 1.0, safety)
            err = torch.where(fr, math.inf, err)
            prev_err = torch.where(fr, st.prev_error_norm, prev_err)
            n_equal0 = torch.where(fr, st.n_equal_steps, n_equal0)

            # ---- one attempt (BdfSolver.step's accept loop, once)
            order, h = st.order, st.h
            Dm = self.masked(st.D, order)
            y_pred = self.predict(st.D, order, Dm)
            psi = self.psi(st.D, order, Dm)
            alpha_o = self.alpha[order]
            cval = h * alpha_o
            t_pred = st.t + h
            x, ok, niter, eta_n = self.newton(st, run, y_pred, psi, cval, t_pred)
            d = x - y_pred
            g_delta = None
            if integrate_out:
                g_delta = self.s(cval) * self.out(st.t + h, y_pred) - self.psi(st.gD, order)
            err_a = self.wnorm2(d, st.y, atol, rtol) * self.ec2[order - 1]
            if out_in_err:
                e_g = self.wnorm2(g_delta, st.g, p.out_atol, p.out_rtol) * self.ec2[order]
                err_a = torch.where(e_g > err_a, e_g, err_a)
            accepted = ok & (err_a <= 1.0)
            safety_a = _rdiv(0.9 * (2.0 * m_newton + 1.0), 2.0 * m_newton + niter.to(F64))
            first = ~ok & ~conv_fail
            second = ~ok & conv_fail
            err_fail = ok & ~accepted
            nf = run & ~ok
            st.newton_fails_total = st.newton_fails_total + nf.to(I64)
            too_many = nf & (st.newton_fails_total > cfg.maximum_newton_fails)
            acc = run & accepted
            err_n = torch.where(run & ok, err_a, err)
            # the accepted step's difference update and the error norms of
            # its neighbour orders (bdf.py:549-575), ahead of the
            # controller so that all its powers take one read
            D_new = self.update_diff(st.D, d, order)
            y_new = D_new[0]
            em = self.wnorm2(D_new[order, ar], y_new, atol, rtol) * self.ec2[(order - 1).clamp(min=0)]
            em = torch.where(order > 1, em, math.inf)
            ep = (self.wnorm2(D_new[(order + 2).clamp(max=ND - 1), ar], y_new, atol, rtol)
                  * self.ec2[(order + 1).clamp(max=MAX_ORDER)])
            ep = torch.where(order < MAX_ORDER, ep, math.inf)
            # an accepted attempt rescaled nothing, so h_changed is the step's
            sel = torch.where(h_changed, 1, n_equal0 + 1) > order
            pis = self.pi_raw(torch.stack([err_a, em, err_n, ep]),
                              torch.stack([prev_err, err_n, err_n, err_n]),
                              torch.stack([order + 1, order, order + 1, order + 2]),
                              torch.stack([run & err_fail] + [acc & sel] * 3))
            raw, f3 = pis[0], pis[1:]
            rej = safety_a * raw
            rej = torch.where(cfg.minimum_timestep_shrink > rej, cfg.minimum_timestep_shrink, rej)
            factor = torch.where(err_fail, rej, 0.3)
            do_rescale = run & (err_fail | second)
            h_new = h * torch.where(do_rescale, factor, 1.0)
            c_jac = h_new * alpha_o
            rel = (c_jac / st.c_last - 1.0).abs()
            rhs_f = ((first & (rel < opts.threshold_to_update_rhs_jacobian))
                     | (second & (st.steps_since_rhs_jac > 0)))
            stats = st.stats
            ni = torch.where(run, niter, 0)
            stats.newton_iterations += ni
            stats.newton_fails += nf.to(I64)
            stats.error_test_failures += (run & err_fail).to(I64)
            stats.rhs_evals += ni
            st.eta = torch.where(run, eta_n, st.eta)
            cause_f = torch.where(first, 1, torch.where(second, 2, 3))
            rejected = run & ~accepted
            err_fails = err_fails + (run & err_fail).to(I64)
            status_f = torch.zeros_like(k)
            status_f = torch.where(err_fail & (err_fails >= cfg.maximum_error_test_failures),
                                   errors.TOO_MANY_ERROR_TEST_FAILURES, status_f)
            status_f = torch.where(do_rescale & (h_new.abs() < cfg.minimum_timestep),
                                   errors.STEP_SIZE_TOO_SMALL, status_f)
            status_f = torch.where(too_many, errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES, status_f)
            status_f = torch.where(run, status_f, 0)
            conv_fail = conv_fail | nf
            err = err_n
            safety = torch.where(run & ok, safety_a, safety)
            prev_err = torch.where(rejected, math.nan, prev_err)
            h_changed = h_changed | do_rescale

            # ---- the accepted step (bdf.py:549-566)
            t_new = st.t + h
            dy_new = D_new[1] / self.s(h)
            g_new, gD_new = st.g, st.gD
            if integrate_out:
                g_new = self.predict(st.gD, order) + g_delta
                gD_new = self.update_diff(st.gD, g_delta, order)
            one = acc.to(I64)
            stats.steps += one
            st.steps_since_jac = st.steps_since_jac + one
            st.steps_since_rhs_jac = st.steps_since_rhs_jac + one
            n_equal = torch.where(h_changed, 1, n_equal0 + 1)
            # ---- order selection (bdf.py:568-610)
            sel = n_equal > order
            max_index = torch.argmax(f3, dim=0)
            sf = safety * f3[max_index, ar]
            sf = torch.where(cfg.maximum_timestep_growth < sf, cfg.maximum_timestep_growth, sf)
            sf = torch.where(cfg.minimum_timestep_shrink > sf, cfg.minimum_timestep_shrink, sf)
            do_change = sel & ((sf >= cfg.minimum_timestep_growth)
                               | (sf <= cfg.maximum_timestep_shrink) | (max_index != 1))
            new_order = order + max_index - 1
            order_new = torch.where(do_change, new_order, order)
            h_acc = h * torch.where(do_change, sf, 1.0)
            D_new, gD_new = self.rescale(acc & do_change, new_order, sf, D_new, gD_new)
            st.eta = torch.where(acc & do_change, ETA_RESET_TIMESTEP, st.eta)
            c2 = h_acc * self.alpha[order_new]
            rel2 = (c2 / st.c_last - 1.0).abs()
            rhs2 = do_change & (st.steps_since_rhs_jac >= opts.update_rhs_jacobian_after_steps)
            jac2 = do_change & ((st.steps_since_jac >= opts.update_jacobian_after_steps)
                                | (rel2 > opts.threshold_to_update_jacobian))
            # one refresh for the rejected members (the failure ladder's)
            # and the accepted ones whose order or step changed
            self.refresh(st, rejected | (acc & (rhs2 | jac2)),
                         torch.where(acc, t_new, st.t), _where(acc, y_new, st.y),
                         torch.where(acc, c2, c_jac), torch.where(acc, rhs2, rhs_f),
                         torch.where(acc, 4, cause_f))
            n_equal_new = torch.where(do_change, 0, n_equal)
            step_stop = torch.where(do_change & (h_acc.abs() < cfg.minimum_timestep),
                                    errors.STEP_SIZE_TOO_SMALL, errors.INTERNAL_TIMESTEP)
            # ---- the root check on the accepted interpolant (bdf.py:612-624)
            step_root_t = torch.full_like(t_new, math.nan)
            step_root_idx = torch.full_like(k, -1)
            root_g_new = st.root_g
            any_found = False
            if has_root:
                found, rt, ri, g1, any_found = self.check_root(
                    acc, root_g0, st.t, y_new, t_new, D_new, h_acc, order_new)
                froot = found & (step_stop == errors.INTERNAL_TIMESTEP)
                step_stop = torch.where(froot, errors.ROOT_FOUND, step_stop)
                step_root_t = torch.where(froot, rt, step_root_t)
                step_root_idx = torch.where(froot, ri, step_root_idx)
                root_g_new = _where(acc, g1.to(st.root_g.dtype), st.root_g)
            # ---- tstop, in-step form (bdf.py:626-643)
            has_ts = ~torch.isnan(st.tstop)
            tr1 = 100.0 * _EPS * (t_new.abs() + h_acc.abs())
            reached = has_ts & ((t_new - st.tstop).abs() <= tr1)
            over = has_ts & ~reached & torch.where(h_acc > 0.0, t_new + h_acc > st.tstop + tr1,
                                                   t_new + h_acc < st.tstop - tr1)
            ts_factor = (st.tstop - t_new) / h_acc
            D_new, gD_new = self.rescale(acc & over, order_new, ts_factor, D_new, gD_new)
            h_acc = torch.where(over, h_acc * ts_factor, h_acc)
            n_equal_new = torch.where(over, 0, n_equal_new)
            st.eta = torch.where(acc & over, ETA_RESET_TIMESTEP, st.eta)
            step_stop = torch.where((step_stop == errors.INTERNAL_TIMESTEP) & reached,
                                    errors.TSTOP_REACHED, step_stop)

            # ---- commit: the rejected attempt's D and h, the accepted step,
            # the fatal attempt's return to the step's start
            st.D, st.gD = self.rescale(do_rescale, order, factor, st.D, st.gD)
            st.D = _where_nd(acc, D_new, st.D)
            st.gD = _where_nd(acc, gD_new, st.gD)
            st.h = torch.where(acc, h_acc, torch.where(run, h_new, st.h))
            st.y = _where(acc, y_new, st.y)
            st.dy = _where(acc, dy_new, st.dy)
            st.g = _where(acc, g_new, st.g)
            st.t = torch.where(acc, t_new, st.t)
            st.order = torch.where(acc, order_new, st.order)
            st.n_equal_steps = torch.where(acc, n_equal_new, st.n_equal_steps)
            st.prev_error_norm = torch.where(acc, err, st.prev_error_norm)
            st.root_g = root_g_new
            st.root_t = torch.where(acc, step_root_t, st.root_t)
            st.root_idx = torch.where(acc, step_root_idx, st.root_idx)
            fatal = run & (status_f != 0)
            st.status = torch.where(fatal, status_f, torch.where(acc, step_stop, st.status))
            fin = acc | fatal
            k = k + fin.to(I64)
            fresh = fin | (fresh & ~run)

            # ---- the driver: the t_eval points the step passed
            wr = acc & (step_stop >= 0)
            t_up = torch.where(step_stop == errors.ROOT_FOUND, step_root_t, t_new)
            t_up = torch.where((step_stop == errors.TSTOP_REACHED) & (final_time > t_up),
                               final_time, t_up)
            mask = wr[None, :] & ~written & (te[:, None] <= t_up[None, :])
            te_b = te[:, None].expand(neval, B)
            vals = self.interp(te_b, st.D, st.t, st.h, st.order)
            ys = torch.where(mask[..., None], vals, ys)
            if integrate_out:
                gs = torch.where(mask[..., None],
                                 self.interp(te_b, st.gD, st.t, st.h, st.order), gs)
            elif out_direct:
                o = self.out(te_b.reshape(-1), vals.reshape(neval * B, -1),
                             params.repeat(neval, 1)).reshape(neval, B, -1)
                gs = torch.where(mask[..., None], o, gs)
            written = written | mask

            # ---- the root protocol (drivers._after_step)
            done = done | fatal
            stop = torch.where(fatal, status_f, stop)
            neg = acc & (step_stop < 0)
            done = done | neg
            stop = torch.where(neg, step_stop, stop)
            tsr = acc & (step_stop == errors.TSTOP_REACHED)
            done = done | tsr
            stop = torch.where(tsr, errors.TSTOP_REACHED, stop)
            if any_found:
                rf = acc & (step_stop == errors.ROOT_FOUND)
                self.pin(st, rf, step_root_t)
                if eqn.reset is None:
                    done = done | rf
                    stop = torch.where(rf, errors.ROOT_FOUND, stop)
                    sol_root_t = torch.where(rf, st.t, sol_root_t)
                    sol_root_idx = torch.where(rf, st.root_idx, sol_root_idx)
                else:
                    rs_status = self.apply_reset(st, rf)
                    bad = rf & (rs_status < 0)
                    done = done | bad
                    stop = torch.where(bad, rs_status, stop)
                    past = rf & ~bad & (st.t >= final_time)
                    done = done | past
                    stop = torch.where(past, errors.TSTOP_REACHED, stop)
        stop = torch.where(done, stop, errors.MAX_STEPS_REACHED)
        st.n_steps = k
        st.rounds = rounds
        st.host_reads = self.reads
        st.newton_sweeps = self.newton_sweeps
        return te, ys, gs, stop, sol_root_t, sol_root_idx, st

    def restore(self, st, mask, snap, snap_stats):
        """The members of ``mask`` back to their step's start."""
        for nm, old in snap.items():
            cur = getattr(st, nm)
            setattr(st, nm, _where_nd(mask, old, cur) if nm in ("D", "gD")
                    else _where(mask, old, cur))
        self.stats_mat.copy_(torch.where(mask, snap_stats, self.stats_mat))

    def pin(self, st, mask, t_root):
        """state_mut_back for the members of ``mask``: the state moved back
        to ``t_root`` inside the last step (drivers._pin_to)."""
        tq = torch.where(mask, t_root, st.t)
        st.y = _where(mask, self.interp(tq, st.D, st.t, st.h, st.order), st.y)
        st.dy = _where(mask, self.interp_deriv(tq, st.D, st.t, st.h, st.order), st.dy)
        if self.p.integrate_out:
            st.g = _where(mask, self.interp(tq, st.gD, st.t, st.h, st.order), st.g)
        st.t = tq
        st.state_modified = st.state_modified | mask

    def apply_reset(self, st, mask):
        """The reset operator for the members of ``mask``, dy refreshed and a
        DAE's consistency solved again (drivers._apply_reset,
        BdfSolver.reinit_after_reset); returns each member's status."""
        eqn, params = self.eqn, self.params
        t = self.tt(st.t)
        if eqn.reset_n is not None:
            y_new = eqn.reset_n(t, st.y, params, st.root_idx.clamp(min=0))
        else:
            y_new = eqn.reset(t, st.y, params)
        st.y = _where(mask, y_new, st.y)
        st.dy = _where(mask, eqn.rhs(t, st.y, params), st.dy)
        status = torch.zeros_like(st.status)
        if self.alg is not None:
            st.y, st.dy, status = self.make_consistent(st.t, st.y, st.dy, mask)
        st.status = torch.where(mask, status, st.status)
        return status


def _scatter_factors(factors, idx, sub):
    """Write a subset's factorization into the batch's, in place: the band
    LU's (n+mu, nb, B) factors along their member axis and its band along
    the first, the dense LU's (lu, pivots) along the first."""
    if isinstance(factors, BandFactors):
        factors.lu.index_copy_(2, idx, sub.lu)
        factors.band.index_copy_(0, idx, sub.band)
    else:
        for full, part in zip(factors, sub):
            full.index_copy_(0, idx, part)


def _expand_factors(sub, idx, B):
    """A batch's factorization holding a subset's (the rest zero, never
    read: only the subset's members solve before their own refresh)."""
    if isinstance(sub, BandFactors):
        lu = sub.lu.new_zeros(sub.lu.shape[:2] + (B,))
        band = sub.band.new_zeros((B,) + sub.band.shape[1:])
        full = BandFactors(lu, band)
    else:
        full = [part.new_zeros((B,) + part.shape[1:]) for part in sub]
        if len(full) > 1:  # pivots of a never-refreshed member: the identity
            full[1] += torch.arange(1, sub[1].shape[-1] + 1, dtype=sub[1].dtype,
                                    device=sub[1].device)
            full[0] += torch.eye(sub[0].shape[-1], dtype=sub[0].dtype, device=sub[0].device)
    _scatter_factors(full, idx, sub)
    return full


def solve_dense_independent(solver: BdfSolver, t_eval, params_batch: torch.Tensor,
                            max_steps: int = 100_000):
    """Every member of ``params_batch`` (B, nparams) solved with its own
    step control, in one batched loop on the params' device (the solver's
    problem must lie there).  Returns a
    :class:`~diffsol_tpu_torch.drivers.Solution` with ``ys`` (neval, B,
    n), ``stop_reason``, ``root_t`` and ``root_idx`` as (B,) tensors and
    ``state`` the batched :class:`IndependentState`."""
    from ..drivers import Solution

    run = _Batched(solver, params_batch)
    te, ys, gs, stop, root_t, root_idx, st = run.solve_dense(t_eval, max_steps)
    return Solution(ts=te, ys=ys, stop_reason=stop, n_points=int(te.numel()),
                    state=st, gs=gs, root_t=root_t, root_idx=root_idx,
                    tier="independent")
