"""What the batched independent-ensemble loops share: B members in one loop,
each with its own step control (counterpart of ``jax.vmap`` over a
solver's ``step`` and ``diffsol_tpu.drivers.solve_dense``, as
``diffsol_tpu.ensemble``'s ``mode="independent"`` runs them).

:class:`BatchedLoop` holds the solve loop and the host control; a method
family brings its state and its step attempt (:mod:`.bdf_independent`,
:mod:`.rk_independent`).  :func:`takes` says which solvers and tiers run
batched (augmented equation sets other than the forward sensitivities do
not), and :func:`solve_dense_independent` runs them.

* **The solve loop** (:meth:`BatchedLoop.solve_dense`, drivers.solve_dense
  of every member): one step attempt of every unfinished member a round;
  a fatal attempt's return to its step's start; ``max_steps`` a member;
  the ``t_eval`` points each accepted step passed (a (neval, B) written
  mask); the root protocol (the pin to a root, its reset and the
  sensitivity jump across it, the stop at a root without a reset); the
  (B,) ``stop_reason``, ``root_t`` and ``root_idx``.
* **The host control**: the step control's powers run on the host, since
  the single solve's control is Python floats, whose ``**`` is C's pow,
  and a device's pow (or PyTorch's vectorized one on the CPU) may round
  differently in the last bit, which is enough to change a step.  So the
  Newton convergence test and the PI controller read their (B,) operands,
  compute each member's powers with :func:`math.pow` and the rest in
  numpy's float64 arithmetic, which rounds as Python's, and send the
  results back (:meth:`~BatchedLoop.converge`, :meth:`~BatchedLoop.pi_raw`,
  :meth:`~BatchedLoop.pow`).  A number over a tensor divides once
  (:func:`_rdiv`).
* **Newton masked per member** (:meth:`~BatchedLoop.newton`): a member
  that converged or diverged is frozen, and the loop ends when none
  iterates; the augmented rows' Newton takes the same form, its norm the
  largest row's.  The consistent initial conditions of a DAE
  (:meth:`~BatchedLoop.make_consistent`) and the root search on each
  member's interpolant (:meth:`~BatchedLoop.check_root`) run per member
  the same way.
* **Factorizations of a subset**: the refreshed members' matrices are
  factored alone and written into the batch's (:func:`_scatter_factors`):
  a dense (B, n, n) LU, the banded tier's (n+mu, nb, B) factors (K3 on the
  card), the block tier's (B K, nb, nb) stack, each member against its
  own K blocks, or the Krylov tier's frozen points and preconditioners
  (a :class:`~diffsol_tpu_torch.ops.krylov.MemberFactors`).
* **The Krylov tier** (``krylov_independent``): every member its own
  frozen point, float32 LU or tridiagonal preconditioner and GMRES
  (:func:`~diffsol_tpu_torch.ops.krylov.gmres_batched`), run for the
  members that iterate (:meth:`~BatchedLoop.lin_solve`); the (B,)
  restarts and Arnoldi iterations of each member end on the state
  (``gmres_restarts``, ``gmres_arnoldi``).  A GMRES call reads the device
  once a restart round, whatever B (``ops.krylov.gmres_counts``).

The members' vectors are member-major (B, n) as in the lockstep lift, the
augmented rows (naug, B, n) as a lockstep ensemble's; the callables are
the lift of :func:`~diffsol_tpu_torch.ensemble.make_lockstep_problem`
with ``member_t=True`` (each member at its own time), and the WRMS norms
stop at the mean over a member's states
(:func:`~diffsol_tpu_torch.norms.scaled_per_member`).

The loop reads the host a bounded number of times a round, whatever B:
once for whether any member is unfinished (and whether one restarts or
failed), once per Newton iteration, once for the step-size controller,
once per refresh of a subset and once per secant iteration of a root
search.  ``rounds`` and ``host_reads`` count them on the final state.
"""

from __future__ import annotations

import math
from dataclasses import fields

import numpy as np
import torch

from .. import errors
from ..norms import error_scale, scaled_per_member
from ..ops.band_lu import BandFactors
from ..ops.krylov import MemberFactors
from ..ops.newton import ETA_RESET_JACOBIAN
from .consistent_ic import algebraic_mask
from .rk_common import Stats

F64 = torch.float64
I64 = torch.int64

_CAUSES = ("lu_from_checkpoint", "lu_from_first_fail", "lu_from_second_fail",
           "lu_from_error_test", "lu_from_step_success")
_MAX_SECANT_ITERS = 100
_TINY, _HUGE = 1e-30, 1e30
_EPS = float(np.finfo(np.float64).eps)


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


def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


def _f64(x: torch.Tensor) -> torch.Tensor:
    return _cast(x, F64)


def _where(mask, a, b):
    """``torch.where`` with a (B,) mask broadcast over trailing axes (field
    by field for a tuple of such tensors: the Krylov tier's frozen
    points)."""
    if isinstance(a, tuple):
        return type(a)(*(_where(mask, x, y) for x, y in zip(a, b)))
    while mask.ndim < a.ndim:
        mask = mask.unsqueeze(-1)
    return torch.where(mask, a, b)


def _where_nd(mask, a, b):
    """The same for ND-leading tensors (ND, B, ...)."""
    m = mask.unsqueeze(0)
    while m.ndim < a.ndim:
        m = m.unsqueeze(-1)
    return torch.where(m, a, b)


def _wm(mask, a, b):
    """``torch.where`` with a (B,) mask on the member axis of a tensor whose
    last two axes are (B, n): a state (B, n), the rows (naug, B, n), D
    (ND, B, n), stage values (s, B, n) or (s, naug, B, n); a (B,) tensor as
    it is."""
    return torch.where(mask if a.ndim < 2 else mask[:, None], a, b)


def member_stats(stats: Stats, b: int) -> Stats:
    """Member ``b``'s counters as the single solve's :class:`Stats`."""
    return Stats(**{f.name: int(getattr(stats, f.name)[b]) for f in fields(Stats)})


def takes(solver) -> bool:
    """Whether ``mode="independent"`` runs this solver batched: a
    :class:`~.bdf.BdfSolver` or :class:`~.sdirk.SdirkSolver` over the dense
    tier (any mass), the banded, the block-diagonal or the matrix-free
    Krylov tier, or an :class:`~.erk.ErkSolver` (which solves no linear
    system), each with no augmented rows or the forward sensitivities."""
    from ..augmented import SensEquations
    from .bdf import BdfSolver
    from .erk import ErkSolver
    from .sdirk import SdirkSolver

    if solver.aug is not None and type(solver.aug) is not SensEquations:
        return False
    if type(solver) is ErkSolver:
        return True
    name = solver.problem.linear_solver.name
    return (type(solver) in (BdfSolver, SdirkSolver)
            and (name == "dense" or name.startswith(("banded", "blockdiag", "krylov("))))


def solve_dense_independent(solver, t_eval, params_batch: torch.Tensor,
                            max_steps: int = 100_000):
    """Every member of ``params_batch`` (B, nparams) solved with its own
    step control, in one batched loop on the params' device (the solver's
    problem must lie there): :mod:`.bdf_independent`'s for a
    :class:`~.bdf.BdfSolver`, :mod:`.rk_independent`'s for an SDIRK or ERK
    solver.  Returns a :class:`~diffsol_tpu_torch.drivers.Solution` with
    ``ys`` (neval, B, n), ``sens`` (neval, naug, B, n) with the forward
    sensitivities, ``stop_reason``, ``root_t`` and ``root_idx`` as (B,)
    tensors and ``state`` the batched state."""
    from ..drivers import Solution
    from .bdf import BdfSolver
    from .bdf_independent import _Batched
    from .rk_independent import RkBatched

    run = (_Batched if type(solver) is BdfSolver else RkBatched)(solver, params_batch)
    te, ys, gs, ss, stop, root_t, root_idx, st = run.solve_dense(t_eval, max_steps)
    return Solution(ts=te, ys=ys, stop_reason=stop, n_points=int(te.numel()),
                    state=st, gs=gs, root_t=root_t, root_idx=root_idx,
                    tier="independent", sens=ss)


class BatchedLoop:
    """The solve loop and the host control of one independent ensemble solve;
    see the module docstring.  A subclass sets ``SNAP`` (the state fields
    a step's attempts change, which a fatal attempt restores) and brings
    ``init_state``, ``begin``, ``attempt``, ``at`` and ``dense_output``."""

    SNAP: tuple = ()

    def __init__(self, solver, params_b: torch.Tensor, lifted=None):
        from ..augmented import SensEquations
        from ..ensemble import make_lockstep_problem

        p = solver.problem
        self.p = p
        self.cfg = solver.config
        self.opts = p.options
        self.B = params_b.shape[0]
        # the member-time lift of the solver's problem, or the caller's own
        # (the independent adjoint's, whose members read their own tables)
        lp = lifted if lifted is not None else make_lockstep_problem(p, self.B, member_t=True)
        self.eqn = lp.eqn
        # the lift's tier: the block tier's member and block axes fuse into
        # one (B K, nb, nb) stack; the dense and banded tiers are unchanged
        self.spec = lp.linear_solver
        self.banded = self.spec.name.startswith("banded")
        # the Krylov tier: each member's GMRES counts, added by every call
        self.krylov = self.spec.name.startswith("krylov")
        self.gmres = self.spec.meta[-1] if self.krylov else None
        self.params = params_b
        self.dev = params_b.device
        self.dtype = p.dtype
        self.eps = float(torch.finfo(self.dtype).eps)
        self.alg = algebraic_mask(p)
        self.jvp_probes = getattr(p.eqn.rhs_jac, "jvp_probes", p.eqn.nstates)
        # the forward sensitivities over the member-time lift
        self.aug = SensEquations(lp) if solver.has_sens else None
        self.sens = self.aug is not None
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
        """(B,) control scalars onto (B, n) state tensors (and onto the
        (naug, B, n) rows)."""
        return self.tt(x).unsqueeze(-1)

    def out(self, t, y, params=None):
        params = self.params if params is None else params
        return y if self.eqn.out is None else self.eqn.out(self.tt(t), y, params)

    def wnorm2(self, x, y, atol, rtol):
        """Each member's squared WRMS norm, (B,) in float64; for the rows
        (naug, B, n) the largest row's."""
        sq = _f64(scaled_per_member(x, error_scale(y, atol, rtol)))
        return sq if sq.ndim == 1 else sq.amax(0)

    def new_stats(self) -> Stats:
        """A :class:`Stats` of (B,) counters, each a row of one (nstats, B)
        matrix (``stats_mat``), so that a step's start and a fatal
        attempt's return take one copy of them."""
        self.stats_mat = torch.zeros((len(fields(Stats)), self.B), dtype=I64, device=self.dev)
        return Stats(**{f.name: self.stats_mat[i] for i, f in enumerate(fields(Stats))})

    # ------------------------------------------------------------------
    # the control's powers, on the host as the single solve takes them
    def to_host(self, *xs):
        """One read of float64 rows broadcast to a common shape -> a numpy
        (len(xs), size) array."""
        self.reads += 1
        rows = torch.broadcast_tensors(*[torch.as_tensor(x, dtype=F64, device=self.dev)
                                         for x in xs])
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
        shape = torch.broadcast_shapes(torch.as_tensor(err).shape, torch.as_tensor(prev).shape,
                                       torch.as_tensor(eff_order).shape,
                                       torch.as_tensor(mask).shape)
        return self.to_dev(out, shape)

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
    def newton(self, residual, x0, scale, factors, eta0, it):
        """newton_solve for every member of ``it`` against its own factors,
        each frozen once it converged or diverged -> (x, converged, niter,
        eta).  ``x0`` is the state (B, n) or the rows (naug, B, n), whose
        convergence norm is the largest row's."""
        tol = float(self.opts.nonlinear_solver_tolerance)
        max_iter = self.cfg.maximum_newton_iterations
        x = x0
        eta = eta0.clone()
        first = torch.zeros_like(eta)
        niter = torch.zeros(self.B, dtype=I64, device=self.dev)
        conv = torch.zeros_like(it)
        it = it.clone()  # the caller has read that some member runs
        for sweep in range(1, max_iter + 1):
            self.newton_sweeps += 1
            delta = self.lin_solve(factors, residual(x), it)
            x = _wm(it, x - delta, x)
            sq = scaled_per_member(delta, scale)
            nrm = torch.sqrt(_f64(sq if sq.ndim == 1 else sq.amax(0)))
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

    def lin_solve(self, factors, b, active):
        """The tier's solve of ``b`` (B, n) or the rows (naug, B, n); the
        Krylov tier's GMRES runs for the members of ``active`` alone (the
        others' columns come back zero and are not counted)."""
        if self.krylov:
            return self.spec.solve(factors, b, active)
        return self.spec.solve(factors, b)

    def c_of(self, c, jac):
        """The step's (B,) c onto the tier's Jacobian stack ((B,) for the
        Krylov tier's frozen points)."""
        return c.to(self.dtype).view(-1, *([1] * (jac.ndim - 1)))

    # ------------------------------------------------------------------
    def initial_step_size(self, t, y0, dy0, order: int):
        """state.initial_step_size for every member (a method of
        ``order``)."""
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
                         self.pow(_rdiv(0.01, max_d), 1.0 / (1.0 + order), max_d >= 1e-15))
        return sgn * torch.minimum(100.0 * h0, h1)

    def sens_start(self, t, y, dy):
        """SensEquations.start at each member's time: the rows dy0/dp and
        their derivative, a DAE's algebraic rows made consistent -> (S,
        dS), each (naug, B, n)."""
        aug, params = self.aug, self.params
        init = self.eqn.init
        t0 = self.p.t0
        S = aug._param_rows(lambda pp: init(t0, pp), params)
        tt = self.tt(t)
        if self.alg is not None:
            return aug.consistent_init(tt, y, dy, params, S, self.alg)
        return S, aug.rhs(tt, y, params, S)

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

            def lin_solve(factors, b, active):
                return self.spec.solve(factors, b)
        elif self.krylov:
            # matrix-free, each member its own GMRES (consistent_ic.py's
            # make_matfree_residual_solver, per member)
            from ..ops.krylov import make_matfree_residual_solver

            fac_b, lin_solve = make_matfree_residual_solver(residual, per_member=True,
                                                            counts=self.gmres)

            def factorize(x, sel):
                return fac_b(x, lambda xx: residual(xx, sel))
        else:
            # the dense and block tiers take the single solve's dense branch
            def factorize(x, sel):
                return DENSE.factor(_blockwise_jacfwd(lambda xx: residual(xx, sel), x))

            def lin_solve(factors, b, active):
                return DENSE.solve(factors, b)

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
            d_new = lin_solve(factors, residual(z), live)
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
    def check_root(self, cand, g0, t0, y_new, t_new, interp):
        """ops.rootfind.check_root of every member of ``cand`` ->
        (found, t_root, root_idx, g1, whether any member found one), the
        secant polishing each member's own crossing on its interpolant
        ``interp(t)`` ((B,) times -> (B, n))."""
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
            gmid = g_at(t_q, interp(t_q))
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
    def solve_dense(self, t_eval, max_steps: int, recorder=None):
        """drivers.solve_dense of every member, one step attempt of each
        unfinished member a round -> (ts, ys, gs, sens, stop, root_t,
        root_idx, state).  A ``recorder`` (the independent adjoint's
        forward pass) sees the initial state (``start``), each member's
        accepted steps (``step``) and each reset event (``event``, which
        returns the members past its capacity: they stop with
        EVENT_CAPACITY_EXCEEDED)."""
        p, eqn, params, B = self.p, self.eqn, self.params, self.B
        te_host = [float(v) for v in torch.as_tensor(t_eval, dtype=F64).reshape(-1).tolist()]
        te = torch.as_tensor(te_host, dtype=F64, device=self.dev)
        neval, final_time = len(te_host), te_host[-1]
        integrate_out = p.integrate_out
        out_direct = eqn.out is not None and not integrate_out
        dev = self.dev

        st = self.init_state(final_time)
        ys = st.y.new_zeros((neval,) + tuple(st.y.shape))
        ss = None if st.s is None else st.s.new_zeros((neval,) + tuple(st.s.shape))
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
        if recorder is not None:
            recorder.start(st)
        self.begin(st)
        snap = {nm: getattr(st, nm) for nm in self.SNAP}
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
                # (the single solver's step keeps the old state); they are
                # done, so nothing read them since
                self.restore(st, fatal, snap, snap_stats)
                fatal = torch.zeros_like(fatal)
            if not any_run:
                break
            rounds += 1
            # the state a fatal attempt returns to (the step's own start)
            for nm in self.SNAP:
                snap[nm] = _wm(fr, getattr(st, nm), snap[nm])
            snap_stats = torch.where(fr, self.stats_mat, snap_stats)

            # ---- one attempt of every member of ``run``, committed
            acc, status_f, step_stop, step_root_t, any_found = self.attempt(
                st, run, fr, mod, any_mod)
            fatal = run & (status_f != 0)
            st.status = torch.where(fatal, status_f, torch.where(acc, step_stop, st.status))
            fin = acc | fatal
            k = k + fin.to(I64)
            fresh = fin | (fresh & ~run)

            # ---- drivers.solve_dense: the t_eval points the step passed
            wr = acc & (step_stop >= 0)
            t_up = torch.where(step_stop == errors.ROOT_FOUND, step_root_t, st.t)
            t_up = torch.where((step_stop == errors.TSTOP_REACHED) & (final_time > t_up),
                               final_time, t_up)
            mask = wr[None, :] & ~written & (te[:, None] <= t_up[None, :])
            te_b = te[:, None].expand(neval, B)
            vals, gvals, svals = self.dense_output(st, te_b)
            ys = torch.where(mask[..., None], vals, ys)
            if integrate_out:
                gs = torch.where(mask[..., None], gvals, gs)
            elif out_direct:
                o = self.out(te_b.reshape(-1), vals.reshape(neval * B, -1),
                             params.repeat(neval, 1)).reshape(neval, B, -1)
                gs = torch.where(mask[..., None], o, gs)
            if ss is not None:
                ss = torch.where(mask[:, None, :, None], svals, ss)
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
            rf = None
            if any_found:
                rf = acc & (step_stop == errors.ROOT_FOUND)
                self.pin(st, rf, step_root_t)
                if eqn.reset is None:
                    done = done | rf
                    stop = torch.where(rf, errors.ROOT_FOUND, stop)
                    sol_root_t = torch.where(rf, st.t, sol_root_t)
                    sol_root_idx = torch.where(rf, st.root_idx, sol_root_idx)
                else:
                    pinned = (st.t, st.y, st.dy)
                    rs_status = self.apply_reset(st, rf)
                    if recorder is not None:
                        over = recorder.event(rf, pinned, st)
                        rs_status = torch.where(over, errors.EVENT_CAPACITY_EXCEEDED, rs_status)
                        st.status = torch.where(over, errors.EVENT_CAPACITY_EXCEEDED,
                                                st.status)
                    bad = rf & (rs_status < 0)
                    done = done | bad
                    stop = torch.where(bad, rs_status, stop)
                    past = rf & ~bad & (st.t >= final_time)
                    done = done | past
                    stop = torch.where(past, errors.TSTOP_REACHED, stop)
            if recorder is not None:
                kept = acc & (step_stop >= 0)
                recorder.step(kept if rf is None else kept & ~rf, st)
        stop = torch.where(done, stop, errors.MAX_STEPS_REACHED)
        st.n_steps = k
        st.rounds = rounds
        st.host_reads = self.reads
        st.newton_sweeps = self.newton_sweeps
        if self.krylov:
            zero = torch.zeros(B, dtype=I64, device=dev)
            st.gmres_restarts, st.gmres_arnoldi = (
                zero if self.gmres[k] is None else self.gmres[k] for k in ("restarts", "arnoldi"))
        return te, ys, gs, ss, stop, sol_root_t, sol_root_idx, st

    def restore(self, st, mask, snap, snap_stats):
        """The members of ``mask`` back to their step's start."""
        for nm, old in snap.items():
            setattr(st, nm, _wm(mask, old, getattr(st, nm)))
        self.stats_mat.copy_(torch.where(mask, snap_stats, self.stats_mat))

    def pin(self, st, mask, t_root):
        """state_mut_back for the members of ``mask``: the state (and the
        rows) moved back to ``t_root`` inside the last step
        (drivers._pin_to)."""
        tq = torch.where(mask, t_root, st.t)
        y, dy, g, s = self.at(st, tq)
        st.y = _where(mask, y, st.y)
        st.dy = _where(mask, dy, st.dy)
        if g is not None:
            st.g = _where(mask, g, st.g)
        if s is not None:
            st.s = _wm(mask, s, st.s)
        st.t = tq
        st.state_modified = st.state_modified | mask

    def apply_reset(self, st, mask):
        """The reset operator for the members of ``mask``, dy refreshed, a
        DAE's consistency solved again and the rows' jump across the reset
        (drivers._apply_reset, the solvers' reinit_after_reset); returns
        each member's status."""
        eqn, params = self.eqn, self.params
        t = self.tt(st.t)
        y_minus, dy_minus, s_minus = st.y, st.dy, st.s
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
        if self.sens:
            s_new = self.aug.apply_reset(t, y_minus, dy_minus, st.y, st.dy, params, s_minus,
                                         st.root_idx.clamp(min=0))
            st.s = _wm(mask, s_new, st.s)
        return status

    # ------------------------------------------------------------------
    def factor_subset(self, st, idx, t_s, jac_s, c_s):
        """M - c J of the members ``idx`` at their times, factored alone
        (K3 on the card's banded tier) and written into the batch's
        factors."""
        pb = self.params.index_select(0, idx)
        a = self.spec.assemble(self.eqn.mass_repr(self.tt(t_s), pb), jac_s,
                               self.c_of(c_s, jac_s))
        _scatter_factors(st.factors, idx, self.spec.factor(a))


def _member_rows(x, r):
    """A factorization's (B r, ...) stack as (B, r, ...): r rows a member
    (one for the dense tier, the K blocks of the block tier)."""
    return x.view((-1, r) + tuple(x.shape[1:]))


def _scatter_tree(full, idx, sub):
    """Every tensor of a :class:`MemberFactors` (nested tuples, None kept)
    written along its leading member axis."""
    if isinstance(full, torch.Tensor):
        full.index_copy_(0, idx, sub)
    elif full is not None:
        for a, b in zip(full, sub):
            _scatter_tree(a, idx, b)


def _expand_tree(sub, B):
    """A :class:`MemberFactors` of B members, zeros (pivots the identity's)
    outside the subset's, which the caller writes."""
    if sub is None:
        return None
    if isinstance(sub, torch.Tensor):
        if sub.dtype in (torch.int32, torch.int64):  # LU pivots
            return torch.arange(1, sub.shape[-1] + 1, dtype=sub.dtype,
                                device=sub.device).expand((B,) + sub.shape[1:]).clone()
        return sub.new_zeros((B,) + sub.shape[1:])
    parts = [_expand_tree(x, B) for x in sub]
    return type(sub)(*parts) if hasattr(sub, "_fields") else type(sub)(parts)


def _scatter_factors(factors, idx, sub):
    """Write a subset's factorization into the batch's, in place: the band
    LU's (n+mu, nb, B) factors along their member axis and its band along
    the first; the dense LU's (lu, pivots) and the block tier's (B K, nb,
    nb) stack along the first, a member's rows together; the Krylov tier's
    frozen points and preconditioners along the first."""
    if isinstance(factors, MemberFactors):
        _scatter_tree(factors, idx, sub)
    elif isinstance(factors, BandFactors):
        factors.lu.index_copy_(2, idx, sub.lu)
        factors.band.index_copy_(0, idx, sub.band)
    else:
        r = sub[0].shape[0] // idx.numel()
        for full, part in zip(factors, sub):
            _member_rows(full, r).index_copy_(0, idx, _member_rows(part, r))


def _expand_factors(sub, idx, B):
    """A batch's factorization holding a subset's (the rest zero, never
    read: only the subset's members solve before their own refresh)."""
    if isinstance(sub, MemberFactors):
        full = _expand_tree(sub, B)
    elif isinstance(sub, BandFactors):
        lu = sub.lu.new_zeros(sub.lu.shape[:2] + (B,))
        band = sub.band.new_zeros((B,) + sub.band.shape[1:])
        full = BandFactors(lu, band)
    else:
        r = sub[0].shape[0] // idx.numel()
        full = [part.new_zeros((B * r,) + part.shape[1:]) for part in sub]
        if len(full) > 1:  # pivots of a never-refreshed member: the identity
            full[1] += torch.arange(1, sub[1].shape[-1] + 1, dtype=sub[1].dtype,
                                    device=sub[1].device)
            full[0] += torch.eye(sub[0].shape[-1], dtype=sub[0].dtype, device=sub[0].device)
    _scatter_factors(full, idx, sub)
    return full
