"""Consistent initial conditions for singular-mass DAEs (counterpart of
``diffsol_tpu.solvers.consistent_ic``; reference op/init.rs `InitOp`,
state.rs:84-162 `set_consistent`, line_search.rs:110-201).

Algebraic variables are the states with a zero mass diagonal.  The
unknowns (du of the differential states, v of the algebraic ones) are
packed into one full-length vector and solved from

    F(x) = f(t0, y|alg<-x) - M (x|alg<-0) = 0

by damped Newton with an Armijo backtracking line search (tau = 0.5,
c = 1e-4, steptol = eps^(2/3)), refactorizing the Jacobian up to
``max_linear_solver_setups`` times.  The JAX version is nested
``lax.while_loop``s; this one is an eager loop with Python scalar control.
The state is member-major, (n,) or (B, n), and the packed Jacobian comes
from n forward-mode probes broadcast over the members, or, under the
banded tier, as the band from ml+mu+1 cyclically colored probes, factored
through the problem's banded solver (the band LU kernels on the card).
Under the dense and the block-diagonal tiers it is factored by a dense LU,
as the JAX package does for both.
"""

from __future__ import annotations

import math

import torch

from .. import errors
from ..norms import norm as wrms_norm
from ..ops.banded import make_banded_jac
from ..ops.linsol import DENSE
from ..ops.newton import CONTINUE, CONVERGED, DIVERGED, ETA_RESET_JACOBIAN



def algebraic_mask(problem, params=None):
    """(n,) boolean mask of the algebraic states (zero mass diagonal), or
    None when there is none; shared by the members of a lockstep problem
    and broadcast over them."""
    eqn = problem.eqn
    if eqn.mass is None:
        return None
    params = problem.params if params is None else params
    if eqn.mass_diag_fn is not None:
        diag = eqn.mass_diag_fn(problem.t0, params)
    else:
        diag = torch.diagonal(eqn.mass(problem.t0, params), dim1=-2, dim2=-1)
    if diag.ndim == 2:  # lockstep (B, n): the partition is shared
        diag = diag[0]
    mask = diag == 0.0
    return mask if bool(mask.any()) else None


def _blockwise_jacfwd(f, x):
    """Per-member Jacobian (..., n, n) of a residual that acts on each
    member on its own: n basis-vector JVPs broadcast over the members."""
    n = x.shape[-1]
    cols = []
    for c in range(n):
        v = torch.zeros_like(x)
        v[..., c] = 1.0
        cols.append(torch.func.jvp(f, (x,), (v,))[1])
    return torch.stack(cols, dim=-1)


def make_consistent(problem, params, y, dy, is_alg, t=None):
    """Solve for consistent (y, dy) at time ``t`` (default ``problem.t0``);
    returns ``(y, dy, status)`` with status INTERNAL_TIMESTEP or
    INITIAL_CONDITION_DID_NOT_CONVERGE (and then the inputs unchanged)."""
    p = problem
    spec = p.linear_solver
    banded = spec.name.startswith("banded")
    if not banded and spec.name != "dense" and not spec.name.startswith("blockdiag"):
        raise NotImplementedError(
            f"consistent initial conditions under the {spec.name} tier are not "
            "ported yet (ROADMAP.md queue 1 item 14)")
    t0 = p.t0 if t is None else p.t0.new_tensor(float(t))
    ic = p.ic_options
    tol = float(p.options.nonlinear_solver_tolerance)
    eps = float(torch.finfo(y.dtype).eps)  # the state's dtype's, as JAX's
    steptol = eps ** (2.0 / 3.0)
    tau, armijo_c = ic.step_reduction_factor, ic.armijo_constant
    max_newton = ic.max_newton_iterations
    is_alg = is_alg.to(y.device)  # the solver's mask may predate the move to the card
    y_fixed = y
    zero = torch.zeros_like(y)

    def residual(x):
        y0 = torch.where(is_alg, x, y_fixed)
        f = p.eqn.rhs(t0, y0, params)
        du = torch.where(is_alg, zero, x)
        mdu = torch.where(is_alg, zero, p.eqn.mass_mul(t0, params, du))
        return f - mdu

    def nrm_of(delta):
        return float(wrms_norm(delta, y_fixed, p.atol, p.rtol))

    def check(niter, nrm, first_norm, eta):
        """Convergence check (convergence.rs:69-130) -> (status, eta)."""
        if niter == 1:
            eta_new = max(eta, 1e4 * eps) ** 0.8
            diverged = False
        else:
            ratio = nrm / first_norm if first_norm > 0.0 else math.inf
            rate = ratio ** (1.0 / max(niter - 1, 1)) if ratio == ratio else math.inf
            if not math.isfinite(rate):
                rate = math.inf
            eta_new = rate / (1.0 - rate) if rate != 1.0 else math.inf
            diverged = rate > 0.9 or (
                rate ** max(max_newton - niter, 0) / (1.0 - rate) * nrm > tol)
        converged = (eta_new * nrm < tol) and not diverged
        return (DIVERGED if diverged else CONVERGED if converged else CONTINUE), eta_new

    if banded:
        # the packed residual inherits the rhs band (plus the in-band mass
        # diagonal): ml+mu+1 probes whatever the size or the batch
        band_jac = make_banded_jac(lambda t_, x, p_: residual(x), *spec.meta[:2])

    def newton_with_linesearch(x, eta):
        """One Newton campaign with a frozen factorization, in the
        problem's linear-solver tier."""
        # the dense and block tiers take the JAX package's dense branch: a
        # one-off (..., n, n) LU of the packed Jacobian
        lu = spec if banded else DENSE
        factors = lu.factor(band_jac(None, x, None) if banded
                            else _blockwise_jacfwd(residual, x))

        def lin(v):
            return lu.solve(factors, v)

        delta = lin(residual(x))
        nrm = nrm_of(delta)
        first = nrm
        status, eta = check(1, nrm, nrm, eta)
        if status == CONVERGED:  # converged on the first norm: full step
            x = x - delta
        niter = 1
        while status == CONTINUE and niter < max_newton:
            phi0 = 0.5 * nrm * nrm
            two_phi0 = nrm * nrm
            min_alpha = steptol / nrm
            alpha, i, ok, failed = 1.0, 0, False, False
            x_try = d_try = n_try = None
            while not ok and not failed and i < ic.max_linesearch_iterations:
                x_try = x - alpha * delta
                d_try = lin(residual(x_try))
                n_try = nrm_of(d_try)
                ok = 0.5 * n_try * n_try <= phi0 - armijo_c * alpha * two_phi0
                failed = not ok and alpha < min_alpha
                alpha *= tau
                i += 1
            niter += 1
            if ok:
                status, eta = check(niter, n_try, first, eta)
                x, delta, nrm = x_try, d_try, n_try
            else:  # the line search ran out: refactorize and retry
                status = DIVERGED
        return x, status, eta

    x = torch.where(is_alg, y, dy)
    eta = ETA_RESET_JACOBIAN
    status = CONTINUE
    setups = 0
    while status != CONVERGED and setups < ic.max_linear_solver_setups:
        x, status, eta = newton_with_linesearch(x, eta)
        setups += 1
    if status != CONVERGED:
        return y, dy, errors.INITIAL_CONDITION_DID_NOT_CONVERGE
    return (torch.where(is_alg, x, y), torch.where(is_alg, zero, x),
            errors.INTERNAL_TIMESTEP)
