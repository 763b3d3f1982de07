"""Newton iteration with rate-based convergence control (counterpart of
``diffsol_tpu.ops.newton``; reference newton.rs:13-36, convergence.rs).

* each iteration solves ``A delta = F(x)`` with a FROZEN factorization and
  takes the full step ``x <- x - delta``;
* the convergence measure is the WRMS norm of ``delta`` scaled by
  ``error_y``;
* from the 2nd iteration the mean rate ``r = (|d_k|/|d_1|)^(1/(k-1))`` is
  tracked: the iteration DIVERGES if ``r > 0.9`` or if the projected
  residual ``r^(max_iter-k)/(1-r) * |d_k|`` exceeds ``tol``;
* it CONVERGES when ``eta * |d_k| < tol`` with ``eta = r/(1-r)``; on the
  first iteration ``eta = max(eta_prev, 1e4*eps)^0.8``.  ``eta`` is carried
  across solves and reset to 20^1.25 on a Jacobian refresh and to 100^1.25
  on a step-size change.

The loop is eager and its bookkeeping is Python floats (the JAX version
keeps it in float32 for the TPU); the eta floor's eps is the state's
dtype's, as in the JAX version.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..norms import error_scale, scaled_per_member

CONTINUE = 0
CONVERGED = 1
DIVERGED = 2

ETA_RESET_JACOBIAN = 20.0**1.25
ETA_RESET_TIMESTEP = 100.0**1.25


class NewtonResult(NamedTuple):
    x: torch.Tensor
    converged: bool
    niter: int
    eta: float  # final eta, persisted by the caller


def newton_solve(residual: Callable, lin_solve: Callable, x0, error_y, atol,
                 rtol, eta0, *, tol: float = 0.2,
                 max_iter: int = 10, axis=None, saxis=None) -> NewtonResult:
    """Solve ``residual(x) = 0`` with the frozen iteration matrix applied
    by ``lin_solve``; ``eta0`` is the rate memory from the previous solve.
    ``axis`` is a sharded lockstep ensemble's member axis: the convergence
    norm's max then runs over every rank's members; ``saxis`` its state
    axis, over which the norm's mean gathers its terms."""
    x = x0
    # the weights stay those of error_y for the whole solve
    scale = error_scale(error_y, atol, rtol)
    first_norm = 0.0
    eta = float(eta0)
    eps = float(torch.finfo(x0.dtype).eps)
    niter = 0
    status = CONTINUE
    while status == CONTINUE and niter < max_iter:
        delta = lin_solve(residual(x))
        x = x - delta
        per = scaled_per_member(delta, scale, saxis)
        nrm = math.sqrt(float(per.amax() if axis is None else axis.max(per)))
        niter += 1
        if niter == 1:
            eta = max(eta, 1e4 * eps) ** 0.8
            diverged = False
            first_norm = nrm
        else:
            ratio = nrm / first_norm if first_norm > 0.0 else math.inf
            rate = max(ratio, 1e-30) ** (1.0 / (niter - 1))
            if not math.isfinite(rate):
                rate = math.inf
            eta = rate / (1.0 - rate) if rate != 1.0 else math.inf
            # past 0.9 the rate test alone decides (and rate**k could
            # overflow a Python float)
            diverged = rate > 0.9 or (
                rate ** max(max_iter - niter, 0) / (1.0 - rate) * nrm > tol
            )
        converged = (eta * nrm < tol) and not diverged
        status = DIVERGED if diverged else (CONVERGED if converged else CONTINUE)
    return NewtonResult(x=x, converged=status == CONVERGED, niter=niter,
                        eta=eta)
