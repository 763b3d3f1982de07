"""Forward sensitivities by differentiating the solve (counterpart of
``diffsol_tpu.sens``; reference ode_solver/sensitivities.rs
``solve_dense_sensitivities``).

Two routes, as in the JAX package:

1. :func:`solve_dense_fwd_sens`: forward mode through the eager solve, one
   ``torch.func.jvp`` of ``solve_dense(...).ys`` a parameter.  The step
   control is Python numbers, so the tangent follows the solution along the
   step sequence the primal solve chose; JAX's ``jacfwd`` also carries
   dh/dp through its ``while_loop``, and the two differ by terms of the
   order of the tolerance.  (``torch.autograd.forward_ad`` cannot be used:
   the Jacobian probes are ``torch.func.jvp`` calls, and nesting the two
   forward modes is refused.)
2. The continuous sensitivity equations beside the main system, sharing
   its factorized ``M - c J``: ``BdfSolver(problem, sens=True)`` (or the
   SDIRK and ERK solvers), whose ``Solution.sens`` holds the rows.

Both routes run the band LU kernels on the card for a banded problem:
route 1 through the forward-mode rule of the tier's entry points
(:mod:`.ops.band_lu`: the factors carry no tangent, and the solve's
tangent x' = A^-1 (b' - A' x) is one more K4 launch on the same factors),
route 2 with the rows as right-hand sides of K4.
"""

from __future__ import annotations

import torch

from .drivers import resolve_device, solve_dense


def solve_dense_fwd_sens(solver, t_eval, params=None, max_steps: int = 100_000,
                         device=None):
    """Solution and forward sensitivities dy/dp, by ``torch.func.jvp``
    through :func:`~diffsol_tpu_torch.drivers.solve_dense`.

    Returns ``(ys, sens)``: ``ys`` (neval, n) and ``sens`` (nparams, neval,
    n), the reference's layout (sensitivities.rs); for a lockstep problem
    (params (B, nparams)) each member's own, ``ys`` (neval, B, n) and
    ``sens`` (nparams, neval, B, n).  ``device`` as in ``solve_dense``: the
    card unless the caller asks for the CPU.
    """
    dev = resolve_device(device, "solve_dense_fwd_sens")
    p = solver.problem
    params = p.params if params is None else torch.as_tensor(params, dtype=p.dtype)
    params = params.to(dev)
    npar = params.shape[-1]

    def ys_of(pp):
        return solve_dense(solver, t_eval, params=pp, max_steps=max_steps,
                           device=dev).ys

    if npar == 0:
        ys = ys_of(params)
        return ys, ys.new_zeros((0,) + tuple(ys.shape))
    rows = []
    for j in range(npar):
        seed = torch.zeros_like(params)
        seed[..., j] = 1.0
        ys, tangent = torch.func.jvp(ys_of, (params,), (seed,))
        rows.append(tangent)
    return ys, torch.stack(rows)
