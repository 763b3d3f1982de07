"""Solve drivers (counterpart of ``diffsol_tpu.drivers``; reference
method.rs:721-818 `solve_dense`).

The JAX driver is one jitted ``lax.while_loop`` writing into fixed-shape
buffers; this one is an eager loop over ``solver.step`` that interpolates
every ``t_eval`` point inside each accepted step (the reference's
``while t_eval[col] <= t`` loop).  Root events and resets are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from . import errors


@dataclass
class Solution:
    """Solve result (reference `Solution`, solution.rs:70-221).

    ``ys`` is (neval, n) for one instance and (neval, B, n) for an
    ensemble.  ``stop_reason`` is an :mod:`errors` code, ``state`` the
    final solver state (None for the fused tier).  ``tier`` names the path
    an ensemble solve took (``"lockstep"``, ``"independent"``,
    ``"fused_small"`` on CUDA or ``"fused_small_reference"`` for the plain
    version on the CPU).  The fused tiers share one adaptive step sequence
    per member tile, and ``tile_steps`` holds each tile's accepted steps.
    """

    ts: torch.Tensor
    ys: torch.Tensor
    stop_reason: int
    n_points: int
    state: Any = None
    tile_steps: Optional[torch.Tensor] = None
    tier: Optional[str] = None

    def replace(self, **kw) -> "Solution":
        return dataclasses.replace(self, **kw)


def solve_dense(solver, t_eval, params=None, state=None,
                max_steps: int = 100_000) -> Solution:
    """Solve and interpolate onto ``t_eval`` (ascending).  ``ys`` has shape
    (len(t_eval), *state.y.shape)."""
    p = solver.problem
    params = p.params if params is None else params
    if state is None:
        state = solver.init_state(params)
    t_eval = torch.as_tensor(t_eval, dtype=torch.float64).reshape(-1)
    te = t_eval.tolist()
    neval = len(te)
    final_time = te[-1]
    state = solver.set_stop_time(state, final_time)
    ys = state.y.new_zeros((neval,) + tuple(state.y.shape))

    written = 0  # t_eval[:written] are filled
    k = 0
    if state.status < 0:
        done, stop = True, state.status
    else:
        done, stop = False, errors.TSTOP_REACHED
    while not done and k < max_steps:
        new = solver.step(state, params)
        status = new.status
        fatal = status < 0
        is_tstop = status == errors.TSTOP_REACHED
        if not fatal:
            # the tstop-landing step may undershoot final_time by roundoff
            t_upper = max(new.t, final_time) if is_tstop else new.t
            while written < neval and te[written] <= t_upper:
                ys[written] = solver.interpolate(new, te[written])
                written += 1
        done = fatal or is_tstop
        if is_tstop:
            stop = errors.TSTOP_REACHED
        elif fatal:
            stop = status
        state = new
        k += 1
    if not done:
        stop = errors.MAX_STEPS_REACHED
    return Solution(
        ts=t_eval.to(ys.device), ys=ys, stop_reason=int(stop),
        n_points=neval, state=state,
    )
