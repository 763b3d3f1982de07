"""Solve drivers (counterpart of ``diffsol_tpu.drivers``; reference
method.rs:721-818 `solve_dense`).

The JAX driver is one jitted ``lax.while_loop`` writing into fixed-shape
buffers; this one is an eager loop over ``solver.step`` that interpolates
every ``t_eval`` point inside each accepted step (the reference's
``while t_eval[col] <= t`` loop).  Root events and resets are not ported
yet.
"""

from __future__ import annotations

import copy
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
    an ensemble solve took (``"lockstep"``, ``"independent"``, the kernel
    tiers ``"fused_small"`` and ``"fused_band"`` on CUDA, or
    ``"fused_small_reference"`` and ``"fused_band_reference"`` for their
    plain versions on the CPU).  The fused tiers share one adaptive step sequence
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


def resolve_device(device, who: str) -> torch.device:
    """The device a solve runs on: None means the card, and raises when
    there is none; the CPU only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on the card by default and no CUDA device is "
                "available; pass device='cpu' to solve on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def solve_dense(solver, t_eval, params=None, state=None,
                max_steps: int = 100_000, device=None) -> Solution:
    """Solve and interpolate onto ``t_eval`` (ascending).  ``ys`` has shape
    (len(t_eval), *state.y.shape).

    ``device`` is where the solve runs: None means ``"cuda"``, and raises
    without a card; pass ``device="cpu"`` for the CPU.  A solver whose
    problem lies elsewhere is copied with its problem moved there.
    """
    dev = resolve_device(device, "solve_dense")
    if solver.problem.t0.device != dev:
        solver = copy.copy(solver)
        solver.problem = solver.problem.to(dev)
    p = solver.problem
    params = p.params if params is None else torch.as_tensor(
        params, dtype=torch.float64).to(dev)
    if state is None:
        state = solver.init_state(params)
    elif state.y.device != dev:
        raise ValueError(f"state lies on {state.y.device}, the solve on {dev}")
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
