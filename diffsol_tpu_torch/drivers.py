"""Solve drivers (counterpart of ``diffsol_tpu.drivers``; reference
method.rs:721-818 `solve_dense`).

The JAX driver is one jitted ``lax.while_loop`` writing into fixed-shape
buffers; this one is an eager loop over ``solver.step`` that interpolates
every ``t_eval`` point inside each accepted step (the reference's
``while t_eval[col] <= t`` loop).  The root protocol is the reference's
(method.rs:774-805): on ROOT_FOUND the state is pinned back to the root
time through the dense-output interpolant; with a reset operator it is
applied and the solve goes on, without one the solve stops at the root.
A solver with augmented rows (``sens=True``) records them beside ``ys``,
interpolates them to a root and carries them across a reset with the
sensitivity jump (reference state.rs:308-560).
"""

from __future__ import annotations

import copy
import dataclasses
import math
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
    plain versions on the CPU).  For :func:`solve` the buffers hold every
    internal step and the first ``n_points`` rows are valid.  The fused
    tiers share one adaptive step sequence per member tile, and
    ``tile_steps`` holds each tile's accepted steps.
    """

    ts: torch.Tensor
    ys: torch.Tensor
    stop_reason: int
    n_points: int
    state: Any = None
    # the integrated output (or, with ``out`` and no quadrature, out(t, y))
    # at ``ts``; None without either
    gs: Optional[torch.Tensor] = None
    # the root a solve without a reset operator stopped at (NaN, -1: none)
    root_t: float = math.nan
    root_idx: int = -1
    tile_steps: Optional[torch.Tensor] = None
    tier: Optional[str] = None
    # the augmented rows (forward sensitivities) at ``ts``, (neval, naug,
    # *y.shape), so (neval, naug, B, n) in lockstep; None without them
    sens: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "Solution":
        return dataclasses.replace(self, **kw)

    def raise_for_status(self) -> "Solution":
        """Raise :class:`~diffsol_tpu_torch.errors.DiffsolError` when the
        solve failed (a negative ``stop_reason``), naming the time the
        final state reached; else return the solution."""
        errors.check_status(int(self.stop_reason), float(self.state.t))
        return self


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


def _pin_to(solver, state, t: float):
    """state_mut_back: move the state back to time t inside the last step."""
    upd = dict(y=solver.interpolate(state, t), dy=solver.interpolate_dy(state, t),
               t=t, state_modified=True)
    if solver.problem.integrate_out:
        upd["g"] = solver.interpolate_out(state, t)
    if state.s is not None:
        upd["s"] = solver.interpolate_sens(state, t)
    return dataclasses.replace(state, **upd)


def _apply_reset(solver, state, params):
    """Apply the reset operator R(t, y) and refresh dy (reference
    state.rs:246-320 apply_reset / apply_reset_with_mass); an index-aware
    reset gets the index of the root that fired (reference
    set_model_index(root_idx) before apply_reset).  Augmented rows get the
    jump correction (state.rs:308-560 apply_reset_with_sens)."""
    p = solver.problem
    t = p.t0.new_tensor(state.t)
    y_minus, dy_minus, s_minus = state.y, state.dy, state.s
    if p.eqn.reset_n is not None:
        y_new = p.eqn.reset_n(t, state.y, params, state.root_idx)
    else:
        y_new = p.eqn.reset(t, state.y, params)
    state = dataclasses.replace(state, y=y_new, state_modified=True)
    state = solver.reinit_after_reset(state, params)
    if s_minus is not None:
        state = dataclasses.replace(state, s=solver.aug.apply_reset(
            t, y_minus, dy_minus, state.y, state.dy, params, s_minus,
            state.root_idx))
    return state


def _prepare(solver, params, state, device, who):
    """The solver, params and state of a solve on its device."""
    dev = resolve_device(device, who)
    if solver.problem.t0.device != dev:
        solver = copy.copy(solver)
        solver.problem = solver.problem.to(dev)
    p = solver.problem
    params = p.params if params is None else torch.as_tensor(
        params, dtype=p.dtype).to(dev)
    if state is None:
        state = solver.init_state(params)
    elif state.y.device != dev:
        raise ValueError(f"state lies on {state.y.device}, the solve on {dev}")
    return solver, params, state


def _after_step(solver, new, params, final_time):
    """The root protocol on the state ``new`` that a step returned.
    Returns ``(state, done, stop, root)``: ``stop`` is None while the solve
    goes on and ``root`` is ``(root_t, root_idx)`` when a solve without a
    reset operator stopped there."""
    p = solver.problem
    status = new.status
    if status < 0:
        return new, True, status, None
    if status == errors.TSTOP_REACHED:
        return new, True, errors.TSTOP_REACHED, None
    if status == errors.ROOT_FOUND:
        idx = new.root_idx
        new = _pin_to(solver, new, new.root_t)
        if p.eqn.reset is None:
            return new, True, errors.ROOT_FOUND, (new.t, idx)
        new = _apply_reset(solver, new, params)
        if new.status < 0:
            return new, True, new.status, None
        if new.t >= final_time:
            return new, True, errors.TSTOP_REACHED, None
    return new, False, None, None


def solve_dense(solver, t_eval, params=None, state=None,
                max_steps: int = 100_000, device=None) -> Solution:
    """Solve and interpolate onto ``t_eval`` (ascending).  ``ys`` has shape
    (len(t_eval), *state.y.shape); points past a root the solve stopped at
    stay zero and ``n_points`` is len(t_eval) all the same.

    ``device`` is where the solve runs: None means ``"cuda"``, and raises
    without a card; pass ``device="cpu"`` for the CPU.  A solver whose
    problem lies elsewhere is copied with its problem moved there.
    """
    solver, params, state = _prepare(solver, params, state, device, "solve_dense")
    p = solver.problem
    integrate_out = p.integrate_out
    out_direct = p.eqn.out is not None and not integrate_out
    t_eval = torch.as_tensor(t_eval, dtype=torch.float64).reshape(-1)
    te = t_eval.tolist()
    neval = len(te)
    final_time = te[-1]
    state = solver.set_stop_time(state, final_time)
    ys = state.y.new_zeros((neval,) + tuple(state.y.shape))
    has_sens = state.s is not None
    ss = state.s.new_zeros((neval,) + tuple(state.s.shape)) if has_sens else None
    gs = None
    if integrate_out:
        gs = state.g.new_zeros((neval,) + tuple(state.g.shape))
    elif out_direct:
        g0 = p.eqn.out(p.t0, state.y, params)
        gs = g0.new_zeros((neval,) + tuple(g0.shape))

    written = 0  # t_eval[:written] are filled
    k = 0
    root_t, root_idx = math.nan, -1
    if state.status < 0:
        done, stop = True, state.status
    else:
        done, stop = False, errors.TSTOP_REACHED
    while not done and k < max_steps:
        stepped = solver.step(state, params)
        status = stepped.status
        if status >= 0:
            # a root ends the step at the root time; the tstop-landing
            # step may undershoot final_time by roundoff
            t_upper = stepped.root_t if status == errors.ROOT_FOUND else stepped.t
            if status == errors.TSTOP_REACHED:
                t_upper = max(t_upper, final_time)
            while written < neval and te[written] <= t_upper:
                tw = te[written]
                ys[written] = solver.interpolate(stepped, tw)
                if has_sens:
                    ss[written] = solver.interpolate_sens(stepped, tw)
                if integrate_out:
                    gs[written] = solver.interpolate_out(stepped, tw)
                elif out_direct:
                    gs[written] = p.eqn.out(p.t0.new_tensor(tw), ys[written], params)
                written += 1
        state, done, stop_now, root = _after_step(solver, stepped, params, final_time)
        if done:
            stop = stop_now
        if root is not None:
            root_t, root_idx = root
        k += 1
    if not done:
        stop = errors.MAX_STEPS_REACHED
    return Solution(
        ts=t_eval.to(ys.device), ys=ys, stop_reason=int(stop),
        n_points=neval, state=state, gs=gs, root_t=root_t, root_idx=root_idx,
        sens=ss,
    )


def solve(solver, final_time, params=None, state=None, max_steps: int = 10_000,
          device=None) -> Solution:
    """Adaptive solve to ``final_time``, recording every internal step.
    ``ts`` and ``ys`` have ``max_steps + 2`` rows (``ts`` NaN past the
    end); the first ``n_points`` are valid.  ``device`` as in
    :func:`solve_dense`."""
    solver, params, state = _prepare(solver, params, state, device, "solve")
    p = solver.problem
    integrate_out = p.integrate_out
    out_direct = p.eqn.out is not None and not integrate_out
    final_time = float(final_time)
    nbuf = max_steps + 2
    ts = state.y.new_full((nbuf,), math.nan)
    ys = state.y.new_zeros((nbuf,) + tuple(state.y.shape))

    def out_of(st):
        if integrate_out:
            return st.g
        return p.eqn.out(p.t0.new_tensor(st.t), st.y, params)

    gs = None
    if integrate_out or out_direct:
        g0 = out_of(state)
        gs = g0.new_zeros((nbuf,) + tuple(g0.shape))

    has_sens = state.s is not None
    ss = state.s.new_zeros((nbuf,) + tuple(state.s.shape)) if has_sens else None

    def write(k, st):
        ts[k] = st.t
        ys[k] = st.y
        if gs is not None:
            gs[k] = out_of(st)
        if has_sens:
            ss[k] = st.s
        return k + 1

    k = write(0, state)
    state = solver.set_stop_time(state, final_time)
    nsteps = 0
    root_t, root_idx = math.nan, -1
    if state.status < 0:
        done, stop = True, state.status
    else:
        done, stop = False, errors.TSTOP_REACHED
    while not done and nsteps < max_steps:
        state, done, stop_now, root = _after_step(
            solver, solver.step(state, params), params, final_time)
        if done:
            stop = stop_now
        if root is not None:
            root_t, root_idx = root
        if state.status >= 0:
            k = write(k, state)
        nsteps += 1
    if not done:
        stop = errors.MAX_STEPS_REACHED
    return Solution(
        ts=ts, ys=ys, stop_reason=int(stop), n_points=k, state=state, gs=gs,
        root_t=root_t, root_idx=root_idx, sens=ss,
    )
