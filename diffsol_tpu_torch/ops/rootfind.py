"""Event root-finding on the solver's dense-output interpolant
(counterpart of ``diffsol_tpu.ops.rootfind``; reference root.rs:12-170 and
the sign-change scan nalgebra_serial.rs:484-504).

The solver keeps the root-function values ``g0`` at the last accepted
state; after each accepted step ``g1 = g(t_new, y_new)`` is compared with
them.  On a sign change a modified secant iteration on the interpolant
brackets the root to within ``100 eps (|t1| + |t1 - t0|)``, biasing the
bracket with a multiplier ``alpha`` that halves or doubles according to
the side the sign change keeps landing on.  The loop is eager, with
Python floats for the times and the g values.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

_MAX_SECANT_ITERS = 100  # safety bound; the tolerance exit dominates
_EPS = float(torch.finfo(torch.float64).eps)


def root_finding(g0, g1):
    """Sign-change scan between two lists of g values.  Returns
    ``(found_exact_zero, max_frac, imax)``: ``imax`` is the strongest
    crossing (argmax |g1 / (g1 - g0)| over components with g0 g1 < 0,
    first on ties), or -1 without a sign change."""
    found_zero = any(b == 0.0 for b in g1)
    imax, max_frac = -1, 0.0
    for i, (a, b) in enumerate(zip(g0, g1)):
        if a * b < 0.0:
            frac = abs(b / (b - a))
            if imax < 0 or frac > max_frac:
                imax, max_frac = i, frac
    return found_zero, max_frac, imax


class RootCheckResult(NamedTuple):
    found: bool
    t_root: float
    root_idx: int
    g0_next: torch.Tensor  # the g values to carry as g0 for the next step
    # lockstep only: the members disagree on (found, crossing index)
    inconsistent: bool


def check_root(root_fn: Callable, interp_y: Callable, g0, t0: float, y_new,
               t_new: float, nbatch: int = 1, axis=None) -> RootCheckResult:
    """Look for a root in (t0, t_new].  ``root_fn(t, y)`` evaluates the
    root function and ``interp_y(t)`` the state inside the accepted step.

    With ``nbatch > 1`` the g values are member-major (B, nroots): every
    member must agree on (found, crossing index), the reference's batch
    consistency (vector/cuda.rs root_finding).  The secant then polishes
    member 0's crossing to a SHARED root time; a disagreement sets
    ``inconsistent`` and clears ``found``.  Under a mesh ``axis`` the scan
    runs over every rank's g values (one all-gather of g0 and g1), and the
    rank that holds member 0 polishes its crossing for all (a second
    collective, only when member 0 has a sign change)."""
    g1_t = root_fn(t_new, y_new)
    if axis is not None:
        both = axis.gather(torch.cat([g0, g1_t], dim=-1)).tolist()
        nr = g1_t.shape[-1]
        rows0, rows1 = [r[:nr] for r in both], [r[nr:] for r in both]
    elif nbatch > 1:
        rows0, rows1 = g0.tolist(), g1_t.tolist()
    if axis is not None or nbatch > 1:
        scans = [root_finding(a, b) for a, b in zip(rows0, rows1)]
        inconsistent = any(s[0] != scans[0][0] or s[2] != scans[0][2]
                           for s in scans)
        if axis is None or scans[0][2] < 0:
            # without a sign change member 0's check reads only its rows
            res0 = _check_one(lambda tt, yy: root_fn(tt, yy)[0], interp_y,
                              rows0[0], t0, rows1[0], t_new)
        else:
            mine = (_check_one(lambda tt, yy: root_fn(tt, yy)[0], interp_y,
                               rows0[0], t0, rows1[0], t_new)
                    if axis.index == 0 else (False, math.nan, -1))
            found0, t_root0, idx0 = axis.from_first(mine)
            res0 = (bool(found0), t_root0, int(idx0))
        return RootCheckResult(
            found=res0[0] and not inconsistent, t_root=res0[1],
            root_idx=res0[2], g0_next=g1_t, inconsistent=inconsistent)
    found, t_root, idx = _check_one(root_fn, interp_y, g0.tolist(), t0,
                                    g1_t.tolist(), t_new)
    return RootCheckResult(found=found, t_root=t_root, root_idx=idx,
                           g0_next=g1_t, inconsistent=False)


def _check_one(root_fn, interp_y, g0, t0, g1, t_new):
    """One member's check on lists of floats -> (found, t_root, idx)."""
    found_zero, _, imax = root_finding(g0, g1)
    if imax < 0:
        # a root exactly at the upper boundary, or nothing
        idx = min(range(len(g1)), key=lambda i: abs(g1[i]))
        return found_zero, t_new, idx

    tol = 100.0 * _EPS * (abs(t_new) + abs(t_new - t0))
    t0_, t1_, g0_, g1_, im = t0, t_new, list(g0), list(g1), imax
    alpha, sc0, sc1 = 1.0, False, True
    res_t, res_i, i, done = t_new, imax, 0, False
    while not done and abs(t1_ - t0_) > tol and i < _MAX_SECANT_ITERS:
        g1v, g0v = g1_[im], g0_[im]
        t_mid = t1_ - (t1_ - t0_) * g1v / (g1v - alpha * g0v)
        # keep t_mid away from the bracket's ends
        fracint = abs(t1_ - t0_) / tol
        fracsub = 0.1 if fracint > 5.0 else 0.5 / fracint
        if abs(t_mid - t0_) < 0.5 * tol:
            t_mid = t0_ + fracsub * (t1_ - t0_)
        if abs(t1_ - t_mid) < 0.5 * tol:
            t_mid = t1_ - fracsub * (t1_ - t0_)
        gmid = root_fn(t_mid, interp_y(t_mid)).tolist()
        rootfnd, _, im2 = root_finding(g0_, gmid)
        lower = im2 >= 0
        if lower:
            t1_, im, g1_ = t_mid, im2, gmid
        elif rootfnd:
            res_t, res_i, done = t_mid, im, True
        else:
            t0_, g0_ = t_mid, gmid
        if i % 2 == 0:
            sc0 = lower
        else:
            sc1 = lower
        if i >= 2:
            alpha = 1.0 if sc0 != sc1 else (0.5 * alpha if sc0 else 2.0 * alpha)
        i += 1
    if done:
        return True, res_t, res_i
    return True, t1_, im
