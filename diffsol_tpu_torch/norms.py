"""Scaled error norms (counterpart of ``diffsol_tpu.norms``).

The squared WRMS norm of the reference (vector/mod.rs:199-212):

    ||x||^2 = (1/n) * sum_i ( x_i / (|y_i| * rtol + atol_i) )^2

States lie on the last axis.  A lockstep ensemble is member-major (B, n),
so the one reduction below serves both a single instance and an ensemble:
the mean over states, then the max over members, which makes every member
share one adaptive step (vector/mod.rs tests:756-775).  A NaN anywhere
propagates into the norm.
"""

from __future__ import annotations

import torch


def error_scale(y, atol, rtol):
    """The error weights' denominators ``|y|*rtol + atol``."""
    return y.abs() * rtol + atol


def _per_member(x, y, atol, rtol):
    return scaled_per_member(x, error_scale(y, atol, rtol))


def scaled_per_member(x, scale):
    """(1/n) sum_i (x_i / scale_i)^2 for each member (0-d for one)."""
    term = x / scale
    return (term * term).mean(dim=-1)


def squared_norm(x, y, atol, rtol):
    """Squared WRMS norm of ``x`` scaled by ``|y|*rtol + atol`` (0-d)."""
    return _per_member(x, y, atol, rtol).amax()


def norm(x, y, atol, rtol):
    """WRMS norm (square root of :func:`squared_norm`)."""
    return torch.sqrt(squared_norm(x, y, atol, rtol))


def squared_norm_and_worst(x, y, atol, rtol):
    """(squared WRMS norm, index of the member that dominates it); the
    index is 0 for a single instance."""
    per = _per_member(x, y, atol, rtol)
    if per.ndim == 0:
        return per, 0
    flat = per.reshape(-1)
    return flat.amax(), int(torch.argmax(flat))
