"""Scaled error norms (counterpart of ``diffsol_tpu.norms``).

The squared WRMS norm of the reference (vector/mod.rs:199-212):

    ||x||^2 = (1/n) * sum_i ( x_i / (|y_i| * rtol + atol_i) )^2

States lie on the last axis.  A lockstep ensemble is member-major (B, n),
so the one reduction below serves both a single instance and an ensemble:
the mean over states, then the max over members, which makes every member
share one adaptive step (vector/mod.rs tests:756-775).  A NaN anywhere
propagates into the norm.  A lockstep ensemble sharded over a mesh passes
its member axis (:class:`~diffsol_tpu_torch.sharding.MemberAxis`) as
``axis``: the max then runs over every rank's members, in one collective.
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


def squared_norm(x, y, atol, rtol, axis=None):
    """Squared WRMS norm of ``x`` scaled by ``|y|*rtol + atol`` (0-d)."""
    per = _per_member(x, y, atol, rtol)
    return per.amax() if axis is None else axis.max(per)


def norm(x, y, atol, rtol, axis=None):
    """WRMS norm (square root of :func:`squared_norm`)."""
    return torch.sqrt(squared_norm(x, y, atol, rtol, axis))


def squared_norm_and_worst(x, y, atol, rtol):
    """(squared WRMS norm, index of the member that dominates it); the
    index is 0 for a single instance."""
    per = _per_member(x, y, atol, rtol)
    if per.ndim == 0:
        return per, 0
    flat = per.reshape(-1)
    return flat.amax(), int(torch.argmax(flat))


def max_norms(parts, axis=None):
    """The squared norms of ``parts``, each an ``(x, y, atol, rtol)``, as
    floats; under a mesh ``axis`` in one collective."""
    if axis is None:
        return [float(squared_norm(*q)) for q in parts]
    return axis.partials([_per_member(*q).amax() for q in parts]).amax(0).tolist()


def error_test_norms(main, others=(), axis=None):
    """The squared norms a step's error test reads together: ``main`` and
    each of ``others`` an ``(x, y, atol, rtol)``.  Returns ``(float, worst,
    [floats])``: main's norm, the member that dominates it and the others'
    norms; under a mesh ``axis`` the worst member is a global index and the
    whole is one collective."""
    if axis is None:
        sq, worst = squared_norm_and_worst(*main)
        return float(sq), worst, [float(squared_norm(*o)) for o in others]
    sq, worst, rest = axis.max_and_argmax(
        _per_member(*main).reshape(-1), [_per_member(*o).amax() for o in others])
    return float(sq), worst, [float(v) for v in rest]
