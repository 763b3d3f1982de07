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
A state sharded over a second mesh axis passes its
:class:`~diffsol_tpu_torch.sharding.StateAxis` as ``saxis``: each member's
terms x_i / scale_i are gathered whole over it and reduced by the same
mean as an unsharded solve's, so the norm keeps its bits (a sum of the
ranks' partial means would not).
"""

from __future__ import annotations

import torch


def error_scale(y, atol, rtol):
    """The error weights' denominators ``|y|*rtol + atol``."""
    return y.abs() * rtol + atol


def _per_member(x, y, atol, rtol, saxis=None):
    return scaled_per_member(x, error_scale(y, atol, rtol), saxis)


def scaled_per_member(x, scale, saxis=None):
    """(1/n) sum_i (x_i / scale_i)^2 for each member (0-d for one); over a
    state axis ``saxis`` the terms of every rank's states."""
    term = x / scale
    if saxis is not None:
        term = saxis.gather(term)
    return (term * term).mean(dim=-1)


def squared_norm(x, y, atol, rtol, axis=None, saxis=None):
    """Squared WRMS norm of ``x`` scaled by ``|y|*rtol + atol`` (0-d)."""
    per = _per_member(x, y, atol, rtol, saxis)
    return per.amax() if axis is None else axis.max(per)


def norm(x, y, atol, rtol, axis=None, saxis=None):
    """WRMS norm (square root of :func:`squared_norm`)."""
    return torch.sqrt(squared_norm(x, y, atol, rtol, axis, saxis))


def squared_norm_and_worst(x, y, atol, rtol, saxis=None):
    """(squared WRMS norm, index of the member that dominates it); the
    index is 0 for a single instance."""
    per = _per_member(x, y, atol, rtol, saxis)
    if per.ndim == 0:
        return per, 0
    flat = per.reshape(-1)
    return flat.amax(), int(torch.argmax(flat))


def max_norms(parts, axis=None):
    """The squared norms of ``parts``, each an ``(x, y, atol, rtol)`` or,
    sharded over a state axis, ``(x, y, atol, rtol, saxis)``, as floats;
    under a mesh ``axis`` in one collective."""
    per = [_per_member(*q).amax() for q in parts]
    if axis is None:
        return [float(v) for v in per]
    return axis.partials(per).amax(0).tolist()


def error_test_norms(main, others=(), axis=None):
    """The squared norms a step's error test reads together: ``main`` and
    each of ``others`` a part as in :func:`max_norms` (a state-sharded
    part carries its state axis; a quadrature's is whole on every rank).
    Returns ``(float, worst, [floats])``: main's norm, the member that
    dominates it and the others' norms; under a mesh ``axis`` the worst
    member is a global index and the whole is one collective (one more a
    part over a state axis)."""
    if axis is None:
        sq, worst = squared_norm_and_worst(*main)
        return float(sq), worst, [float(_per_member(*o).amax()) for o in others]
    per = _per_member(*main).reshape(-1)
    rest = [_per_member(*o).amax() for o in others]
    sq, worst, rest = axis.max_and_argmax(per, rest)
    return float(sq), worst, [float(v) for v in rest]
