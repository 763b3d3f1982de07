"""Exponential decay fixture: dy/dt = -a*y, p = [a, y0] (counterpart of
``diffsol_tpu.models.exponential_decay``; reference
test_models/exponential_decay.rs): two identical decaying states, analytic
solution y(t) = y0 exp(-a t), default p = [0.1, 1.0], t0 = 0, and the
root and reset variants of the event tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import OdeBuilder, OdeProblem


def rhs(t, y, p):
    return -p[0] * y


def init(t, p):
    return torch.stack([p[1], p[1]])


def root(t, y, p):
    """Fires when y[0] drops to 0.6."""
    return torch.stack([y[0] - 0.6])


def reset(t, y, p):
    """Back to the initial value."""
    return torch.stack([p[1], p[1]])


def soln(t, p):
    """Analytic solution as numpy, shape (..., 2)."""
    t = np.asarray(t, np.float64)
    return p[1] * np.exp(-p[0] * t)[..., None] * np.ones(2)


def _builder(rtol, atol, p):
    return OdeBuilder().rhs(rhs).init(init).p(list(p)).rtol(rtol).atol(atol)


def problem(rtol=1e-6, atol=1e-6, p=(0.1, 1.0), integrate_out=False) -> OdeProblem:
    b = _builder(rtol, atol, p)
    if integrate_out:
        # the default output is the state itself
        b = b.integrate_out()
    return b.build()


def problem_with_root(rtol=1e-6, atol=1e-6, p=(0.1, 1.0)) -> OdeProblem:
    """Root when y[0] drops to 0.6."""
    return _builder(rtol, atol, p).root(root).build()


def problem_with_reset(rtol=1e-6, atol=1e-6, p=(0.1, 1.0)) -> OdeProblem:
    """Root at y[0] = 0.6, then y goes back to the initial value."""
    return _builder(rtol, atol, p).root(root).reset(reset).build()
