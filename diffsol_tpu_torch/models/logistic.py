"""Logistic growth, du/dt = r u (1 - u/k), p = [r, k, y0] (counterpart of
``diffsol_tpu.models.logistic``; reference test_models/logistic.rs), with
the analytic solution u(t) = y0 e^{rt} / (1 - y0/k + (y0/k) e^{rt})."""

from __future__ import annotations

import numpy as np

from ..problem import OdeBuilder, OdeProblem


def rhs(t, y, p):
    r, k = p[0], p[1]
    return r * y * (1.0 - y / k)


def init(t, p):
    return p[2:3].clone()


def soln(t, p):
    """Analytic solution as numpy, shape (..., 1)."""
    r, k, y0 = (float(v) for v in np.asarray(p, np.float64)[:3])
    e = np.exp(r * np.asarray(t, np.float64))
    return (y0 * e / (1.0 - y0 / k + (y0 / k) * e))[..., None]


def problem(rtol=1e-6, atol=1e-6, p=(1.0, 1.0, 0.1)) -> OdeProblem:
    return OdeBuilder().rhs(rhs).init(init).p(list(p)).rtol(rtol).atol(atol).build()
