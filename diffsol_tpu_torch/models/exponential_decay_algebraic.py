"""Exponential decay with an algebraic constraint, an index-1 DAE
(counterpart of ``diffsol_tpu.models.exponential_decay_algebraic``;
reference test_models/exponential_decay_with_algebraic.rs):
dy0/dt = -a y0, dy1/dt = -a y1, 0 = y2 - y1 with mass diag(1, 1, 0),
p = [a] (default 0.1), init = [1, 1, 0], which is inconsistent: the IC
solve must find y2 = 1.  Every component of the solution is exp(-a t).
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import OdeBuilder, OdeProblem

F64 = torch.float64


def rhs(t, y, p):
    a = p[0]
    return torch.stack([-a * y[0], -a * y[1], y[2] - y[1]])


def mass(t, p):
    return torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=F64, device=p.device))


def init(t, p):
    return torch.tensor([1.0, 1.0, 0.0], dtype=F64, device=p.device)


def soln(t, p):
    """Analytic solution as numpy, shape (..., 3)."""
    e = np.exp(-p[0] * np.asarray(t, np.float64))
    return np.stack([e, e, e], axis=-1)


def problem(rtol=1e-6, atol=1e-8, p=(0.1,)) -> OdeProblem:
    return (OdeBuilder().rhs(rhs).init(init).mass(mass).p(list(p))
            .rtol(rtol).atol(atol).build())
