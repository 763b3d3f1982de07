"""The small models on which the fused tier's events, quadrature and
transcendental paths are tested and smoke-tested: those of the JAX
package's tests/test_pallas_stepper.py (:196 root stop, :239 bouncing
ball, :275 and :307 quadrature, :372 transcendental rhs), written in
torch operation for operation.  Each ``*_problem()`` builds the problem;
the member callables are module functions, so a test can hand them to
``interop.problem_from_jax`` too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import OdeBuilder, OdeProblem

F64 = torch.float64


def _tight(b: OdeBuilder) -> OdeBuilder:
    return b.rtol(1e-6).atol(1e-8)


# ---- exponential decay crossing 0.5: the solve stops at t = ln 2 / a ------
def decay_rhs(t, y, p):
    return -p[0] * y


def decay_init(t, p):
    return torch.ones(1, dtype=F64, device=p.device)


def decay_root(t, y, p):
    return y[0:1] - 0.5


ROOT_STOP_T_EVAL = [0.25, 0.5, 1.0, 3.0]


def root_stop_problem() -> OdeProblem:
    return _tight(OdeBuilder().rhs(decay_rhs).init(decay_init).root(decay_root)
                  .p([1.0])).build()


# ---- bouncing ball through its bounces: reset and continue ----------------
def ball_rhs(t, y, p):
    return torch.stack([y[1], -p[0] * torch.ones_like(y[1])])


def ball_init(t, p):
    return torch.tensor([10.0, 0.0], dtype=F64, device=p.device)


def ball_root(t, y, p):
    return y[0:1]


def ball_reset(t, y, p):
    return torch.stack([torch.full_like(y[0], 1e-9), -p[1] * y[1]])


BALL_T_EVAL = [1.0, 1.6, 2.0]  # the first bounce is at sqrt(2 * 10 / 9.81) ~ 1.428
BALL_P = (9.81, 0.8)


def bouncing_ball_problem() -> OdeProblem:
    return _tight(OdeBuilder().rhs(ball_rhs).init(ball_init).root(ball_root)
                  .reset(ball_reset).p(list(BALL_P))).build()


def ball_height(t, g=BALL_P[0], e=BALL_P[1], h0=10.0):
    """Closed form of the ball's height up to the second bounce."""
    t = np.asarray(t, np.float64)
    t1 = np.sqrt(2.0 * h0 / g)
    v1 = e * g * t1
    return np.where(t <= t1, h0 - 0.5 * g * t * t,
                    v1 * (t - t1) - 0.5 * g * (t - t1) ** 2)


# ---- quadrature of the state itself: g = y0 (1 - e^{-a t}) / a ------------
def quad_init(t, p):
    return torch.stack([p[1], 2.0 * p[1]])


QUAD_T_EVAL = [1.0, 5.0, 10.0]


def quadrature_problem() -> OdeProblem:
    return _tight(OdeBuilder().rhs(decay_rhs).init(quad_init).p([0.1, 1.0])
                  .integrate_out()).build()


# ---- an explicit out() whose quadrature joins the error test ---------------
def square_out(t, y, p):
    return torch.stack([y[0] * y[0]])


QUAD_ERR_T_EVAL = [1.0, 4.0]


def quadrature_err_problem() -> OdeProblem:
    """g = int y^2 = (1 - e^{-2 a t}) / (2 a)."""
    return _tight(OdeBuilder().rhs(decay_rhs).init(decay_init).out(square_out)
                  .p([0.5]).integrate_out().out_rtol(1e-6).out_atol(1e-8)).build()


# ---- a transcendental rhs: y0(t) = -log(e^{-y00} + p0 t) -------------------
def transcendental_rhs(t, y, p):
    return torch.stack([
        -p[0] * torch.exp(y[0]),
        -p[1] * torch.sin(y[1]) + p[0] * torch.tanh(y[2]),
        -p[0] * y[2] * torch.log1p(y[0] * y[0]),
    ])


def transcendental_init(t, p):
    return torch.tensor([0.5, 1.0, 0.8], dtype=F64, device=p.device)


TRANSCENDENTAL_T_EVAL = [0.1, 0.5, 1.5]


def transcendental_problem() -> OdeProblem:
    return (OdeBuilder().rhs(transcendental_rhs).init(transcendental_init)
            .p([1.0, 1.0]).rtol(1e-6).atol(1e-9).build())


def transcendental_y0(t, a, y00=0.5):
    """Closed form of the first state."""
    return -np.log(np.exp(-y00) + a * np.asarray(t, np.float64))


def pallas_cpu_tile_product(s, v):
    """``ops.fused_stepper._tile_mul`` as the Pallas kernel computes it in
    interpret mode on the CPU.  There XLA copies the float32 product
    ``s.hi * v.hi`` of a (1, 1) tile scalar and a lane vector into the
    fusions that consume it and contracts it with the following add into an
    FMA, so the ``quick_two_sum`` that closes ``df32.mul`` sees the exact
    product where it expects the rounded one, and the product's float32
    rounding error enters the result twice: the double-float product is
    off by up to 2^-25 relative.  On smooth problems that noise hides the
    small high-order differences the order selection reads, and the kernel
    climbs in order later and takes fewer steps.  Tests patch this over
    ``_tile_mul`` to reproduce that kernel's step counts."""
    s = s.reshape(s.shape + (1,) * (v.ndim - 1))
    s32, v32 = s.to(torch.float32), v.to(torch.float32)
    twice = s32.to(torch.float64) * v32.to(torch.float64) - (s32 * v32).to(torch.float64)
    return s * v + twice
