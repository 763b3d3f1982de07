"""Adaptive step-size PI controller (counterpart of
``diffsol_tpu.ops.controller``; reference runge_kutta.rs:1313-1335).

The raw factor is ``err^(-(kI+kP)/k) * prev^(kP/k)`` with ``err`` and
``prev`` SQUARED scaled error norms and ``k = order + 1``; with no previous
error (NaN) or ``kP = 0`` it is ``err^(-kI/k)``.  Both norms are clamped
to [1e-30, 1e30] before the powers.

The JAX version computes in float32 because f64 transcendentals are slow
emulated ops on a TPU.  The H100 has native f64, so this one computes in
float64; the two agree to float32 resolution.
"""

from __future__ import annotations

import torch

F64 = torch.float64
_TINY = 1e-30
_HUGE = 1e30


def _raw_of_numbers(err, prev, pi_integral, pi_proportional, eff_order):
    """The tensor formula below on Python floats, operation for operation
    (a number over a tensor is the tensor's reciprocal times the number;
    a 0-d pow is libm's, as Python's), so the result is the same double
    at a hundredth of the cost of the 0-d tensor ops."""
    k = float(eff_order)
    ki = (1.0 / k) * pi_integral
    kp = (1.0 / k) * pi_proportional
    err = float(err)
    prev = float(prev)
    if err == err:
        err = min(max(err, _TINY), _HUGE)
    if prev == prev and pi_proportional != 0.0:
        return err ** -(ki + kp) * min(max(prev, _TINY), _HUGE) ** kp
    return err ** -ki


def pi_controller_raw(error_norm, prev_error_norm, pi_integral,
                      pi_proportional, eff_order):
    """Raw PI step-size factor; arguments may be tensors or numbers and
    broadcast against each other (per-tile vectors in the fused path).
    Numbers alone (the eager solvers' control) give a Python float."""
    if not any(isinstance(v, torch.Tensor)
               for v in (error_norm, prev_error_norm, eff_order)):
        return _raw_of_numbers(error_norm, prev_error_norm, pi_integral,
                               pi_proportional, eff_order)
    err = torch.as_tensor(error_norm, dtype=F64)
    prev = torch.as_tensor(prev_error_norm, dtype=F64, device=err.device)
    order_f = torch.as_tensor(eff_order, device=err.device).to(F64)
    ki = pi_integral / order_f
    kp = pi_proportional / order_f
    have_prev = ~torch.isnan(prev)
    use_pi = have_prev & (pi_proportional != 0.0)
    err_safe = err.clamp(_TINY, _HUGE)
    prev_safe = torch.where(have_prev, prev, 1.0).clamp(_TINY, _HUGE)
    i_only = err_safe ** -ki
    pi_both = err_safe ** -(ki + kp) * prev_safe ** kp
    return torch.where(use_pi, pi_both, i_only)


def clamp_factor(factor: float, min_reduce: float, max_reduce: float,
                 min_increase: float, max_increase: float) -> float:
    """Dead zone and hard clamps on a step-size factor
    (runge_kutta.rs:466-495): inside (max_reduce, min_increase) the step
    size stays (factor 1), outside the factor is clamped to [min_reduce,
    max_increase].  A NaN factor stays NaN."""
    if max_reduce < factor < min_increase:
        factor = 1.0
    return min(max(factor, min_reduce), max_increase)
