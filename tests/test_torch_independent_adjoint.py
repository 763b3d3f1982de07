"""``make_differentiable_solve_ensemble(mode="independent")``: one batched
forward pass with per-member ragged knot tables and one batched backward
pass in which every member walks its own schedule
(diffsol_tpu_torch/adjoint_independent.py).

Each member's gradient is held to the port's own single
``make_differentiable_solve`` of it (held to JAX in
tests/test_torch_adjoint*.py): equal forward and backward ``Stats``, equal
statuses, the gradient within 1e-12 + 1e-10 |ref|.  ``info`` is per member:
(B,) counters and (B,) statuses.
"""

import dataclasses

import numpy as np
import torch

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.models import exponential_decay as ted
from diffsol_tpu_torch.models import heat1d
from diffsol_tpu_torch.models import robertson as trob

torch.set_num_threads(1)
F64 = torch.float64
RTOL, ATOL = 1e-10, 1e-12


def _grad(fn, params, loss):
    p = torch.as_tensor(params, dtype=F64).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(fn(p)), p)
    return g.numpy()


def _sum_sq(ys):
    return (ys**2).sum()


def _member(info, key, b):
    return {f.name: int(getattr(info[key], f.name)[b]) for f in dataclasses.fields(info[key])}


def _members_match(problem, t_eval, pb):
    """The batched gradient of the sum of squares, then each member against
    its single one."""
    pb = np.asarray(pb, dtype=np.float64)
    B = pb.shape[0]
    fn = dtt.make_differentiable_solve_ensemble(problem, t_eval, B, mode="independent",
                                                device="cpu")
    g = _grad(fn, pb, _sum_sq)
    info = fn.info
    for key in ("status", "backward_status"):
        assert tuple(info[key].shape) == (B,)
    for b in range(B):
        one = dtt.make_differentiable_solve(problem, t_eval, device="cpu")
        ref = _grad(one, pb[b], _sum_sq)
        assert _member(info, "forward", b) == dataclasses.asdict(one.info["forward"]), b
        assert _member(info, "backward", b) == dataclasses.asdict(one.info["backward"]), b
        assert int(info["status"][b]) == one.info["status"]
        assert int(info["backward_status"][b]) == one.info["backward_status"]
        if np.isnan(ref).all():
            assert np.isnan(g[b]).all(), b
        else:
            np.testing.assert_allclose(g[b], ref, rtol=RTOL, atol=ATOL)
    return g, info


def test_decay():
    g, info = _members_match(ted.problem(), [0.5, 1.0, 2.0],
                             [[0.1, 1.0], [0.3, 2.0], [0.05, 0.5]])
    assert len(set(info["backward"].steps.tolist())) > 1  # own backward sequences


def test_robertson_to_4e6_k1_spread():
    """The Robertson cell's problem to t = 4e6, B = 3 with k1 spread: the
    backward solves end near the Newton-failure limit, each counting its
    own failures."""
    k1 = 0.04 * np.array([0.5, 1.0, 2.0])
    pb = np.stack([k1, np.full(3, 1e4), np.full(3, 3e7)], axis=1)
    _members_match(trob.problem_ode(), [t for t in trob.T_EVAL_4E10 if t <= 4e6], pb)


def test_reset_event_per_member():
    """The reset twin of tests/test_torch_adjoint_ensemble.py (a time-
    triggered reset at t = 2, y -> p[1]) and a state-triggered one: the
    double knots and the event correction, each member at its own event."""
    init = lambda t, p: torch.ones(2, dtype=F64, device=p.device)  # noqa: E731
    timed = (dtt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y).init(init)
             .root(lambda t, y, p: torch.stack([t - 2.0]))
             .reset(lambda t, y, p: p[1] * torch.ones_like(y))
             .p([0.1, 0.7]).rtol(1e-8).atol(1e-10).build())
    _members_match(timed, [1.0, 3.0, 4.0], [[0.1, 0.7], [0.3, 0.5], [0.2, 1.5]])
    _members_match(ted.problem_with_reset(), [0.5, 1.0, 2.0, 4.0],
                   [[0.1, 1.0], [0.3, 2.0], [0.2, 1.5]])


def test_heat1d_banded():
    """heat1d n = 16 on the banded tier: the forward pass through the band
    LU's plain versions, the backward on the dense adjoint tier."""
    problem, _ = heat1d.make(15, rtol=1e-6, atol=1e-8, banded=True)
    _members_match(problem, [0.01, 0.05, 0.1], [[0.5], [1.0], [2.0]])


def test_failing_member_is_nan_and_alone():
    """Robertson to t = 4e8: the cell's member (k1 = 0.04) runs its backward
    solve out of Newton failures (tests/test_torch_adjoint.py::
    test_backward_failure_fails_loudly); members with k1 = 1e-9 and 1e-6
    succeed.  Member 1 is NaN with TOO_MANY_NONLINEAR_SOLVER_FAILURES, the
    others equal their single gradients."""
    te = [t for t in trob.T_EVAL_4E10 if t <= 4e8]
    pb = [[1e-9, 1e4, 3e7], [0.04, 1e4, 3e7], [1e-6, 1e4, 3e7]]
    g, info = _members_match(trob.problem_ode(), te, pb)
    assert np.isnan(g[1]).all() and np.isfinite(g[[0, 2]]).all()
    assert info["backward_status"].tolist() == [
        errors.TSTOP_REACHED, errors.TOO_MANY_NONLINEAR_SOLVER_FAILURES, errors.TSTOP_REACHED]
    assert info["status"].tolist() == [errors.TSTOP_REACHED] * 3
