"""The singular-mass twin of tests/test_adjoint_ensemble.py, split from
tests/test_torch_adjoint_ensemble.py so that pytest-xdist's workers
(``--dist loadfile``) run it beside that file: the lockstep gradient of
the Robertson DAE at rtol 1e-8 (~5,400 backward steps), each member
against the port's single-instance adjoint (the JAX test's oracle, at its
1e-3 bound).
"""

import numpy as np
import torch

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.models import robertson as trob

from test_torch_adjoint import grad_of
from test_torch_adjoint_ensemble import _member_params

torch.set_num_threads(1)
F64 = torch.float64


def test_lockstep_grad_dae_mass():
    """Singular mass (Robertson DAE): the per-member partitioned output
    jump and algebraic lambda rows."""
    problem = trob.problem_dae(rtol=1e-8, atol=(1e-10, 1e-10, 1e-10))
    t_eval = [0.1, 1.0, 10.0]
    B = 3
    pb = _member_params(problem.params, B, spread=0.1)
    w = torch.tensor([1.0, 1e4, 1.0], dtype=F64)
    ys_of = dtt.make_differentiable_solve_ensemble(problem, t_eval, B, device="cpu")
    grad_b = grad_of(ys_of, pb, lambda ys: torch.sum((w * ys) ** 2))
    one = dtt.make_differentiable_solve(problem, t_eval, device="cpu")
    for b in range(B):
        g1 = grad_of(one, pb[b], lambda ys: torch.sum((w * ys) ** 2))
        # lockstep shares one step sequence, the single solves take their own
        assert np.max(np.abs(grad_b[b] - g1) / np.max(np.abs(g1))) < 1e-3, (grad_b[b], g1)
