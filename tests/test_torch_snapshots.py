"""Twin of tests/test_snapshots.py: the exact solver-statistics counters
of five problems (the reference's insta snapshots, bdf.rs:1740-1757),
through the port's ``solve_dense`` on the CPU as the JAX test runs them.
The counters are the JAX package's ``SNAPSHOTS``, imported from that test:
the port takes the JAX algorithm's steps, Newton iterations and LU setups
one for one, so any numerics or policy change shows as a counter change.
"""

import pytest
import torch
from test_snapshots import SNAPSHOTS

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import errors
from diffsol_tpu_torch.models import exponential_decay, logistic, robertson
from diffsol_tpu_torch.utils import stats_dict, stats_json

torch.set_num_threads(1)

# the cases of tests/test_snapshots.py:58-64, with the port's fixtures
CASES = {
    "expdecay_bdf": (lambda: exponential_decay.problem(rtol=1e-6, atol=1e-8), "bdf", 1.0),
    "logistic_bdf": (lambda: logistic.problem(rtol=1e-6, atol=1e-8), "bdf", 10.0),
    "robertson_dae_bdf": (lambda: robertson.problem_dae(), "bdf", 4e5),
    "logistic_trbdf2": (lambda: logistic.problem(rtol=1e-6, atol=1e-8), "tr_bdf2", 10.0),
    "expdecay_tsit45": (lambda: exponential_decay.problem(rtol=1e-6, atol=1e-8), "tsit45", 1.0),
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_counter_snapshot(name):
    make, method, tf = CASES[name]
    s = dtt.solver(make(), method)
    sol = dtt.solve_dense(s, [tf * 0.5, tf], max_steps=20_000, device="cpu")
    assert sol.stop_reason == errors.TSTOP_REACHED
    got = stats_dict(sol)
    assert list(got) == list(SNAPSHOTS[name])  # JAX's key order
    assert got == SNAPSHOTS[name]
    assert stats_json(sol.state) == stats_json(sol)
