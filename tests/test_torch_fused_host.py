"""The host side of a fused ensemble call (diffsol_tpu_torch/ensemble.py):
the static-argument key of the fused-solve cache and the output times it
keeps on each device.  CPU only, on the fused tier's plain version at a
small size; no JAX.
"""

import numpy as np
import pytest
import torch

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import ensemble
from diffsol_tpu_torch.models import exponential_decay as ted

torch.set_num_threads(1)

T_EVAL = [0.5, 1.0, 2.0]


@pytest.mark.parametrize("form", ["list", "tuple", "numpy", "tensor", "tensor_2d"])
def test_output_times_key_is_the_same_for_every_form(form):
    """The cache key of the output times: the same tuple of floats whether
    they come as a list, a tuple, an array or a tensor (of any shape)."""
    te = {"list": list(T_EVAL), "tuple": tuple(T_EVAL), "numpy": np.array(T_EVAL),
          "tensor": torch.tensor(T_EVAL, dtype=torch.float64),
          "tensor_2d": torch.tensor(T_EVAL, dtype=torch.float64)[:, None]}[form]
    key = ensemble._te_key(te)
    assert key == tuple(T_EVAL) and all(type(v) is float for v in key)


def test_fused_calls_reuse_the_solve_and_its_output_times():
    """Two fused calls with the same static arguments build one solve; each
    Solution's ts equals t_eval on the solve's device, and is its own
    tensor (a copy of the kept one, so a caller may change it)."""
    problem = ted.problem()
    params = np.tile(np.array([[0.1, 1.0]]), (4, 1)) * np.linspace(1.0, 1.3, 4)[:, None]
    sols = [dtt.solve_dense_ensemble(dtt.BdfSolver, problem, T_EVAL, params, mode="fused",
                                     tile=2, device="cpu") for _ in range(2)]
    key, (solve, tier, ts_on) = ensemble._fused_cache[problem]
    assert key[0] == tuple(T_EVAL) and tier == "fused_small"
    assert list(ts_on) == [torch.device("cpu")]
    for sol in sols:
        assert sol.tier == "fused_small_reference"
        assert torch.equal(sol.ts, torch.tensor(T_EVAL, dtype=torch.float64))
        assert sol.ts.data_ptr() != ts_on[torch.device("cpu")].data_ptr()
    assert sols[0].ts.data_ptr() != sols[1].ts.data_ptr()
    sols[0].ts.add_(1.0)
    assert torch.equal(sols[1].ts, torch.tensor(T_EVAL, dtype=torch.float64))
    torch.testing.assert_close(sols[0].ys, sols[1].ys, rtol=0.0, atol=0.0)
    y = params[:, 1] * np.exp(-params[:, 0] * np.array(T_EVAL)[:, None])  # (neval, B)
    exact = torch.tensor(np.repeat(y[..., None], 2, axis=-1), dtype=torch.float64)
    torch.testing.assert_close(sols[1].ys, exact, rtol=1e-4, atol=1e-6)
    # another t_eval builds a new solve in the entry
    other = dtt.solve_dense_ensemble(dtt.BdfSolver, problem, [1.0], params, mode="fused",
                                     tile=2, device="cpu")
    assert ensemble._fused_cache[problem][0][0] == (1.0,)
    assert other.ts.tolist() == [1.0]
