#!/usr/bin/env python3
"""The host part of the batched independent loop's step control on the
card (diffsol_tpu_torch/solvers/bdf_independent.py).

    python scripts/torch_independent_host.py

Runs chip_smoke.py phase 26 (a)'s call (Robertson, B = 10,000 members with
k1 spread, to t = 4e10, mode="independent") once to warm up and once
measured, and sums the host-clock time spent in the three functions that
take the control to the host: ``_Batched.converge`` (the Newton test a
sweep), ``_Batched.pi_raw`` (the step-size controller a round) and
``_Batched.pow`` (the initial step).  Each reads its operands from the
card, so its time includes waiting for the work queued before it.  Prints
the card, the call's time, rounds, each function's time and calls, and
their share of the call.  Needs a CUDA card.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from diffsol_tpu_torch import BdfSolver, solve_dense_ensemble  # noqa: E402
from diffsol_tpu_torch.models import robertson  # noqa: E402
from diffsol_tpu_torch.solvers import bdf_independent as bi  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_independent_host: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    spent = {"converge": 0.0, "pi_raw": 0.0, "pow": 0.0}
    calls = dict.fromkeys(spent, 0)
    for name in spent:
        def timed(self, *a, _orig=getattr(bi._Batched, name), _name=name, **k):
            t0 = time.perf_counter()
            try:
                return _orig(self, *a, **k)
            finally:
                spent[_name] += time.perf_counter() - t0
                calls[_name] += 1
        setattr(bi._Batched, name, timed)
    params = cs.robertson_params(cs.B_MAIN, np.random.default_rng(cs.SEED), dev)

    def run():
        return solve_dense_ensemble(BdfSolver, robertson.problem_ode(),
                                    robertson.T_EVAL_4E10, params, mode="independent")

    run()
    torch.cuda.synchronize()
    for name in spent:
        spent[name], calls[name] = 0.0, 0
    t0 = time.perf_counter()
    sol = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    parts = ", ".join(f"{k} {v * 1e3:.1f} ms in {calls[k]} calls" for k, v in spent.items())
    print(f"card {cs.card()}; B={cs.B_MAIN}: call {wall * 1e3:.1f} ms (host clock), "
          f"{sol.state.rounds} rounds; {parts}; together "
          f"{sum(spent.values()) / wall:.1%} of the call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
