#!/usr/bin/env python3
"""The step at which BdfSolver first changes its order on chip_smoke.py
phase 30 (j)'s problem, unsharded, on the CPU.

Run from the root of a checkout:

    python3 scripts/torch_bdf_order_probe.py [mgrid] [steps]

heat1d banded (rtol 1e-6, atol 1e-8) at n = mgrid + 1 (default 2^20) for
(j)'s B = 2 members, BdfSolver and then TR-BDF2 from init_state: each
step's t, h, order and counters.  The band LU's plain version loops over
the columns in Python, so here the factorization keeps the band and each
solve is scipy's banded LAPACK solve: the steps agree with the card's to
rounding, not bit for bit.  (j) takes fewer steps than the first order
change needs at n = 2^20 (chip_smoke.IMPLICIT_SHARD_STEPS).
"""
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import scipy.linalg  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def banded_scipy():
    """Route the band LU's raw factor and solve through scipy."""
    from diffsol_tpu_torch.ops import band_lu

    def factor(band, ml, mu):
        return band.clone()

    def solve(F, b2, ml, mu):
        return torch.from_numpy(np.stack([
            scipy.linalg.solve_banded((ml, mu), F[i].numpy(), b2[i].numpy())
            for i in range(F.shape[0])]))

    band_lu._factor_raw, band_lu._solve_raw = factor, solve


if __name__ == "__main__":
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.drivers import init_state
    from diffsol_tpu_torch.models import heat1d

    mgrid = int(sys.argv[1]) if len(sys.argv) > 1 else cs.ERK_SHARD_MGRID
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    banded_scipy()
    dev = torch.device("cpu")
    problem = heat1d.make(mgrid, rtol=1e-6, atol=1e-8, banded=True)[0]
    params = torch.tensor(cs.ERK_SHARD_D, dtype=torch.float64)
    lp, params, _ = cs.state_sharded(problem, params, None, dev)
    for name, cls in (("bdf", dtt.BdfSolver), ("sdirk", dtt.SdirkSolver)):
        solver = cls(lp)
        st = init_state(solver, params, device=dev)
        for k in range(steps):
            st = solver.step(st, params)
            print(f"{name} step {k + 1}: t {st.t:.4e} h {st.h:.4e} order "
                  f"{getattr(st, 'order', None)} factorizations "
                  f"{st.stats.linear_solver_setups} Newton {st.stats.newton_iterations} "
                  f"error-test failures {st.stats.error_test_failures}", flush=True)
