"""Hand-built equations object, bypassing the OdeBuilder closures
(counterpart of the JAX package's ``examples/custom_ode_equations.py``).

Equivalent of reference examples/custom-ode-equations (src/my_equations.rs
et al.): the reference implements the OdeEquations trait family by hand --
rhs op with an explicit jac_mul, mass op, init op, root op, out op -- and
feeds it to OdeBuilder::build_from_eqn.  Here
:class:`diffsol_tpu_torch.OdeEquations` is built directly with an
explicit ``rhs_jac`` (in place of the default ``torch.func.jacfwd``) and
the :class:`OdeProblem` dataclass without the builder.

The model is the reference example's: logistic growth with a scaling mass
matrix, a root at y = 0.6, and out = 2y.

Run: python -m diffsol_tpu_torch.examples.custom_ode_equations [--cpu]
"""

import numpy as np
import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device
from diffsol_tpu_torch.problem import OdeProblem

F64 = torch.float64


def main(device=None):
    dev = resolve_device(device, "custom_ode_equations")

    # p = [r, k]: dy/dt = r*y*(1 - y/k), M = I (the reference's MyMass is
    # the identity application), y0 = 0.1, root at y - 0.6, out = 2y
    def rhs(t, y, p):
        return p[0] * y * (1.0 - y / p[1])

    def rhs_jac(t, y, p):
        # explicit dense Jacobian, the analog of MyRhs's hand-written
        # jac_mul (my_rhs_impl_nonlinear.rs) -- no AD involved
        return torch.diag(p[0] * (1.0 - 2.0 * y / p[1]))

    def mass(t, p):
        return torch.eye(1, dtype=F64, device=p.device)

    def init(t, p):
        return torch.tensor([0.1], dtype=F64, device=p.device)

    def root(t, y, p):
        return y[0:1] - 0.6

    def out(t, y, p):
        return 2.0 * y

    eqn = dt.OdeEquations(
        rhs=rhs,
        init=init,
        mass=mass,
        root=root,
        out=out,
        rhs_jac=rhs_jac,
        nstates=1,
        nout=1,
        nroots=1,
        nparams=2,
    )
    problem = OdeProblem(
        eqn=eqn,
        params=torch.tensor([1.0, 10.0], dtype=F64),
        t0=torch.tensor(0.0, dtype=F64),
        h0=torch.tensor(0.0, dtype=F64),
        rtol=torch.tensor(1e-8, dtype=F64),
        atol=torch.full((1,), 1e-10, dtype=F64),
    )

    solver = dt.BdfSolver(problem)
    sol = dt.solve(solver, 10.0, device=dev)
    n = sol.n_points
    # the root at y = 0.6 stops the adaptive solve (no reset op): check
    # against the analytic logistic crossing time
    y_final = float(sol.ys[n - 1, 0])
    t_final = float(sol.ts[n - 1])
    r, k = 1.0, 10.0
    y0 = 0.1
    t_expect = float(np.log((0.6 / (k - 0.6)) / (y0 / (k - y0))) / r)
    assert abs(y_final - 0.6) < 1e-6, y_final
    assert abs(t_final - t_expect) < 1e-6, (t_final, t_expect)
    print(f"custom equations: root y=0.6 found at t={t_final:.6f} "
          f"(analytic {t_expect:.6f}), explicit-Jacobian path exercised")
    return {"t_root": t_final, "t_expect": t_expect, "y_root": y_final,
            "n_points": n}


if __name__ == "__main__":
    main(cli_device())
