"""Two-compartment PK drug delivery with periodic dosing + sensitivities
(counterpart of the JAX package's ``examples/drug_delivery.py``).

Equivalent of reference examples/compartmental-models-drug-delivery (+ the
-declarative and -sensitivities variants): repeated bolus doses applied
through staged solves -- solve to each dose time, bump the central
compartment, continue from the same state (reference set_stop_time/step
loop; the state starts on the solve's device through
``drivers.init_state``); then parameter sensitivities d(amount)/d(CL,
Qp1) by forward mode through the solve.

Run: python -m diffsol_tpu_torch.examples.drug_delivery [--cpu]
"""

import dataclasses

import numpy as np
import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import init_state, resolve_device
from diffsol_tpu_torch.examples import cli_device

DIFFSL = """
in_i { CL = 100.0, Qp1 = 50.0 }
Vc { 1000.0 } Vp1 { 1000.0 }
u_i {
    centralamount = 0,
    peripheralamount = 0,
}
F_i {
    - centralamount / Vc * CL - Qp1 * (centralamount / Vc - peripheralamount / Vp1),
    Qp1 * (centralamount / Vc - peripheralamount / Vp1),
}
"""


def dosed(state, dose: float):
    """The state with ``dose`` added to the central compartment; the
    stepper restarts its history from it (reference state_mut())."""
    y = state.y.clone()
    y[0] += dose
    return dataclasses.replace(state, y=y, state_modified=True)


def main(device=None):
    dev = resolve_device(device, "drug_delivery")
    problem = dt.OdeBuilder().rtol(1e-6).atol(1e-8).build_from_diffsl(DIFFSL)
    solver = dt.BdfSolver(problem)
    doses = [(0.0, 1000.0), (6.0, 1000.0), (12.0, 1000.0), (18.0, 1000.0)]

    state = init_state(solver, device=dev)
    # first dose at t=0 (reference: solver.state_mut().y[0] = dose)
    state = dosed(state, doses[0][1])
    print(f"t = 0.0 h: central = {float(state.y[0]):8.2f} ng")
    stages = []
    for t_dose, dose in doses[1:]:
        sol = dt.solve(solver, t_dose, state=state, max_steps=500, device=dev)
        sol.raise_for_status()
        state = sol.state
        central, peripheral = float(state.y[0]), float(state.y[1])
        stages.append((float(state.t), central, peripheral))
        print(f"t = {float(state.t):4.1f} h: central = "
              f"{central:8.2f} ng, peripheral = {peripheral:8.2f} ng")
        state = dosed(state, dose)
    sol = dt.solve(solver, 24.0, state=state, max_steps=500, device=dev)
    sol.raise_for_status()
    central_24 = float(sol.state.y[0])
    print(f"t = 24.0 h: central = {central_24:8.2f} ng")

    # --- sensitivities (reference compartmental-...-sensitivities):
    # d(amounts)/d(CL, Qp1) over one dosing interval
    p2 = dt.OdeBuilder().rtol(1e-8).atol(1e-10).build_from_diffsl(DIFFSL)

    def init_dosed(t, p):
        return torch.tensor([1000.0, 0.0], dtype=torch.float64, device=p.device)

    p2 = (
        dt.OdeBuilder()
        .rhs(p2.eqn.rhs)
        .init(init_dosed)
        .p(p2.params.tolist())
        .rtol(1e-8)
        .atol(1e-10)
        .build()
    )
    t_eval = np.linspace(1.0, 6.0, 6)
    # forward mode through the solve; the JAX example's solver also carries
    # the sensitivity rows (sens=True), which this route neither reads nor
    # needs, so they are left out (the same numbers at a seventh of the cost)
    ys, sens = dt.solve_dense_fwd_sens(dt.BdfSolver(p2), t_eval, device=dev)
    d_cl, d_qp1 = float(sens[0, -1, 0]), float(sens[1, -1, 0])
    print("sensitivities at t = 6 h:")
    print(f"  d(central)/dCL  = {d_cl:+.4f}")
    print(f"  d(central)/dQp1 = {d_qp1:+.4f}")
    assert d_cl < 0.0  # more clearance -> less drug
    return {"stages": stages, "central_24": central_24, "dcentral_dCL": d_cl,
            "dcentral_dQp1": d_qp1}


if __name__ == "__main__":
    main(cli_device())
