"""Solver comparison under frequent state-mutation events (counterpart of
the JAX package's ``examples/solver_events_performance.py``).

Equivalent of reference examples/performance-solver-events (src/main.rs):
a stiff 2-state linear system is integrated across 100 stop-time events
spaced 0.05 apart; at each event the solver state is mutated (y += 1) and
the solve resumes from it -- the staged-solve protocol (reference
set_stop_time + state_mut, method.rs:56-70), with the state started on
the solve's device by ``drivers.init_state``.  BDF, TR-BDF2 and ESDIRK34
are compared on wall time and solver statistics.

Model (main.rs LAMBDA_SLOW/FAST): dy0/dt = -y0,
dy1/dt = 999*y0 - 1000*y1, rtol=1e-8/atol=1e-10.

Run: python -m diffsol_tpu_torch.examples.solver_events_performance [--cpu]
"""

import dataclasses

import torch

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import init_state, resolve_device
from diffsol_tpu_torch.examples import cli_device, synchronize, timed

EVENT_INTERVAL = 0.05
NUM_EVENTS = 101
LAMBDA_SLOW, LAMBDA_FAST = 1.0, 1000.0


def make_problem():
    def rhs(t, y, p):
        return torch.stack([-LAMBDA_SLOW * y[0],
                            (LAMBDA_FAST - LAMBDA_SLOW) * y[0] - LAMBDA_FAST * y[1]])

    return (
        dt.OdeBuilder()
        .rhs(rhs)
        .init(lambda t, p: torch.ones(2, dtype=torch.float64, device=p.device))
        .rtol(1e-8)
        .atol(1e-10)
        .build()
    )


def run_staged(solver_name: str, dev, num_events: int = NUM_EVENTS):
    # the solver's own methods (reinit_after_reset) run between stages, so
    # its problem lies on the solve's device
    problem = make_problem().to(dev)
    solver = dt.solver(problem, solver_name)

    # warm-up: one stage
    sol = dt.solve(solver, EVENT_INTERVAL, state=init_state(solver, device=dev),
                   max_steps=2000, device=dev)
    synchronize(dev)

    def stages():
        state = init_state(solver, device=dev)
        for k in range(1, num_events):
            sol = dt.solve(solver, EVENT_INTERVAL * k, state=state, max_steps=2000,
                           device=dev)
            state = sol.state
            # the event: mutate the solver state (reference state_mut();
            # state_modified makes the stepper re-initialize its difference
            # history from the new point)
            state = dataclasses.replace(state, y=state.y + 1.0, state_modified=True)
            state = solver.reinit_after_reset(state, problem.params)
        return state

    state, elapsed = timed(stages, dev)
    stats = state.stats
    return {
        "solver": solver_name,
        "elapsed_s": elapsed,
        "steps": int(stats.steps),
        "error_test_fails": int(stats.error_test_failures),
        "newton_iters": int(stats.newton_iterations),
        "final_state": state.y.tolist(),
    }


def main(device=None, num_events: int = NUM_EVENTS):
    dev = resolve_device(device, "solver_events_performance")
    rows = [run_staged(name, dev, num_events) for name in ("bdf", "tr_bdf2", "esdirk34")]
    print(f"{'solver':<10} {'time (s)':>9} {'steps':>7} "
          f"{'err fails':>9} {'newton':>7}")
    for r in rows:
        print(f"{r['solver']:<10} {r['elapsed_s']:>9.3f} {r['steps']:>7} "
              f"{r['error_test_fails']:>9} {r['newton_iters']:>7}")
    # all solvers must agree on the final state (per-stage local error
    # ~rtol accumulates across the 100 restarts)
    ref = rows[0]["final_state"]
    for r in rows[1:]:
        for a, b in zip(ref, r["final_state"]):
            assert abs(a - b) < 1e-4, (ref, r)
    print(f"final state {ref} (all solvers agree)")
    return {"rows": rows}


if __name__ == "__main__":
    main(cli_device())
