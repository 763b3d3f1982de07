#!/usr/bin/env python3
"""Time two eager float64 BDF paths on the card, where every step-size
change rescales the difference matrices (``bdf.apply_ru``), and the
rescale alone:

* the lockstep gradient of chip_smoke.py phase 22 (a): Robertson, B =
  10,000 members with k1 spread +-10 % (numpy seed 0, member 0 nominal),
  t_eval 0.4 ... 4e6, loss sum ys^2, forward and backward
  (``make_differentiable_solve_ensemble``, mode="lockstep");
* one Robertson solve to t = 4e10 (``solve_dense``, k1 = 0.04);
* ``bdf.apply_ru`` alone at the lockstep shape (ND, 30,000) and the single
  solve's (ND, 3): the host time a call, over 2,000 calls issued back to
  back after 100 warm-up calls (the card drains the queue at the end).

    python scripts/torch_lockstep_time.py [--root CHECKOUT] [--reps N]

``--root`` imports ``diffsol_tpu_torch`` from another checkout (e.g. the
parent commit unpacked with ``git archive`` under ``build/``), so that two
versions compare on one card in one call: run parent, change, change,
parent.  One warm-up call of each path, then ``--reps`` (default 2)
between CUDA events; prints the card, the root, each path's median and
times and its steps.  Needs a CUDA card.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, SEED = 10_000, 0


def timed(fn, reps):
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return out, times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lockstep_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import robertson

    dev = torch.device("cuda", 0)
    u = np.random.default_rng(SEED).uniform(-1.0, 1.0, B)
    u[0] = 0.0
    params = torch.tensor(np.stack([0.04 * (1.0 + 0.1 * u), np.full(B, 1e4), np.full(B, 3e7)],
                                   axis=1), dtype=torch.float64, device=dev)
    problem = robertson.problem_ode()
    te6 = robertson.T_EVAL_4E10[:8]
    fn = dtt.make_differentiable_solve_ensemble(problem, te6, B)

    def grad():
        p = params.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((fn(p) ** 2).sum(), p)
        return g

    def single():
        return dtt.solve_dense(dtt.BdfSolver(problem), robertson.T_EVAL_4E10, max_steps=5000)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    g, t_grad = timed(grad, args.reps)
    if not bool(torch.isfinite(g).all()):
        print("torch_lockstep_time: a gradient is not finite", file=sys.stderr)
        return 1
    info = fn.info
    sol, t_one = timed(single, args.reps)
    from diffsol_tpu_torch.solvers import bdf

    ru = bdf.compute_ru(3, 0.7)
    micro = []
    for n in (3 * B, 3):
        D = torch.randn(bdf.ND, n, dtype=torch.float64, device=dev)
        for reps in (100, 2000):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                bdf.apply_ru(ru, D)
            torch.cuda.synchronize()
        micro.append(f"(ND, {n}) {(time.perf_counter() - t0) / reps * 1e6:.2f} us")
    print(f"apply_ru from {args.root}: {', '.join(micro)} a call (host clock, 2000 calls); "
          f"card {card}", flush=True)
    for name, times, steps in (
            ("lockstep gradient B=10000 to 4e6 (phase 22 a)", t_grad,
             f"forward {info['forward'].steps}, backward {info['backward'].steps} steps"),
            ("single Robertson solve to 4e10", t_one, f"{sol.state.stats.steps} steps")):
        print(f"{name} from {args.root}: {float(np.median(times)):.1f} ms median of "
              f"{len(times)} ({', '.join(f'{t:.1f}' for t in times)}; CUDA events, after a "
              f"warm-up); {steps}; card {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
