#!/usr/bin/env python3
"""Time the single Krylov solve of chip_smoke.py phase 24 (a) on the card:
rhs = -p y + C y at n = 962, C dense uniform(-0.01, 0.01) from numpy seed
2, to t = 1 at rtol 1e-6, atol 1e-8, through krylov(lu32).

    python scripts/torch_krylov_time.py [--root CHECKOUT]

``--root`` imports ``diffsol_tpu_torch`` from another checkout (e.g. the
parent commit unpacked with ``git archive`` under ``build/``), so that two
versions compare on one card in one call: run parent, change, change,
parent.  One warm-up solve, then three between CUDA events; prints the
card, the root, the median and each time, the steps and the GMRES counts
of the warm-up.  Needs a CUDA card.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N, SEED, T_EVAL = 962, 2, [0.5, 1.0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_krylov_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.ops import krylov

    dev = torch.device("cuda", 0)
    C = torch.tensor(np.random.default_rng(SEED).uniform(-0.01, 0.01, (N, N)), device=dev)
    problem = (dtt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y + C @ y)
               .init(lambda t, p: torch.ones(N, dtype=torch.float64, device=p.device))
               .p([1.0]).rtol(1e-6).atol(1e-8).linear_solver("krylov").build())
    solver = dtt.BdfSolver(problem)
    krylov.reset_gmres_counts()
    sol = dtt.solve_dense(solver, T_EVAL, max_steps=2000)
    counts = krylov.gmres_counts()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dtt.solve_dense(solver, T_EVAL, max_steps=2000)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    print(f"krylov(lu32) n={N} from {args.root}: {float(np.median(times)):.1f} ms median of 3 "
          f"({', '.join(f'{t:.1f}' for t in times)}; CUDA events, after a warm-up); "
          f"{sol.state.stats.steps} steps, GMRES {counts['calls']} calls, "
          f"{counts['restarts']} restarts, {counts['arnoldi']} Arnoldi iterations; card {card}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
