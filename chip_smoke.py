#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: its name and power limit from nvidia-smi;
2. build the fused BDF kernel (csrc/fused_bdf.cuh plus the Robertson model
   header generated from the torch rhs) with nvcc; print the build time and
   ptxas's register and spill counts;
3. the kernel against its plain PyTorch version on the card: 256 Robertson
   members with k1 spread +-10%, t_eval 0.4 ... 4e10, the same tile;
4. the main path: solve_dense_ensemble(BdfSolver, robertson.problem_ode(),
   T_EVAL_4E10, params (10,000, 3) f64 on the card, mode="fused"), with the
   kernel's launch counter read around it, checked against the reference's
   CVODE table (robertson.SOLN);
5. times of the main path and of the plain version at the same shapes
   (CUDA events), with the card's name and power limit.

The line before the last is a JSON record of the kernel (launches, error
against the plain version, times); the last line is the JSON result
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

B_CHECK = 256
B_MAIN = 10_000
SEED = 0
# kernel vs plain version, both float64 and the same algorithm: they differ
# only by the order of f64 operations (FMA contraction, LU and reduction
# order).  On the H100 they take equal steps in every tile and agree to
# 1e-13 absolute; the JAX kernel, with float32 heuristics and double-float
# state, sits ~1e-7 relative from the plain version.  The bound lies
# between the two, so a kernel of lower precision, or a flipped step
# decision (which moves ys by ~rtol=1e-4), fails it.
YS_RTOL, YS_ATOL = 1e-9, 1e-12
# member 0 against the CVODE table, as tests/test_dae.py:71-72
SOLN_TOL = ((5e-3, 1e-10), None, (5e-3, 1e-8))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def robertson_params(nbatch: int, rng, device) -> torch.Tensor:
    """k1 spread +-10% around 0.04 (member 0 nominal), k2 = 1e4, k3 = 3e7."""
    u = rng.uniform(-1.0, 1.0, nbatch)
    u[0] = 0.0
    p = np.stack([0.04 * (1.0 + 0.1 * u), np.full(nbatch, 1e4),
                  np.full(nbatch, 3e7)], axis=1)
    return torch.tensor(p, dtype=torch.float64, device=device)


def time_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` in ms between CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_close(name, got, ref, steps_got, steps_ref):
    """Equal accepted steps in every tile and ys within YS_ATOL + YS_RTOL
    |ref|; returns the largest absolute difference and the largest share
    of the bound."""
    if not torch.equal(steps_got, steps_ref):
        raise AssertionError(f"{name}: steps per tile differ: {steps_got.tolist()} "
                             f"vs {steps_ref.tolist()}")
    share = (got - ref).abs() / (YS_ATOL + YS_RTOL * ref.abs())
    finite = bool(torch.isfinite(got).all()) and bool(torch.isfinite(ref).all())
    if not finite or bool((share > 1.0).any()):
        raise AssertionError(f"{name}: ys disagree at {int((share > 1.0).sum())} "
                             f"entries, up to {float(share.max()):.3e} of the bound")
    return float((got - ref).abs().max()), float(share.max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffsol_tpu_torch import BdfSolver, errors, solve_dense_ensemble
    from diffsol_tpu_torch._build import load_fused_bdf
    from diffsol_tpu_torch.models import robertson
    from diffsol_tpu_torch.ops import fused_stepper as fs

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    card_line = card()
    print(f"[1] card: {card_line}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # ---- 2. build
    problem = robertson.problem_ode()
    te = robertson.T_EVAL_4E10
    check_solve = fs.make_fused_bdf_solve(problem, te, B_CHECK)
    t0 = time.perf_counter()
    load_fused_bdf(check_solve.header)
    build_s = time.perf_counter() - t0
    if load_fused_bdf.builds:
        print(f"[2] built fused_bdf for robertson in {build_s:.1f} s", flush=True)
        for ln in load_fused_bdf.builds[-1]["ptxas"]:
            print(f"[2] {ln}", flush=True)
    else:
        print("[2] fused_bdf for robertson was already built under "
              "build/diffsol_tpu_torch/ (delete it to see ptxas's report)", flush=True)

    # ---- 3. kernel vs plain version at B=256
    p_check = robertson_params(B_CHECK, rng, dev)
    ys_k, st_k, steps_k = check_solve(p_check)
    ys_p, st_p, steps_p = check_solve.reference(p_check)
    torch.cuda.synchronize()
    if int(st_k.min()) != fs.OK or int(st_p.min()) != fs.OK:
        raise AssertionError(f"status kernel {st_k.tolist()} plain {st_p.tolist()}")
    abs3, share3 = check_close("B=256", ys_k, ys_p, steps_k, steps_p)
    print(f"[3] kernel vs plain, B={B_CHECK} tile={check_solve.tile}: max abs diff "
          f"{abs3:.3e}, {share3:.3e} of the bound (atol {YS_ATOL:g}, rtol "
          f"{YS_RTOL:g}); steps per tile kernel {steps_k.tolist()} plain "
          f"{steps_p.tolist()}", flush=True)

    # ---- 4. the main path
    p_main = robertson_params(B_MAIN, rng, dev)

    def main_path():
        return solve_dense_ensemble(BdfSolver, problem, te, p_main, mode="fused")

    fs.launch_fused_bdf.launches = 0
    sol = main_path()
    torch.cuda.synchronize()
    launches = fs.launch_fused_bdf.launches
    if sol.tier != "fused_small":
        raise AssertionError(f"tier {sol.tier!r}")
    if launches < 1:
        raise AssertionError("the main path launched no kernel")
    if sol.stop_reason != errors.TSTOP_REACHED:
        raise AssertionError(f"stop_reason {sol.stop_reason}")
    if tuple(sol.ys.shape) != (len(te), B_MAIN, 3) or not bool(torch.isfinite(sol.ys).all()):
        raise AssertionError(f"ys shape {tuple(sol.ys.shape)} or non-finite values")
    rows = robertson.SOLN[1:][robertson.SOLN[1:, 0] <= 4e6]
    y0 = sol.ys[: len(rows), 0, :].cpu().numpy()
    for s, tol in enumerate(SOLN_TOL):
        if tol is not None:
            np.testing.assert_allclose(y0[:, s], rows[:, 1 + s], rtol=tol[0], atol=tol[1])
    rel_soln = np.max(np.abs(y0[:, [0, 2]] / rows[:, [1, 3]] - 1.0))
    steps = sol.tile_steps.cpu().numpy()
    print(f"[4] main path: B={B_MAIN}, tier {sol.tier}, {launches} kernel launch(es), "
          f"stop_reason TSTOP_REACHED, member 0 vs SOLN (t <= 4e6) max rel "
          f"{rel_soln:.2e}", flush=True)
    print(f"[4] accepted steps per tile ({len(steps)} tiles of {check_solve.tile}): "
          f"min {steps.min()}, median {int(np.median(steps))}, max {steps.max()}; "
          f"all: {steps.tolist()}", flush=True)

    # ---- 5. times; the plain version at the same shapes
    main_solve = fs.make_fused_bdf_solve(problem, te, B_MAIN)
    ys_p, st_p, steps_p = main_solve.reference(p_main)
    torch.cuda.synchronize()
    ys_k = sol.ys.movedim(1, -1)  # back to the kernel's (neval, n, B)
    abs5, share5 = check_close("B=10000", ys_k, ys_p, sol.tile_steps, steps_p)
    kernel_ms = time_ms(main_path, 5)
    plain_ms = time_ms(lambda: main_solve.reference(p_main), 3)
    print(f"[5] main path (fused kernel): {kernel_ms:.3f} ms median of 5; plain "
          f"PyTorch version: {plain_ms:.1f} ms median of 3; kernel vs plain max abs "
          f"{abs5:.3e}, {share5:.3e} of the bound; card {card_line}", flush=True)

    record = {"kernels": [{
        "name": "fused_bdf",
        "route": "cuda",
        "source": "diffsol_tpu_torch/csrc/fused_bdf.cuh",
        "replaces": "diffsol_tpu/ops/pallas_stepper.py:656",
        "launches": launches,
        "max_abs_err": abs5,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}
    print(f"card: {card_line}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
