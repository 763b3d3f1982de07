#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: its name and power limit from nvidia-smi;
2. build every kernel library at once, one nvcc each: the fused BDF
   kernel (csrc/fused_bdf.cuh) once for each of its seven model headers
   (Robertson ODE and DAE, the root-stop, bouncing-ball, two quadrature
   and transcendental models of models/fused_cases.py) and of phase 20's
   three DiffSL ones, the band LU
   (csrc/band_lu.cuh) and the fused band BDF kernel
   (csrc/fused_band_bdf.cuh) once for each of the heat1d, heat2d and
   foodweb rhs headers and phase 20's DiffSL heat1d and heat2d, and the
   fused BDF kernel's mixed-precision build;
   print each fused BDF build's time and, for each of its two kernels (the
   256- and the 1024-thread build), ptxas's registers, stack frame, spill
   store and spill load bytes;
3. the fused BDF kernel against its plain PyTorch version on the card: 256
   Robertson members with k1 spread +-10%, t_eval 0.4 ... 4e10, the same
   tile;
4. the small-n main path: solve_dense_ensemble(BdfSolver,
   robertson.problem_ode(), T_EVAL_4E10, params (10,000, 3), mode="fused")
   with the kernel's launch counter read around it, checked against the
   reference's CVODE table (robertson.SOLN);
5. times of that path, of the kernel alone (CUDA events around the bare
   launch; the difference is the call's host part) and of the plain
   version at the same shapes (CUDA events), with the card's name and
   power limit;
6. the band libraries' build times and ptxas lines, the band LU
   kernels' dynamic shared memory a block at the three models' shapes, and
   the fused band kernel's launch plan at each model's main path (grid,
   cluster and block shape, shared memory a block, the clusters the card
   holds at once, registers and local bytes a thread);
7. the band LU kernels (factor, solve) against their plain versions on the
   heat1d iteration matrix M - cJ (n=128, B=1024, c=1e-3) and on a random
   diagonally dominant band (ml=3, mu=2, numpy seed 0), each wrapper
   counting one launch a call; times of both, of the plain versions and of
   torch.linalg.lu_factor / lu_solve on the dense (1024, 128, 128)
   expansion;
8. the banded lockstep path: heat1d n=128 (mgrid=127, rtol 1e-6, atol
   1e-8), tridiagonal, B=1024 diffusivities linspace(0.5, 2.0), t_eval
   [0.001, 0.01, 0.05, 0.1, 0.2], mode="lockstep", with the band LU launch
   counters read around it, checked against the analytic Fourier series;
9. the fused band kernel against its plain version at B=256 (2 tiles);
10. the banded fused main path at B=1024: one kernel launch, the same
    checks, agreement with phase 8, its time (median of 5) and the plain
    version's at the same shapes;
11. one traced call of each of the paths (torch.profiler), heat2d's
    lockstep path among them: the device time by kernel, the fused small-n
    kernel's (K1), the band LU kernels' (K3, K4) and the fused band
    kernel's (K2) where the path runs them, and the device's busy share of
    the call (the profiler's own overhead is in the call's time); for the
    small-n paths (Robertson ODE, DAE, mixed) also unprofiled: the call and
    K1 alone between CUDA events, K1's share of the call and the call's
    host part;
12. (run after phase 5) the rest of the fused BDF kernel, one variant at a
    time: the Robertson DAE (mass diag(1, 1, 0)), the root that stops the
    solve, the bouncing ball's reset, quadrature of the state, quadrature
    with error control, and the transcendental rhs.  Each: the kernel
    against its plain version at B=256 (equal steps, root counts and
    indices in every tile, ys and gs within the bound, root times within
    1e-12 relative), then the full-width path at B=10,000 through
    solve_dense_ensemble(mode="fused") with the launch counter set to 0
    just before and read just after, held against the closed form the JAX
    package's tests use (robertson.SOLN and x + y + z = 1 and the ODE
    path's ys for the DAE; ln 2; the ball's height; (1 - e^{-at})/a; the
    log form of the transcendental model's first state), its time (median
    of 5) and the plain version's at the same shapes (one run); and
    members that cross at different times must end the solve in
    ROOT_BATCH_INCONSISTENT.

13. the 2-D method-of-lines DAEs through the banded tier at full width,
    B=1,024 identical members (as the reference's rows broadcast them):
    heat2d mgrid=20 (n=400, ml=mu=20, 41 colored probes a Jacobian; rtol =
    atol = 1e-5, t_eval [0.01, 0.03, 0.1]) and foodweb nx=10 (n=200,
    ml=mu=20; t_eval [1e-3, 1e-2, 1e-1], max_steps 3000), whose
    inconsistent ``init`` goes through the banded consistent-IC solve.
    Each: mode="fused" (one launch of the fused band kernel, its counter
    set to 0 just before and read just after) and mode="lockstep" (the
    band LU kernels counted; timed as the median of 3 calls after the
    first, host clock), held to TSTOP_REACHED, to each other within
    1e-6 + 5e-4 |ref|, and member 0 to a single solve_dense of the dense
    (banded=False) problem on the card; heat2d's boundary rows stay 0
    within 1e-9; foodweb's corner values meet IDA's (foodweb.SOLN, rtol
    2e-3) and its consistent initial state's algebraic residual has fallen
    by more than a thousand.  The kernel against its plain version at
    B=256: heat2d by the rule of phase 9 (equal steps, 1e-12 + 1e-9 |ref|);
    foodweb, whose step sequence follows the last bit of its rhs
    (tests/test_torch_mol2d.py shows it on the plain version alone),
    within 10 error weights and a fifth of the steps, with what was
    measured printed;
14. the band LU kernels at the 2-D models' width, nb=41: the iteration
    matrices M - cJ (B=1,024, c=1e-3) of heat2d (n=400) and foodweb
    (n=200) against their plain versions by phase 7's rule, with
    torch.linalg.lu_factor / lu_solve on the dense (1024, n, n) expansion
    timed as the library call, and the launches of each model's lockstep
    run of phase 13;
15. the fused BDF kernel with precision="mixed" (float32 Jacobian, LU and
    Newton solve): Robertson ODE, B=10,000 identical nominal members,
    t=4e10, one launch; against
    its own plain version (whose float32 operations run in another order:
    the steps of both are printed, and ys are held to 5 error weights) and
    against the float64 kernel on the same members as tests/test_pallas_stepper.py:451
    (< 5 weights over all points, < 0.1 up to t = 4e4);
16. every method of ``solver``/``METHODS`` (bdf, tr_bdf2, esdirk34,
    tsit45) on the five exact-solution cases of tests/test_parity_sweep.py
    at rtol 1e-6, atol 1e-8 on the card (tsit45 takes no DAE), each within
    200 rtol of its exact solution;
17. RK lockstep ensembles of 1,024 members (mode="lockstep": the fused and
    auto modes take the BDF kernel whatever the solver factory): the
    Robertson ODE with k1 spread +-10 % (numpy seed 0, member 0 nominal)
    through tr_bdf2 and esdirk34 to t = 4e6, member 0 against the CVODE
    table and members 0, 511 and 1023 against their own single solves
    (rtol 2e-3); the logistic equation with r spread +-10 % through
    tsit45, every member within 200 rtol of its exact solution;
18. the block-diagonal tier at the reference's width (bench.py:591-646):
    robertson.problem_ode_groups(1000), n = 3,000 on blockdiag(3,1000),
    one BdfSolver solve to t = 4e10, every group against the CVODE table
    to t = 4e6, its batched LU factorizations and one profiled call of its
    first 100 steps (kernel launches a step, the card's busy share); 100
    groups x 100
    lockstep members, one (10,000, 3, 3) LU stack, members 0 and 99
    against their single solves; and 5 groups on the block tier against
    the dense Jacobian (rtol 1e-6, atol 1e-10);
19. a mass given as a matrix with a user Jacobian (rhs_implicit):
    models/heat2d_mass.py, with its lumped and with its dense consistent
    mass, through bdf and tr_bdf2 on the card against the same solve on
    the CPU (1e-8 relative and 1e-14 absolute, steps within 2).
Each of phases 16-19 prints its steps, Newton iterations and linear solver
setups and its time (the median of 3 calls after a warm-up whose solution
the gates read, between CUDA events) beside the card's name and power
limit; these paths launch PyTorch's kernels only (their JAX counterparts
reach no Pallas kernel).
20. models written as DiffSL text (models/diffsl_sources.py, from the
    hand-written models' constants), built with
    OdeBuilder.build_from_diffsl, one at a time: (a) the Robertson ODE and
    (b) DAE (mass diag(1, 1, 0) from its dudt labels) at B=10,000 with k1
    spread +-10 % (numpy seed 0, member 0 nominal) to t = 4e10 through K1;
    (c) the stop/reset model of tests/test_diffsl.py:166-173, 10,000
    identical members through K1's reset build, the one reset at ln 2;
    (d) heat1d n=128 (use_coloring -> banded(1,1)), B=1,024 diffusivities
    linspace(0.5, 2.0); (e) heat2d mgrid=20 in the reference's matrix form
    (D_ij, M_i { Mass_ij * dydt_j }; n = 400 colors itself to
    banded(20,20)), B=1,024 identical members; (d) and (e) fused through K2
    and lockstep through K3/K4.  Each: one kernel launch a fused call (the
    counter set to 0 just before and read just after; K3/K4 counted around
    the lockstep call); the kernel against its plain version by phase 12's
    gates (K1 at B=10,000, heat1d at 1,024, heat2d at 256); the fused call
    against the hand-written model's on the same members (1e-6 + 5e-4
    |ref|, with whether the two IRs are equal, their rhs op counts and
    header hashes); the closed form (robertson.SOLN and x + y + z = 1,
    1.5 e^-(t - ln 2), the Fourier series, heat2d's boundary 0 within
    1e-9); times, median of 5 (3 for heat2d) between CUDA events, the
    DiffSL path, its twin's and the DiffSL path again (lockstep: the DiffSL
    path and its twin's), beside the plain version's (one run).  Then the N models (reset_n) of
    tests/test_diffsl.py and a two-root one: mode="fused" refuses them
    (UnsupportedForKernel), mode="auto" solves them lockstep on the card,
    y against its closed form and the hidden index N the fired root's.
21. forward sensitivities, each path timed as the median of 3 after a
    warm-up between CUDA events, with its steps, Newton iterations and
    linear solver setups: (a) the Robertson ODE lockstep,
    BdfSolver(sens=True), B=10,000 with k1 spread +-10 % (numpy seed 0,
    member 0 nominal), 3 rows, to t = 4e10 on the dense tier: ys as in
    phase 4, members 0, 4,999 and 9,999 to t = 4e6 against
    solve_dense_fwd_sens of their own solves on the card at rtol 1e-6 (1e-3
    of its largest, tests/test_sens.py:182-208; at the problem's rtol 1e-4
    that oracle is itself 2.6e-3 off the true sensitivity for member
    9,999); (b) the same as the DAE, mass
    diag(1, 1, 0), its rows made consistent at t0 (they sum to 0 within
    1e-10) and member 0 against its oracle (5e-3); (c) heat1d n=128 banded
    lockstep, B=1,024 diffusivities, 1 row, K3 and K4 counted around the
    call (the rows' solves are K4 launches of naug B right-hand sides): the
    member nearest d = 1 against d/dd of the Fourier series at t >= 0.01
    (5e-4 of max |s|), members 0 and 1,023 against a B=64 lockstep solve on
    the CPU (1e-8 relative, steps within 2); and heat2d (n=400, nb=41)
    lockstep with sens=True at B=256, K4 counted, its rows exactly 0 (the
    rhs does not read p); (d) robertson_ode ngroups=1000 on the block tier,
    every group's rows against one dense-tier Robertson solve (1e-9 of its
    largest); (e) K4 with R = 3 B rows against B factorizations in one
    launch at heat1d's M - cJ (B=1,024, c=1e-3) and at heat2d's (nb=41),
    against its plain version by phase 7's rule, its time, the plain
    version's, torch.linalg.lu_solve on the dense expansion with the rows
    broadcast, and the bound (each member's factors once, the rows in and
    out); (f) tr_bdf2, esdirk34 and tsit45 with sens=True on the logistic
    equation against the same solve on the CPU (1e-8 relative, steps
    within 2), and the exponential decay with a reset through bdf and
    tsit45 against central differences on the card (1e-3).
22. adjoints (make_differentiable_solve / _quadrature and the ensemble
    forms), each path timed as the median of 3 after a warm-up between
    CUDA events, with its forward and backward steps, Newton iterations and
    failures and the table's bytes: (a) Robertson ODE lockstep B=10,000 (k1
    spread +-10 %, numpy seed 0), t_eval 0.4 ... 4e6, loss sum ys^2: the
    forward alone (no_grad) and forward + backward; members 0, 4,999 and
    9,999 against 2 sum y.s from solve_dense_fwd_sens at rtol 1e-6 (5e-3
    of the largest); one traced backward pass (of the outputs to t = 40):
    launches a step and the busy share; (b) heat1d n=128 banded lockstep
    B=1,024: K3/K4 counted around the forward pass (above 0) and around
    the dense-table backward pass (exactly 0), every member against 2 sum
    y.s from the sens=True lockstep rows (1e-4); (c) checkpoint_interval=32
    on (a) (its gradient within 5e-3, both modes' peak
    torch.cuda.max_memory_allocated and times) and on (b) (K3/K4 counted in
    the backward pass: the segment re-solves); (d) make_differentiable_solve
    on the exponential decay with a reset and make_differentiable_quadrature
    on its quadrature: the card against the CPU (1e-8 relative) and against
    central differences on the card (1e-3 relative, 1e-4 absolute).
23. float32 solves, forward mode through the band LU, the SDE solvers and
    the API surface: (a) Robertson ODE lockstep in float32
    (OdeBuilder.dtype) at bench.py's f32 width, B=100,000, rtol 1e-4, atol
    1e-6, k1 spread +-10 % (linspace), t_eval 0.4 ... 4e5: ys float32,
    x + y + z = 1 within 1e-3, member B/2 within 2e-2 of the CVODE table at
    t = 0.4, 4, 40 (bench.py:340-349); then B=10,000 in float32 and in
    float64, members 0, 4,999 and 9,999 within 2e-4 of each other to
    t = 40, both timed (median of 3) and their stats_json printed; (b)
    heat1d n=128 banded lockstep in float32, B=1,024 diffusivities,
    rtol 1e-4: every K3/K4 launch the float build's (counted around the
    call), within 10 error weights of the float64 solve; (c) heat2d
    (nb=41) lockstep in float32 (its float K3/K4 launches counted, within
    10 error weights of float64), and the float K3/K4 against their float
    plain versions at heat1d's M - cJ and on a random nb=41 band (n=400):
    1e-5 of the largest entry, A x = b within 1e-4 of max |b|, times
    (median of 20), the float bound and torch.linalg's float32 dense LU;
    (d) solve_dense_fwd_sens of heat1d's B=1,024 banded lockstep ensemble
    on the card, K3/K4 counted (the tangent solves are K4 launches),
    against phase 21's sens=True rows (rtol 5e-4, atol 1e-7, the routes'
    bound in tests/test_torch_sens.py) and at B=16 against the CPU (1e-10
    relative), and one K4 call under torch.func.jvp against the rule's
    plain version (1e-12 relative), timed beside torch.func.jvp of
    torch.linalg.solve on the dense expansion; (e) Euler-Maruyama on an
    Ornstein-Uhlenbeck ensemble of 131,072 paths x 2,000 steps with a
    seeded generator on the card (the stationary variance within 10 % of
    sigma^2/2theta, |mean| < 0.02), and Milstein against EM on geometric
    Brownian motion, 16,384 paths at 50 ... 800 steps, the exact solution
    from the same increments (Milstein below EM everywhere and below 0.01
    at 400 steps, fitted strong orders within 0.15 of 1.0 and 0.5), with
    times and kernel launches a step; (f) the five counter snapshots of
    tests/test_snapshots.py on the card (steps within 2 of JAX's) and
    raise_for_status on y' = y^2.

The line before the last is a JSON record of the kernels: the fused BDF
kernel once for each variant, the band LU's two and the fused band kernel,
each also at the 2-D models' width (the band LU's at heat2d's and at
foodweb's shape), K1 and K2 once for each DiffSL model of phase 20, and
K4 with rows per factorization at heat1d's and at heat2d's width (phase
21; launches on paths (c) and its heat2d run), and K3/K4 on phase 22's
banded gradient (`band_lu_factor:adjoint_heat1d`, `band_lu_solve:...`,
launches of its forward pass, the other numbers phase 7's at that shape),
the float K3/K4 at heat1d's and at nb=41's shape (`band_lu_factor:f32`,
`band_lu_solve:f32`, `:f32_nb41`; launches on phase 23's heat1d and
heat2d float32 paths) and K4 under forward mode
(`band_lu_solve:jvp_heat1d`, launches on phase 23 d's path)
(launches on their path, error against the plain version, times, the
card's least time for the same work); the last line is the JSON result
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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

# the banded tier (bench.py row_pallas_band, examples/heat1d_band_ensemble.py)
HEAT_MGRID = 127  # n = 128
HEAT_T_EVAL = [0.001, 0.01, 0.05, 0.1, 0.2]
B_BAND = 1024
B_BAND_CHECK = 256
# band LU kernel vs plain version: float64, the same operation order, so
# they part only by FMA contraction, about one rounding per column step of
# a diagonally dominant band; 1e-12 relative (of the largest entry for the
# near-zero ones) leaves room for n = 128 such steps and fails any f32 path
LU_RTOL = 1e-12
# the member nearest d = 1.0 against the analytic series
# (examples/heat1d_band_ensemble.py:74-92), and the two banded modes
# against each other at the solver's tolerance (tests/test_pallas_band.py)
ANALYTIC_TOL = 1e-4
MODES_RTOL, MODES_ATOL = 5e-4, 1e-6
# the card's peaks (NVIDIA H100 SXM data sheet): f64 without tensor cores
# and HBM bandwidth
PEAK_F64 = 34e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# the 2-D method-of-lines DAEs (bench.py:681-705): name -> grid, t_eval,
# max_steps; B_BAND identical members
MOL2D = {
    "heat2d": (20, [0.01, 0.03, 0.1], 100_000),
    "foodweb": (10, [1e-3, 1e-2, 1e-1], 3000),
}
# one fused call slower than this is timed at B_BAND_CHECK instead
MOL2D_SLOW_S = 20.0
# member 0 against a single dense solve_dense, two solves at rtol 1e-5
# (tests/test_banded.py:78), and foodweb's corners against IDA's
# (tests/test_models.py:55-75)
DENSE_RTOL, DENSE_ATOL = 5e-4, 1e-6
SOLN_CORNER_RTOL = 2e-3
# foodweb's kernel against its plain version, and the mixed-precision
# kernel against its plain version and against the float64 path, in units
# of the error test's weight atol + rtol |y|
FOODWEB_WEIGHTS = 10.0
MIXED_WEIGHTS, MIXED_EARLY_WEIGHTS = 5.0, 0.1


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


def host_us(fn, reps: int) -> float:
    """Mean host wall time of ``fn`` in microseconds over ``reps`` calls
    issued back to back, after one warm-up call; the card drains the
    queue once at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e6


def bound(nbytes: float, ops: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that moves ``nbytes`` and does ``ops`` f64 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F64 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bdf_step_ops(n: int, rhs_ops: int, solve_ops: int) -> int:
    """f64 operations every accepted BDF step does at least once per
    member: the prediction and psi (5n at order 1), one Newton iteration
    (the rhs, the residual 4n, one linear solve, its norm 4n), the error
    norm (4n) and the difference update (4n at order 1).  Rejected
    attempts, further Newton iterations, Jacobians and factorizations come
    on top, so a bound from it is a lower bound."""
    return 5 * n + rhs_ops + 4 * n + solve_ops + 4 * n + 4 * n + 4 * n


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


def check_lu(name, got, ref):
    """Band LU kernel vs plain version within LU_RTOL; returns the largest
    absolute difference."""
    atol = LU_RTOL * float(ref.abs().max())
    bad = (got - ref).abs() > atol + LU_RTOL * ref.abs()
    if not bool(torch.isfinite(got).all()) or bool(bad.any()):
        raise AssertionError(f"{name}: kernel and plain version disagree at "
                             f"{int(bad.sum())} entries")
    return float((got - ref).abs().max())


def print_builds(tag, builds):
    for b in builds:
        print(f"[{tag}] built {b['name']} ({b['library']}) in {b['seconds']:.1f} s",
              flush=True)
        for ln in b["ptxas"]:
            print(f"[{tag}]   {ln}", flush=True)


def ptxas_kernels(lines):
    """(kernel, registers, stack frame, spill store and spill load bytes)
    for each kernel in a build's ptxas lines ("Function properties for K",
    then "S bytes stack frame, X bytes spill stores, Y bytes spill loads",
    then "Used R registers, ...")."""
    import re

    out, name, frame = [], None, None
    for ln in lines:
        if "Function properties for" in ln:
            name, frame = ln.rsplit(" ", 1)[-1], None
        elif "stack frame" in ln and name is not None:
            frame = [int(v) for v in re.findall(r"(\d+) bytes", ln)[:3]]
        elif "Used" in ln and "registers" in ln and name is not None and frame:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            if "kernel" in name:
                out.append((name, regs, *frame))
            name = None
    return out


def check_heat(name, sol, soln, d, n):
    """TSTOP_REACHED, finite ys of the right shape, the member nearest
    d = 1.0 against the analytic series and the midpoint decay monotone in
    d; returns that member's error."""
    from diffsol_tpu_torch import errors

    if sol.stop_reason != errors.TSTOP_REACHED:
        raise AssertionError(f"{name}: stop_reason {sol.stop_reason}")
    ys = sol.ys.cpu().numpy()
    if ys.shape != (len(HEAT_T_EVAL), len(d), n) or not np.all(np.isfinite(ys)):
        raise AssertionError(f"{name}: ys shape {ys.shape} or non-finite values")
    m = int(np.argmin(np.abs(d - 1.0)))
    err = float(np.abs(ys[:, m] - soln(HEAT_T_EVAL, d[m])).max())
    if not err < ANALYTIC_TOL:
        raise AssertionError(f"{name}: member d={d[m]} off the analytic series by {err}")
    mid = ys[-1, :, n // 2]
    if not np.all(np.diff(mid) < 0):
        raise AssertionError(f"{name}: midpoint decay not monotone in d")
    return err


def print_band_plan(label, check_solve):
    """Phase 6: the fused band kernel's launch plan at the main path's B
    and what the card makes of it: grid, cluster and block shape, shared
    memory a block, the clusters the card holds at once, and the build's
    registers and local (spill and stack) bytes a thread."""
    import ctypes
    import dataclasses

    from diffsol_tpu_torch import _build
    from diffsol_tpu_torch.ops import fused_band_stepper as fb

    cfg = check_solve.cfg
    ntiles = -(-B_BAND // cfg.tile)
    cfg = dataclasses.replace(cfg, nbatch=B_BAND, ntiles=ntiles)
    plan = fb.band_plan(cfg.n, cfg.ml, cfg.mu, cfg.tile, ntiles)
    lib = _build.load_fused_band_bdf(check_solve.header, cfg.ml, cfg.mu)
    out = (ctypes.c_int * 5)()
    rc = lib.fused_band_bdf_report(ctypes.addressof(fb._c_config(cfg)), out)
    if rc != 0:
        raise AssertionError(f"fused band kernel report for {label}: CUDA error {rc}")
    print(f"[6] fused band kernel at {label}'s shape (n={cfg.n}, ml={cfg.ml}, mu={cfg.mu}), "
          f"B={B_BAND}: {ntiles} tiles of {cfg.tile} in a grid of {plan.grid} blocks, "
          f"clusters of {plan.cluster} blocks of {plan.members} warps (a warp a member, "
          f"{plan.threads} threads), factor chunk {plan.fchunk} columns, solve chunk "
          f"{plan.schunk}; shared memory {out[3]} B dynamic + {out[4]} B static a block; "
          f"the card holds {out[0]} such clusters at once ({min(out[0], ntiles) * plan.cluster} "
          f"blocks); {out[1]} registers and {out[2]} local bytes a thread", flush=True)


def k1_step_ops(solve) -> int:
    """f64 operations of an accepted step of a fused BDF solve, a member
    (bdf_step_ops with the dense n x n LU solve, plus the traced mass,
    root and output)."""
    from diffsol_tpu_torch.ops.eqn_codegen import op_count

    cfg, model = solve.cfg, solve.model
    n = cfg.n
    extra = sum(op_count(ir) for ir in (model.mass, model.root, model.out)
                if ir is not None)
    # a constant mass scales the residual; a quadrature row costs its
    # psi (5), delta (3), difference update (4) and, with error
    # control, its share of the norm (4)
    extra += (n if cfg.has_mass else 0) + cfg.nquad * (12 + 4 * cfg.out_in_err)
    return bdf_step_ops(n, op_count(model.rhs), 2 * n * n) + extra


def k1_record(variant, **numbers):
    """One entry of the kernels line for a variant of the fused BDF kernel
    (no library call computes a whole adaptive solve)."""
    return {"name": f"fused_bdf:{variant}", "route": "cuda",
            "source": "diffsol_tpu_torch/csrc/fused_bdf.cuh",
            "replaces": "diffsol_tpu/ops/pallas_stepper.py:656",
            "library_ms": None, **numbers}


def k2_bound(n, ml, mu, rhs_ops, nbatch, steps, p_numel, ys_numel):
    """(ms, "bytes" or "operations") of a fused band solve: params, the
    host's initial state and h per tile in, ys out once, or the f64 work of
    the accepted steps (mean of ``steps`` a tile; a band solve each)."""
    ops = nbatch * float(np.mean(steps)) * bdf_step_ops(n, rhs_ops, (2 * ml + 2 * mu + 1) * n)
    return bound(8 * (p_numel + 2 * n * nbatch + len(steps) + ys_numel + 2 * n), ops) + (ops,)


def k2_record(name, **numbers):
    """One entry of the kernels line for the fused band BDF kernel (no
    library call computes a whole adaptive solve)."""
    return {"name": name, "route": "cuda",
            "source": "diffsol_tpu_torch/csrc/fused_band_bdf.cuh",
            "replaces": "diffsol_tpu/ops/pallas_stepper_band.py:290",
            "library_ms": None, **numbers}


def robertson_phases(dev, rng, card_line, problem, check_solve, shared):
    """Phases 3-5; returns the small-n main path (name, callable) and the
    fused_bdf kernel's record, and leaves the main path's params and ys in
    ``shared`` for the DAE path to be held against."""
    from diffsol_tpu_torch import BdfSolver, errors, solve_dense_ensemble
    from diffsol_tpu_torch.models import robertson
    from diffsol_tpu_torch.ops import fused_stepper as fs
    from diffsol_tpu_torch.ops.eqn_codegen import op_count, trace_model

    te = robertson.T_EVAL_4E10
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
    shared["p_main"] = p_main

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
    shared["ode_ys"] = sol.ys
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
    # the kernel alone: CUDA events around the bare launch, so the rest of
    # the call is host work (and the few small kernels around the launch)
    te_dev = torch.tensor(te, dtype=torch.float64, device=dev)
    alone_ms = time_ms(lambda: fs.launch_fused_bdf(main_solve.cfg, main_solve.header,
                                                   p_main, te_dev), 5)
    plain_ms = time_ms(lambda: main_solve.reference(p_main), 1)
    print(f"[5] main path (fused kernel): {kernel_ms:.3f} ms median of 5; the kernel "
          f"alone {alone_ms:.3f} ms (median of 5, events around the launch), so "
          f"{kernel_ms - alone_ms:.3f} ms of the call is host work; plain "
          f"PyTorch version: {plain_ms:.1f} ms (one run); kernel vs plain max abs "
          f"{abs5:.3e}, {share5:.3e} of the bound; card {card_line}", flush=True)
    # the least time: params in and ys out once, or the f64 work of the
    # accepted steps (an n x n LU solve each), whichever is longer
    n = 3
    rhs_ops = op_count(trace_model(problem.eqn.rhs, None, n, 3).rhs)
    ops = B_MAIN * int(sol.tile_steps.sum()) / len(steps) * bdf_step_ops(
        n, rhs_ops, 2 * n * n)
    nbytes = 8 * (p_main.numel() + sol.ys.numel() + len(te))
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"[5] least time for that work: {bound_ms:.4f} ms, bound by {bound_by} "
          f"({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP f64, a lower bound)", flush=True)
    return ("small-n fused main path (B=10,000)", main_path, "fused_bdf_kernel",
            lambda: fs.launch_fused_bdf(main_solve.cfg, main_solve.header, p_main,
                                        te_dev)), k1_record(
        "ode", launches=launches, max_abs_err=abs5, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by)


# root times of the kernel and its plain version: both polish the same
# interpolant to a bracket of 100 eps (|t| + |dt|) ~ 2e-14 |t|
ROOT_T_RTOL = 1e-12
# the DAE path against the ODE path on the same members, two solves at
# rtol 1e-4: up to t = 4e6 (where SOLN is checked too) at the solver's
# tolerance (tests/test_pallas_stepper.py:63-65); over all ~310 steps to
# t = 4e10, where x has fallen to 5 atol, in units of the error test's
# weight atol + rtol |y| (test_pallas_stepper.py:474-476 allows 5 weights
# between two precisions of one formulation; two formulations get 10)
DAE_ODE_RTOL, DAE_ODE_ATOL = 5e-3, 1e-8
DAE_ODE_WEIGHTS = 10.0


def k1_variants(rng):
    """name -> (problem, t_eval, params(nbatch) -> (B, np) numpy) of the
    further variants of the fused BDF kernel.  Every member of a root
    problem has the same parameters, since a tile's members must cross
    together; the others are spread from the seeded generator (the DAE's
    spread is the ODE main path's)."""
    from diffsol_tpu_torch.models import fused_cases as fc
    from diffsol_tpu_torch.models import robertson

    def spread(center, width, nbatch):
        return center * (1.0 + width * rng.uniform(-1.0, 1.0, nbatch))

    return {
        "dae": (robertson.problem_dae(), robertson.T_EVAL_4E10, None),
        "root_stop": (fc.root_stop_problem(), fc.ROOT_STOP_T_EVAL,
                      lambda b: np.ones((b, 1))),
        "root_reset": (fc.bouncing_ball_problem(), fc.BALL_T_EVAL,
                       lambda b: np.tile(fc.BALL_P, (b, 1))),
        "quad": (fc.quadrature_problem(), fc.QUAD_T_EVAL,
                 lambda b: np.stack([spread(0.1, 0.05, b), np.ones(b)], 1)),
        "quad_err": (fc.quadrature_err_problem(), fc.QUAD_ERR_T_EVAL,
                     lambda b: spread(0.5, 0.05, b)[:, None]),
        "transcendental": (fc.transcendental_problem(), fc.TRANSCENDENTAL_T_EVAL,
                           lambda b: np.stack([rng.uniform(0.5, 1.5, b), np.ones(b)], 1)),
    }


def as_dict(raw):
    return raw if isinstance(raw, dict) else dict(zip(("ys", "status", "steps"), raw))


def check_variant(name, got, ref):
    """Kernel and plain version of a variant on the same inputs: equal
    statuses, steps, root counts and indices in every tile, ys and gs
    within the bound, root times within ROOT_T_RTOL.  Returns the largest
    absolute difference over ys and gs."""
    got, ref = as_dict(got), as_dict(ref)
    for key in ("status", "n_points", "n_roots", "root_idx"):
        if key in ref and got[key].tolist() != ref[key].tolist():
            raise AssertionError(f"{name}: {key} differ: {got[key].tolist()} vs "
                                 f"{ref[key].tolist()}")
    worst = 0.0
    for key in ("ys", "gs"):
        if key in ref:
            worst = max(worst, check_close(f"{name} {key}", got[key], ref[key],
                                           got["steps"], ref["steps"])[0])
    if "root_t" in ref:
        a, b = got["root_t"], ref["root_t"]
        both_nan = torch.isnan(a) & torch.isnan(b)
        if bool((~both_nan & ~((a - b).abs() <= ROOT_T_RTOL * b.abs())).any()):
            raise AssertionError(f"{name}: root times differ: {a.tolist()} vs {b.tolist()}")
    return worst


def variant_checks(name, sol, params, t_eval, shared):
    """The full-width run of a variant against its closed form; returns a
    line for the log."""
    from diffsol_tpu_torch import errors
    from diffsol_tpu_torch.models import fused_cases as fc
    from diffsol_tpu_torch.models import robertson

    want = errors.ROOT_FOUND if name == "root_stop" else errors.TSTOP_REACHED
    if sol.stop_reason != want:
        raise AssertionError(f"{name}: stop_reason {sol.stop_reason}, expected {want}")
    ys = sol.ys.cpu().numpy()
    te = np.asarray(t_eval)
    if ys.shape[:2] != (len(te), B_MAIN) or not np.all(np.isfinite(ys)):
        raise AssertionError(f"{name}: ys shape {ys.shape} or non-finite values")
    p = params.cpu().numpy()
    if name == "dae":
        rows = robertson.SOLN[1:][robertson.SOLN[1:, 0] <= 4e6]
        for s, tol in enumerate(SOLN_TOL):
            if tol is not None:
                np.testing.assert_allclose(ys[: len(rows), 0, s], rows[:, 1 + s],
                                           rtol=tol[0], atol=tol[1])
        total = np.abs(ys.sum(-1) - 1.0).max()
        if not total <= 1e-6:
            raise AssertionError(f"dae: x + y + z off 1 by {total}")
        ode = shared["ode_ys"].cpu().numpy()
        early = te <= 4e6
        np.testing.assert_allclose(ys[early], ode[early], rtol=DAE_ODE_RTOL,
                                   atol=DAE_ODE_ATOL)
        weight = np.array([1e-8, 1e-6, 1e-6]) + 1e-4 * np.abs(ode)
        scaled = float(np.max(np.abs(ys - ode) / weight))
        if not scaled < DAE_ODE_WEIGHTS:
            raise AssertionError(f"dae: {scaled} error weights from the ODE path")
        return (f"member 0 matches SOLN (t <= 4e6), |x+y+z-1| <= {total:.2e} over every "
                f"member and point, vs the ODE path inside rtol {DAE_ODE_RTOL:g} atol "
                f"{DAE_ODE_ATOL:g} up to t = 4e6 and {scaled:.2f} error weights "
                f"(atol + rtol |y|) at worst over all points")
    if name == "root_stop":
        np.testing.assert_allclose(sol.root_t, np.log(2.0), rtol=1e-5)
        exact = np.exp(-te[:2])
        np.testing.assert_allclose(ys[:2, :, 0], exact[:, None] * np.ones(B_MAIN), rtol=1e-5)
        if sol.root_idx != 0 or np.any(ys[2:] != 0.0) or sol.n_points != len(te):
            raise AssertionError("root_stop: root index, zeros past the root or n_points")
        return (f"ROOT_FOUND at t = {sol.root_t:.12f} (ln 2 rel "
                f"{abs(sol.root_t / np.log(2.0) - 1.0):.2e}), zeros past the root")
    if name == "root_reset":
        height = fc.ball_height(te)
        np.testing.assert_allclose(ys[:, :, 0], height[:, None] * np.ones(B_MAIN),
                                   rtol=2e-4, atol=1e-6)
        return (f"height vs the closed form through one bounce max abs "
                f"{np.abs(ys[:, :, 0] - height[:, None]).max():.2e}")
    if name in ("quad", "quad_err"):
        gs = sol.gs.cpu().numpy()
        a = p[:, 0][None, :]
        if name == "quad":
            exact = (1.0 - np.exp(-a * te[:, None])) / a
            np.testing.assert_allclose(gs[:, :, 0], exact, rtol=1e-5)
            np.testing.assert_allclose(gs[:, :, 1], 2.0 * exact, rtol=1e-5)
        else:
            exact = (1.0 - np.exp(-2.0 * a * te[:, None])) / (2.0 * a)
            np.testing.assert_allclose(gs[:, :, 0], exact, rtol=1e-5)
        return f"gs vs the closed form max rel {np.abs(gs[:, :, 0] / exact - 1.0).max():.2e}"
    exact = fc.transcendental_y0(te[:, None], p[:, 0][None, :])
    np.testing.assert_allclose(ys[:, :, 0], exact, rtol=1e-5, atol=1e-7)
    return f"y0 vs the closed form max abs {np.abs(ys[:, :, 0] - exact).max():.2e}"


def variant_phases(dev, rng, card_line, variants, check_solves, shared):
    """Phase 12; returns the DAE main path (name, callable) and the
    variants' records."""
    from diffsol_tpu_torch import BdfSolver, errors, solve_dense_ensemble
    from diffsol_tpu_torch.ops import fused_stepper as fs

    records, dae_path = [], None
    for name, (problem, t_eval, make_params) in variants.items():
        # ---- kernel vs plain version at B=256 (two tiles)
        check_solve = check_solves[name]
        p_check = (robertson_params(B_CHECK, rng, dev) if make_params is None
                   else torch.tensor(make_params(B_CHECK), device=dev))
        got, ref = as_dict(check_solve(p_check)), as_dict(check_solve.reference(p_check))
        torch.cuda.synchronize()
        abs_c = check_variant(f"{name} B={B_CHECK}", got, ref)
        roots = (f", roots per tile {got['n_roots'].tolist()} at t = "
                 f"{got['root_t'].tolist()}" if "root_t" in got else "")
        print(f"[12] {name}: kernel vs plain, B={B_CHECK} tile={check_solve.tile}: max abs "
              f"diff {abs_c:.3e}; status {got['status'].tolist()}, steps per tile kernel "
              f"{got['steps'].tolist()} plain {ref['steps'].tolist()}{roots}", flush=True)

        # ---- the full-width path, the launch counter read around it
        p_main = (shared["p_main"] if make_params is None
                  else torch.tensor(make_params(B_MAIN), device=dev))

        def path(problem=problem, t_eval=t_eval, p_main=p_main):
            return solve_dense_ensemble(BdfSolver, problem, t_eval, p_main, mode="fused")

        fs.launch_fused_bdf.launches = 0
        sol = path()
        torch.cuda.synchronize()
        launches = fs.launch_fused_bdf.launches
        if sol.tier != "fused_small" or launches != 1:
            raise AssertionError(f"{name}: tier {sol.tier!r}, {launches} kernel launches")
        line = variant_checks(name, sol, p_main, t_eval, shared)
        steps = sol.tile_steps.cpu().numpy()
        print(f"[12] {name}: full-width path B={B_MAIN}, tier {sol.tier}, {launches} kernel "
              f"launch, {line}; accepted steps per tile ({len(steps)} tiles): min "
              f"{steps.min()}, median {int(np.median(steps))}, max {steps.max()}",
              flush=True)

        # ---- times; the plain version at the same shapes, one run
        main_solve = fs.make_fused_bdf_solve(problem, t_eval, B_MAIN)
        t0 = time.perf_counter()
        ref = main_solve.reference(p_main)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        abs_m = check_variant(f"{name} B={B_MAIN}", main_solve(p_main), ref)
        kernel_ms = time_ms(path, 5)
        ops = B_MAIN * int(sol.tile_steps.sum()) / len(steps) * k1_step_ops(main_solve)
        nbytes = 8 * (p_main.numel() + sol.ys.numel() + len(t_eval)
                      + (0 if sol.gs is None else sol.gs.numel()))
        bound_ms, bound_by = bound(nbytes, ops)
        print(f"[12] {name}: path {kernel_ms:.3f} ms median of 5; plain PyTorch version "
              f"{plain_ms:.1f} ms (one run, host clock); kernel vs plain at B={B_MAIN} max "
              f"abs {abs_m:.3e}, equal steps per tile; least time {bound_ms:.4f} ms by "
              f"{bound_by} ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP f64, a lower "
              f"bound); card {card_line}", flush=True)
        records.append(k1_record(name, launches=launches, max_abs_err=abs_m, ms=kernel_ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
        if name == "dae":
            te_dev = torch.tensor(t_eval, dtype=torch.float64, device=dev)
            dae_path = ("Robertson DAE fused main path (B=10,000)", path,
                        "fused_bdf_kernel",
                        lambda s=main_solve, p=p_main, te=te_dev: fs.launch_fused_bdf(
                            s.cfg, s.header, p, te))

    # ---- members that cross at different times fail the solve loudly
    problem, t_eval, _ = variants["root_stop"]
    rates = rng.uniform(0.5, 4.0, (B_MAIN, 1))
    fs.launch_fused_bdf.launches = 0
    sol = solve_dense_ensemble(BdfSolver, problem, [1.0, 3.0], rates, mode="fused")
    if (sol.stop_reason != errors.ROOT_BATCH_INCONSISTENT
            or fs.launch_fused_bdf.launches != 1 or bool(torch.isfinite(sol.ys).any())):
        raise AssertionError(f"inconsistent crossing: stop_reason {sol.stop_reason}")
    print(f"[12] root_stop with rates spread over [0.5, 4): ROOT_BATCH_INCONSISTENT, "
          f"every member NaN, 1 kernel launch", flush=True)
    return dae_path, records


def lu_once(band, b, ml, mu):
    """One K3 and one K4 call; fails unless each wrapper counted exactly
    one launch."""
    from diffsol_tpu_torch.ops import band_lu

    f0, s0 = band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches
    F = band_lu.band_lu_factor(band, ml, mu)
    x = band_lu.band_lu_solve(F, b, ml, mu)
    df = band_lu.launch_band_lu_factor.launches - f0
    ds = band_lu.launch_band_lu_solve.launches - s0
    if (df, ds) != (1, 1):
        raise AssertionError(f"band LU wrappers counted {df} and {ds} launches for one call each")
    return F, x


def band_lu_phase(dev, heat_problem, card_line):
    """Phase 7; returns the band_lu_factor and band_lu_solve records
    (launches filled in by phase 8)."""
    from diffsol_tpu_torch.ops import band_lu
    from diffsol_tpu_torch.ops.banded import _band_index

    n, B = HEAT_MGRID + 1, B_BAND
    d = torch.linspace(0.5, 2.0, B, dtype=torch.float64, device=dev)[:, None]
    jac = torch.func.vmap(heat_problem.eqn.jac, in_dims=(None, 0, 0))(
        torch.tensor(0.0, dtype=torch.float64, device=dev),
        torch.zeros(B, n, dtype=torch.float64, device=dev), d)
    heat_band = heat_problem.linear_solver.assemble(None, jac, 1e-3)
    rng = np.random.default_rng(SEED)
    ml_r, mu_r = 3, 2
    rnd = rng.standard_normal((B, ml_r + mu_r + 1, n))
    rnd[:, mu_r] += 2.0 * (ml_r + mu_r + 1)
    rnd *= _band_index(n, ml_r, mu_r)[1]
    rnd_band = torch.tensor(rnd, device=dev)
    b = torch.tensor(rng.standard_normal((B, n)), device=dev)
    errs = {"factor": 0.0, "solve": 0.0}
    for name, band, ml, mu in (("heat1d", heat_band, 1, 1),
                               ("random", rnd_band, ml_r, mu_r)):
        F, x = lu_once(band, b, ml, mu)
        F_p = band_lu.band_lu_factor_reference(band, ml, mu)
        x_p = band_lu.band_lu_solve_reference(F_p, b, ml, mu)
        torch.cuda.synchronize()
        ef = check_lu(f"{name} factor", F.lu, F_p)
        ex = check_lu(f"{name} solve", x, x_p)
        if name == "heat1d":  # the main path's shapes
            errs = {"factor": ef, "solve": ex}
        print(f"[7] band LU kernels vs plain, {name} (B={B}, n={n}, ml={ml}, mu={mu}): "
              f"factors max abs diff {ef:.3e}, x max abs diff {ex:.3e} "
              f"(bound {LU_RTOL:g} relative); one launch each", flush=True)

    F = band_lu.band_lu_factor(heat_band, 1, 1)
    # the kernels through their launch wrappers; the entry points'
    # autograd.Functions cost the host more, measured below
    k3_ms = time_ms(lambda: band_lu.launch_band_lu_factor(heat_band, 1, 1), 20)
    k4_ms = time_ms(lambda: band_lu.launch_band_lu_solve(F.lu, b, 1, 1), 20)
    k3_plain = time_ms(lambda: band_lu.band_lu_factor_reference(heat_band, 1, 1), 3)
    k4_plain = time_ms(lambda: band_lu.band_lu_solve_reference(F.lu, b, 1, 1), 3)
    dense = torch.zeros(B, n, n, dtype=torch.float64, device=dev)
    i = torch.arange(n, device=dev)
    dense[:, i, i] = heat_band[:, 1]
    dense[:, i[1:], i[:-1]] = heat_band[:, 2, :-1]
    dense[:, i[:-1], i[1:]] = heat_band[:, 0, 1:]
    lu, piv = torch.linalg.lu_factor(dense)
    x_lib = torch.linalg.lu_solve(lu, piv, b.unsqueeze(-1)).squeeze(-1)
    x_k = band_lu.band_lu_solve(F, b, 1, 1)
    lib_err = float((x_lib - x_k).abs().max())
    lib_f_ms = time_ms(lambda: torch.linalg.lu_factor(dense), 5)
    lib_s_ms = time_ms(lambda: torch.linalg.lu_solve(lu, piv, b.unsqueeze(-1)), 5)
    # the host's cost of the entry points' autograd.Functions: the entry
    # point against its launch wrapper, wall time a call over 200 calls
    host = {name: host_us(fn, 200) for name, fn in (
        ("factor", lambda: band_lu.band_lu_factor(heat_band, 1, 1)),
        ("launch_factor", lambda: band_lu.launch_band_lu_factor(heat_band, 1, 1)),
        ("solve", lambda: band_lu.band_lu_solve(F, b, 1, 1)),
        ("launch_solve", lambda: band_lu.launch_band_lu_solve(F.lu, b, 1, 1)))}
    print(f"[7] host time a call (mean of 200): band_lu_factor {host['factor']:.1f} us "
          f"against launch_band_lu_factor {host['launch_factor']:.1f} us, band_lu_solve "
          f"{host['solve']:.1f} us against launch_band_lu_solve {host['launch_solve']:.1f} us "
          f"(the difference is the autograd.Function's own cost)", flush=True)
    # bytes: the band read once and the factors written once (factor); the
    # factor elements the two sweeps use (the ml multipliers of columns
    # 0 .. n-2, the mu+1 rows of U), b read once and x written once
    # (solve); the f64 work of the column sweeps is far smaller
    ml = mu = 1
    nb = ml + mu + 1
    f_bytes = 8 * B * (nb * n + (n + mu) * nb)
    s_bytes = 8 * B * ((n - 1) * ml + n * (mu + 1) + 2 * n)
    f_bound = bound(f_bytes, B * n * (1 + 1 + 2))
    s_bound = bound(s_bytes, B * (2 * (n - 1) + 3 * n))
    print(f"[7] band LU at B={B}, n={n}, ml=mu=1 (median of 20): factor {k3_ms:.4f} ms "
          f"(least {f_bound[0]:.4f} ms by {f_bound[1]}), solve {k4_ms:.4f} ms (least "
          f"{s_bound[0]:.4f} ms by {s_bound[1]}); plain {k3_plain:.2f} / {k4_plain:.2f} ms; "
          f"torch.linalg.lu_factor / lu_solve on the dense (B, n, n) expansion "
          f"{lib_f_ms:.3f} / {lib_s_ms:.3f} ms (max abs diff to the kernel's x "
          f"{lib_err:.2e}); card {card_line}", flush=True)
    common = {"route": "cuda", "source": "diffsol_tpu_torch/csrc/band_lu.cuh"}
    return [
        dict(name="band_lu_factor", replaces="diffsol_tpu/ops/pallas_banded.py:51",
             launches=0, max_abs_err=errs["factor"], ms=k3_ms, plain_ms=k3_plain,
             bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=lib_f_ms, **common),
        dict(name="band_lu_solve", replaces="diffsol_tpu/ops/pallas_banded.py:72",
             launches=0, max_abs_err=errs["solve"], ms=k4_ms, plain_ms=k4_plain,
             bound_ms=s_bound[0], bound_by=s_bound[1], library_ms=lib_s_ms, **common),
    ]


def band_phases(dev, card_line, heat_problem, soln, check_solve):
    """Phases 7-10; returns the two banded paths (name, callable) and the
    records of the band LU and the fused band kernels."""
    from diffsol_tpu_torch import BdfSolver, solve_dense_ensemble
    from diffsol_tpu_torch.ops import band_lu
    from diffsol_tpu_torch.ops import fused_band_stepper as fb
    from diffsol_tpu_torch.ops import fused_stepper as fs
    from diffsol_tpu_torch.ops.eqn_codegen import op_count, trace_model

    n = HEAT_MGRID + 1
    lu_records = band_lu_phase(dev, heat_problem, card_line)
    d = np.linspace(0.5, 2.0, B_BAND)
    params = d[:, None]  # numpy: the entry point places it on the card

    # ---- 8. the lockstep path: K3 on every factorization, K4 on every solve
    band_lu.launch_band_lu_factor.launches = 0
    band_lu.launch_band_lu_solve.launches = 0
    t0 = time.perf_counter()
    lock = solve_dense_ensemble(BdfSolver, heat_problem, HEAT_T_EVAL, params,
                                mode="lockstep")
    torch.cuda.synchronize()
    lock_s = time.perf_counter() - t0
    k3 = band_lu.launch_band_lu_factor.launches
    k4 = band_lu.launch_band_lu_solve.launches
    if lock.tier != "lockstep" or not lock.ys.is_cuda:
        raise AssertionError(f"lockstep: tier {lock.tier!r}, ys on {lock.ys.device}")
    if k3 < 1 or k4 < 1:
        raise AssertionError(f"lockstep launched K3 {k3} and K4 {k4} times")
    err8 = check_heat("lockstep", lock, soln, d, n)
    st = lock.state.stats
    print(f"[8] lockstep path: B={B_BAND}, n={n}, {st.steps} steps, {st.newton_iterations} "
          f"Newton iterations, band LU launches factor {k3} solve {k4}, "
          f"TSTOP_REACHED, member d=1.0 vs analytic {err8:.3e}, {lock_s:.2f} s "
          f"(host clock, one run)", flush=True)
    lu_records[0]["launches"], lu_records[1]["launches"] = k3, k4

    # ---- 9. the fused band kernel vs its plain version at B=256
    p_check = torch.tensor(np.linspace(0.5, 2.0, B_BAND_CHECK)[:, None], device=dev)
    ys_k, st_k, steps_k = check_solve(p_check)
    ys_p, st_p, steps_p = check_solve.reference(p_check)
    torch.cuda.synchronize()
    if int(st_k.min()) != fs.OK or int(st_p.min()) != fs.OK:
        raise AssertionError(f"band status kernel {st_k.tolist()} plain {st_p.tolist()}")
    abs9, share9 = check_close("band B=256", ys_k, ys_p, steps_k, steps_p)
    print(f"[9] fused band kernel vs plain, B={B_BAND_CHECK} tile={check_solve.tile}: max "
          f"abs diff {abs9:.3e}, {share9:.3e} of the bound; steps per tile kernel "
          f"{steps_k.tolist()} plain {steps_p.tolist()}", flush=True)

    # ---- 10. the banded fused main path
    def main_path():
        return solve_dense_ensemble(BdfSolver, heat_problem, HEAT_T_EVAL, params,
                                    mode="fused")

    fb.launch_fused_band_bdf.launches = 0
    sol = main_path()
    torch.cuda.synchronize()
    k2 = fb.launch_fused_band_bdf.launches
    if sol.tier != "fused_band" or k2 != 1:
        raise AssertionError(f"fused: tier {sol.tier!r}, {k2} kernel launches")
    err10 = check_heat("fused", sol, soln, d, n)
    diff = (sol.ys - lock.ys).abs()
    if bool((diff > MODES_ATOL + MODES_RTOL * lock.ys.abs()).any()):
        raise AssertionError(f"fused and lockstep disagree: max abs {float(diff.max())}")
    steps = sol.tile_steps.cpu().numpy()
    print(f"[10] fused main path: B={B_BAND}, tier {sol.tier}, {k2} kernel launch, "
          f"TSTOP_REACHED, member d=1.0 vs analytic {err10:.3e}, vs lockstep max abs "
          f"{float(diff.max()):.3e}; accepted steps per tile {steps.tolist()}", flush=True)
    main_solve = fb.make_fused_band_bdf_solve(heat_problem, HEAT_T_EVAL, B_BAND)
    p_main = torch.tensor(params, device=dev)
    t0 = time.perf_counter()
    ys_p, st_p, steps_p = main_solve.reference(p_main)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    abs10, share10 = check_close("band B=1024", sol.ys.movedim(1, -1), ys_p,
                                 sol.tile_steps, steps_p)
    kernel_ms = time_ms(main_path, 5)
    # the least time: params, the host's initial state and h per tile in,
    # ys out once, or the f64 work of the accepted steps (a band solve
    # each), whichever is longer
    rhs_ops = op_count(trace_model(heat_problem.eqn.rhs, None, n, 1).rhs)
    bound_ms, bound_by, ops = k2_bound(n, 1, 1, rhs_ops, B_BAND, steps, B_BAND,
                                       sol.ys.numel())
    print(f"[10] fused band main path: {kernel_ms:.3f} ms median of 5; plain PyTorch "
          f"version {plain_ms:.1f} ms (one run, host clock); kernel vs plain max abs "
          f"{abs10:.3e}, {share10:.3e} of the bound, equal steps per tile; least time "
          f"{bound_ms:.4f} ms by {bound_by} ({ops / 1e9:.3f} GFLOP f64, a lower bound); "
          f"card {card_line}", flush=True)
    paths = [
        ("banded fused main path (B=1024)", main_path, "fused_band_bdf_kernel"),
        ("banded lockstep path (B=1024)", lambda: solve_dense_ensemble(
            BdfSolver, heat_problem, HEAT_T_EVAL, params, mode="lockstep"),
         "band_lu_solve_kernel"),
    ]
    return paths, lu_records + [k2_record(
        "fused_band_bdf", launches=k2, max_abs_err=abs10, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by)]


def mol2d_problem(name, banded=True):
    from diffsol_tpu_torch.models import foodweb, heat2d

    grid = MOL2D[name][0]
    return (heat2d.make(grid, banded=banded) if name == "heat2d"
            else foodweb.make(grid, banded=banded))


def mol2d_phases(dev, card_line, check_solves):
    """Phase 13; returns the 2-D paths to profile (name, callable, kernel:
    both fused ones and heat2d's lockstep one), the fused band kernel's
    records on them, and the band LU launches of each lockstep run (name
    -> (K3, K4)) for phase 14."""
    from diffsol_tpu_torch import BdfSolver, errors, solve_dense, solve_dense_ensemble
    from diffsol_tpu_torch.models import foodweb
    from diffsol_tpu_torch.ops import band_lu
    from diffsol_tpu_torch.ops import fused_band_stepper as fb
    from diffsol_tpu_torch.ops import fused_stepper as fs
    from diffsol_tpu_torch.ops.eqn_codegen import op_count

    paths, records, lu_launches = [], [], {}
    for name, (grid, te, max_steps) in MOL2D.items():
        problem = mol2d_problem(name)
        n = problem.eqn.nstates
        ml, mu = problem.linear_solver.meta
        params = np.ones((B_BAND, 1))

        def path(problem=problem, te=te, max_steps=max_steps, params=params):
            return solve_dense_ensemble(BdfSolver, problem, te, params, mode="fused",
                                        max_steps=max_steps)

        # ---- the fused path: one launch of the fused band kernel
        fb.launch_fused_band_bdf.launches = 0
        t0 = time.perf_counter()
        sol = path()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        k2 = fb.launch_fused_band_bdf.launches
        if sol.tier != "fused_band" or k2 != 1:
            raise AssertionError(f"{name} fused: tier {sol.tier!r}, {k2} kernel launches")
        if sol.stop_reason != errors.TSTOP_REACHED:
            raise AssertionError(f"{name} fused: stop_reason {sol.stop_reason}")
        if (tuple(sol.ys.shape) != (len(te), B_BAND, n)
                or not bool(torch.isfinite(sol.ys).all())):
            raise AssertionError(f"{name} fused: ys shape {tuple(sol.ys.shape)} or "
                                 "non-finite values")
        steps = sol.tile_steps.cpu().numpy()
        print(f"[13] {name} fused path: B={B_BAND}, n={n}, ml=mu={ml}, tier {sol.tier}, "
              f"{k2} kernel launch, TSTOP_REACHED, accepted steps per tile "
              f"{steps.tolist()}, first call {first_s:.2f} s (host clock)", flush=True)

        # ---- the lockstep path: the band LU kernels on every Newton matrix
        def lock_path(problem=problem, te=te, max_steps=max_steps, params=params):
            return solve_dense_ensemble(BdfSolver, problem, te, params, mode="lockstep",
                                        max_steps=max_steps)

        band_lu.launch_band_lu_factor.launches = 0
        band_lu.launch_band_lu_solve.launches = 0
        t0 = time.perf_counter()
        lock = lock_path()
        torch.cuda.synchronize()
        lock_s = time.perf_counter() - t0
        k3 = band_lu.launch_band_lu_factor.launches
        k4 = band_lu.launch_band_lu_solve.launches
        if lock.tier != "lockstep" or lock.stop_reason != errors.TSTOP_REACHED:
            raise AssertionError(f"{name} lockstep: tier {lock.tier!r}, stop_reason "
                                 f"{lock.stop_reason}")
        if k3 < 1 or k4 < 1:
            raise AssertionError(f"{name} lockstep launched K3 {k3} and K4 {k4} times")
        lu_launches[name] = (k3, k4)
        diff = (sol.ys - lock.ys).abs()
        if bool((diff > MODES_ATOL + MODES_RTOL * lock.ys.abs()).any()):
            raise AssertionError(f"{name}: fused and lockstep disagree, max abs "
                                 f"{float(diff.max())}")
        st = lock.state.stats
        lock_runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            lock_path()
            torch.cuda.synchronize()
            lock_runs.append(time.perf_counter() - t0)
        print(f"[13] {name} lockstep path: B={B_BAND}, {st.steps} steps, "
              f"{st.newton_iterations} Newton iterations, band LU launches factor {k3} "
              f"solve {k4}, TSTOP_REACHED, {float(np.median(lock_runs)):.3f} s median of 3 "
              f"after the first ({', '.join(f'{t:.3f}' for t in lock_runs)}; first call "
              f"{lock_s:.3f} s; host clock); fused vs lockstep max abs "
              f"{float(diff.max()):.3e} (largest value {float(lock.ys.abs().max()):.4g}); "
              f"card {card_line}", flush=True)
        if name == "heat2d":
            paths.append((f"{name} lockstep path (B={B_BAND})", lock_path,
                          "band_lu_factor_kernel"))

        # ---- member 0 against a single dense solve on the card
        dense = solve_dense(BdfSolver(mol2d_problem(name, banded=False)), te,
                            max_steps=20_000)
        if dense.stop_reason != errors.TSTOP_REACHED or not dense.ys.is_cuda:
            raise AssertionError(f"{name} dense: stop_reason {dense.stop_reason}")
        scale = max(1.0, float(dense.ys.abs().max()))
        d0 = (sol.ys[:, 0] - dense.ys).abs()
        if bool((d0 > DENSE_ATOL * scale + DENSE_RTOL * dense.ys.abs()).any()):
            raise AssertionError(f"{name}: member 0 off the dense solve by "
                                 f"{float(d0.max())}")
        line = f"member 0 vs dense solve_dense max abs {float(d0.max()):.3e}"
        md = torch.tensor(check_solves[name].cfg.mass_diag, device=dev)
        if name == "heat2d":
            edge = float(sol.ys[:, :, md == 0.0].abs().max())
            if not edge <= 1e-9:
                raise AssertionError(f"heat2d: boundary rows up to {edge}")
            line += f"; boundary rows within {edge:.1e} of 0"
        else:
            rows = [int(np.argmin(np.abs(foodweb.SOLN[:, 0] - t))) for t in te]
            corners = foodweb.corner_values(sol.ys[:, 0].cpu().numpy(), grid)
            np.testing.assert_allclose(corners, foodweb.SOLN[rows, 1:],
                                       rtol=SOLN_CORNER_RTOL)
            rel = float(np.abs(corners / foodweb.SOLN[rows, 1:] - 1.0).max())
            # the consistent initial state the fused tier starts from
            cfg = fb.make_fused_band_bdf_solve(problem, te, 2).cfg
            one = torch.ones(2, 1, dtype=torch.float64, device=dev)
            y0c = fb.initial_state(cfg, problem, one)[0][0, 0]
            t0_ = torch.tensor(0.0, dtype=torch.float64, device=dev)
            raw = problem.eqn.init(t0_, one[0])
            g_raw = float(problem.eqn.rhs(t0_, raw, one[0])[md == 0.0].abs().max())
            g_ic = float(problem.eqn.rhs(t0_, y0c, one[0])[md == 0.0].abs().max())
            if not (cfg.needs_ic_solve and g_ic < 1e-3 * g_raw):
                raise AssertionError(f"foodweb: algebraic residual {g_raw} -> {g_ic}")
            line += (f"; corners vs IDA (SOLN) max rel {rel:.2e}; consistent-IC solve took "
                     f"the algebraic residual from {g_raw:.3e} to {g_ic:.3e}")
        print(f"[13] {name}: {line}", flush=True)

        # ---- the kernel against its plain version at B=256
        check = check_solves[name]
        p_check = torch.ones(B_BAND_CHECK, 1, dtype=torch.float64, device=dev)
        ys_k, st_k, steps_k = check(p_check)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys_p, st_p, steps_p = check.reference(p_check)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if int(st_k.min()) != fs.OK or int(st_p.min()) != fs.OK:
            raise AssertionError(f"{name} status kernel {st_k.tolist()} plain "
                                 f"{st_p.tolist()}")
        if name == "heat2d":
            abs_c, share = check_close(f"{name} B=256", ys_k, ys_p, steps_k, steps_p)
            gate = f"{share:.3e} of the bound (atol {YS_ATOL:g}, rtol {YS_RTOL:g})"
        else:
            weight = float(problem.rtol) * ys_p.abs() + problem.atol.to(dev)[None, :, None]
            abs_c = float((ys_k - ys_p).abs().max())
            scaled = float(((ys_k - ys_p).abs() / weight).max())
            apart = int((steps_k - steps_p).abs().max())
            if not (scaled < FOODWEB_WEIGHTS and apart <= 0.2 * int(steps_p.max())):
                raise AssertionError(f"foodweb: kernel {scaled} error weights and {apart} "
                                     "steps from its plain version")
            gate = (f"{scaled:.3f} error weights (bound {FOODWEB_WEIGHTS:g}; max rel "
                    f"{float(((ys_k - ys_p).abs() / ys_p.abs()).max()):.3e}), not the "
                    f"1e-9 rule: its steps follow the last bit of the rhs")
        print(f"[13] {name}: fused band kernel vs plain, B={B_BAND_CHECK} "
              f"tile={check.tile}: max abs diff {abs_c:.3e}, {gate}; steps per tile kernel "
              f"{steps_k.tolist()} plain {steps_p.tolist()}; plain version {plain_ms:.0f} ms "
              f"(one run, host clock, B={B_BAND_CHECK})", flush=True)

        # ---- times and the least time for the accepted steps' work
        timed_b, timed = B_BAND, path
        if first_s > MOL2D_SLOW_S:
            timed_b = B_BAND_CHECK
            small = np.ones((timed_b, 1))

            def timed(problem=problem, te=te, max_steps=max_steps, small=small):
                return solve_dense_ensemble(BdfSolver, problem, te, small, mode="fused",
                                            max_steps=max_steps)
            print(f"[13] {name}: one fused call at B={B_BAND} took {first_s:.1f} s "
                  f"(> {MOL2D_SLOW_S:g} s), so it is timed at B={timed_b}", flush=True)
        kernel_ms = time_ms(timed, 3)
        rhs_ops = op_count(check.model.rhs)
        bound_ms, bound_by, ops = k2_bound(n, ml, mu, rhs_ops, timed_b, steps, timed_b,
                                           len(te) * n * timed_b)
        print(f"[13] {name} fused path at B={timed_b}: {kernel_ms:.1f} ms median of 3; "
              f"least time {bound_ms:.4f} ms by {bound_by} ({rhs_ops} f64 operations an "
              f"rhs, {ops / 1e9:.3f} GFLOP, a lower bound); card {card_line}", flush=True)
        paths.append((f"{name} fused path (B={timed_b})", timed, "fused_band_bdf_kernel"))
        records.append(k2_record(
            f"fused_band_bdf:{name}", launches=k2, max_abs_err=abs_c, ms=kernel_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
    return paths, records, lu_launches


def band_lu_wide_phase(dev, card_line, lu_launches):
    """Phase 14: the band LU kernels at nb = 41 on the iteration matrices of
    heat2d (n = 400) and foodweb (n = 200); returns their records, with the
    launches of each model's lockstep run."""
    from diffsol_tpu_torch.ops import band_lu
    from diffsol_tpu_torch.ops.banded import band_to_dense

    records = []
    common = {"route": "cuda", "source": "diffsol_tpu_torch/csrc/band_lu.cuh"}
    for name, tag in (("heat2d", "nb41"), ("foodweb", "foodweb")):
        problem = mol2d_problem(name)
        n, B = problem.eqn.nstates, B_BAND
        ml, mu = problem.linear_solver.meta
        nb = ml + mu + 1
        t0 = torch.tensor(0.0, dtype=torch.float64, device=dev)
        one = torch.ones(1, dtype=torch.float64, device=dev)
        y0 = problem.eqn.init(t0, one)
        jac = problem.eqn.jac(t0, y0, one)  # (nb, n), the same for every member
        mass = problem.eqn.mass_repr(t0, one)
        band1 = problem.linear_solver.assemble(mass, jac, 1e-3)
        band = band1.expand(B, -1, -1).contiguous()
        b = torch.tensor(np.random.default_rng(SEED).standard_normal((B, n)), device=dev)
        F, x = lu_once(band, b, ml, mu)
        F_p = band_lu.band_lu_factor_reference(band, ml, mu)
        x_p = band_lu.band_lu_solve_reference(F_p, b, ml, mu)
        torch.cuda.synchronize()
        ef = check_lu(f"{name} nb={nb} factor", F.lu, F_p)
        ex = check_lu(f"{name} nb={nb} solve", x, x_p)
        k3_ms = time_ms(lambda: band_lu.launch_band_lu_factor(band, ml, mu), 10)
        k4_ms = time_ms(lambda: band_lu.launch_band_lu_solve(F.lu, b, ml, mu), 10)
        k3_plain = time_ms(lambda: band_lu.band_lu_factor_reference(band, ml, mu), 1)
        k4_plain = time_ms(lambda: band_lu.band_lu_solve_reference(F.lu, b, ml, mu), 1)
        dense = band_to_dense(band1, ml, mu).expand(B, -1, -1).contiguous()
        lu, piv = torch.linalg.lu_factor(dense)
        x_lib = torch.linalg.lu_solve(lu, piv, b.unsqueeze(-1)).squeeze(-1)
        lib_err = float((x_lib - x).abs().max() / x.abs().max())
        lib_f_ms = time_ms(lambda: torch.linalg.lu_factor(dense), 3)
        lib_s_ms = time_ms(lambda: torch.linalg.lu_solve(lu, piv, b.unsqueeze(-1)), 3)
        # bytes: the band in and the factors out (factor); the factor
        # elements the sweeps use (the ml multipliers of columns 0 .. n-2, the
        # mu+1 rows of U), b in and x out (solve); operations: 2 ml mu a
        # column (factor), 2 (ml + mu) + 1 a row (solve)
        f_bound = bound(8 * B * (nb * n + (n + mu) * nb), B * n * 2 * ml * mu)
        s_bound = bound(8 * B * ((n - 1) * ml + n * (mu + 1) + 2 * n),
                        B * n * (2 * ml + 2 * mu + 1))
        print(f"[14] band LU kernels vs plain on {name}'s M - cJ (B={B}, n={n}, "
              f"ml=mu={ml}, nb={nb}): factors max abs diff {ef:.3e}, x max abs diff "
              f"{ex:.3e} (bound {LU_RTOL:g} relative), one launch each; median of 10: "
              f"factor {k3_ms:.4f} ms (least {f_bound[0]:.4f} ms by {f_bound[1]}), solve "
              f"{k4_ms:.4f} ms (least {s_bound[0]:.4f} ms by {s_bound[1]}); plain "
              f"{k3_plain:.0f} / {k4_plain:.0f} ms (one run); torch.linalg.lu_factor / "
              f"lu_solve on the dense (B, n, n) expansion {lib_f_ms:.3f} / {lib_s_ms:.3f} ms "
              f"(x within {lib_err:.1e} relative of the kernel's); {name}'s lockstep run "
              f"launched K3 {lu_launches[name][0]} and K4 {lu_launches[name][1]} times; card "
              f"{card_line}", flush=True)
        records += [
            dict(name=f"band_lu_factor:{tag}", replaces="diffsol_tpu/ops/pallas_banded.py:51",
                 launches=lu_launches[name][0], max_abs_err=ef, ms=k3_ms, plain_ms=k3_plain,
                 bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=lib_f_ms, **common),
            dict(name=f"band_lu_solve:{tag}", replaces="diffsol_tpu/ops/pallas_banded.py:72",
                 launches=lu_launches[name][1], max_abs_err=ex, ms=k4_ms, plain_ms=k4_plain,
                 bound_ms=s_bound[0], bound_by=s_bound[1], library_ms=lib_s_ms, **common),
        ]
    return records


def mixed_phase(dev, card_line, problem, shared):
    """Phase 15: the fused BDF kernel's mixed-precision build on the small-n
    main path's members; returns its path and record."""
    from diffsol_tpu_torch import BdfSolver, errors, solve_dense_ensemble
    from diffsol_tpu_torch.models import robertson
    from diffsol_tpu_torch.ops import fused_stepper as fs
    from diffsol_tpu_torch.ops.eqn_codegen import op_count

    te = robertson.T_EVAL_4E10
    # identical nominal members, as tests/test_pallas_stepper.py:451 and as
    # the reference's rows broadcast them: in the last decade to t = 4e10
    # float32 cannot resolve 1 - cJ (c |J| ~ 1e14), Newton fails often, and a
    # tile of spread members runs into the kernel's limit of 50 failures
    p_main = torch.tensor(np.tile(np.array(robertson.P_DEFAULT), (B_MAIN, 1)), device=dev)

    def path():
        return solve_dense_ensemble(BdfSolver, problem, te, p_main, mode="fused",
                                    precision="mixed")

    fs.launch_fused_bdf.launches = 0
    sol = path()
    torch.cuda.synchronize()
    launches = fs.launch_fused_bdf.launches
    if sol.tier != "fused_small_mixed" or launches != 1:
        raise AssertionError(f"mixed: tier {sol.tier!r}, {launches} kernel launches")
    if sol.stop_reason != errors.TSTOP_REACHED or not bool(torch.isfinite(sol.ys).all()):
        raise AssertionError(f"mixed: stop_reason {sol.stop_reason} or non-finite values")
    ode = solve_dense_ensemble(BdfSolver, problem, te, p_main, mode="fused").ys
    weight = torch.tensor([1e-8, 1e-6, 1e-6], device=dev) + 1e-4 * ode.abs()
    early = sum(t <= 4e4 for t in te)
    vs_df = float(((sol.ys - ode).abs() / weight).max())
    vs_df_early = float(((sol.ys[:early] - ode[:early]).abs() / weight[:early]).max())
    if not (vs_df < MIXED_WEIGHTS and vs_df_early < MIXED_EARLY_WEIGHTS):
        raise AssertionError(f"mixed: {vs_df} error weights from the float64 path "
                             f"({vs_df_early} up to t = 4e4)")
    main_solve = fs.make_fused_bdf_solve(problem, te, B_MAIN, precision="mixed")
    t0 = time.perf_counter()
    ys_p, st_p, steps_p = main_solve.reference(p_main)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if int(st_p.min()) != fs.OK:
        raise AssertionError(f"mixed plain version: status {st_p.tolist()}")
    diff = (sol.ys.movedim(1, -1) - ys_p).abs()
    vs_plain = float((diff / weight.movedim(1, -1)).max())
    if not vs_plain < MIXED_WEIGHTS:
        raise AssertionError(f"mixed: kernel {vs_plain} error weights from its plain "
                             "version")
    steps = sol.tile_steps.cpu().numpy()
    steps_pl = steps_p.cpu().numpy()
    kernel_ms = time_ms(path, 5)
    # the least time: the linear solve's 2 n^2 operations a step run in
    # float32, the rest of the step in float64
    n = 3
    member_steps = B_MAIN * float(np.mean(steps))
    ops64 = member_steps * bdf_step_ops(n, op_count(main_solve.model.rhs), 0)
    ops32 = member_steps * 2 * n * n
    nbytes = 8 * (p_main.numel() + sol.ys.numel() + len(te))
    bound_ms, bound_by = bound(nbytes, ops64 + ops32 * PEAK_F64 / PEAK_F32)
    print(f"[15] fused BDF kernel, precision=\"mixed\": B={B_MAIN}, tier {sol.tier}, "
          f"{launches} kernel launch, TSTOP_REACHED; vs the float64 path {vs_df:.3f} error "
          f"weights over all points (bound {MIXED_WEIGHTS:g}), {vs_df_early:.2e} up to "
          f"t = 4e4 (bound {MIXED_EARLY_WEIGHTS:g}); vs its plain version {vs_plain:.3f} "
          f"weights, max abs {float(diff.max()):.3e}, steps per tile kernel min "
          f"{steps.min()} median {int(np.median(steps))} max {steps.max()}, plain min "
          f"{steps_pl.min()} median {int(np.median(steps_pl))} max {steps_pl.max()}, equal "
          f"in {int((steps == steps_pl).sum())} of {len(steps)} tiles (the float32 LU and "
          f"probes run in another order in the two)", flush=True)
    spread = solve_dense_ensemble(BdfSolver, problem, te, shared["p_main"], mode="fused",
                                  precision="mixed")
    ok_tiles = int(torch.isfinite(spread.ys[-1, :, 0]).sum())
    print(f"[15] the same with phase 4's spread members (k1 +-10%): stop_reason "
          f"{spread.stop_reason}, {ok_tiles} of {B_MAIN} members finite at t = 4e10 (a tile "
          f"that runs into the 50-failure Newton limit fails loudly, as in the plain "
          f"version)", flush=True)
    print(f"[15] mixed path: {kernel_ms:.3f} ms median of 5; plain PyTorch version "
          f"{plain_ms:.1f} ms (one run, host clock); least time {bound_ms:.4f} ms by "
          f"{bound_by} (a lower bound: the solve's operations at the float32 peak, the "
          f"rest at the float64 one); card {card_line}",
          flush=True)
    te_dev = torch.tensor(te, dtype=torch.float64, device=dev)
    return (("small-n mixed-precision path (B=10,000)", path, "fused_bdf_kernel",
             lambda: fs.launch_fused_bdf(main_solve.cfg, main_solve.header, p_main, te_dev)),
            k1_record("mixed", launches=launches, max_abs_err=float(diff.max()),
                      ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by))


def profile_paths(paths, card_line):
    """Phase 11: trace one call of each path (after a warm-up) with
    torch.profiler; print its wall time, the device time by kernel and the
    busy share.  ``paths`` holds (name, callable, a part of the name of
    the kernel the path must show) and, for the small-n kernel's paths, a
    fourth item: a callable that launches the kernel alone.  A trace that
    lacks the kernel (the tracer at times drops the record of a kernel
    launched through ctypes) is taken again, up to four times, and then
    reported as not measured with what it did record.  Where the kernel
    alone can be launched, the call and the kernel are also timed
    unprofiled between CUDA events: the kernel's device time, its share of
    the call and the call's host part."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, fn, must_show, *alone in paths:
        fn()
        torch.cuda.synchronize()
        if alone:
            call_ms, k_ms = time_ms(fn, 5), time_ms(alone[0], 5)
            print(f"[11] {name}: unprofiled, call {call_ms:.3f} ms and K1 alone {k_ms:.3f} "
                  f"ms (CUDA events, medians of 5): the kernel {k_ms / call_ms:.1%} of the "
                  f"call, host part {call_ms - k_ms:.3f} ms; card {card_line}", flush=True)
        for _ in range(4):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            kernels = sorted(
                ((getattr(ev, "self_device_time_total", 0.0), ev.count, ev.key)
                 for ev in prof.key_averages()
                 if getattr(ev, "device_type", None) == DeviceType.CUDA),
                reverse=True)
            if any(must_show in key for _, _, key in kernels):
                break
        else:
            seen = "; ".join(f"{key[:60]} x{cnt}" for _, cnt, key in kernels[:4]) or "nothing"
            print(f"[11] {name}: the profiler recorded no {must_show} in four traces (not "
                  f"measured); it recorded {seen}", flush=True)
            continue
        busy_us = sum(k[0] for k in kernels)
        top = "; ".join(f"{key[:60]} {us / 1e3:.3f} ms x{cnt}" for us, cnt, key in kernels[:6])
        # each kernel of the port's share, where the path runs it
        ours = "".join(
            f", {label} {sum(us for us, _, key in hits) / 1e3:.3f} ms x"
            f"{sum(cnt for _, cnt, _ in hits)}"
            for label, hits in (
                (label, [k for k in kernels if kernel in k[2]])
                for label, kernel in (("K1", "fused_bdf_kernel"),
                                      ("K2", "fused_band_bdf_kernel"),
                                      ("K3", "band_lu_factor_kernel"),
                                      ("K4", "band_lu_solve_kernel")))
            if hits)
        k1_us = sum(us for us, _, key in kernels if "fused_bdf_kernel" in key)
        host = (f", host part of the call (call minus K1) {(wall_us - k1_us) / 1e3:.3f} ms"
                if k1_us else "")
        print(f"[11] {name}: call {wall_us / 1e3:.3f} ms (host clock, profiled), "
              f"device busy {busy_us / 1e3:.3f} ms = {busy_us / wall_us:.1%} of the call"
              f"{ours}{host}, {sum(k[1] for k in kernels)} kernel launches; top: {top}; card "
              f"{card_line}", flush=True)

# ---------------------------------------------------------------------------
# phases 16-19: the eager paths of the other methods, the block-diagonal tier
# and a dense mass.  Their JAX counterparts reach no Pallas kernel, so these
# paths launch PyTorch's own kernels only; each is timed and gated here.

# the parity sweep's tolerances and bound (tests/test_parity_sweep.py)
SWEEP_RTOL, SWEEP_ATOL = 1e-6, 1e-8
SWEEP_CHECK = 200 * SWEEP_RTOL
B_RK = 1024
# lockstep members against their own single solves, as
# tests/test_blockdiag.py:156-159
MEMBER_RTOL, MEMBER_ATOL = 2e-3, 1e-10
# the block tier against the dense Jacobian (tests/test_blockdiag.py:124-126)
BLOCK_RTOL, BLOCK_ATOL = 1e-6, 1e-10
# the card's solve against the CPU's of the same problem
CARD_CPU_RTOL, CARD_CPU_ATOL, CARD_CPU_STEPS = 1e-8, 1e-14, 2


def timed_solve(fn):
    """``(solution, ms)``: ``fn``'s first call, whose solution the gates
    read, is the warm-up; then the median of 3 calls between CUDA events
    (an eager solve reads its status on the host, a sync, every step)."""
    sol = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sol, float(np.median(times))


def stats_line(sol) -> str:
    st = sol.state.stats
    return (f"{st.steps} steps, {st.newton_iterations} Newton iterations, "
            f"{st.linear_solver_setups} linear solver setups")


def check_soln(name, ys, rtol=5e-3):
    """Robertson ODE rows (neval, ..., 3) against the CVODE table for t <=
    4e6, at tests/test_torch_bdf.py:58-59's tolerances (every group or
    member along the middle axes)."""
    from diffsol_tpu_torch.models import robertson

    ys = ys.cpu().numpy()[:8]
    ref = robertson.SOLN[1:9, 1:].reshape((8,) + (1,) * (ys.ndim - 2) + (3,))
    for i, atol in ((0, 1e-10), (2, 1e-8)):
        np.testing.assert_allclose(ys[..., i], np.broadcast_to(ref[..., i], ys[..., i].shape),
                                   rtol=rtol, atol=atol, err_msg=name)


def sweep_cases():
    """The five exact-solution cases of tests/test_parity_sweep.py:41-84."""
    import dataclasses

    from diffsol_tpu_torch.models import (exponential_decay, exponential_decay_algebraic,
                                          logistic, misc)

    def tight(pr):
        return dataclasses.replace(pr, rtol=torch.tensor(SWEEP_RTOL, dtype=torch.float64),
                                   atol=torch.full_like(pr.atol, SWEEP_ATOL))

    gd = tight(misc.gaussian_decay_problem())
    t1, t2, t3 = [0.25, 0.5, 1.0], [1.0, 5.0, 10.0], [0.5, 1.0]
    return {
        "exponential_decay": (exponential_decay.problem(rtol=SWEEP_RTOL, atol=SWEEP_ATOL), t1,
                              exponential_decay.soln(t1, [0.1, 1.0])),
        "logistic": (logistic.problem(rtol=SWEEP_RTOL, atol=SWEEP_ATOL), t2,
                     logistic.soln(t2, [1.0, 1.0, 0.1])),
        "gaussian_decay": (gd, t3, misc.gaussian_decay_soln(t3, gd.params.numpy())),
        "dydt_y2": (tight(misc.dydt_y2_problem()), [0.4, 0.8],
                    misc.dydt_y2_soln([0.4, 0.8])),
        "exponential_decay_algebraic": (tight(exponential_decay_algebraic.problem()),
                                        [0.4, 0.8],
                                        exponential_decay_algebraic.soln([0.4, 0.8], [0.1])),
    }


def methods_phase(card_line):
    """Phase 16: each of METHODS on the parity sweep's five cases on the
    card, against the exact solution."""
    import diffsol_tpu_torch as dtt

    for name, (problem, te, exact) in sweep_cases().items():
        for method in dtt.METHODS:
            if method == "tsit45" and problem.eqn.mass is not None:
                continue  # explicit RK takes no DAE (as the JAX test)

            def run(problem=problem, te=te, method=method):
                return dtt.solve_dense(dtt.solver(problem, method), te, max_steps=40_000)

            sol, ms = timed_solve(run)
            if sol.stop_reason != dtt.errors.TSTOP_REACHED or not sol.ys.is_cuda:
                raise AssertionError(f"{name} {method}: stop_reason {sol.stop_reason}")
            err = float(np.max(np.abs(sol.ys.cpu().numpy() - exact) / (np.abs(exact) + 1e-3)))
            if not err < SWEEP_CHECK:
                raise AssertionError(f"{name} {method}: error {err} >= {SWEEP_CHECK}")
            print(f"[16] {name} {method}: {stats_line(sol)}, error vs exact {err:.3e} "
                  f"(< {SWEEP_CHECK:g}), {ms:.2f} ms median of 3 (CUDA events); card "
                  f"{card_line}", flush=True)


def rk_lockstep_phase(dev, card_line):
    """Phase 17: RK lockstep ensembles of 1,024 members on the card."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import logistic, robertson

    te = robertson.SOLN[1:9, 0]
    problem = robertson.problem_ode()
    params = robertson_params(B_RK, np.random.default_rng(SEED), dev)
    for method in ("tr_bdf2", "esdirk34"):
        def run(method=method):
            return dtt.solve_dense_ensemble(lambda pr: dtt.solver(pr, method), problem, te,
                                            params, mode="lockstep", max_steps=20_000)

        sol, ms = timed_solve(run)
        if sol.tier != "lockstep" or sol.stop_reason != dtt.errors.TSTOP_REACHED:
            raise AssertionError(f"robertson {method}: tier {sol.tier}, stop_reason "
                                 f"{sol.stop_reason}")
        check_soln(f"robertson {method} member 0", sol.ys[:, 0])
        worst = 0.0
        for b in (0, B_RK // 2 - 1, B_RK - 1):
            one = dtt.solve_dense(dtt.solver(problem, method), te, params=params[b],
                                  max_steps=20_000).ys
            d = (sol.ys[:, b] - one).abs()
            if bool((d > MEMBER_ATOL + MEMBER_RTOL * one.abs()).any()):
                raise AssertionError(f"robertson {method}: member {b} off its single solve")
            worst = max(worst, float((d / (MEMBER_ATOL + one.abs())).max()))
        print(f"[17] robertson_ode {method} lockstep B={B_RK}: {stats_line(sol)}, "
              f"{ms:.1f} ms median of 3 (CUDA events); member 0 meets the CVODE table "
              f"(rtol 5e-3), members 0, {B_RK // 2 - 1}, {B_RK - 1} within {worst:.2e} "
              f"relative of their single solves (< {MEMBER_RTOL:g}); card {card_line}",
              flush=True)

    rng = np.random.default_rng(SEED)
    r = 1.0 + 0.1 * rng.uniform(-1.0, 1.0, B_RK)
    r[0] = 1.0
    lp = torch.tensor(np.stack([r, np.ones(B_RK), np.full(B_RK, 0.1)], axis=1), device=dev)
    tl = [1.0, 5.0, 10.0]
    lproblem = logistic.problem()

    def run_logistic():
        return dtt.solve_dense_ensemble(lambda pr: dtt.solver(pr, "tsit45"), lproblem, tl, lp,
                                        mode="lockstep")

    sol, ms = timed_solve(run_logistic)
    exact = np.stack([logistic.soln(tl, p) for p in lp.cpu().numpy()], axis=1)
    err = float(np.max(np.abs(sol.ys.cpu().numpy() - exact) / (np.abs(exact) + 1e-3)))
    check = 200 * float(lproblem.rtol)
    if sol.stop_reason != dtt.errors.TSTOP_REACHED or not err < check:
        raise AssertionError(f"logistic tsit45: stop_reason {sol.stop_reason}, error {err}")
    print(f"[17] logistic tsit45 lockstep B={B_RK}: {stats_line(sol)}, "
          f"{sol.state.stats.rhs_evals} rhs evaluations, {ms:.2f} ms median of 3 (CUDA "
          f"events); every member within {err:.2e} of the exact solution (< {check:g}); "
          f"card {card_line}", flush=True)


def profile_line(tag, fn, card_line, steps_of=lambda sol: sol.state.stats.steps):
    """One traced call of ``fn`` (a solve, whose steps ``steps_of`` reads
    from its result): the kernel launches a step and the card's busy share
    of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the card's activity only: a host-side record of the ~45,000 launches'
    # operators would cost more to gather than the call itself
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = steps_of(fn())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [ev for ev in prof.key_averages()
               if getattr(ev, "device_type", None) == DeviceType.CUDA]
    launches = sum(ev.count for ev in kernels)
    busy_us = sum(getattr(ev, "self_device_time_total", 0.0) for ev in kernels)
    top = sorted(kernels, key=lambda ev: -getattr(ev, "self_device_time_total", 0.0))[:4]
    print(f"[{tag}] profiled call {wall_us / 1e3:.1f} ms (host clock), {steps} steps, "
          f"{launches} kernel launches = {launches / max(steps, 1):.1f} a step, device busy "
          f"{busy_us / 1e3:.2f} ms = {busy_us / wall_us:.1%} of the call; top: "
          + "; ".join(f"{ev.key[:50]} {ev.self_device_time_total / 1e3:.2f} ms x{ev.count}"
                      for ev in top) + f"; the trace took {time.perf_counter() - t_prof:.1f} s "
          f"in all; card {card_line}", flush=True)


def blockdiag_phase(dev, card_line):
    """Phase 18: the block-diagonal tier at the reference's width."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import robertson

    te = robertson.T_EVAL_4E10
    wide = robertson.problem_ode_groups(1000)
    if wide.linear_solver.name != "blockdiag(3,1000)":
        raise AssertionError(f"ngroups=1000 routed to {wide.linear_solver.name}")

    def run_wide():
        return dtt.solve_dense(dtt.BdfSolver(wide), te, max_steps=5000)

    sol, ms = timed_solve(run_wide)
    if sol.stop_reason != dtt.errors.TSTOP_REACHED or not sol.ys.is_cuda:
        raise AssertionError(f"ngroups=1000: stop_reason {sol.stop_reason}")
    check_soln("ngroups=1000", sol.ys.reshape(len(te), 1000, 3))
    factorizations = sol.state.stats.linear_solver_setups
    print(f"[18] robertson_ode ngroups=1000 (n=3000, blockdiag(3,1000)) BdfSolver to "
          f"t=4e10: {stats_line(sol)}, {factorizations} batched LU factorizations of "
          f"(1000, 3, 3), {ms:.1f} ms median of 3 (CUDA events); every group meets the "
          f"CVODE table to t=4e6 (rtol 5e-3); card {card_line}", flush=True)
    # the trace of a call costs ten times the call: trace its first 100
    # steps, to t = 400, as the window
    profile_line(18, lambda: dtt.solve_dense(dtt.BdfSolver(wide), te[:4], max_steps=5000),
                 card_line)

    narrow = robertson.problem_ode_groups(100)
    B = 100
    pb = torch.tensor(np.tile(np.array(robertson.P_DEFAULT), (B, 1)), device=dev)

    def run_lock():
        return dtt.solve_dense_ensemble(dtt.BdfSolver, narrow, te, pb, mode="lockstep",
                                        max_steps=5000)

    lock, ms = timed_solve(run_lock)
    if lock.stop_reason != dtt.errors.TSTOP_REACHED:
        raise AssertionError(f"g100 x b100: stop_reason {lock.stop_reason}")
    for b in (0, B - 1):
        one = dtt.solve_dense(dtt.BdfSolver(narrow), te, params=pb[b], max_steps=5000).ys
        d = (lock.ys[:, b] - one).abs()
        if bool((d > MEMBER_ATOL + MEMBER_RTOL * one.abs()).any()):
            raise AssertionError(f"g100 x b100: member {b} off its single solve")
    print(f"[18] robertson_ode g100 x b100 lockstep (one (10000, 3, 3) LU stack, "
          f"{dtt.make_lockstep_problem(narrow, B).linear_solver.name}): {stats_line(lock)}, "
          f"{ms:.1f} ms median of 3 (CUDA events); members 0 and {B - 1} match their "
          f"single solves (rtol {MEMBER_RTOL:g}); card {card_line}", flush=True)

    small_te = robertson.SOLN[1:9, 0]
    blk = dtt.solve_dense(dtt.BdfSolver(robertson.problem_ode_groups(5)), small_te,
                          max_steps=5000)
    dense = dtt.solve_dense(dtt.BdfSolver(robertson.problem_ode_groups(5, use_coloring=False)),
                            small_te, max_steps=5000)
    diff = (blk.ys - dense.ys).abs()
    if bool((diff > BLOCK_ATOL + BLOCK_RTOL * dense.ys.abs()).any()):
        raise AssertionError(f"ngroups=5: block and dense tiers part by {float(diff.max())}")
    print(f"[18] ngroups=5: block tier vs dense Jacobian max abs {float(diff.max()):.3e} "
          f"(bound {BLOCK_ATOL:g} + {BLOCK_RTOL:g} |y|), steps {blk.state.stats.steps} vs "
          f"{dense.state.stats.steps}; card {card_line}", flush=True)


def mass_phase(card_line):
    """Phase 19: a mass given as a matrix and a user Jacobian on the card,
    against the same solve on the CPU."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import heat2d_mass

    te = [0.01, 0.05]
    for consistent, label in ((False, "lumped (diagonal) mass"), (True, "dense mass")):
        problem = heat2d_mass.problem(4, consistent)
        for method in ("bdf", "tr_bdf2"):
            def run(device=None, problem=problem, method=method):
                return dtt.solve_dense(dtt.solver(problem, method), te, max_steps=2000,
                                       device=device)

            (sol, ms), ref = timed_solve(run), run("cpu")
            if sol.stop_reason != dtt.errors.TSTOP_REACHED or not sol.ys.is_cuda:
                raise AssertionError(f"heat2d_mass {label} {method}: {sol.stop_reason}")
            # 1e-8 relative, and 1e-14 absolute for the edge states at zero
            diff = (sol.ys.cpu() - ref.ys).abs()
            d = float((diff / (CARD_CPU_ATOL + ref.ys.abs())).max())
            dsteps = abs(sol.state.stats.steps - ref.state.stats.steps)
            if (bool((diff > CARD_CPU_ATOL + CARD_CPU_RTOL * ref.ys.abs()).any())
                    or dsteps > CARD_CPU_STEPS):
                raise AssertionError(f"heat2d_mass {label} {method}: card vs CPU max abs "
                                     f"{float(diff.max())}, steps {sol.state.stats.steps} "
                                     f"vs {ref.state.stats.steps}")
            print(f"[19] heat2d_mass mgrid=4 (n=16) {label}, user Jacobian, {method}: "
                  f"{stats_line(sol)}, {ms:.2f} ms median of 3 (CUDA events); vs the CPU "
                  f"max abs {float(diff.max()):.2e} (max of |diff| / (1e-14 + |y|) "
                  f"{d:.2e}), steps {sol.state.stats.steps} vs "
                  f"{ref.state.stats.steps}; card {card_line}", flush=True)


# ---------------------------------------------------------------------------
# phase 20: models written as DiffSL text, through K1 and K2 (fused) and
# K3/K4 (banded lockstep)
# ---------------------------------------------------------------------------

# tests/test_diffsl.py:166-173: decay to 0.5 at ln 2, reset to 1.5; the
# next crossing (ln 2 + ln 3) lies past the last output time
DIFFSL_STOP_RESET = """
in_i { r = 1.0 }
u_i { y = 1.0 }
F_i { -r * y }
stop_i { y - 0.5 }
reset_i { y + 1.0 }
out_i { y }
"""
DIFFSL_RESET_T_EVAL = [0.25, 0.5, 0.75, 1.0, 1.25, 1.5]
# tests/test_diffsl.py::test_model_index_builtin_N: the reset at t = 0.5
# sets N to the fired root's index (0) and y to 0.1 + 0.5 N
DIFFSL_MODEL_INDEX = """
in_i { r = 1 }
u_i { y = 0.1 }
dudt_i { dydt = 0 }
F_i { r * y * (1.0 - y) }
stop_i { t - 0.5 }
reset_i { 0.1 + 0.5 * N }
out_i { y }
"""
# two roots, the second (y = 0.5, near t = 2.2) fires first: N = 1 and y
# resets to 0.3 (the JAX lockstep path keeps N = 0, ROADMAP.md queue 3)
DIFFSL_TWO_ROOTS = """
in_i { r = 1.0 }
u_i { y = 0.1 }
F_i { r * y * (1.0 - y) }
stop_i { t - 5.0, y - 0.5 }
reset_i { 0.1 + 0.2 * N }
out_i { y }
"""
B_DIFFSL_LOCKSTEP = 256
# the phase-20 models that the small-n kernel takes
K1_DIFFSL = ("diffsl_ode", "diffsl_dae", "diffsl_reset")


def diffsl_models():
    """name -> (the DiffSL problem, its hand-written twin or None, t_eval,
    params and the twin's params (numpy, (B, np))), for phase 20."""
    from diffsol_tpu_torch import OdeBuilder
    from diffsol_tpu_torch.models import diffsl_sources as ds
    from diffsol_tpu_torch.models import heat1d, robertson

    atol = [1e-8, 1e-6, 1e-6]
    spread = robertson_params(B_MAIN, np.random.default_rng(SEED), "cpu").numpy()
    d = np.linspace(0.5, 2.0, B_BAND)[:, None]
    return {
        "diffsl_ode": (OdeBuilder().rtol(1e-4).atol(atol).build_from_diffsl(ds.robertson_ode()),
                       robertson.problem_ode(), robertson.T_EVAL_4E10, spread, spread),
        "diffsl_dae": (OdeBuilder().rtol(1e-4).atol(atol).build_from_diffsl(ds.robertson_dae()),
                       robertson.problem_dae(), robertson.T_EVAL_4E10, spread, spread),
        "diffsl_reset": (OdeBuilder().rtol(1e-8).atol(1e-10).build_from_diffsl(DIFFSL_STOP_RESET),
                         None, DIFFSL_RESET_T_EVAL, np.ones((B_MAIN, 1)), None),
        "diffsl_heat1d": (OdeBuilder().rtol(1e-6).atol(1e-8).use_coloring()
                          .build_from_diffsl(ds.heat1d(HEAT_MGRID)),
                          heat1d.make(HEAT_MGRID, rtol=1e-6, atol=1e-8, banded=True)[0],
                          HEAT_T_EVAL, d, d),
        # n = 400 >= 256 states: the builder colors and routes to the band
        "diffsl_heat2d": (OdeBuilder().rtol(1e-5).atol(1e-5)
                          .build_from_diffsl(ds.heat2d(MOL2D["heat2d"][0])),
                          mol2d_problem("heat2d"), MOL2D["heat2d"][1],
                          np.zeros((B_BAND, 0)), np.ones((B_BAND, 1))),
    }


def diffsl_check_solves(models):
    """The kernel-vs-plain solves of phase 20 (built at phase 2, so that
    their nvcc runs start with the others): K1 at full width, K2 at
    heat1d's full width and at B_BAND_CHECK for heat2d."""
    from diffsol_tpu_torch.ops import fused_band_stepper as fb
    from diffsol_tpu_torch.ops import fused_stepper as fs

    out = {}
    for name, (problem, _twin, te, params, _tp) in models.items():
        if problem.linear_solver.name.startswith("banded"):
            nb = B_BAND if name == "diffsl_heat1d" else B_BAND_CHECK
            out[name] = fb.make_fused_band_bdf_solve(problem, te, nb)
        else:
            out[name] = fs.make_fused_bdf_solve(problem, te, len(params))
    return out


def diffsl_closed_form(name, sol, t_eval):
    """Each DiffSL model's fused run against its closed form; returns a
    line for the log."""
    from diffsol_tpu_torch.models import diffsl_sources as ds
    from diffsol_tpu_torch.models import heat1d, robertson

    ys = sol.ys.cpu().numpy()
    te = np.asarray(t_eval)
    if name in ("diffsl_ode", "diffsl_dae"):
        rows = robertson.SOLN[1:][robertson.SOLN[1:, 0] <= 4e6]
        for s, tol in enumerate(SOLN_TOL):
            if tol is not None:
                np.testing.assert_allclose(ys[: len(rows), 0, s], rows[:, 1 + s],
                                           rtol=tol[0], atol=tol[1])
        total = float(np.abs(ys.sum(-1) - 1.0).max())
        if not total <= 1e-6:
            raise AssertionError(f"{name}: x + y + z off 1 by {total}")
        return (f"member 0 matches SOLN (t <= 4e6), |x+y+z-1| <= {total:.2e} over every "
                "member and point")
    if name == "diffsl_reset":
        t_r = np.log(2.0)
        exact = np.where(te < t_r, np.exp(-te), 1.5 * np.exp(-(te - t_r)))
        np.testing.assert_allclose(ys[:, :, 0], exact[:, None] * np.ones(ys.shape[1]),
                                   rtol=1e-5)
        return (f"y vs e^-t, then 1.5 e^-(t - ln 2) after the one reset: max rel "
                f"{np.abs(ys[:, :, 0] / exact[:, None] - 1.0).max():.2e}")
    if name == "diffsl_heat1d":
        n = HEAT_MGRID + 1
        _problem, soln = heat1d.make(HEAT_MGRID)
        err = check_heat(name, sol, soln, np.linspace(0.5, 2.0, B_BAND), n)
        return f"member d=1.0 vs the Fourier series {err:.3e}"
    _D, mass, _u0, _dx2 = ds.heat2d_matrices(MOL2D["heat2d"][0])
    edge = float(np.abs(ys[:, :, np.diagonal(mass) == 0.0]).max())
    if not edge <= 1e-9:
        raise AssertionError(f"{name}: boundary rows up to {edge}")
    return f"boundary rows within {edge:.1e} of 0"


def diffsl_index_phase(dev, card_line):
    """The N models (reset_n): refused by the fused tier, solved lockstep
    under mode="auto" on the card, with the reset values the index gives."""
    from diffsol_tpu_torch import BdfSolver, OdeBuilder, errors, solve_dense_ensemble
    from diffsol_tpu_torch.ops.eqn_codegen import UnsupportedForKernel

    def logistic(y0, t):
        return y0 * np.exp(t) / (1.0 - y0 + y0 * np.exp(t))

    cases = (
        ("model_index", DIFFSL_MODEL_INDEX, [0.25, 0.5, 0.75, 1.0],
         lambda te: np.where(te <= 0.5, logistic(0.1, te), logistic(0.1, te - 0.5)), 0.0),
        # y = 0.5 at t1 = ln 9, reset to 0.3; a second crossing past t = 4
        ("two_roots", DIFFSL_TWO_ROOTS, [1.0, 2.0, 3.0, 4.0],
         lambda te: np.where(te <= np.log(9.0), logistic(0.1, te),
                             logistic(0.3, te - np.log(9.0))), 1.0),
    )
    for label, text, t_eval, exact, index in cases:
        problem = OdeBuilder().rtol(1e-8).atol(1e-10).build_from_diffsl(text)
        params = np.ones((B_DIFFSL_LOCKSTEP, 1))
        try:
            solve_dense_ensemble(BdfSolver, problem, t_eval, params, mode="fused")
        except UnsupportedForKernel as e:
            refused = str(e)
        else:
            raise AssertionError(f"{label}: the fused tier took a reset_n model")
        t0 = time.perf_counter()
        sol = solve_dense_ensemble(BdfSolver, problem, t_eval, params, mode="auto")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if sol.tier != "lockstep" or sol.stop_reason != errors.TSTOP_REACHED:
            raise AssertionError(f"{label}: tier {sol.tier!r}, stop_reason {sol.stop_reason}")
        ys = sol.ys.cpu().numpy()
        te = np.asarray(t_eval)
        if label == "two_roots":  # the second crossing: y = 0.5 again past t = 3
            te, ys = te[:3], ys[:3]
        want = exact(te)
        np.testing.assert_allclose(ys[:, :, 0], want[:, None] * np.ones(ys.shape[1]),
                                   rtol=1e-6)
        if not np.all(ys[-1, :, 1] == index):
            raise AssertionError(f"{label}: hidden index {ys[-1, :, 1]}, expected {index}")
        print(f"[20] {label} (reset_n): mode='fused' refused ({refused}); mode='auto' -> "
              f"{sol.tier}, B={B_DIFFSL_LOCKSTEP}, {sol.state.stats.steps} steps, "
              f"TSTOP_REACHED, y vs the closed form max rel "
              f"{np.abs(ys[:, :, 0] / want[:, None] - 1.0).max():.2e}, hidden index N = "
              f"{index:g} after the reset; {secs:.2f} s (host clock, one run); card "
              f"{card_line}", flush=True)


def diffsl_phase(dev, card_line, models, check_solves):
    """Phase 20; returns the kernels' records of the DiffSL paths."""
    import hashlib

    from diffsol_tpu_torch import BdfSolver, _build, errors, solve_dense_ensemble
    from diffsol_tpu_torch.ops import band_lu
    from diffsol_tpu_torch.ops import fused_band_stepper as fb
    from diffsol_tpu_torch.ops import fused_stepper as fs
    from diffsol_tpu_torch.ops.eqn_codegen import op_count

    records = []
    for name, (problem, twin, te, params, twin_params) in models.items():
        band = problem.linear_solver.name.startswith("banded")
        counter = fb.launch_fused_band_bdf if band else fs.launch_fused_bdf
        p = torch.tensor(params, device=dev)
        reps = 3 if name == "diffsl_heat2d" else 5

        def path(problem=problem, te=te, p=p):
            return solve_dense_ensemble(BdfSolver, problem, te, p, mode="fused")

        # ---- the fused path: one launch of its kernel
        counter.launches = 0
        sol = path()
        torch.cuda.synchronize()
        launches = counter.launches
        tier = "fused_band" if band else "fused_small"
        if sol.tier != tier or launches != 1:
            raise AssertionError(f"{name}: tier {sol.tier!r}, {launches} kernel launches")
        if sol.stop_reason != errors.TSTOP_REACHED:
            raise AssertionError(f"{name}: stop_reason {sol.stop_reason}")
        n = problem.eqn.nstates
        if (tuple(sol.ys.shape) != (len(te), len(params), n)
                or not bool(torch.isfinite(sol.ys).all())):
            raise AssertionError(f"{name}: ys shape {tuple(sol.ys.shape)} or non-finite")
        line = diffsl_closed_form(name, sol, te)
        steps = sol.tile_steps.cpu().numpy()
        print(f"[20] {name}: {problem.linear_solver.name}, n={n}, B={len(params)}, tier "
              f"{sol.tier}, {launches} kernel launch, TSTOP_REACHED; {line}; accepted steps "
              f"per tile min {steps.min()}, median {int(np.median(steps))}, max "
              f"{steps.max()}", flush=True)

        # ---- the kernel against its plain version
        check = check_solves[name]
        lib = (_build.load_fused_band_bdf(check.header, *problem.linear_solver.meta) if band
               else _build.load_fused_bdf(check.header))
        built = [b["seconds"] for b in _build.BUILDS
                 if b["library"] == lib._name.rsplit("/", 1)[-1]]
        print(f"[20] {name}: rhs op_count {op_count(check.model.rhs)}, nvcc "
              + (f"{built[0]:.1f} s" if built else "not run (the library was under build/)"),
              flush=True)
        pc = p if check.cfg.nbatch == len(params) else p[: check.cfg.nbatch].contiguous()
        got = as_dict(check(pc))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = as_dict(check.reference(pc))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        max_abs = check_variant(f"{name} B={check.cfg.nbatch}", got, ref)
        print(f"[20] {name}: kernel vs plain, B={check.cfg.nbatch} tile={check.tile}: max abs "
              f"{max_abs:.3e}, statuses {sorted(set(got['status'].tolist()))}, equal steps "
              f"per tile; plain version {plain_ms:.1f} ms (one run, host clock)", flush=True)

        # ---- the hand-written twin on the same members
        if twin is not None:
            tw = solve_dense_ensemble(BdfSolver, twin, te, torch.tensor(twin_params, device=dev),
                                      mode="fused")
            diff = (sol.ys - tw.ys).abs()
            if bool((diff > MODES_ATOL + MODES_RTOL * tw.ys.abs()).any()):
                raise AssertionError(f"{name}: off its hand-written twin by "
                                     f"{float(diff.max())}")
            maker = fb.make_fused_band_bdf_solve if band else fs.make_fused_bdf_solve
            twin_solve = maker(twin, te, check.cfg.nbatch)

            def digest(header):
                return hashlib.sha256(header.encode()).hexdigest()[:12]

            print(f"[20] {name} vs the hand-written model's fused call: max abs "
                  f"{float(diff.max()):.3e} (largest value {float(tw.ys.abs().max()):.4g}), "
                  f"steps per tile equal: {torch.equal(sol.tile_steps, tw.tile_steps)}; "
                  f"IR equal: {check.model.rhs == twin_solve.model.rhs}, rhs op_count "
                  f"{op_count(check.model.rhs)} vs {op_count(twin_solve.model.rhs)}, header "
                  f"{digest(check.header)} vs {digest(twin_solve.header)}", flush=True)

        # ---- times and the least time for the accepted steps' work
        kernel_ms = time_ms(path, reps)
        # the twin in the same call, between two timings of the DiffSL
        # path: whether a model costs the same written either way
        versus = ""
        if twin is not None:
            twin_p = torch.tensor(twin_params, device=dev)

            def twin_path(twin=twin, te=te, twin_p=twin_p, mode="fused"):
                return solve_dense_ensemble(BdfSolver, twin, te, twin_p, mode=mode)

            twin_ms = time_ms(twin_path, reps)
            again_ms = time_ms(path, reps)
            versus = (f"; the hand-written model's fused path {twin_ms:.3f} ms, then the "
                      f"DiffSL path again {again_ms:.3f} ms")
        if band:
            bound_ms, bound_by, ops = k2_bound(n, *problem.linear_solver.meta,
                                               op_count(check.model.rhs), len(params), steps,
                                               p.numel(), sol.ys.numel())
        else:
            ops = len(params) * float(np.mean(steps)) * k1_step_ops(check)
            bound_ms, bound_by = bound(8 * (p.numel() + sol.ys.numel() + len(te)), ops)
        print(f"[20] {name}: fused path {kernel_ms:.3f} ms median of {reps} (CUDA events)"
              f"{versus}; plain version {plain_ms:.1f} ms at B={check.cfg.nbatch}; least time "
              f"{bound_ms:.4f} ms by {bound_by} ({ops / 1e9:.3f} GFLOP f64, a lower bound); "
              f"card {card_line}", flush=True)
        numbers = dict(launches=launches, max_abs_err=max_abs, ms=kernel_ms,
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        if not band:
            records.append(k1_record(name, **numbers))
            continue
        records.append(k2_record(f"fused_band_bdf:{name}", **numbers))

        # ---- the banded lockstep path: K3 and K4 on every Newton matrix
        def lock_path(problem=problem, te=te, p=p):
            return solve_dense_ensemble(BdfSolver, problem, te, p, mode="lockstep")

        band_lu.launch_band_lu_factor.launches = 0
        band_lu.launch_band_lu_solve.launches = 0
        lock = lock_path()
        torch.cuda.synchronize()
        k3 = band_lu.launch_band_lu_factor.launches
        k4 = band_lu.launch_band_lu_solve.launches
        if lock.tier != "lockstep" or lock.stop_reason != errors.TSTOP_REACHED:
            raise AssertionError(f"{name} lockstep: tier {lock.tier!r}, stop_reason "
                                 f"{lock.stop_reason}")
        if k3 < 1 or k4 < 1:
            raise AssertionError(f"{name} lockstep launched K3 {k3} and K4 {k4} times")
        diffsl_closed_form(name, lock, te)
        diff = (sol.ys - lock.ys).abs()
        if bool((diff > MODES_ATOL + MODES_RTOL * lock.ys.abs()).any()):
            raise AssertionError(f"{name}: fused and lockstep disagree by {float(diff.max())}")
        lock_ms = time_ms(lock_path, reps)
        twin_lock_ms = time_ms(lambda: twin_path(mode="lockstep"), reps)
        st = lock.state.stats
        print(f"[20] {name} lockstep path: {st.steps} steps, {st.newton_iterations} Newton "
              f"iterations, band LU launches factor {k3} solve {k4}, TSTOP_REACHED, the "
              f"closed form holds, fused vs lockstep max abs {float(diff.max()):.3e}; "
              f"{lock_ms:.1f} ms median of {reps} (CUDA events), the hand-written model's "
              f"lockstep path {twin_lock_ms:.1f} ms; card {card_line}", flush=True)
    diffsl_index_phase(dev, card_line)
    return records


# ---------------------------------------------------------------------------
# phase 21: forward sensitivities (the continuous sensitivity equations,
# sens=True, and solve_dense_fwd_sens) on the dense, block and banded tiers
# ---------------------------------------------------------------------------

# members to t = 4e6 against solve_dense_fwd_sens of their single solve,
# relative to the oracle's largest row (tests/test_sens.py:182-208, and
# :159-179 for the DAE)
SENS_ODE_TOL, SENS_DAE_TOL = 1e-3, 5e-3
# the ODE members' oracle is solved at rtol 1e-6: at the problem's rtol 1e-4
# the oracle itself sits 2.6e-3 of its largest from the true sensitivity
# for member 9,999 (k1 = 0.0362; rtol 1e-10 as the truth, on the CPU),
# farther than the lockstep rows do (9.0e-4); at rtol 1e-6 within 1.2e-5
SENS_ORACLE_RTOL, SENS_ORACLE_ATOL = 1e-6, (1e-10, 1e-8, 1e-8)
# the DAE's rows at t0 sum to 0 (x + y + z = 1 for every p)
SENS_CONSERVE_TOL = 1e-10
# heat1d's member nearest d = 1 against the series' d/dd at t >= 0.01, of
# max |s|: the MOL grid and the solver's tolerance part them by 6.3e-5 (a
# single solve at d = 1, rtol 1e-6, on the CPU)
SENS_HEAT_TOL = 5e-4
# the block tier's 1,000 identical groups against one dense-tier Robertson
# solve, of the largest row: 2.3e-14 on the CPU, equal steps
SENS_BLOCK_TOL = 1e-9
# the reset model's rows against central differences on the card
# (tests/test_sens.py:129-156)
SENS_FD_TOL = 1e-3
B_SENS_CPU = 64
B_SENS_HEAT2D = 256
NAUG_ROWS = 3


def sens_oracle_check(name, rows, problem, params, members, te, tol):
    """The lockstep rows (neval, naug, B, n) of ``members`` against
    solve_dense_fwd_sens of ``problem`` for each member on the card (its
    members' derivatives are independent, so one lockstep problem of the
    chosen members serves), relative to the oracle's largest entry for the
    member; returns the largest share."""
    import diffsol_tpu_torch as dtt

    solver = dtt.BdfSolver(dtt.make_lockstep_problem(problem, len(members)))
    _, oracle = dtt.solve_dense_fwd_sens(solver, te, params=params[list(members)],
                                         max_steps=20_000)
    oracle = oracle.movedim(0, 1)  # (neval, np, members, n)
    worst = 0.0
    for k, m in enumerate(members):
        ref = oracle[:, :, k]
        err = float((rows[: len(te), :, m] - ref).abs().max() / ref.abs().max())
        if not err < tol:
            raise AssertionError(f"{name} member {m}: rows off solve_dense_fwd_sens by "
                                 f"{err:.3e} of its largest (bound {tol:g})")
        worst = max(worst, err)
    return worst


def k4_rows_record(dev, card_line, tag, band, ml, mu, launches):
    """Phase 21 (e): K4 with R = naug B rows against B factorizations in one
    launch (row r with member r mod B), against its plain version by phase
    7's rule; its time, the plain version's, torch.linalg.lu_solve on the
    dense expansion with the same rows (one broadcast call), and the bound.
    Returns the kernel record."""
    from diffsol_tpu_torch.ops import band_lu

    B, nb, n = band.shape
    F = band_lu.band_lu_factor(band, ml, mu)
    rows = torch.tensor(np.random.default_rng(SEED).standard_normal((NAUG_ROWS * B, n)),
                        device=dev)
    s0 = band_lu.launch_band_lu_solve.launches
    x = band_lu.band_lu_solve(F, rows, ml, mu)
    torch.cuda.synchronize()
    if band_lu.launch_band_lu_solve.launches != s0 + 1:
        raise AssertionError(f"{tag}: {NAUG_ROWS * B} rows took "
                             f"{band_lu.launch_band_lu_solve.launches - s0} launches")
    x_p = band_lu.band_lu_solve_reference(F.lu, rows, ml, mu)
    err = check_lu(f"K4 rows {tag}", x, x_p)
    ms = time_ms(lambda: band_lu.launch_band_lu_solve(F.lu, rows, ml, mu), 10)
    plain_ms = time_ms(lambda: band_lu.band_lu_solve_reference(F.lu, rows, ml, mu), 1)
    dense = dense_of(band, ml, mu)
    lu, piv = torch.linalg.lu_factor(dense)
    rhs = rows.reshape(NAUG_ROWS, B, n, 1)
    x_lib = torch.linalg.lu_solve(lu, piv, rhs).reshape(NAUG_ROWS * B, n)
    lib_err = float((x_lib - x).abs().max() / x.abs().max())
    lib_ms = time_ms(lambda: torch.linalg.lu_solve(lu, piv, rhs), 5)
    # bytes: each member's factor elements once (the ml multipliers of
    # columns 0 .. n-2, the mu+1 rows of U), the rows in and out; the
    # kernel reads each member's factors naug times, so it cannot reach it
    nbytes = 8 * (B * ((n - 1) * ml + n * (mu + 1)) + 2 * NAUG_ROWS * B * n)
    b_ms, b_by = bound(nbytes, NAUG_ROWS * B * n * (2 * ml + 2 * mu + 1))
    print(f"[21e] K4 rows per factorization, {tag} (B={B} factorizations, n={n}, "
          f"ml={ml}, mu={mu}, R={NAUG_ROWS * B} rows, one launch): vs plain max abs "
          f"{err:.3e} (bound {LU_RTOL:g} relative); {ms:.4f} ms median of 10 (least "
          f"{b_ms:.4f} ms by {b_by}); plain {plain_ms:.1f} ms (one run); "
          f"torch.linalg.lu_solve on the dense (B, n, n) expansion, the rows broadcast "
          f"{lib_ms:.3f} ms (x within {lib_err:.1e} relative); card {card_line}", flush=True)
    return dict(name=f"band_lu_solve:rows_{tag}", route="cuda",
                source="diffsol_tpu_torch/csrc/band_lu.cuh",
                replaces="diffsol_tpu/ops/pallas_banded.py:72", launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def sens_phase(dev, card_line, heat_problem, soln):
    """Phase 21; returns the K4 rows-per-factorization records and (c)'s
    heat1d solution with its rows."""
    import dataclasses

    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import exponential_decay, logistic, robertson
    from diffsol_tpu_torch.ops import band_lu

    def sens_solver(pr):
        return dtt.BdfSolver(pr, sens=True)

    te = robertson.T_EVAL_4E10
    te6 = te[:8]  # to 4e6, where the oracle is checked
    params = robertson_params(B_MAIN, np.random.default_rng(SEED), dev)

    # ---- (a) and (b): Robertson ODE and DAE lockstep, dense tier
    oracles = {"a": (robertson.problem_ode(rtol=SENS_ORACLE_RTOL, atol=SENS_ORACLE_ATOL),
                     (0, B_MAIN // 2 - 1, B_MAIN - 1), SENS_ODE_TOL),
               "b": (robertson.problem_dae(), (0,), SENS_DAE_TOL)}
    for tag, problem in (("a", robertson.problem_ode()), ("b", robertson.problem_dae())):
        def run(problem=problem):
            return dtt.solve_dense_ensemble(sens_solver, problem, te, params,
                                            mode="lockstep", max_steps=5000)

        sol, ms = timed_solve(run)
        if sol.tier != "lockstep" or sol.stop_reason != dtt.errors.TSTOP_REACHED:
            raise AssertionError(f"[21{tag}] tier {sol.tier}, stop_reason {sol.stop_reason}")
        if (tuple(sol.sens.shape) != (len(te), 3, B_MAIN, 3) or not sol.sens.is_cuda
                or not bool(torch.isfinite(sol.sens).all())):
            raise AssertionError(f"[21{tag}] sens {tuple(sol.sens.shape)} or not finite")
        check_soln(f"[21{tag}] member 0", sol.ys[:, 0])
        oracle_problem, members, tol = oracles[tag]
        err = sens_oracle_check(f"[21{tag}]", sol.sens, oracle_problem, params, members,
                                te6, tol)
        extra = ""
        if tag == "b":
            lp = dtt.make_lockstep_problem(problem.to(dev), B_MAIN)
            s0 = sens_solver(lp).init_state(params).s
            drift = float(s0.sum(-1).abs().max())
            if not drift < SENS_CONSERVE_TOL:
                raise AssertionError(f"[21b] rows at t0 sum to {drift} (bound "
                                     f"{SENS_CONSERVE_TOL:g})")
            extra = f"; the rows at t0 sum to {drift:.1e} (< {SENS_CONSERVE_TOL:g})"
        label = "ODE" if tag == "a" else "DAE (mass diag(1, 1, 0), consistent_init)"
        print(f"[21{tag}] Robertson {label} lockstep B={B_MAIN}, BdfSolver(sens=True), 3 "
              f"rows, t=4e10: {stats_line(sol)}, {ms:.1f} ms median of 3 (CUDA events); "
              f"member 0 meets the CVODE table; members {list(members)} within {err:.2e} "
              f"of solve_dense_fwd_sens at rtol {float(oracle_problem.rtol):g} (< {tol:g} "
              f"of its largest){extra}; card {card_line}", flush=True)
        if tag == "a":
            # the card's busy share, over the first 77 steps (to t = 40)
            profile_line("21a", lambda: dtt.solve_dense_ensemble(
                sens_solver, problem, te[:4], params, mode="lockstep"), card_line)

    # ---- (c) heat1d banded lockstep: K3 on every factorization, K4 on the
    # main solves and every sensitivity solve (naug B rows a launch)
    n = HEAT_MGRID + 1
    d = np.linspace(0.5, 2.0, B_BAND)

    def run_heat(device=None, pb=d[:, None]):
        return dtt.solve_dense_ensemble(sens_solver, heat_problem, HEAT_T_EVAL, pb,
                                        mode="lockstep", device=device)

    band_lu.launch_band_lu_factor.launches = 0
    band_lu.launch_band_lu_solve.launches = 0
    heat = run_heat()
    torch.cuda.synchronize()
    k3, k4 = band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches
    if k3 < 1 or k4 < 1:
        raise AssertionError(f"[21c] launched K3 {k3} and K4 {k4} times")
    err_ys = check_heat("[21c]", heat, soln, d, n)
    _, heat_ms = timed_solve(run_heat)
    m = int(np.argmin(np.abs(d - 1.0)))
    h = 1.0 / (HEAT_MGRID + 2)
    x = (np.arange(n) + 1.0) * h
    t = np.asarray(HEAT_T_EVAL)
    series = np.zeros((len(t), n))
    for k in range(1, 200):
        mk = 2 * k - 1
        series += ((-1.0) ** (k - 1) * np.sin(mk * np.pi * x)[None, :]
                   * np.exp(-(mk ** 2) * np.pi ** 2 * d[m] * t)[:, None])
    exact = -8.0 * t[:, None] * series
    rows = heat.sens[:, 0, m].cpu().numpy()
    late = t >= 0.01
    err_s = float(np.abs(rows[late] - exact[late]).max() / np.abs(rows).max())
    if not err_s < SENS_HEAT_TOL:
        raise AssertionError(f"[21c] member d={d[m]} off du/dd by {err_s:.3e} of max |s|")
    cpu = run_heat("cpu", np.linspace(0.5, 2.0, B_SENS_CPU)[:, None])
    worst = 0.0
    for mg, mc in ((0, 0), (B_BAND - 1, B_SENS_CPU - 1)):
        for got, ref in ((heat.ys[:, mg], cpu.ys[:, mc]), (heat.sens[:, :, mg], cpu.sens[:, :, mc])):
            diff = (got.cpu() - ref).abs()
            if bool((diff > CARD_CPU_ATOL + CARD_CPU_RTOL * ref.abs().max()).any()):
                raise AssertionError(f"[21c] member {mg} off the CPU's by {float(diff.max())}")
            worst = max(worst, float(diff.max() / ref.abs().max()))
    dsteps = abs(heat.state.stats.steps - cpu.state.stats.steps)
    if dsteps > CARD_CPU_STEPS:
        raise AssertionError(f"[21c] steps {heat.state.stats.steps} vs the CPU's "
                             f"{cpu.state.stats.steps}")
    print(f"[21c] heat1d n={n} banded lockstep B={B_BAND}, BdfSolver(sens=True), 1 row: "
          f"{stats_line(heat)}, K3 {k3} and K4 {k4} launches (the rows' solves among "
          f"them), {heat_ms:.1f} ms median of 3 (CUDA events); ys vs the series "
          f"{err_ys:.2e}; member d={d[m]:.4f} vs du/dd of the series {err_s:.2e} of max "
          f"|s| (< {SENS_HEAT_TOL:g}, t >= 0.01); members 0 and {B_BAND - 1} vs a B="
          f"{B_SENS_CPU} lockstep solve on the CPU within {worst:.1e} of their largest "
          f"(< {CARD_CPU_RTOL:g}), steps {heat.state.stats.steps} vs "
          f"{cpu.state.stats.steps}; card {card_line}", flush=True)

    # heat2d's rows go through K4 at nb = 41; its rhs does not read p, so
    # every row is exactly 0 (init, consistent_init and each Newton solve)
    heat2d = mol2d_problem("heat2d")
    band_lu.launch_band_lu_solve.launches = 0
    h2 = dtt.solve_dense_ensemble(sens_solver, heat2d, MOL2D["heat2d"][1],
                                  np.ones((B_SENS_HEAT2D, 1)), mode="lockstep")
    torch.cuda.synchronize()
    k4_nb41 = band_lu.launch_band_lu_solve.launches
    if (h2.stop_reason != dtt.errors.TSTOP_REACHED or k4_nb41 < 1
            or bool(h2.sens.abs().max() != 0.0)):
        raise AssertionError(f"[21c] heat2d: stop_reason {h2.stop_reason}, K4 {k4_nb41}, "
                             f"largest row {float(h2.sens.abs().max())}")
    print(f"[21c] heat2d mgrid=20 (n=400, nb=41) banded lockstep B={B_SENS_HEAT2D}, "
          f"sens=True: {stats_line(h2)}, K4 {k4_nb41} launches, every row exactly 0 (the "
          f"rhs does not read p); card {card_line}", flush=True)

    # ---- (d) the block tier at the reference's width
    wide = robertson.problem_ode_groups(1000)
    if wide.linear_solver.name != "blockdiag(3,1000)":
        raise AssertionError(f"[21d] ngroups=1000 routed to {wide.linear_solver.name}")
    blk, blk_ms = timed_solve(lambda: dtt.solve_dense(sens_solver(wide), te, max_steps=5000))
    one = dtt.solve_dense(sens_solver(robertson.problem_ode()), te, max_steps=5000)
    if blk.stop_reason != dtt.errors.TSTOP_REACHED or one.stop_reason != blk.stop_reason:
        raise AssertionError(f"[21d] stop_reason {blk.stop_reason}, {one.stop_reason}")
    groups = blk.sens.reshape(len(te), 3, 1000, 3)
    err_b = float((groups - one.sens[:, :, None, :]).abs().max() / one.sens.abs().max())
    if not err_b < SENS_BLOCK_TOL:
        raise AssertionError(f"[21d] groups off the single solve by {err_b:.3e}")
    print(f"[21d] robertson_ode ngroups=1000 (n=3000, blockdiag(3,1000)) BdfSolver(sens="
          f"True) to t=4e10: {stats_line(blk)}, {blk_ms:.1f} ms median of 3 (CUDA events); "
          f"every group's 3 rows within {err_b:.1e} of the dense-tier single solve's "
          f"largest (< {SENS_BLOCK_TOL:g}; steps {blk.state.stats.steps} vs "
          f"{one.state.stats.steps}); card {card_line}", flush=True)

    # ---- (e) K4 with rows per factorization against its plain version
    jac = torch.func.vmap(heat_problem.eqn.jac, in_dims=(None, 0, 0))(
        torch.tensor(0.0, dtype=torch.float64, device=dev),
        torch.zeros(B_BAND, n, dtype=torch.float64, device=dev),
        torch.tensor(d[:, None], device=dev))
    heat_band = heat_problem.linear_solver.assemble(None, jac, 1e-3)
    t0 = torch.tensor(0.0, dtype=torch.float64, device=dev)
    p1 = torch.ones(1, dtype=torch.float64, device=dev)
    y2 = heat2d.eqn.init(t0, p1)
    band2 = heat2d.linear_solver.assemble(heat2d.eqn.mass_repr(t0, p1),
                                          heat2d.eqn.jac(t0, y2, p1), 1e-3)
    records = [
        k4_rows_record(dev, card_line, "heat1d", heat_band, 1, 1, k4),
        k4_rows_record(dev, card_line, "nb41", band2.expand(B_BAND, -1, -1).contiguous(),
                       *heat2d.linear_solver.meta, k4_nb41),
    ]

    # ---- (f) the SDIRK and ERK rows, and the reset jump
    lp = dataclasses.replace(logistic.problem(),
                             sens_rtol=torch.tensor(1e-6, dtype=torch.float64),
                             sens_atol=torch.full((1,), 1e-6, dtype=torch.float64))
    for method in ("tr_bdf2", "esdirk34", "tsit45"):
        def run_rk(device=None, method=method):
            return dtt.solve_dense(dtt.solver(lp, method, sens=True), [1.0, 5.0, 10.0],
                                   max_steps=20_000, device=device)

        (sol, ms), ref = timed_solve(run_rk), run_rk("cpu")
        diff = (sol.sens.cpu() - ref.sens).abs()
        dsteps = abs(sol.state.stats.steps - ref.state.stats.steps)
        if (sol.stop_reason != dtt.errors.TSTOP_REACHED or dsteps > CARD_CPU_STEPS
                or bool((diff > CARD_CPU_ATOL + CARD_CPU_RTOL * ref.sens.abs()).any())):
            raise AssertionError(f"[21f] logistic {method}: card vs CPU rows "
                                 f"{float(diff.max())}, steps {sol.state.stats.steps} vs "
                                 f"{ref.state.stats.steps}")
        print(f"[21f] logistic {method} sens=True (rows in the error test): "
              f"{stats_line(sol)}, {ms:.2f} ms median of 3 (CUDA events); rows vs the CPU "
              f"max abs {float(diff.max()):.2e}, steps {sol.state.stats.steps} vs "
              f"{ref.state.stats.steps}; card {card_line}", flush=True)
    tr = [2.0, 6.0, 10.0]
    for method in ("bdf", "tsit45"):
        def ys_at(p0, p1, method=method):
            return dtt.solve_dense(dtt.solver(exponential_decay.problem_with_reset(
                p=(p0, p1)), method), tr, max_steps=4000).ys

        eps = 1e-6
        fd = [(ys_at(0.1 + eps, 1.0) - ys_at(0.1 - eps, 1.0)) / (2 * eps),
              (ys_at(0.1, 1.0 + eps) - ys_at(0.1, 1.0 - eps)) / (2 * eps)]
        (sol, ms) = timed_solve(lambda method=method: dtt.solve_dense(
            dtt.solver(exponential_decay.problem_with_reset(), method, sens=True), tr,
            max_steps=4000))
        errs = [float((sol.sens[:, j] - fd[j]).abs().max()) for j in range(2)]
        if sol.stop_reason != dtt.errors.TSTOP_REACHED or not max(errs) < SENS_FD_TOL:
            raise AssertionError(f"[21f] reset {method}: {sol.stop_reason}, vs central "
                                 f"differences {errs}")
        print(f"[21f] exponential decay with a reset, {method} sens=True: {stats_line(sol)}, "
              f"{ms:.2f} ms median of 3 (CUDA events); rows vs central differences on the "
              f"card {errs[0]:.1e} (p0, moves the event) and {errs[1]:.1e} (p1, the reset "
              f"value) (< {SENS_FD_TOL:g}); card {card_line}", flush=True)
    return records, heat


# ---------------------------------------------------------------------------
# phase 22: adjoints (make_differentiable_solve / _quadrature and their
# lockstep ensemble forms as torch.autograd.Functions)
# ---------------------------------------------------------------------------

# (a) the lockstep gradient's members against 2 sum y.s of their own
# forward sensitivities at rtol 1e-6 (phase 21's oracle), of the largest
# component (tests/test_adjoint.py:112-129): the CPU rehearsal at B = 20
# (scripts/torch_adjoint_cpu.py rehearsal) puts members 0, 4,999 and 9,999
# within 1.8e-3, 1.6e-3 and 2.0e-3 of it, and as far from the truth
ADJ_ORACLE_TOL = 5e-3
# (c) checkpoint_interval=32 against the dense table: the JAX test's 2e-4
# (tests/test_adjoint_checkpointing.py:84) is at rtol 1e-8; at Robertson's
# rtol 1e-4 the two modes part by the adjoint's own error, 1.75e-3 in the
# CPU rehearsal and 2.1e-3 in the JAX package on one instance (both within
# ~2e-3 of the truth), so the bound is (a)'s
ADJ_BOUNDED_TOL = ADJ_ORACLE_TOL
# (b) heat1d's members against 2 sum y.s of the sens=True lockstep rows, of
# each member's largest component: 3.5e-6 in the CPU rehearsal at B = 16
ADJ_HEAT_TOL = 1e-4
# (d) central differences as tests/test_adjoint.py:132-192: the reset
# model relative to its largest component, the quadrature absolute
ADJ_FD_RESET_TOL, ADJ_FD_QUAD_TOL = 1e-3, 1e-4


def grad_call(fn, params, loss):
    """``(output, dL/dp)`` of ``loss(fn(p))`` through torch.autograd."""
    p = params.detach().clone().requires_grad_(True)
    out = fn(p)
    (g,) = torch.autograd.grad(loss(out), p)
    return out.detach(), g


def adjoint_stats(fn) -> str:
    info = fn.info
    f, b = info["forward"], info["backward"]
    store = (f"table {info['table_bytes'] / 2**20:.3f} MiB" if "table_bytes" in info
             else f"{info['checkpoints']} checkpoints, {info['resolve_steps']} re-solve steps")
    return (f"forward {f.steps} steps / {f.newton_iterations} Newton iterations, backward "
            f"{b.steps} steps / {b.newton_iterations} Newton iterations / {b.newton_fails} "
            f"Newton failures (the solve fails past 50), {store}")


def member_rel(g, ref):
    """Each member's largest difference relative to its largest component."""
    return ((g - ref).abs().amax(-1) / ref.abs().amax(-1)).cpu()


def adjoint_phase(dev, card_line, heat_problem, band_records):
    """Phase 22; returns the band LU records of 22(b)'s path."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import exponential_decay, robertson
    from diffsol_tpu_torch.ops import band_lu

    def sum_sq(ys):
        return (ys**2).sum()

    # ---- (a) Robertson ODE lockstep at full width, to t = 4e6
    te6 = robertson.T_EVAL_4E10[:8]
    params = robertson_params(B_MAIN, np.random.default_rng(SEED), dev)
    problem = robertson.problem_ode()
    fn = dtt.make_differentiable_solve_ensemble(problem, te6, B_MAIN)

    def forward_only():
        with torch.no_grad():
            return fn(params)

    fwd_ms = time_ms(forward_only, 3)
    ys, g = grad_call(fn, params, sum_sq)
    _, fb_ms = timed_solve(lambda: grad_call(fn, params, sum_sq))
    if tuple(g.shape) != (B_MAIN, 3) or not g.is_cuda or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"[22a] gradient {tuple(g.shape)} on {g.device} or not finite")
    check_soln("[22a] member 0", ys[:, 0])
    members = [0, B_MAIN // 2 - 1, B_MAIN - 1]
    oracle = robertson.problem_ode(rtol=SENS_ORACLE_RTOL, atol=SENS_ORACLE_ATOL)
    o_ys, o_sens = dtt.solve_dense_fwd_sens(
        dtt.BdfSolver(dtt.make_lockstep_problem(oracle, len(members))), te6,
        params=params[members], max_steps=20_000)
    ref = 2.0 * torch.einsum("tbn,ptbn->bp", o_ys, o_sens)
    errs = member_rel(g[members], ref)
    if not bool((errs < ADJ_ORACLE_TOL).all()):
        raise AssertionError(f"[22a] members {members} off their forward sensitivities by "
                             f"{errs.tolist()} (bound {ADJ_ORACLE_TOL:g})")
    info_a = adjoint_stats(fn)
    print(f"[22a] Robertson ODE lockstep B={B_MAIN} to t=4e6, make_differentiable_solve_"
          f"ensemble, loss sum ys^2: {info_a}; forward alone (no_grad) {fwd_ms:.1f} ms, "
          f"forward + backward {fb_ms:.1f} ms, medians of 3 (CUDA events); members "
          f"{members} within {[f'{e:.2e}' for e in errs.tolist()]} of 2 sum y.s from "
          f"solve_dense_fwd_sens at rtol {SENS_ORACLE_RTOL:g} (< {ADJ_ORACLE_TOL:g} of the "
          f"largest); card {card_line}", flush=True)
    short = dtt.make_differentiable_solve_ensemble(problem, te6[:4], B_MAIN)
    p_short = params.clone().requires_grad_(True)
    out = short(p_short)
    torch.cuda.synchronize()
    print("[22a] the traced call below is the backward pass alone of the outputs to t = 40",
          flush=True)
    profile_line("22a", lambda: torch.autograd.grad(sum_sq(out), p_short), card_line,
                 steps_of=lambda _: short.info["backward"].steps)

    # ---- (c) bounded memory, Robertson: the same ensemble, checkpoint_interval=32
    def peak_of(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    bounded = dtt.make_differentiable_solve_ensemble(problem, te6, B_MAIN,
                                                     checkpoint_interval=32)
    peak_dense = peak_of(lambda: grad_call(fn, params, sum_sq))
    peak_bnd = peak_of(lambda: grad_call(bounded, params, sum_sq))
    (_, g_bnd), bnd_ms = timed_solve(lambda: grad_call(bounded, params, sum_sq))
    err_c = float(member_rel(g_bnd, g).max())
    if not err_c < ADJ_BOUNDED_TOL:
        raise AssertionError(f"[22c] bounded gradient off the dense table's by {err_c:.3e}")
    print(f"[22c] Robertson checkpoint_interval=32: {adjoint_stats(bounded)}; forward + "
          f"backward {bnd_ms:.1f} ms (dense table {fb_ms:.1f} ms), medians of 3; peak "
          f"memory above the inputs {peak_bnd:.1f} MiB (dense table {peak_dense:.1f} MiB, "
          f"torch.cuda.max_memory_allocated); every member within {err_c:.2e} of the dense "
          f"table's gradient (< {ADJ_BOUNDED_TOL:g}); card {card_line}", flush=True)

    # ---- (b) heat1d banded lockstep at full width: K3/K4 in the forward pass
    d = torch.tensor(np.linspace(0.5, 2.0, B_BAND)[:, None], device=dev)
    heat = dtt.make_differentiable_solve_ensemble(heat_problem, HEAT_T_EVAL, B_BAND)

    def counts():
        torch.cuda.synchronize()
        return (band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches)

    band_lu.launch_band_lu_factor.launches = 0
    band_lu.launch_band_lu_solve.launches = 0
    p_heat = d.clone().requires_grad_(True)
    ys_h = heat(p_heat)
    fwd_k = counts()
    (g_h,) = torch.autograd.grad(sum_sq(ys_h), p_heat)
    all_k = counts()
    if fwd_k[0] < 1 or fwd_k[1] < 1 or all_k != fwd_k:
        raise AssertionError(f"[22b] K3/K4 launches: forward {fwd_k}, forward + backward "
                             f"{all_k} (the dense-table backward launches none)")

    def heat_forward():
        with torch.no_grad():
            return heat(d)

    heat_fwd_ms = time_ms(heat_forward, 3)
    _, heat_ms = timed_solve(lambda: grad_call(heat, d, sum_sq))
    rows = dtt.solve_dense_ensemble(lambda pr: dtt.BdfSolver(pr, sens=True), heat_problem,
                                    HEAT_T_EVAL, d, mode="lockstep")
    ref_h = 2.0 * torch.einsum("tbn,tpbn->bp", rows.ys, rows.sens)
    errs_h = member_rel(g_h, ref_h)
    if not bool((errs_h < ADJ_HEAT_TOL).all()):
        raise AssertionError(f"[22b] members off the sens=True rows by up to "
                             f"{float(errs_h.max()):.3e} (bound {ADJ_HEAT_TOL:g})")
    print(f"[22b] heat1d n={HEAT_MGRID + 1} banded lockstep B={B_BAND}, the gradient of sum "
          f"ys^2: {adjoint_stats(heat)}; K3 {fwd_k[0]} and K4 {fwd_k[1]} launches in the "
          f"forward pass, none in the dense (B, {HEAT_MGRID + 2}, {HEAT_MGRID + 2}) backward; "
          f"forward alone {heat_fwd_ms:.1f} ms, forward + backward {heat_ms:.1f} ms, medians "
          f"of 3; every member within {float(errs_h.max()):.2e} of 2 sum y.s from the "
          f"sens=True lockstep rows (< {ADJ_HEAT_TOL:g}); card {card_line}", flush=True)
    heat_bnd = dtt.make_differentiable_solve_ensemble(heat_problem, HEAT_T_EVAL, B_BAND,
                                                      checkpoint_interval=32)
    p_heat = d.clone().requires_grad_(True)
    ys_hb = heat_bnd(p_heat)
    mid = counts()
    (g_hb,) = torch.autograd.grad(sum_sq(ys_hb), p_heat)
    end = counts()
    bwd_k = (end[0] - mid[0], end[1] - mid[1])
    err_hb = float(member_rel(g_hb, g_h).max())
    if bwd_k[0] < 1 or bwd_k[1] < 1 or not err_hb < ADJ_BOUNDED_TOL:
        raise AssertionError(f"[22c] heat1d bounded: backward K3/K4 {bwd_k}, gradient off "
                             f"the dense table's by {err_hb:.3e}")
    print(f"[22c] heat1d checkpoint_interval=32: {adjoint_stats(heat_bnd)}; K3 {bwd_k[0]} "
          f"and K4 {bwd_k[1]} launches in the backward pass (the segment re-solves); within "
          f"{err_hb:.2e} of the dense table's gradient; card {card_line}", flush=True)

    # ---- (d) single-instance paths, the card against the CPU and central
    # differences
    eps = 1e-6
    cases = (
        ("make_differentiable_solve, exponential decay with a reset",
         exponential_decay.problem_with_reset(), ADJ_FD_RESET_TOL, True,
         lambda pr, dv: dtt.make_differentiable_solve(pr, [2.0, 6.0, 10.0], device=dv),
         sum_sq,
         lambda pr, p: float(sum_sq(dtt.solve_dense(dtt.BdfSolver(pr), [2.0, 6.0, 10.0],
                                                    params=p, max_steps=4000).ys))),
        ("make_differentiable_quadrature, exponential decay to t=4",
         exponential_decay.problem(integrate_out=True), ADJ_FD_QUAD_TOL, False,
         lambda pr, dv: dtt.make_differentiable_quadrature(pr, 4.0, device=dv),
         torch.sum,
         lambda pr, p: float(dtt.solve_dense(dtt.BdfSolver(pr), [4.0], params=p,
                                             max_steps=4000).gs[-1].sum())),
    )
    for label, pr, tol, relative, make, loss, plain in cases:
        p0 = pr.params.to(dev)
        card_fn = make(pr, None)
        _, g_card = grad_call(card_fn, p0, loss)
        (_, _), ms = timed_solve(lambda: grad_call(card_fn, p0, loss))
        _, g_cpu = grad_call(make(pr, "cpu"), pr.params, loss)
        diff = float(((g_card.cpu() - g_cpu).abs() / g_cpu.abs()).max())
        fd = torch.tensor([(plain(pr, p0 + eps * e) - plain(pr, p0 - eps * e)) / (2 * eps)
                           for e in torch.eye(len(p0), dtype=torch.float64, device=dev)])
        err_fd = float((g_cpu - fd).abs().max() / (fd.abs().max() if relative else 1.0))
        if not diff < CARD_CPU_RTOL or not err_fd < tol:
            raise AssertionError(f"[22d] {label}: card vs CPU {diff:.3e}, vs central "
                                 f"differences {err_fd:.3e}")
        print(f"[22d] {label}: {adjoint_stats(card_fn)}; {ms:.2f} ms median of 3 (CUDA "
              f"events); the card's gradient within {diff:.1e} of the CPU's (< "
              f"{CARD_CPU_RTOL:g}), within {err_fd:.1e} of central differences on the card "
              f"(< {tol:g}); card {card_line}", flush=True)

    return [dict(rec, name=f"{rec['name']}:adjoint_heat1d", launches=k)
            for rec, k in zip(band_records, fwd_k)]


# ---------------------------------------------------------------------------
# phase 23: float32 solves, forward mode through the band LU kernels, the
# SDE solvers and the API surface
# ---------------------------------------------------------------------------

# (a) bench.py's f32 rows (:55, :310-350, :674-678): lockstep Robertson at
# rtol 1e-4, atol 1e-6, k1 spread +-10 % (linspace), t_eval 0.4 ... 4e5
F32_T_EVAL = [0.4, 4.0, 40.0, 400.0, 4000.0, 4.0e4, 4.0e5]
B_F32, B_F32_CMP = 100_000, 10_000
F32_CONSERVE_TOL = 1e-3  # bench.py:340-341
# (g) K1 vs its plain version on a float32 problem: both round each rhs
# to float32, one float32 ulp apart where their float64 values straddle a
# rounding boundary, which moves a tile's step sequence now and then (one
# step in one of 79 tiles on the H100), so float32 gates: steps within
# F32_FUSED_STEPS a tile and ys within F32_CMP_ATOL
F32_FUSED_STEPS = 2
F32_SOLN_RTOL = 2e-2  # bench.py:342-349, member B // 2 at t = 0.4, 4, 40
F32_CMP_ATOL = 2e-4  # tests/test_ensemble.py:224-227, float32 vs float64 to t = 40
# (b) heat1d float32 against float64 lockstep, in error weights atol + rtol |y|
F32_BAND_WEIGHTS = 10.0
# (c) the float K3/K4 against their float plain versions (relative to the
# largest entry), and A x = b relative to max |b|: one float32 algorithm
# parting by FMA contraction and the back sweep's order
# (tests/test_torch_cuda.py F32_LU_RTOL, F32_RESIDUAL)
F32_LU_RTOL, F32_RESIDUAL = 1e-5, 1e-4
# (d) solve_dense_fwd_sens against the sens=True rows, the bound
# tests/test_torch_sens.py holds the two routes to; and the card against
# the CPU, one algorithm in float64
FWD_ROUTES_RTOL, FWD_ROUTES_ATOL = 5e-4, 1e-7
B_FWD_CPU, FWD_CPU_RTOL = 16, 1e-10
# (e) the SDE gates of tests/test_sde.py at Monte Carlo width; the fitted
# strong orders within SDE_SLOPE_TOL of 1.0 (Milstein) and 0.5 (EM)
SDE_OU_PATHS, SDE_OU_STEPS = 131_072, 2000
SDE_GBM_PATHS, SDE_GBM_NSTEPS = 16_384, (50, 100, 200, 400, 800)
SDE_SLOPE_TOL = 0.15
# (f) the steps of tests/test_snapshots.py's SNAPSHOTS (exact on the CPU,
# tests/test_torch_snapshots.py); the card's LU rounds otherwise than
# LAPACK, so the card is held within CARD_CPU_STEPS of them
SNAPSHOT_STEPS = {"expdecay_bdf": 35, "logistic_bdf": 91, "robertson_dae_bdf": 197,
                  "logistic_trbdf2": 156, "expdecay_tsit45": 5}


def bound32(nbytes: float, ops: float):
    """As :func:`bound` for float32 work: bytes over the memory rate or
    float32 operations over the card's float32 peak, the larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_of(band, ml: int, mu: int) -> torch.Tensor:
    """The dense (B, n, n) matrices of a (B, nb, n) member-major band."""
    B, nb, n = band.shape
    dense = band.new_zeros((B, n, n))
    j = torch.arange(n, device=band.device)
    for dd in range(nb):
        i = j + dd - mu
        ok = (i >= 0) & (i < n)
        dense[:, i[ok], j[ok]] = band[:, dd, ok]
    return dense


def launches_of(fn):
    """``(result, kernel launches on the card)`` of one traced call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(ev.count for ev in prof.key_averages()
                    if getattr(ev, "device_type", None) == DeviceType.CUDA)


def f32_lu_record(dev, card_line, tag, band, ml, mu, launches):
    """The float K3/K4 against their float plain versions on ``band``
    (B, nb, n) float32: error, A x = b, times (median of 20; plain 3),
    the float bound and torch.linalg's float32 dense LU; two records."""
    from diffsol_tpu_torch.ops import band_lu

    B, nb, n = band.shape
    b = torch.tensor(np.random.default_rng(SEED).standard_normal((B, n)), device=dev).float()
    f0, s0 = band_lu.launch_band_lu_factor.launches_f32, band_lu.launch_band_lu_solve.launches_f32
    fac = band_lu.band_lu_factor(band, ml, mu)
    x = band_lu.band_lu_solve(fac, b, ml, mu)
    F = fac.lu
    torch.cuda.synchronize()
    counted = (band_lu.launch_band_lu_factor.launches_f32 - f0,
               band_lu.launch_band_lu_solve.launches_f32 - s0)
    if counted != (1, 1) or F.dtype != torch.float32 or x.dtype != torch.float32:
        raise AssertionError(f"[23c] {tag}: float launches {counted}, dtypes {F.dtype}, "
                             f"{x.dtype}")
    F_p = band_lu.band_lu_factor_reference(band, ml, mu)
    x_p = band_lu.band_lu_solve_reference(F_p, b, ml, mu)
    errs = []
    for what, got, ref in (("factors", F, F_p), ("x", x, x_p)):
        err = float((got - ref).abs().max())
        if not err <= F32_LU_RTOL * float(ref.abs().max()):
            raise AssertionError(f"[23c] {tag} {what}: kernel vs plain {err:.3e} (bound "
                                 f"{F32_LU_RTOL:g} of {float(ref.abs().max()):.3e})")
        errs.append(err)
    dense = dense_of(band, ml, mu)
    resid = float((torch.bmm(dense, x.unsqueeze(-1)).squeeze(-1) - b).abs().max())
    if not resid <= F32_RESIDUAL * float(b.abs().max()):
        raise AssertionError(f"[23c] {tag}: |A x - b| {resid:.3e} (bound {F32_RESIDUAL:g} of "
                             f"max |b|)")
    k3_ms = time_ms(lambda: band_lu.launch_band_lu_factor(band, ml, mu), 20)
    k4_ms = time_ms(lambda: band_lu.launch_band_lu_solve(F, b, ml, mu), 20)
    k3_plain = time_ms(lambda: band_lu.band_lu_factor_reference(band, ml, mu), 3)
    k4_plain = time_ms(lambda: band_lu.band_lu_solve_reference(F, b, ml, mu), 3)
    lu, piv = torch.linalg.lu_factor(dense)
    lib_f_ms = time_ms(lambda: torch.linalg.lu_factor(dense), 5)
    lib_s_ms = time_ms(lambda: torch.linalg.lu_solve(lu, piv, b.unsqueeze(-1)), 5)
    # phase 7's counts in 4-byte words
    f_bound = bound32(4 * B * (nb * n + (n + mu) * nb), B * n * (1 + ml + 2 * ml * mu))
    s_bound = bound32(4 * B * ((n - 1) * ml + n * (mu + 1) + 2 * n),
                      B * (2 * (n - 1) * ml + (2 * mu + 1) * n))
    print(f"[23c] float K3/K4 at {tag} (B={B}, n={n}, ml={ml}, mu={mu}): kernel vs plain "
          f"factors {errs[0]:.2e}, x {errs[1]:.2e} (< {F32_LU_RTOL:g} of the largest), "
          f"|A x - b| {resid:.2e} (< {F32_RESIDUAL:g} of max |b|); factor {k3_ms:.4f} ms "
          f"(least {f_bound[0]:.4f} by {f_bound[1]}), solve {k4_ms:.4f} ms (least "
          f"{s_bound[0]:.4f} by {s_bound[1]}), medians of 20; plain {k3_plain:.2f} / "
          f"{k4_plain:.2f} ms; torch.linalg.lu_factor / lu_solve float32 on the dense "
          f"expansion {lib_f_ms:.3f} / {lib_s_ms:.3f} ms; launches on the path {launches}; "
          f"card {card_line}", flush=True)
    common = {"route": "cuda", "source": "diffsol_tpu_torch/csrc/band_lu.cuh"}
    return [
        dict(name=f"band_lu_factor:{tag}", replaces="diffsol_tpu/ops/pallas_banded.py:51",
             launches=launches[0], max_abs_err=errs[0], ms=k3_ms, plain_ms=k3_plain,
             bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=lib_f_ms, **common),
        dict(name=f"band_lu_solve:{tag}", replaces="diffsol_tpu/ops/pallas_banded.py:72",
             launches=launches[1], max_abs_err=errs[1], ms=k4_ms, plain_ms=k4_plain,
             bound_ms=s_bound[0], bound_by=s_bound[1], library_ms=lib_s_ms, **common),
    ]


def k4_jvp_record(dev, card_line, heat_problem, launches):
    """K4 under forward mode at heat1d's M - cJ (B_BAND, c=1e-3): the
    primal and tangent solves of band_lu_solve under torch.func.jvp (two
    K4 launches and a band mat-vec) against the rule's plain version;
    the library call is torch.func.jvp of torch.linalg.solve on the dense
    expansion."""
    from diffsol_tpu_torch.ops import band_lu

    n = HEAT_MGRID + 1
    d = torch.tensor(np.linspace(0.5, 2.0, B_BAND)[:, None], device=dev)
    jac = torch.func.vmap(heat_problem.eqn.jac, in_dims=(None, 0, 0))(
        torch.tensor(0.0, dtype=torch.float64, device=dev),
        torch.zeros(B_BAND, n, dtype=torch.float64, device=dev), d)
    band = heat_problem.linear_solver.assemble(None, jac, 1e-3)
    rng = np.random.default_rng(SEED)
    dband = torch.tensor(rng.standard_normal(band.shape), device=dev) * (band != 0)
    b, db = (torch.tensor(rng.standard_normal((B_BAND, n)), device=dev) for _ in range(2))
    F = band_lu.band_lu_factor(band, 1, 1).lu

    def kernel():
        return torch.func.jvp(
            lambda a, rhs: band_lu.band_lu_solve(band_lu.BandFactors(F, a), rhs, 1, 1),
            (band, b), (dband, db))

    def plain():
        x = band_lu.band_lu_solve_reference(F, b, 1, 1)
        return x, band_lu.band_lu_solve_reference(
            F, db - band_lu.band_matvec(dband, x, 1, 1), 1, 1)

    s0 = band_lu.launch_band_lu_solve.launches
    (x, dx), (x_p, dx_p) = kernel(), plain()
    torch.cuda.synchronize()
    if band_lu.launch_band_lu_solve.launches - s0 != 2:
        raise AssertionError("[23d] the jvp of one solve launched K4 "
                             f"{band_lu.launch_band_lu_solve.launches - s0} times, not 2")
    err = max(float((x - x_p).abs().max()), float((dx - dx_p).abs().max()))
    if not err <= LU_RTOL * float(dx_p.abs().max()):
        raise AssertionError(f"[23d] K4 jvp vs its plain version {err:.3e}")
    ms = time_ms(kernel, 20)
    plain_ms = time_ms(plain, 3)
    dense, ddense = dense_of(band, 1, 1), dense_of(dband, 1, 1)
    lib_ms = time_ms(lambda: torch.func.jvp(torch.linalg.solve, (dense, b), (ddense, db)), 5)
    # the transform's own cost on the same inputs: jvp of a copy
    jvp_ms = time_ms(lambda: torch.func.jvp(lambda a, rhs: rhs * 1.0, (band, b), (dband, db)),
                     20)
    # the factor elements both sweeps read, A' (nb n), b, b', x and x' a member
    nb = 3
    bd = bound(8 * B_BAND * ((n - 1) + 2 * n + nb * n + 4 * n),
               B_BAND * 2 * (2 * (n - 1) + 3 * n) + B_BAND * 2 * nb * n)
    print(f"[23d] K4 under torch.func.jvp at heat1d's M - cJ (B={B_BAND}, n={n}): two K4 "
          f"launches and a band mat-vec, {ms:.4f} ms median of 20 (least {bd[0]:.4f} ms by "
          f"{bd[1]}), of which torch.func.jvp's own setup {jvp_ms:.4f} ms (the jvp of a "
          f"copy); the rule's plain version {plain_ms:.2f} ms, within {err:.2e}; "
          f"torch.func.jvp of torch.linalg.solve on the dense expansion {lib_ms:.3f} ms; "
          f"card {card_line}", flush=True)
    return dict(name="band_lu_solve:jvp_heat1d", route="cuda",
                source="diffsol_tpu_torch/csrc/band_lu.cuh",
                replaces="diffsol_tpu/ops/pallas_banded.py:72", launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bd[0], bound_by=bd[1],
                library_ms=lib_ms)


def f32_sde_api_phase(dev, card_line, heat_problem, heat_rows):
    """Phase 23; returns the float K3/K4 and the forward-mode K4 records."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import (exponential_decay, heat1d, heat2d, logistic,
                                          robertson)
    from diffsol_tpu_torch.ops import band_lu
    from diffsol_tpu_torch.solvers import sde
    from diffsol_tpu_torch.utils import stats_json

    f32 = torch.float32

    def k1_params(nbatch, dtype):
        k1 = 0.04 * (1.0 + 0.1 * np.linspace(-1.0, 1.0, nbatch))
        p = np.stack([k1, np.full(nbatch, 1e4), np.full(nbatch, 3e7)], axis=1)
        return torch.tensor(p, device=dev).to(dtype)

    def counters_zero():
        torch.cuda.synchronize()
        for fn in (band_lu.launch_band_lu_factor, band_lu.launch_band_lu_solve):
            fn.launches = fn.launches_f32 = 0

    def counters():
        torch.cuda.synchronize()
        return (band_lu.launch_band_lu_factor.launches_f32,
                band_lu.launch_band_lu_solve.launches_f32,
                band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches)

    # ---- (a) float32 lockstep Robertson at bench.py's f32 width
    rob = {dt: robertson.problem_ode(rtol=1e-4, atol=1e-6, dtype=dt)
           for dt in (f32, torch.float64)}

    def rob_run(dtype, nbatch):
        return dtt.solve_dense_ensemble(dtt.BdfSolver, rob[dtype], F32_T_EVAL,
                                        k1_params(nbatch, dtype), mode="lockstep",
                                        max_steps=5000)

    big, big_ms = timed_solve(lambda: rob_run(f32, B_F32))
    mid = B_F32 // 2
    cons = float((big.ys.double().sum(-1) - 1.0).abs().max())
    rel = [abs(float(big.ys[r, mid, 0]) - robertson.SOLN[r + 1, 1]) / robertson.SOLN[r + 1, 1]
           for r in range(3)]
    if (big.ys.dtype != f32 or big.stop_reason < 0 or not cons < F32_CONSERVE_TOL
            or not max(rel) < F32_SOLN_RTOL):
        raise AssertionError(f"[23a] B={B_F32}: ys {big.ys.dtype}, stop {big.stop_reason}, "
                             f"conservation {cons:.2e}, member {mid} vs SOLN {rel}")
    print(f"[23a] Robertson ODE lockstep float32 B={B_F32} (rtol 1e-4, atol 1e-6, t_eval "
          f"0.4 ... 4e5; bench.py row_b100k_f32): {stats_line(big)}, {big_ms:.1f} ms median "
          f"of 3 (CUDA events); ys {big.ys.dtype}, x + y + z = 1 within {cons:.2e} (< "
          f"{F32_CONSERVE_TOL:g}), member {mid} x within {max(rel):.2e} of the CVODE table at "
          f"t = 0.4, 4, 40 (< {F32_SOLN_RTOL:g}); card {card_line}", flush=True)
    s32, ms32 = timed_solve(lambda: rob_run(f32, B_F32_CMP))
    s64, ms64 = timed_solve(lambda: rob_run(torch.float64, B_F32_CMP))
    members = [0, B_F32_CMP // 2 - 1, B_F32_CMP - 1]
    gap = (s32.ys.double() - s64.ys).abs()
    early = float(gap[:3, members].max())
    if s32.stop_reason < 0 or s64.stop_reason < 0 or not early < F32_CMP_ATOL:
        raise AssertionError(f"[23a] B={B_F32_CMP}: float32 vs float64 members {members} "
                             f"{early:.2e} to t = 40 (bound {F32_CMP_ATOL:g})")
    print(f"[23a] B={B_F32_CMP} lockstep float32 {ms32:.1f} ms ({stats_line(s32)}) against "
          f"float64 {ms64:.1f} ms ({stats_line(s64)}), medians of 3: float32 over float64 "
          f"{ms64 / ms32:.3f}x (bench.py's f32_vs_f64_speedup); members {members} within "
          f"{early:.2e} of float64 to t = 40 (< {F32_CMP_ATOL:g}), largest gap over the "
          f"horizon and all members {float(gap.max()):.2e}; card {card_line}", flush=True)
    print(f"[23a] stats_json float32: {stats_json(s32)}", flush=True)
    print(f"[23a] stats_json float64: {stats_json(s64)}", flush=True)

    # ---- (b) float32 banded lockstep: heat1d through the float K3/K4
    d = np.linspace(0.5, 2.0, B_BAND)[:, None]
    heat32, _ = heat1d.make(HEAT_MGRID, rtol=1e-4, atol=1e-6, banded=True, dtype=f32)
    heat64, _ = heat1d.make(HEAT_MGRID, rtol=1e-4, atol=1e-6, banded=True)

    def heat_run(problem):
        return dtt.solve_dense_ensemble(dtt.BdfSolver, problem, HEAT_T_EVAL, d,
                                        mode="lockstep")

    counters_zero()
    h32 = heat_run(heat32)
    k_heat = counters()
    if k_heat[0] < 1 or k_heat[1] < 1 or k_heat[:2] != k_heat[2:]:
        raise AssertionError(f"[23b] float K3/K4 launches {k_heat[:2]} of {k_heat[2:]}")
    (_, h32_ms), (h64, h64_ms) = timed_solve(lambda: heat_run(heat32)), timed_solve(
        lambda: heat_run(heat64))
    weights = float(((h32.ys.double() - h64.ys).abs()
                     / (1e-6 + 1e-4 * h64.ys.abs())).max())
    if h32.ys.dtype != f32 or h32.stop_reason < 0 or not weights < F32_BAND_WEIGHTS:
        raise AssertionError(f"[23b] heat1d float32: {h32.ys.dtype}, stop {h32.stop_reason}, "
                             f"{weights:.2f} error weights from float64")
    print(f"[23b] heat1d n={HEAT_MGRID + 1} banded lockstep float32 B={B_BAND} (rtol 1e-4, "
          f"atol 1e-6): {stats_line(h32)}, K3 {k_heat[0]} and K4 {k_heat[1]} float launches "
          f"(all of them), {h32_ms:.1f} ms against float64's {h64_ms:.1f} ms ({stats_line(h64)}"
          f"), medians of 3; within {weights:.3f} error weights of float64 (< "
          f"{F32_BAND_WEIGHTS:g}); card {card_line}", flush=True)

    # ---- (c) the float K3/K4 against their plain versions, heat1d and nb = 41;
    # nb = 41's launches on heat2d's float32 lockstep path
    te2 = MOL2D["heat2d"][1]
    h2 = {dt: heat2d.make(MOL2D["heat2d"][0], dtype=dt) for dt in (f32, torch.float64)}
    counters_zero()
    s2 = dtt.solve_dense_ensemble(dtt.BdfSolver, h2[f32], te2, np.ones((B_BAND, 1)),
                                  mode="lockstep")
    k_2d = counters()
    s2_64 = dtt.solve_dense_ensemble(dtt.BdfSolver, h2[torch.float64], te2,
                                     np.ones((B_BAND, 1)), mode="lockstep")
    w2 = float(((s2.ys.double() - s2_64.ys).abs() / (1e-5 + 1e-5 * s2_64.ys.abs())).max())
    if (k_2d[0] < 1 or k_2d[1] < 1 or k_2d[:2] != k_2d[2:] or s2.ys.dtype != f32
            or s2.stop_reason < 0 or not w2 < F32_BAND_WEIGHTS):
        raise AssertionError(f"[23c] heat2d float32: launches {k_2d}, stop "
                             f"{s2.stop_reason}, {w2:.2f} error weights from float64")
    print(f"[23c] heat2d mgrid=20 (n=400, nb=41) lockstep float32 B={B_BAND}: "
          f"{stats_line(s2)}, K3 {k_2d[0]} and K4 {k_2d[1]} float launches, within "
          f"{w2:.3f} error weights of float64 ({stats_line(s2_64)}); card {card_line}",
          flush=True)
    n = HEAT_MGRID + 1
    jac = torch.func.vmap(heat32.eqn.jac, in_dims=(None, 0, 0))(
        torch.tensor(0.0, dtype=f32, device=dev), torch.zeros(B_BAND, n, dtype=f32, device=dev),
        torch.tensor(d, device=dev).float())
    band_h = heat32.linear_solver.assemble(None, jac, 1e-3)
    from diffsol_tpu_torch.ops.banded import _band_index
    rnd = np.random.default_rng(SEED).standard_normal((B_BAND, 41, 400))
    rnd[:, 20] += 2.0 * 41
    band_41 = torch.tensor(rnd * _band_index(400, 20, 20)[1], device=dev).float()
    records = (f32_lu_record(dev, card_line, "f32", band_h, 1, 1, k_heat[:2])
               + f32_lu_record(dev, card_line, "f32_nb41", band_41, 20, 20, k_2d[:2]))

    # ---- (d) forward mode through K3/K4: solve_dense_fwd_sens on the card
    lp = dtt.make_lockstep_problem(heat_problem, B_BAND)
    d64 = torch.tensor(d, device=dev)
    counters_zero()
    t0 = time.perf_counter()
    _, fwd = dtt.solve_dense_fwd_sens(dtt.BdfSolver(lp), HEAT_T_EVAL, params=d64)
    k_fwd = counters()
    fwd_s = time.perf_counter() - t0
    rows = heat_rows.sens.movedim(1, 0)  # (naug, neval, B, n)
    over = float(((fwd - rows).abs() - FWD_ROUTES_RTOL * rows.abs()).max())
    if k_fwd[2] < 1 or k_fwd[3] < 1 or fwd.shape != rows.shape or not over <= FWD_ROUTES_ATOL:
        raise AssertionError(f"[23d] fwd_sens: K3/K4 {k_fwd[2:]}, shape {tuple(fwd.shape)}, "
                             f"off the sens=True rows by {over:.3e} past the bound")
    lp16 = dtt.make_lockstep_problem(heat_problem, B_FWD_CPU)
    d16 = np.linspace(0.5, 2.0, B_FWD_CPU)[:, None]
    _, card16 = dtt.solve_dense_fwd_sens(dtt.BdfSolver(lp16), HEAT_T_EVAL, params=d16)
    _, cpu16 = dtt.solve_dense_fwd_sens(dtt.BdfSolver(lp16), HEAT_T_EVAL, params=d16,
                                        device="cpu")
    diff16 = float((card16.cpu() - cpu16).abs().max() / cpu16.abs().max())
    if not diff16 < FWD_CPU_RTOL:
        raise AssertionError(f"[23d] fwd_sens B={B_FWD_CPU}: card vs CPU {diff16:.3e}")
    print(f"[23d] solve_dense_fwd_sens(BdfSolver(heat1d n={n} banded lockstep B={B_BAND})) "
          f"on the card: K3 {k_fwd[2]} and K4 {k_fwd[3]} launches (the tangent solves are K4 "
          f"launches), {fwd_s:.2f} s (host clock, one call); within rtol "
          f"{FWD_ROUTES_RTOL:g}, atol {FWD_ROUTES_ATOL:g} of phase 21's sens=True rows; at "
          f"B={B_FWD_CPU} within {diff16:.1e} of the CPU's (< {FWD_CPU_RTOL:g}); card "
          f"{card_line}", flush=True)
    records.append(k4_jvp_record(dev, card_line, heat_problem, k_fwd[3]))

    # ---- (e) the SDE solvers at Monte Carlo width
    theta, sigma = 1.5, 0.4

    def ou_rhs(t, y, p):
        return -p[0] * y

    def ou_diff(t, y, p):
        return torch.ones_like(y) * p[1]

    gen = torch.Generator(device=dev)

    def ou_run(nsteps, t1):
        gen.manual_seed(SEED)
        return sde.solve_em_ensemble(
            ou_rhs, ou_diff, torch.zeros(1, dtype=torch.float64, device=dev), 0.0, t1,
            nsteps, torch.tensor([theta, sigma], device=dev), gen, SDE_OU_PATHS)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ou = ou_run(SDE_OU_STEPS, 8.0)
    torch.cuda.synchronize()
    ou_s = time.perf_counter() - t0
    _, ou_launches = launches_of(lambda: ou_run(100, 0.4))
    tail = ou.ys[:, -500:, 0]
    var, mean, want = float(tail.var()), float(tail.mean()), sigma**2 / (2 * theta)
    if (tuple(ou.ys.shape) != (SDE_OU_PATHS, SDE_OU_STEPS + 1, 1) or ou.ys.device.type != dev.type
            or not abs(var - want) < 0.1 * want or not abs(mean) < 0.02):
        raise AssertionError(f"[23e] OU: ys {tuple(ou.ys.shape)}, variance {var:.4f} vs "
                             f"{want:.4f}, mean {mean:.4f}")
    print(f"[23e] solve_em_ensemble, Ornstein-Uhlenbeck theta={theta}, sigma={sigma}: "
          f"{SDE_OU_PATHS} paths x {SDE_OU_STEPS} steps on [0, 8] in {ou_s:.2f} s (host "
          f"clock, one call), {ou_launches / 100:.1f} kernel launches a step (a traced "
          f"100-step call); the "
          f"last 500 steps' variance {var:.5f} against sigma^2/2theta = {want:.5f} "
          f"({(var - want) / want:+.2%}, < 10 %), mean {mean:+.5f} (< 0.02); card "
          f"{card_line}", flush=True)
    mu_g, sig_g = 0.05, 0.5
    y0 = torch.ones((SDE_GBM_PATHS, 1), dtype=torch.float64, device=dev)
    pg = torch.tensor([mu_g, sig_g], device=dev)

    def gbm_rhs(t, y, p):
        return p[0] * y

    def gbm_diff(t, y, p):
        return p[1] * y

    errs = {"em": [], "milstein": []}
    times = {"em": [], "milstein": []}
    for nsteps in SDE_GBM_NSTEPS:
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + nsteps)
        w = (torch.randn((nsteps,) + tuple(y0.shape), generator=g, dtype=torch.float64,
                         device=dev) * np.sqrt(1.0 / nsteps)).sum(0)
        exact = torch.exp((mu_g - 0.5 * sig_g**2) + sig_g * w)
        for name, fn in (("em", sde.solve_em), ("milstein", sde.solve_milstein)):
            g.manual_seed(SEED + nsteps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = fn(gbm_rhs, gbm_diff, y0, 0.0, 1.0, nsteps, pg, g)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            errs[name].append(float((sol.ys[-1] - exact).abs().mean()))
    hs = np.log(1.0 / np.asarray(SDE_GBM_NSTEPS))
    slopes = {k: float(np.polyfit(hs, np.log(v), 1)[0]) for k, v in errs.items()}
    i400 = SDE_GBM_NSTEPS.index(400)
    if (not all(m < e for m, e in zip(errs["milstein"], errs["em"]))
            or not errs["milstein"][i400] < 0.01
            or not abs(slopes["milstein"] - 1.0) < SDE_SLOPE_TOL
            or not abs(slopes["em"] - 0.5) < SDE_SLOPE_TOL):
        raise AssertionError(f"[23e] GBM strong errors {errs}, slopes {slopes}")
    _, mil_launches = launches_of(lambda: sde.solve_milstein(gbm_rhs, gbm_diff, y0, 0.0, 1.0,
                                                              100, pg, g))
    print(f"[23e] geometric Brownian motion mu={mu_g}, sigma={sig_g}, {SDE_GBM_PATHS} paths, "
          f"exact solution from the same increments: mean strong error at nsteps "
          f"{list(SDE_GBM_NSTEPS)}: EM {[f'{e:.3e}' for e in errs['em']]}, Milstein "
          f"{[f'{e:.3e}' for e in errs['milstein']]}; fitted orders EM {slopes['em']:.3f} "
          f"(0.5 +- {SDE_SLOPE_TOL:g}), Milstein {slopes['milstein']:.3f} (1.0 +- "
          f"{SDE_SLOPE_TOL:g}); times (host clock) EM {[f'{t:.1f}' for t in times['em']]} "
          f"ms, Milstein {[f'{t:.1f}' for t in times['milstein']]} ms; Milstein "
          f"{mil_launches / 100:.1f} kernel launches a step; card {card_line}", flush=True)

    # ---- (g) a float32 problem on the fused tier: K1's float64 build,
    # params cast up, the callables' float32 casts kept as roundings in
    # the generated model, held to K1's plain version
    from diffsol_tpu_torch.ops import fused_stepper as fs

    p_fused = k1_params(B_F32_CMP, f32)

    def fused32():
        return dtt.solve_dense_ensemble(dtt.BdfSolver, rob[f32], F32_T_EVAL, p_fused,
                                        mode="fused")

    torch.cuda.synchronize()
    fs.launch_fused_bdf.launches = 0
    fz = fused32()
    torch.cuda.synchronize()
    k1_launches = fs.launch_fused_bdf.launches
    plain = fs.make_fused_bdf_solve(rob[f32], F32_T_EVAL, B_F32_CMP)
    if "dsol_f32(" not in plain.header:
        raise AssertionError("[23g] the float32 problem's model header rounds nothing")
    ys_p, st_p, steps_p = plain.reference(p_fused.double())
    torch.cuda.synchronize()
    if (fz.tier != "fused_small" or fz.ys.dtype != torch.float64 or k1_launches < 1
            or fz.stop_reason != dtt.errors.TSTOP_REACHED or int(st_p.min()) != fs.OK):
        raise AssertionError(f"[23g] tier {fz.tier}, ys {fz.ys.dtype}, {k1_launches} K1 "
                             f"launches, stop {fz.stop_reason}, plain status {st_p.tolist()}")
    ys_g = fz.ys.movedim(1, -1)
    step_gap = (fz.tile_steps - steps_p).abs()
    abs_g = float((ys_g - ys_p).abs().max())
    rel_g = float(((ys_g - ys_p).abs() / ys_p.abs()).max())
    share_g = float(((ys_g - ys_p).abs() / (1e-6 + 1e-4 * ys_p.abs())).max())
    if int(step_gap.max()) > F32_FUSED_STEPS or not abs_g <= F32_CMP_ATOL:
        raise AssertionError(f"[23g] K1 vs plain: steps a tile {fz.tile_steps.tolist()} vs "
                             f"{steps_p.tolist()}, ys max abs {abs_g:.3e}")
    cons_g = float((fz.ys.sum(-1) - 1.0).abs().max())
    if not cons_g < F32_CONSERVE_TOL:
        raise AssertionError(f"[23g] conservation {cons_g:.3e}")
    _, fz_ms = timed_solve(fused32)
    print(f"[23g] Robertson float32 problem, mode=\"fused\", B={B_F32_CMP}: tier {fz.tier}, "
          f"ys {fz.ys.dtype}, {k1_launches} K1 launch(es), steps a tile "
          f"{fz.tile_steps.min().item()}-{fz.tile_steps.max().item()}, "
          f"{int((step_gap > 0).sum())} of {len(step_gap)} tiles apart from the plain "
          f"version's by up to {int(step_gap.max())} (bound {F32_FUSED_STEPS}); K1 vs plain "
          f"max abs {abs_g:.3e} (bound {F32_CMP_ATOL:g}), max rel {rel_g:.3e}, {share_g:.3e} "
          f"of an error weight; conservation {cons_g:.2e}; {fz_ms:.3f} ms median of 3; "
          f"card {card_line}", flush=True)

    # ---- (f) the API surface on the card
    from diffsol_tpu_torch.utils import stats_dict

    cases = {
        "expdecay_bdf": (exponential_decay.problem(rtol=1e-6, atol=1e-8), "bdf", 1.0),
        "logistic_bdf": (logistic.problem(rtol=1e-6, atol=1e-8), "bdf", 10.0),
        "robertson_dae_bdf": (robertson.problem_dae(), "bdf", 4e5),
        "logistic_trbdf2": (logistic.problem(rtol=1e-6, atol=1e-8), "tr_bdf2", 10.0),
        "expdecay_tsit45": (exponential_decay.problem(rtol=1e-6, atol=1e-8), "tsit45", 1.0),
    }
    for name, (pr, method, tf) in cases.items():
        sol = dtt.solve_dense(dtt.solver(pr, method), [tf * 0.5, tf], max_steps=20_000)
        got = stats_dict(sol)
        if (sol.stop_reason != dtt.errors.TSTOP_REACHED or sol.ys.device.type != dev.type
                or abs(got["steps"] - SNAPSHOT_STEPS[name]) > CARD_CPU_STEPS):
            raise AssertionError(f"[23f] {name}: stop {sol.stop_reason}, {got}")
        print(f"[23f] snapshot {name} on the card: {got} (tests/test_snapshots.py: "
              f"{SNAPSHOT_STEPS[name]} steps); card {card_line}", flush=True)
    blow = (dtt.OdeBuilder().rhs(lambda t, y, p: y * y)
            .init(lambda t, p: torch.ones(1, dtype=torch.float64, device=p.device))
            .p([0.0]).rtol(1e-8).atol(1e-10).build())
    sol = dtt.solve_dense(dtt.BdfSolver(blow), [0.5, 2.0], max_steps=2000)
    try:
        sol.raise_for_status()
    except dtt.errors.DiffsolError as e:
        print(f"[23f] y' = y^2 from 1: stop_reason {sol.stop_reason}, raise_for_status "
              f"raised DiffsolError({e}); card {card_line}", flush=True)
    else:
        raise AssertionError(f"[23f] raise_for_status did not raise (stop {sol.stop_reason})")
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffsol_tpu_torch import _build
    from diffsol_tpu_torch.models import heat1d, robertson
    from diffsol_tpu_torch.ops import fused_band_stepper as fb
    from diffsol_tpu_torch.ops import fused_stepper as fs

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    card_line = card()
    print(f"[1] card: {card_line}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # ---- 2. build every kernel library at once
    problem = robertson.problem_ode()
    check_solve = fs.make_fused_bdf_solve(problem, robertson.T_EVAL_4E10, B_CHECK)
    variants = k1_variants(rng)
    check_solves = {name: fs.make_fused_bdf_solve(v[0], v[1], B_CHECK)
                    for name, v in variants.items()}
    heat_problem, soln = heat1d.make(HEAT_MGRID, rtol=1e-6, atol=1e-8, banded=True)
    band_check = fb.make_fused_band_bdf_solve(heat_problem, HEAT_T_EVAL, B_BAND_CHECK)
    mol2d_checks = {
        name: fb.make_fused_band_bdf_solve(mol2d_problem(name), te, B_BAND_CHECK,
                                           max_steps=max_steps)
        for name, (_, te, max_steps) in MOL2D.items()}
    mixed_check = fs.make_fused_bdf_solve(problem, robertson.T_EVAL_4E10, B_CHECK,
                                          precision="mixed")
    # phase 23 g's float32 problem: its model rounds each rhs to float32
    f32_check = fs.make_fused_bdf_solve(
        robertson.problem_ode(rtol=1e-4, atol=1e-6, dtype=torch.float32), F32_T_EVAL,
        B_F32_CMP)
    t0 = time.perf_counter()
    diffsl = diffsl_models()
    diffsl_checks = diffsl_check_solves(diffsl)
    print(f"[2] DiffSL models compiled, built and traced in {time.perf_counter() - t0:.1f} s",
          flush=True)
    k1_solves = {"ode": check_solve, **check_solves, "mixed": mixed_check, "f32": f32_check,
                 **{k: v for k, v in diffsl_checks.items() if k in K1_DIFFSL}}
    band_solves = {"heat1d": band_check, **mol2d_checks,
                   **{k: v for k, v in diffsl_checks.items() if k not in K1_DIFFSL}}
    with ThreadPoolExecutor(max_workers=len(k1_solves) + len(band_solves) + 1) as ex:
        # one nvcc each, all started together; the widest first
        builds = [ex.submit(_build.load_fused_band_bdf, sv.header, sv.cfg.ml, sv.cfg.mu)
                  for sv in reversed(band_solves.values())]
        builds.append(ex.submit(_build.load_band_lu))
        k1_libs = {name: ex.submit(_build.load_fused_bdf, sv.header)
                   for name, sv in k1_solves.items()}
        for b in builds + list(k1_libs.values()):
            b.result()
    build_s = time.perf_counter() - t0
    print(f"[2] kernel libraries ready in {build_s:.1f} s (parallel nvcc, "
          f"{len(k1_solves)} fused BDF and {len(band_solves)} fused band BDF model "
          f"headers)", flush=True)
    for name, fut in k1_libs.items():
        lib_name = fut.result()._name.rsplit("/", 1)[-1]
        for b in _build.BUILDS:
            if b["library"] != lib_name:
                continue
            print(f"[2] fused BDF variant {name}: built {lib_name} in {b['seconds']:.1f} s",
                  flush=True)
            for kname, regs, frame, st, ld in ptxas_kernels(b["ptxas"]):
                threads = "1024" if "Li1024E" in kname else "256"
                print(f"[2] fused BDF variant {name}, {threads}-thread build: {regs} "
                      f"registers, {frame} B stack frame, {st} B spill stores, {ld} B "
                      f"spill loads", flush=True)
    if not _build.BUILDS:
        print("[2] the libraries were already built under build/diffsol_tpu_torch/ "
              "(delete it to see ptxas's report)", flush=True)

    shared = {}
    small_path, small_record = robertson_phases(dev, rng, card_line, problem, check_solve,
                                                shared)
    dae_path, variant_records = variant_phases(dev, rng, card_line, variants,
                                               check_solves, shared)
    print_builds(6, [b for b in _build.BUILDS if b["name"] != "fused_bdf"])
    lu_lib = _build.load_band_lu()
    for label, n_, ml_, mu_ in (("heat1d", 128, 1, 1), ("heat2d", 400, 20, 20),
                                ("foodweb", 200, 20, 20)):
        print(f"[6] band LU dynamic shared memory a block at {label}'s shape (n={n_}, "
              f"ml=mu={ml_}): factor {lu_lib.band_lu_shared_bytes(n_, ml_, mu_, 0, 8)} B, "
              f"solve {lu_lib.band_lu_shared_bytes(n_, ml_, mu_, 1, 8)} B (float build: "
              f"{lu_lib.band_lu_shared_bytes(n_, ml_, mu_, 0, 4)} B, "
              f"{lu_lib.band_lu_shared_bytes(n_, ml_, mu_, 1, 4)} B)", flush=True)
    for label, sv in band_solves.items():
        print_band_plan(label, sv)
    band_paths, band_records = band_phases(dev, card_line, heat_problem, soln, band_check)
    mol2d_paths, mol2d_records, lu_launches = mol2d_phases(dev, card_line, mol2d_checks)
    wide_lu_records = band_lu_wide_phase(dev, card_line, lu_launches)
    mixed_path, mixed_record = mixed_phase(dev, card_line, problem, shared)
    profile_paths([small_path, dae_path] + band_paths + mol2d_paths + [mixed_path],
                  card_line)
    t_new = time.perf_counter()
    for tag, phase in ((16, lambda: methods_phase(card_line)),
                       (17, lambda: rk_lockstep_phase(dev, card_line)),
                       (18, lambda: blockdiag_phase(dev, card_line)),
                       (19, lambda: mass_phase(card_line))):
        t_phase = time.perf_counter()
        phase()
        print(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s (host clock)",
              flush=True)
    print(f"[16-19] {time.perf_counter() - t_new:.1f} s together; card {card_line}",
          flush=True)
    t_phase = time.perf_counter()
    diffsl_records = diffsl_phase(dev, card_line, diffsl, diffsl_checks)
    print(f"[20] phase took {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)
    t_phase = time.perf_counter()
    sens_records, heat_rows = sens_phase(dev, card_line, heat_problem, soln)
    print(f"[21] phase took {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)
    t_phase = time.perf_counter()
    adjoint_records = adjoint_phase(dev, card_line, heat_problem, band_records[:2])
    print(f"[22] phase took {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)
    t_phase = time.perf_counter()
    f32_records = f32_sde_api_phase(dev, card_line, heat_problem, heat_rows)
    print(f"[23] phase took {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)
    record = ([small_record] + variant_records + [mixed_record] + band_records
              + mol2d_records + wide_lu_records + diffsl_records + sens_records
              + adjoint_records + f32_records)

    print(f"card: {card_line}")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
