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
   foodweb rhs headers, phase 20's DiffSL heat1d and heat2d and phase
   29's heat1d example, and the fused BDF kernel's mixed-precision build;
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
11. for the small-n paths (Robertson ODE, DAE, mixed), unprofiled: the
    call and K1 alone between CUDA events, K1's share of the call and the
    call's host part (the paths' traced calls went for the script's
    budget);
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
    to t = 4e6 and its batched LU factorizations; 100 groups x 100
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
    warm-up between CUDA events (the calls of seconds, (a), (b), (c)'s
    heat1d, (d) and (f), on their first call: LONG_REPS), with its steps,
    Newton iterations and
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
    CUDA events (the ensemble calls of (a)-(c) on their first call:
    LONG_REPS),
    with its forward and backward steps, Newton iterations and
    failures and the table's bytes: (a) Robertson ODE lockstep B=10,000 (k1
    spread +-10 %, numpy seed 0), t_eval 0.4 ... 4e6, loss sum ys^2: the
    forward alone (no_grad) and forward + backward; members 0, 4,999 and
    9,999 against 2 sum y.s from solve_dense_fwd_sens at rtol 1e-6 (5e-3
    of the largest); (b) heat1d n=128 banded lockstep
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
24. the matrix-free Newton-Krylov tier (no kernel of its own): (a) rhs =
    -p y + C y at n = 962 (the reference DFN's state count), C dense
    uniform(-0.01, 0.01) from numpy seed 2 (tests/test_krylov.py's
    coupling), to t = 1 at rtol 1e-6, atol 1e-8, through krylov(lu32)
    and through the dense LU, each within rtol 1e-4, atol 1e-7 of scipy's
    expm, with steps, Newton iterations, GMRES calls, restarts, Arnoldi
    iterations and host reads, the time (CUDA events: the counted first
    call, then the median of 3 calls for the dense LU and one call for
    krylov(lu32)), the dense LU's traced call's launches a step and busy
    share (krylov(lu32)'s ~100k-launch trace, ~20 s of processing, went to
    phase 30's sharded paths), and which tier is faster; use_coloring's
    route for the dense coupling; (b) the heat2d
    DAE at mgrid 20 (n = 400) as a lockstep krylov ensemble of 1,024
    identical members (256, printed as a cut, where four times the B = 256
    call would pass 36 s), its matrix-free consistent ICs and joint GMRES,
    every member within rtol 1e-3, atol 1e-6 of the banded lockstep solve
    (K3/K4 counted), both timed.
25. the C ABI: build libdiffsol_tpu_torch.so and the port's C consumer
    (g++/gcc), run the consumer with DIFFSOL_PLATFORM unset (the card) and
    require "ALL CHECKS PASSED" (build and run times printed), and show
    in-process that a handle's problem lives on the card.
26. mode="independent" as one batched BDF loop, each member its own step
    control: (a) the Robertson cell's B = 10,000 members to t = 4e10
    (bench.py's gate, eight members against their single solves on the
    card, its first call timed (LONG_REPS), rounds and host reads, beside
    lockstep and the member loop); (b) heat1d n=128
    banded, B = 1,024 (K3/K4 counted, and held to their plain versions on
    the path's M - cJ); (c) 1,024 balls, stop at the root and bounce.
27. mode="independent" batched for SDIRK and ERK, with sens=True and on the
    block tier: (a) TR-BDF2 on the Robertson cell's B = 10,000 members to
    t = 4e6 (member 0 against the CVODE table; members 0, 9,999 and six
    drawn with a seed against their single solves on the card: equal
    Stats, ys within 1e-12 + 1e-9 |ref|), timed (its first call, LONG_REPS)
    with rounds,
    host reads, the members' steps, lockstep at B = 10,000 and the member
    loop's time a member; (b) TSIT45 on phase 17's logistic rates, B = 10,000, every
    member within 200 rtol of the exact solution, 8 members against their
    single solves; (c) ESDIRK34 on heat1d n=128 banded, B = 1,024
    diffusivities linspace(0.5, 2.0): the analytic series within 1e-4, 4
    members against single solves, K3/K4 counted and held to their plain
    versions on the path's M - gamma h J; (d) BdfSolver(sens=True) on the
    same heat1d members, one row: the rows against solve_dense_fwd_sens
    (1e-3 of their largest), K3/K4 counted (the rows' solves are K4
    launches of naug B right-hand sides) and held to their plain versions;
    (e) robertson_ode g100 x b100 (bench.py:614-646) on the block tier,
    every group against the CVODE table to t = 4e6 (rtol 5e-3), its first
    call timed (LONG_REPS).
28. the last two member loops of mode="independent" made batched: (a)
    phase 24's coupling at n = 962 on krylov(lu32), B = 64 (p linspace(0.5,
    2)) to t = 1, every member against e^(-p t) expm(C t) y0 (rtol 1e-4,
    atol 1e-7), members 0, 63 and two drawn with a seed against their
    single Krylov solves on the card (equal Stats, GMRES restarts and
    Arnoldi iterations, ys within 1e-12 + 1e-9 |ref|), one call timed after
    a B = 4 warm-up with rounds, host reads, the members' restarts and
    Arnoldi iterations, and the single solve's time a member; (b) the heat2d
    DAE (n = 400) on the Krylov tier, B = 16, with the batched matrix-free
    consistent ICs, every member against the banded independent solve
    (rtol 1e-3, atol 1e-6), member 0 against its single Krylov solve; (c)
    the independent gradient (one batched forward, one batched backward)
    of the Robertson cell's members to t = 4e6, loss sum ys^2, after a B =
    64 warm-up to t = 0.4: B = 1,024 where ten times a B = 1,024 call passes 45 s
    (the cut printed), else B = 10,000; members 0, B - 1, two drawn and the
    first and last whose backward solve failed against their single
    make_differentiable_solve on the card (equal forward and backward
    Stats and statuses, gradients within 1e-12 + 1e-9 |ref|, NaN where the
    single gradient is NaN), member 0 (the first whose backward solve succeeds) against 2
    sum y.s from solve_dense_fwd_sens, a member whose backward solve spent
    the 50 Newton failures NaN alone, forward + backward timed, the
    members' steps and failures; (d) the same gradient on
    heat1d n=128 banded, B = 1,024 diffusivities: K3/K4 counted in the
    forward pass (none in the backward) and held to their plain versions
    on the path's M - cJ, two members against their single gradients.
29. the examples (diffsol_tpu_torch/examples/), each through its main()
    on the card, its host-clock seconds printed: robertson_ensemble (B =
    10,000, mode="auto": tier fused_small, K1 counted), heat1d_band_ensemble
    (B = 256: tier fused_band, K2 counted) and pde_heat (K3/K4 counted)
    in full, each kernel example's first tile against the card's lockstep
    solve of the same members (MODES_ATOL + MODES_RTOL |ref|), the kernel
    against its plain version on the example's members (K1, K2 by phase
    12's gates; K3/K4 on pde_heat's M - cJ by phase 7's) and timed; the
    single-solve and staged examples in full; the fits (predator_prey_fitting
    and the four adjoint fits) at full width with their loops cut to one
    iteration (the cut printed): the loss falls from the first
    iteration to the fitted parameters, and each adjoint fit's
    first gradient equals the same example's on the CPU within 1e-8 of its
    largest entry.
30. the ensemble sharded over a torch DeviceMesh (diffsol_tpu_torch/
    sharding.py): two spawned ranks of a gloo mesh ("dp") on the one card
    (every collective and the join under a time limit; gloo's all-reduce
    and all-gather on card tensors tried and printed), each calling with
    the global batch, their launch counters and all-gathers read around
    each call: (a) Robertson fused, B = 10,000 to 4e10 as 2 x 5,000 (K1),
    each block equal to the unsharded fused call on its members (equal
    tile statuses and steps, ys within 1e-12 + 1e-9 |ref|), member 0 on
    robertson.SOLN, K1 on rank 0's block against its plain version; (b)
    heat1d fused n=128, B = 1,024 (K2), the same gates and the analytic
    series; (c) heat2d lockstep on the banded tier, B = 1,024, one joint
    solve with its reductions as collectives: every rank's Stats equal to
    the unsharded solve's, ys within 1e-12 + 1e-9 |ref|, K3/K4 counted
    and held to their plain versions on rank 0's block of the last M - cJ;
    (d) Robertson independent, B = 1,024 to 4e4: every member's Stats
    equal to the unsharded batch's; (e) the lockstep gradient of
    Robertson, B = 1,024 to 4e4: equal forward and backward Stats, the
    gradient within 1e-10 of the unsharded one; (g) phase 24's heat2d DAE
    lockstep on the Krylov tier, B = 256 as 2 x 128, to its first output,
    one GMRES over both ranks' members (its dot products and norms summed
    over the mesh): every rank's Stats and GMRES counts equal to the
    unsharded call's and ys within 1e-10 of its largest entry; (h) heat1d
    ERK with every member's 2^20 states sharded over a (dp = 1, sp = 2)
    mesh of the same two ranks, B = 2, five steps from init_state: each
    rank's block of y and dy, the time, step and Stats equal bit for bit
    to the unsharded five steps, with the all-gathers a step; (j) banded
    heat1d BdfSolver and then TR-BDF2 steps from init_state over the same
    2^20 states a member (each rank builds and factors the whole members'
    Newton matrix, K3, and solves the gathered residual, K4): every rank's
    blocks of y, dy and D or the stage values, t, h, order, Stats and K3/K4
    launches equal to the unsharded steps', BDF's last Jacobian too; K3/K4
    at this shape held to their plain versions on the leading 2^14
    columns of rank 0's last M - cJ, the full-n factor's leading columns
    to that plain factor and the full-n solve to its residual; (k)
    solve_dense over the same mesh at test size, each equal bit for bit to
    the unsharded solve: the heat2d DAE (diagonal mass, consistent initial
    conditions, out(); K3/K4 at nb = 41) and heat1d n = 128 with a root, a
    reset, out() and its quadrature under BdfSolver and TR-BDF2; (i) phase
    28 d's independent gradient of heat1d banded, B = 1,024 as 2 x 512,
    every member's ys, gradient, forward and backward Stats and statuses
    equal bit for bit to phase 28 d's, K3/K4 counted on each rank and held
    to their plain versions on rank 0's block of the forward pass's last
    M - cJ; (f) (c) again over a 1-rank NCCL mesh.  The parent computes
    the unsharded references while the ranks run.  Each call's time and
    all-gathers are printed; two ranks share one card, so nothing here
    measures scaling.

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
heat2d float32 paths), K4 under forward mode
(`band_lu_solve:jvp_heat1d`, launches on phase 23 d's path) and K3/K4 on
the batched independent paths (`band_lu_factor:independent`,
`band_lu_solve:independent` of phase 26 b; `:independent_rk` of phase 27
c, `:independent_sens` of phase 27 d, `:independent_adjoint` of phase 28
d) and the kernel examples of phase 29 (`fused_bdf:example_robertson`,
`fused_band_bdf:example_heat1d`, `band_lu_factor:example_pde_heat`,
`band_lu_solve:example_pde_heat`) and the sharded paths of phase 30
(`fused_bdf:sharded`, `fused_band_bdf:sharded`,
`band_lu_factor:sharded_heat2d`, `band_lu_solve:sharded_heat2d`,
`band_lu_factor:sharded_independent_adjoint`,
`band_lu_solve:sharded_independent_adjoint`,
`band_lu_factor:sharded_state_bdf`, `band_lu_solve:sharded_state_bdf`;
launches over both ranks)
(launches on their path, error against the plain version, times, the
card's least time for the same work); the last line is the JSON result
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

import contextlib
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
    warm-up call (``reps=0``: the first call's)."""
    if reps == 0:
        return events_ms(fn)[1]
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
    # the gate's run is the plain version's timed one (one run)
    (ys_p, st_p, steps_p), plain_ms = events_ms(lambda: main_solve.reference(p_main))
    ys_k = sol.ys.movedim(1, -1)  # back to the kernel's (neval, n, B)
    abs5, share5 = check_close("B=10000", ys_k, ys_p, sol.tile_steps, steps_p)
    kernel_ms = time_ms(main_path, 5)
    # the kernel alone: CUDA events around the bare launch, so the rest of
    # the call is host work (and the few small kernels around the launch)
    te_dev = torch.tensor(te, dtype=torch.float64, device=dev)
    alone_ms = time_ms(lambda: fs.launch_fused_bdf(main_solve.cfg, main_solve.header,
                                                   p_main, te_dev), 5)
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
              f"tile={check.tile}, to t = {check.cfg.t_eval[-1]:g}: max abs diff "
              f"{abs_c:.3e}, {gate}; steps per tile kernel {steps_k.tolist()} plain "
              f"{steps_p.tolist()}; plain version {plain_ms:.0f} ms (one run, host clock, "
              f"B={B_BAND_CHECK})", flush=True)

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


def call_and_kernel(paths, card_line):
    """Phase 11: for each small-n path (name, callable, kernel name, a
    callable that launches K1 alone), the call and K1 alone between CUDA
    events, unprofiled: the kernel's share of the call and the call's host
    part.  The paths' traced calls (device time by kernel, busy share)
    went for the script's budget; PERF.md keeps their numbers."""
    for name, fn, _kernel, *alone in paths:
        if not alone:
            continue
        call_ms, k_ms = time_ms(fn, 5), time_ms(alone[0], 5)
        print(f"[11] {name}: call {call_ms:.3f} ms and K1 alone {k_ms:.3f} ms (CUDA events, "
              f"medians of 5 after a warm-up): the kernel {k_ms / call_ms:.1%} of the call, "
              f"host part {call_ms - k_ms:.3f} ms; card {card_line}", flush=True)


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


# timed calls after the warm-up for a solve of seconds (the script's
# 1,200 s budget, which phase 28 brought near): none, their first call is
# timed; the host's speed, not the repetition, sets their spread (up to 2x
# between runs on separate machines)
LONG_REPS = 0
LONG_WHEN = "the first call, no warm-up (LONG_REPS)"


def timed_solve(fn, reps=3):
    """``(solution, ms)``: ``fn``'s first call, whose solution the gates
    read, is the warm-up; then the median of ``reps`` calls between CUDA
    events (an eager solve reads its status on the host, a sync, every
    step).  ``reps=0`` times the first call itself."""
    if reps == 0:
        return events_ms(fn)
    sol = fn()
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


def profile_line(tag, fn, card_line):
    """One traced call of ``fn`` (a solve): the kernel launches a step and
    the card's busy share of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the card's activity only: a host-side record of the ~45,000 launches'
    # operators would cost more to gather than the call itself
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = fn().state.stats.steps
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
        print(f"[20] {name}: kernel vs plain, B={check.cfg.nbatch} tile={check.tile}, to t = "
              f"{check.cfg.t_eval[-1]:g}: max abs {max_abs:.3e}, statuses "
              f"{sorted(set(got['status'].tolist()))}, equal steps per tile; plain version "
              f"{plain_ms:.1f} ms (one run, host clock)", flush=True)

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

        sol, ms = timed_solve(run, LONG_REPS)
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
              f"rows, t=4e10: {stats_line(sol)}, {ms:.1f} ms ({LONG_WHEN}, "
              f"CUDA events); "
              f"member 0 meets the CVODE table; members {list(members)} within {err:.2e} "
              f"of solve_dense_fwd_sens at rtol {float(oracle_problem.rtol):g} (< {tol:g} "
              f"of its largest){extra}; card {card_line}", flush=True)

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
    _, heat_ms = timed_solve(run_heat, LONG_REPS)
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
          f"them), {heat_ms:.1f} ms ({LONG_WHEN}, CUDA events); ys vs the series "
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
    blk, blk_ms = timed_solve(lambda: dtt.solve_dense(sens_solver(wide), te, max_steps=5000),
                              LONG_REPS)
    one = dtt.solve_dense(sens_solver(robertson.problem_ode()), te, max_steps=5000)
    if blk.stop_reason != dtt.errors.TSTOP_REACHED or one.stop_reason != blk.stop_reason:
        raise AssertionError(f"[21d] stop_reason {blk.stop_reason}, {one.stop_reason}")
    groups = blk.sens.reshape(len(te), 3, 1000, 3)
    err_b = float((groups - one.sens[:, :, None, :]).abs().max() / one.sens.abs().max())
    if not err_b < SENS_BLOCK_TOL:
        raise AssertionError(f"[21d] groups off the single solve by {err_b:.3e}")
    print(f"[21d] robertson_ode ngroups=1000 (n=3000, blockdiag(3,1000)) BdfSolver(sens="
          f"True) to t=4e10: {stats_line(blk)}, {blk_ms:.1f} ms ({LONG_WHEN}, "
          f"CUDA events); "
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

        (sol, ms), ref = timed_solve(run_rk, LONG_REPS), run_rk("cpu")
        diff = (sol.sens.cpu() - ref.sens).abs()
        dsteps = abs(sol.state.stats.steps - ref.state.stats.steps)
        if (sol.stop_reason != dtt.errors.TSTOP_REACHED or dsteps > CARD_CPU_STEPS
                or bool((diff > CARD_CPU_ATOL + CARD_CPU_RTOL * ref.sens.abs()).any())):
            raise AssertionError(f"[21f] logistic {method}: card vs CPU rows "
                                 f"{float(diff.max())}, steps {sol.state.stats.steps} vs "
                                 f"{ref.state.stats.steps}")
        print(f"[21f] logistic {method} sens=True (rows in the error test): "
              f"{stats_line(sol)}, {ms:.2f} ms ({LONG_WHEN}, CUDA events); rows vs the CPU "
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
            max_steps=4000), LONG_REPS)
        errs = [float((sol.sens[:, j] - fd[j]).abs().max()) for j in range(2)]
        if sol.stop_reason != dtt.errors.TSTOP_REACHED or not max(errs) < SENS_FD_TOL:
            raise AssertionError(f"[21f] reset {method}: {sol.stop_reason}, vs central "
                                 f"differences {errs}")
        print(f"[21f] exponential decay with a reset, {method} sens=True: {stats_line(sol)}, "
              f"{ms:.2f} ms ({LONG_WHEN}, CUDA events); rows vs central differences on the "
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

    def peak_of(run):
        """``(run(), MiB)``: its result and the card's peak memory above
        what was allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = run()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2**20

    fwd_ms = time_ms(forward_only, LONG_REPS)
    # one gradient call: the gates read it, its time is the timed one, its
    # peak memory (c)'s dense-table figure
    ((ys, g), fb_ms), peak_dense = peak_of(
        lambda: timed_solve(lambda: grad_call(fn, params, sum_sq), LONG_REPS))
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
          f"forward + backward {fb_ms:.1f} ms, each {LONG_WHEN} (CUDA events); members "
          f"{members} within {[f'{e:.2e}' for e in errs.tolist()]} of 2 sum y.s from "
          f"solve_dense_fwd_sens at rtol {SENS_ORACLE_RTOL:g} (< {ADJ_ORACLE_TOL:g} of the "
          f"largest); card {card_line}", flush=True)

    # ---- (c) bounded memory, Robertson: the same ensemble, checkpoint_interval=32
    bounded = dtt.make_differentiable_solve_ensemble(problem, te6, B_MAIN,
                                                     checkpoint_interval=32)
    ((_, g_bnd), bnd_ms), peak_bnd = peak_of(
        lambda: timed_solve(lambda: grad_call(bounded, params, sum_sq), LONG_REPS))
    err_c = float(member_rel(g_bnd, g).max())
    if not err_c < ADJ_BOUNDED_TOL:
        raise AssertionError(f"[22c] bounded gradient off the dense table's by {err_c:.3e}")
    print(f"[22c] Robertson checkpoint_interval=32: {adjoint_stats(bounded)}; forward + "
          f"backward {bnd_ms:.1f} ms (dense table {fb_ms:.1f} ms), each {LONG_WHEN}; peak "
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

    heat_fwd_ms = time_ms(heat_forward, LONG_REPS)
    _, heat_ms = timed_solve(lambda: grad_call(heat, d, sum_sq), LONG_REPS)
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
          f"forward alone {heat_fwd_ms:.1f} ms, forward + backward {heat_ms:.1f} ms, each "
          f"{LONG_WHEN}; every member within {float(errs_h.max()):.2e} of 2 sum y.s from the "
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


# ---------------------------------------------------------------------------
# phase 24: the matrix-free Newton-Krylov tier (ops/krylov.py, no kernel of
# its own: GMRES on torch.func.jvp, a float32 torch.linalg LU preconditioner)
# against the dense torch.linalg LU at the reference DFN's state count, and
# in lockstep against the banded tier (K3/K4).  phase 25: the C ABI.

KRYLOV_N = 962  # the reference's DFN state count
KRYLOV_SEED = 2  # tests/test_krylov.py:92-142's coupling, at n = 300 there
KRYLOV_T_EVAL = [0.5, 1.0]
KRYLOV_EXPM_RTOL, KRYLOV_EXPM_ATOL = 1e-4, 1e-7  # tests/test_krylov.py:139-141
KRYLOV_MGRID = 20  # heat2d n = 400 (bench.py:681-690)
KRYLOV_HEAT2D_T_EVAL = [0.01, 0.1]
B_KRYLOV, B_KRYLOV_CUT = 1024, 256
# the B = 1,024 lockstep call runs only where four times the B = 256 call's
# time stays under this (the phase's budget is about 60 s)
KRYLOV_B_BUDGET_S = 36.0
# member against the banded lockstep solve (tests/test_krylov.py:281-283)
KRYLOV_BAND_RTOL, KRYLOV_BAND_ATOL = 1e-3, 1e-6
CAPI_TIMEOUT_S = 600


def krylov_heat2d():
    """The heat2d DAE (n = 400) on the matrix-free Krylov tier (phase 24 b,
    phase 30 g)."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import heat2d

    fns = heat2d.callables(KRYLOV_MGRID)
    return (dtt.OdeBuilder().rhs(fns["rhs"]).init(fns["init"]).mass(fns["mass"]).p([1.0])
            .rtol(1e-5).atol(1e-5).linear_solver("krylov").build())


def krylov_phase(dev, card_line):
    """Phase 24: (a) rhs = -p y + C y at n = 962, C dense uniform(-0.01,
    0.01) from numpy seed 2, to t = 1 at rtol 1e-6, atol 1e-8, through
    krylov(lu32) and through the dense LU, each against scipy's expm; (b)
    the heat2d DAE at mgrid 20 as a lockstep krylov ensemble against the
    banded lockstep solve of the same members."""
    import scipy.linalg

    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.ensemble import make_lockstep_problem
    from diffsol_tpu_torch.models import heat2d
    from diffsol_tpu_torch.ops import band_lu, krylov

    n = KRYLOV_N
    C = np.random.default_rng(KRYLOV_SEED).uniform(-0.01, 0.01, (n, n))
    c_on = {}

    def rhs(t, y, p):
        Cd = c_on.get(y.device)
        if Cd is None:
            Cd = c_on[y.device] = torch.tensor(C, device=y.device)
        return -p[0] * y + Cd @ y

    def init(t, p):
        return torch.ones(n, dtype=torch.float64, device=p.device)

    def build(route):
        b = dtt.OdeBuilder().rhs(rhs).init(init).p([1.0]).rtol(1e-6).atol(1e-8)
        if route == "krylov":
            b = b.linear_solver("krylov")
        elif route == "auto":
            b = b.use_coloring()
        return b.build()

    auto = build("auto")
    print(f"[24] (a) n = {n}: use_coloring routes the dense coupling to "
          f"{auto.linear_solver.name!r} (the JAX builder's rule off a TPU)", flush=True)
    exact = scipy.linalg.expm(C - np.eye(n)) @ np.ones(n)
    results = {}
    for route in ("krylov", "dense"):
        problem = build(route)
        solver = dtt.BdfSolver(problem)
        krylov.reset_gmres_counts()
        sol, ms_first = events_ms(lambda: dtt.solve_dense(solver, KRYLOV_T_EVAL,
                                                          max_steps=2000))
        counts = krylov.gmres_counts()
        if sol.stop_reason < 0:
            raise RuntimeError(f"[24] (a) {route}: stop_reason {sol.stop_reason}")
        err = float(np.max(np.abs(sol.ys[-1].cpu().numpy() - exact)
                           / (KRYLOV_EXPM_ATOL + KRYLOV_EXPM_RTOL * np.abs(exact))))
        if not err <= 1.0:
            raise RuntimeError(f"[24] (a) {route}: {err:.3g} bounds from expm")
        # the counted call was the warm-up: then the median of 3 timed
        # calls of the dense LU's ~0.1 s, one of krylov's seconds
        reps = 1 if route == "krylov" else 3
        ms = float(np.median([events_ms(lambda: dtt.solve_dense(
            solver, KRYLOV_T_EVAL, max_steps=2000))[1] for _ in range(reps)]))
        when = "one call" if reps == 1 else f"median of {reps}"
        gm = (f"; GMRES {counts['calls']} calls, {counts['restarts']} restarts, "
              f"{counts['arnoldi']} Arnoldi iterations, {counts['host_reads']} host reads"
              if route == "krylov" else "")
        print(f"[24] (a) {problem.linear_solver.name}: {stats_line(sol)}, "
              f"{sol.state.stats.jacobian_evals} Jacobian evaluations{gm}; {ms:.1f} ms "
              f"({when} after the counted first call of {ms_first:.1f} ms, CUDA events); "
              f"t = 1 within {err:.3f} of the expm bound "
              f"(rtol {KRYLOV_EXPM_RTOL:g}, atol {KRYLOV_EXPM_ATOL:g}); card {card_line}",
              flush=True)
        if route == "dense":
            profile_line(f"24 a {route}",
                         lambda: dtt.solve_dense(solver, KRYLOV_T_EVAL, max_steps=2000),
                         card_line)
        results[route] = ms
    faster = min(results, key=results.get)
    slower = max(results, key=results.get)
    print(f"[24] (a) at n = {n} the {faster} tier is faster: {results[slower] / results[faster]:.2f}"
          f"x ({results[faster]:.1f} ms against {results[slower]:.1f} ms); card {card_line}",
          flush=True)

    # ---- (b) heat2d DAE, lockstep krylov against the banded lockstep
    kry = krylov_heat2d()
    band = heat2d.make(KRYLOV_MGRID)
    print(f"[24] (b) heat2d n = {KRYLOV_MGRID ** 2}: {kry.linear_solver.name}, its "
          f"preconditioner's Jacobian from "
          f"{'colored probes' if kry.linear_solver.meta[4] is not None else 'jacfwd'}; "
          f"mass diagonal: {kry.eqn.mass_diag_fn is not None}", flush=True)

    def run(problem, nb):
        lp = make_lockstep_problem(problem.to(dev), nb)
        params = torch.ones((nb, 1), dtype=torch.float64, device=dev)
        solver = dtt.BdfSolver(lp)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        sol = dtt.solve_dense(solver, KRYLOV_HEAT2D_T_EVAL, params=params, max_steps=5000)
        end.record()
        torch.cuda.synchronize()
        return sol, start.elapsed_time(end)

    # B = 256 first: the measured call where B = 1,024 would pass the
    # phase's budget, else the warm-up
    krylov.reset_gmres_counts()
    sol, ms_k = run(kry, B_KRYLOV_CUT)
    counts = krylov.gmres_counts()
    ms256, nb = ms_k, B_KRYLOV_CUT
    if ms256 * 4 / 1e3 <= KRYLOV_B_BUDGET_S:
        nb = B_KRYLOV
        krylov.reset_gmres_counts()
        sol, ms_k = run(kry, nb)
        counts = krylov.gmres_counts()
    else:
        print(f"[24] (b) cut: B = {B_KRYLOV_CUT}, not {B_KRYLOV} (the B = {B_KRYLOV_CUT} "
              f"call took {ms256:.0f} ms; four times that passes {KRYLOV_B_BUDGET_S:g} s)",
              flush=True)
    run(band, nb)  # the warm-up
    band_lu.launch_band_lu_factor.launches = band_lu.launch_band_lu_solve.launches = 0
    solb, ms_b = run(band, nb)
    k3, k4 = band_lu.launch_band_lu_factor.launches, band_lu.launch_band_lu_solve.launches
    if sol.stop_reason < 0 or solb.stop_reason < 0:
        raise RuntimeError(f"[24] (b) stop_reason {sol.stop_reason} / {solb.stop_reason}")
    if k3 == 0 or k4 == 0:
        raise RuntimeError("[24] (b) the banded lockstep solve launched no K3/K4")
    got, ref = sol.ys.cpu().numpy(), solb.ys.cpu().numpy()
    err = float(np.max(np.abs(got - ref) / (KRYLOV_BAND_ATOL + KRYLOV_BAND_RTOL * np.abs(ref))))
    if not err <= 1.0:
        raise RuntimeError(f"[24] (b) krylov against banded: {err:.3g} bounds")
    print(f"[24] (b) heat2d lockstep B = {nb}: krylov_lockstep(lu32) {stats_line(sol)}, GMRES "
          f"{counts['calls']} calls (the consistent ICs' among them), {counts['restarts']} "
          f"restarts, {counts['arnoldi']} Arnoldi iterations, {counts['host_reads']} host "
          f"reads, {ms_k:.1f} ms (B = {B_KRYLOV_CUT}: {ms256:.1f} ms; the first call at its B); "
          f"banded lockstep {stats_line(solb)}, K3 {k3} and K4 {k4} launches, {ms_b:.1f} ms "
          f"(after a warm-up; CUDA events, one call each); every member within {err:.3f} of the bound "
          f"(rtol {KRYLOV_BAND_RTOL:g}, atol {KRYLOV_BAND_ATOL:g}); card {card_line}", flush=True)


CAPI_LOGISTIC = "in_i { r = 1.0, k = 1.0 }\nu { 0.1 }\nF { r * u * (1.0 - u / k) }\n"


def capi_phase(card_line):
    """Phase 25: build libdiffsol_tpu_torch.so and the port's C consumer,
    run the consumer with DIFFSOL_PLATFORM unset (the card) and require
    every check; in-process, a handle's problem lives on the card."""
    import os

    from diffsol_tpu_torch import _build, capi_host

    t0 = time.perf_counter()
    built = _build.build_capi()
    print(f"[25] libdiffsol_tpu_torch.so and test_capi built in {built['seconds']:.1f} s "
          f"(g++/gcc; {time.perf_counter() - t0:.1f} s with the check for an earlier build)",
          flush=True)
    env = _build.capi_env(None)
    t0 = time.perf_counter()
    res = subprocess.run([str(built["consumer"])], env=env, cwd=built["dir"],
                         capture_output=True, text=True, timeout=CAPI_TIMEOUT_S)
    run_s = time.perf_counter() - t0
    if res.returncode != 0 or "ALL CHECKS PASSED" not in res.stdout:
        raise RuntimeError(f"[25] the C consumer failed ({res.returncode}):\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    print(f"[25] the C consumer on the card (DIFFSOL_PLATFORM unset): "
          f"{res.stdout.strip().splitlines()[-1]!r} in {run_s:.1f} s (host clock, its "
          f"interpreter's start and torch's import included); card {card_line}", flush=True)
    saved = os.environ.pop("DIFFSOL_PLATFORM", None)
    try:
        h = capi_host.new_jit(CAPI_LOGISTIC)
        capi_host.set_params(h, [1.0, 10.0])
        problem = capi_host._get(h).problem()
        ys, stop = capi_host.solve_dense(h, [0.1, 0.25, 0.4])
        capi_host.free(h)
    finally:
        if saved is not None:
            os.environ["DIFFSOL_PLATFORM"] = saved
    t = np.array([0.1, 0.25, 0.4])
    exact = 10.0 * 0.1 * np.exp(t) / (10.0 + 0.1 * (np.exp(t) - 1.0))
    if not (problem.params.is_cuda and problem.t0.is_cuda and stop >= 0
            and np.max(np.abs(np.asarray(ys) - exact)) < 1e-5):
        raise RuntimeError(f"[25] in-process handle: params on {problem.params.device}, "
                           f"stop {stop}, ys {ys}")
    print(f"[25] in-process: a handle's problem holds its tensors on "
          f"{problem.params.device}; solve_dense within "
          f"{np.max(np.abs(np.asarray(ys) - exact)):.2e} of the logistic", flush=True)


# ---------------------------------------------------------------------------
# phase 26: mode="independent" as one batched BDF loop
# (solvers/bdf_independent.py): every member its own step control.  (a) the
# Robertson cell's problem and members, against single solves of eight
# members on the card and timed beside lockstep and the member loop; (b)
# heat1d banded through K3/K4 on the refreshed members' bands; (c) 1,024
# stop-at-root and bouncing balls, each at its own times.

# a member of the batched loop against its single solve on the card: the
# same accepted steps, ys within 1e-12 + 1e-9 |ref| (the control runs in
# float64 on the card in one and on the host in the other)
IND_RTOL, IND_ATOL = 1e-9, 1e-12
# bench.py:338-346's gate: mass conserved within 1e-3, x within 2e-2 of
# the CVODE table at t = 0.4, 4, 40 for the nominal member
IND_CONS, IND_SOLN_REL = 1e-3, 2e-2
B_BALLS = 1024
BALL_ROOT_TOL = 2e-4
BALL_T_EVAL_26 = [0.5, 1.0, 1.5, 2.0, 2.5]


def ball_problem(reset):
    from diffsol_tpu_torch import OdeBuilder

    def rhs(t, y, p):
        return torch.stack([y[1], -p[0] * torch.ones_like(y[1])])

    b = (OdeBuilder().rhs(rhs)
         .init(lambda t, p: torch.tensor([10.0, 0.0], dtype=torch.float64, device=p.device))
         .root(lambda t, y, p: y[0:1]).p([9.81]).rtol(1e-8).atol(1e-10))
    if reset:
        b = b.reset(lambda t, y, p: torch.stack([torch.full_like(y[0], 1e-9), -0.8 * y[1]]))
    return b.build()


def member_vs_single(name, sol, problem, te, params, members, max_steps=100_000):
    """Each of ``members`` against its single eager solve on the card;
    returns (largest abs difference, the single solves' seconds each)."""
    from diffsol_tpu_torch import BdfSolver, solve_dense

    worst, secs = 0.0, []
    for b in members:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = solve_dense(BdfSolver(problem), te, params=params[b], max_steps=max_steps)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got, ref = sol.ys[:, b], one.ys
        steps_b = int(sol.state.stats.steps[b])
        if steps_b != one.state.stats.steps or int(sol.stop_reason[b]) != one.stop_reason:
            raise AssertionError(f"{name}: member {b} took {steps_b} steps (stop "
                                 f"{int(sol.stop_reason[b])}), its single solve "
                                 f"{one.state.stats.steps} (stop {one.stop_reason})")
        bad = (got - ref).abs() > IND_ATOL + IND_RTOL * ref.abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: member {b} off its single solve at "
                                 f"{int(bad.sum())} entries, max abs "
                                 f"{float((got - ref).abs().max()):.3e}")
        worst = max(worst, float((got - ref).abs().max()))
    return worst, secs


def independent_phase(dev, card_line, heat_problem, soln):
    """Phase 26; returns the K3/K4 records of the banded independent path."""
    from diffsol_tpu_torch import BdfSolver, errors, solve_dense_ensemble
    from diffsol_tpu_torch.models import robertson
    from diffsol_tpu_torch.ops import band_lu
    from diffsol_tpu_torch.solvers.bdf_independent import IndependentState

    # ---- (a) Robertson, the cell's problem and members
    problem = robertson.problem_ode()
    te = robertson.T_EVAL_4E10
    rng = np.random.default_rng(SEED)
    params = robertson_params(B_MAIN, rng, dev)

    def run():
        return solve_dense_ensemble(BdfSolver, problem, te, params, mode="independent")

    sol, ms = timed_solve(run, LONG_REPS)
    st = sol.state
    if sol.tier != "independent" or not isinstance(st, IndependentState):
        raise AssertionError(f"(a): tier {sol.tier!r}, state {type(st).__name__}")
    if not bool((sol.stop_reason == errors.TSTOP_REACHED).all()):
        raise AssertionError(f"(a): stop reasons {sol.stop_reason.unique().tolist()}")
    ys = sol.ys
    if tuple(ys.shape) != (len(te), B_MAIN, 3) or not bool(torch.isfinite(ys).all()):
        raise AssertionError(f"(a): ys {tuple(ys.shape)} or non-finite values")
    cons = float((ys.sum(-1) - 1.0).abs().max())
    rel = [abs(float(ys[r - 1, 0, 0]) - robertson.SOLN[r, 1]) / robertson.SOLN[r, 1]
           for r in (1, 2, 3)]
    if not cons < IND_CONS or not max(rel) < IND_SOLN_REL:
        raise AssertionError(f"(a): bench.py's gate: conservation {cons:.2e}, member 0 "
                             f"vs SOLN {max(rel):.2e}")
    drawn = sorted(np.random.default_rng(SEED + 26).choice(
        np.arange(1, B_MAIN - 1), 6, replace=False).tolist())
    members = [0, B_MAIN - 1] + drawn
    worst, secs = member_vs_single("(a)", sol, problem, te, params, members)
    steps = st.stats.steps
    print(f"[26a] independent Robertson, B={B_MAIN} to t=4e10: every member "
          f"TSTOP_REACHED, conservation {cons:.2e}, member 0 vs SOLN at t=0.4, 4, 40 "
          f"{max(rel):.2e} (bench.py's gate {IND_CONS:g}, {IND_SOLN_REL:g}); members "
          f"{members} against their single solves on the card: equal accepted steps, max "
          f"abs {worst:.3e} (bound {IND_ATOL:g} + {IND_RTOL:g}|ref|)", flush=True)
    lock_ms = timed_solve(lambda: solve_dense_ensemble(BdfSolver, problem, te, params,
                                                       mode="lockstep"))[1]
    loop_ms = float(np.mean(secs)) * 1e3
    print(f"[26a] independent call {ms:.1f} ms ({LONG_WHEN}, CUDA events); "
          f"{st.rounds} "
          f"rounds, {st.host_reads} host reads ({st.host_reads / st.rounds:.2f} a round), "
          f"{st.newton_sweeps} Newton sweeps; members' accepted steps min "
          f"{int(steps.min())} max {int(steps.max())} median {int(steps.median())}; "
          f"lockstep on the same problem {lock_ms:.1f} ms (median "
          f"of 3); the member loop {loop_ms:.1f} ms a member (mean of the {len(secs)} "
          f"single solves), {loop_ms * B_MAIN / 1e3:.0f} s for B={B_MAIN} extrapolated; "
          f"card {card_line}", flush=True)

    # ---- (b) heat1d banded: K3 on the refreshed members' bands, K4 on all
    n = HEAT_MGRID + 1
    d = np.linspace(0.5, 2.0, B_BAND)
    hp = torch.tensor(d[:, None], device=dev)

    def run_heat():
        return solve_dense_ensemble(BdfSolver, heat_problem, HEAT_T_EVAL, hp,
                                    mode="independent")

    band_lu.launch_band_lu_factor.launches = 0
    band_lu.launch_band_lu_solve.launches = 0
    hs = run_heat()
    torch.cuda.synchronize()
    k3 = band_lu.launch_band_lu_factor.launches
    k4 = band_lu.launch_band_lu_solve.launches
    if k3 < 1 or k4 < 1:
        raise AssertionError(f"(b): launched K3 {k3} and K4 {k4} times")
    if not bool((hs.stop_reason == errors.TSTOP_REACHED).all()):
        raise AssertionError(f"(b): stop reasons {hs.stop_reason.unique().tolist()}")
    hys = hs.ys.cpu().numpy()
    series = np.stack([soln(HEAT_T_EVAL, dd) for dd in d], axis=1)
    err_b = float(np.abs(hys - series).max())
    if not err_b < ANALYTIC_TOL:
        raise AssertionError(f"(b): off the analytic series by {err_b}")
    hmembers = [0, B_BAND // 3, 2 * B_BAND // 3, B_BAND - 1]
    hworst, _ = member_vs_single("(b)", hs, heat_problem, HEAT_T_EVAL, hp, hmembers)
    heat_ms = timed_solve(run_heat)[1]
    hst = hs.state
    print(f"[26b] independent heat1d banded, B={B_BAND}, n={n}: {k3} K3 launches (the "
          f"refreshed members' bands), {k4} K4 launches (every member against its own "
          f"factors), {hst.rounds} rounds; every member vs the analytic series "
          f"{err_b:.3e} (bound {ANALYTIC_TOL:g}); members {hmembers} vs their single "
          f"solves max abs {hworst:.3e}; {heat_ms:.1f} ms median of 3; "
          f"steps min {int(hst.stats.steps.min())} max {int(hst.stats.steps.max())}; card "
          f"{card_line}", flush=True)
    # K3/K4 against their plain versions on this path's M - c J: each
    # member's last Jacobian and c
    band = heat_problem.linear_solver.assemble(
        None, hst.jac, hst.c_last.view(-1, 1, 1))
    b = torch.tensor(np.random.default_rng(SEED).standard_normal((B_BAND, n)), device=dev)
    F, x = lu_once(band, b, 1, 1)
    F_p = band_lu.band_lu_factor_reference(band, 1, 1)
    x_p = band_lu.band_lu_solve_reference(F_p, b, 1, 1)
    ef, ex = check_lu("(b) factor", F.lu, F_p), check_lu("(b) solve", x, x_p)
    f_ms = time_ms(lambda: band_lu.launch_band_lu_factor(band, 1, 1), 20)
    s_ms = time_ms(lambda: band_lu.launch_band_lu_solve(F.lu, b, 1, 1), 20)
    f_plain = time_ms(lambda: band_lu.band_lu_factor_reference(band, 1, 1), 3)
    s_plain = time_ms(lambda: band_lu.band_lu_solve_reference(F.lu, b, 1, 1), 3)
    dense = dense_of(band, 1, 1)
    lu, piv = torch.linalg.lu_factor(dense)
    lib_f = time_ms(lambda: torch.linalg.lu_factor(dense), 5)
    lib_s = time_ms(lambda: torch.linalg.lu_solve(lu, piv, b.unsqueeze(-1)), 5)
    nb = 3
    f_bound = bound(8 * B_BAND * (nb * n + (n + 1) * nb), B_BAND * n * 4)
    s_bound = bound(8 * B_BAND * ((n - 1) + 2 * n + 2 * n), B_BAND * (2 * (n - 1) + 3 * n))
    print(f"[26b] K3/K4 on this path's M - cJ (B={B_BAND}): vs plain max abs factor "
          f"{ef:.3e}, x {ex:.3e}; factor {f_ms:.4f} ms, solve {s_ms:.4f} ms (medians of "
          f"20; least {f_bound[0]:.4f} / {s_bound[0]:.4f} ms); plain {f_plain:.2f} / "
          f"{s_plain:.2f} ms; torch.linalg.lu_factor / lu_solve on the dense expansion "
          f"{lib_f:.3f} / {lib_s:.3f} ms; card {card_line}", flush=True)
    common = {"route": "cuda", "source": "diffsol_tpu_torch/csrc/band_lu.cuh"}
    records = [
        dict(name="band_lu_factor:independent", replaces="diffsol_tpu/ops/pallas_banded.py:51",
             launches=k3, max_abs_err=ef, ms=f_ms, plain_ms=f_plain, bound_ms=f_bound[0],
             bound_by=f_bound[1], library_ms=lib_f, **common),
        dict(name="band_lu_solve:independent", replaces="diffsol_tpu/ops/pallas_banded.py:72",
             launches=k4, max_abs_err=ex, ms=s_ms, plain_ms=s_plain, bound_ms=s_bound[0],
             bound_by=s_bound[1], library_ms=lib_s, **common),
    ]

    # ---- (c) balls over gravities linspace(6, 15), each at its own times
    g = torch.linspace(6.0, 15.0, B_BALLS, dtype=torch.float64, device=dev)[:, None]
    t_land = torch.sqrt(20.0 / g[:, 0])
    for reset in (False, True):
        bp = ball_problem(reset)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bs = solve_dense_ensemble(BdfSolver, bp, BALL_T_EVAL_26, g, mode="independent",
                                  max_steps=4000)
        torch.cuda.synchronize()
        ball_s = time.perf_counter() - t0
        if reset:
            if not bool((bs.stop_reason == errors.TSTOP_REACHED).all()):
                raise AssertionError(f"(c) reset: stops {bs.stop_reason.unique().tolist()}")
            gg = g[:, 0].cpu().numpy()
            ref = np.stack([fc_ball_height(np.asarray(BALL_T_EVAL_26), gi) for gi in gg], 1)
            err = float(np.abs(bs.ys[..., 0].cpu().numpy() - ref).max())
            if not err < 1e-4:
                raise AssertionError(f"(c) reset: heights off the closed form by {err}")
            what = f"heights vs the closed form (to the second bounce) max abs {err:.2e}"
        else:
            if not bool((bs.stop_reason == errors.ROOT_FOUND).all()):
                raise AssertionError(f"(c) stop: stops {bs.stop_reason.unique().tolist()}")
            err = float((bs.root_t - t_land).abs().max())
            if not err < BALL_ROOT_TOL or not bool((bs.root_idx == 0).all()):
                raise AssertionError(f"(c) stop: root_t off sqrt(2*10/g) by {err}")
            what = f"root_t vs sqrt(2*10/g) max abs {err:.2e} (bound {BALL_ROOT_TOL:g})"
        print(f"[26c] independent balls, B={B_BALLS}, {'reset' if reset else 'stop at root'}"
              f": {what}; {bs.state.rounds} rounds, {bs.state.host_reads} host reads, steps "
              f"min {int(bs.state.stats.steps.min())} max {int(bs.state.stats.steps.max())}; "
              f"{ball_s:.2f} s (host clock, one call); card {card_line}", flush=True)
    return records


# ---------------------------------------------------------------------------
# phase 27: mode="independent" batched for SDIRK and ERK, with sens=True and
# on the block-diagonal tier (solvers/rk_independent.py and
# solvers/bdf_independent.py on solvers/independent.py's driver).  (a)
# TR-BDF2 on the Robertson cell's members, timed beside lockstep and the
# member loop; (b) TSIT45 on phase 17's logistic rates; (c) ESDIRK34 on
# heat1d banded through K3/K4; (d) BdfSolver(sens=True) on heat1d banded,
# the rows' solves K4 launches of naug B right-hand sides; (e) the
# g100 x b100 cell on the block tier.

B_IND_LOGISTIC_MEMBERS = 8
B_IND_G100 = 100


def member_stats_match(name, sol, make, problem, te, params, members, max_steps=100_000):
    """Each of ``members`` against its single eager solve on the card:
    its whole Stats and stop equal, ys (and the rows) within 1e-12 + 1e-9
    |ref|; returns (largest abs difference, the single solves' seconds
    each)."""
    import dataclasses

    from diffsol_tpu_torch import solve_dense

    worst, secs = 0.0, []
    for b in members:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = solve_dense(make(problem), te, params=params[b], max_steps=max_steps)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got_stats = dataclasses.asdict(sol.state.member_stats(b))
        if got_stats != dataclasses.asdict(one.state.stats) or \
                int(sol.stop_reason[b]) != one.stop_reason:
            raise AssertionError(f"{name}: member {b} Stats {got_stats} (stop "
                                 f"{int(sol.stop_reason[b])}), its single solve "
                                 f"{one.state.stats} (stop {one.stop_reason})")
        pairs = [(sol.ys[:, b], one.ys)]
        if one.sens is not None:
            pairs.append((sol.sens[:, :, b], one.sens))
        for got, ref in pairs:
            bad = (got - ref).abs() > IND_ATOL + IND_RTOL * ref.abs()
            if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name}: member {b} off its single solve at "
                                     f"{int(bad.sum())} entries, max abs "
                                     f"{float((got - ref).abs().max()):.3e}")
            worst = max(worst, float((got - ref).abs().max()))
    return worst, secs


def path_lu_records(dev, card_line, tag, band, nrows, phase=27):
    """K3 and K4 against their plain versions on a path's (B, nb, n) M - c J
    band (ml = mu = 1), K4 with ``nrows`` B right-hand sides (row r against
    factorization r mod B): max abs difference, time, the plain version's,
    torch.linalg's on the dense expansion and the bound.  Returns the two
    records without their ``launches``."""
    from diffsol_tpu_torch.ops import band_lu

    B, nb, n = band.shape
    b = torch.tensor(np.random.default_rng(SEED).standard_normal((nrows * B, n)), device=dev)
    F, x = lu_once(band, b, 1, 1)
    F_p = band_lu.band_lu_factor_reference(band, 1, 1)
    x_p = band_lu.band_lu_solve_reference(F_p, b, 1, 1)
    ef, ex = check_lu(f"{tag} factor", F.lu, F_p), check_lu(f"{tag} solve", x, x_p)
    f_ms = time_ms(lambda: band_lu.launch_band_lu_factor(band, 1, 1), 20)
    s_ms = time_ms(lambda: band_lu.launch_band_lu_solve(F.lu, b, 1, 1), 20)
    f_plain = time_ms(lambda: band_lu.band_lu_factor_reference(band, 1, 1), 3)
    s_plain = time_ms(lambda: band_lu.band_lu_solve_reference(F.lu, b, 1, 1), 3)
    dense = dense_of(band, 1, 1)
    lu, piv = torch.linalg.lu_factor(dense)
    rhs = b.reshape(nrows, B, n, 1)
    lib_f = time_ms(lambda: torch.linalg.lu_factor(dense), 5)
    lib_s = time_ms(lambda: torch.linalg.lu_solve(lu, piv, rhs), 5)
    f_bound = bound(8 * B * (nb * n + (n + 1) * nb), B * n * 4)
    # each member's factors once (one multiplier and two U rows a column),
    # the rows in and out
    s_bound = bound(8 * (B * ((n - 1) + 2 * n) + 2 * nrows * B * n),
                    nrows * B * (2 * (n - 1) + 3 * n))
    print(f"[{phase}{tag}] K3/K4 on this path's M - cJ (B={B}, K4 with {nrows * B} rows): vs "
          f"plain max abs factor {ef:.3e}, x {ex:.3e}; factor {f_ms:.4f} ms, solve "
          f"{s_ms:.4f} ms (medians of 20; least {f_bound[0]:.4f} / {s_bound[0]:.4f} ms); "
          f"plain {f_plain:.2f} / {s_plain:.2f} ms; torch.linalg.lu_factor / lu_solve on "
          f"the dense expansion {lib_f:.3f} / {lib_s:.3f} ms; card {card_line}", flush=True)
    common = {"route": "cuda", "source": "diffsol_tpu_torch/csrc/band_lu.cuh"}
    return (dict(name="band_lu_factor", replaces="diffsol_tpu/ops/pallas_banded.py:51",
                 max_abs_err=ef, ms=f_ms, plain_ms=f_plain, bound_ms=f_bound[0],
                 bound_by=f_bound[1], library_ms=lib_f, **common),
            dict(name="band_lu_solve", replaces="diffsol_tpu/ops/pallas_banded.py:72",
                 max_abs_err=ex, ms=s_ms, plain_ms=s_plain, bound_ms=s_bound[0],
                 bound_by=s_bound[1], library_ms=lib_s, **common))


def counted(fn):
    """``fn()`` with K3's and K4's counts set to 0 just before it and read
    just after: (its result, K3 launches, K4 launches, its ms between CUDA
    events)."""
    from diffsol_tpu_torch.ops import band_lu

    band_lu.launch_band_lu_factor.launches = 0
    band_lu.launch_band_lu_solve.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return (out, band_lu.launch_band_lu_factor.launches,
            band_lu.launch_band_lu_solve.launches, start.elapsed_time(end))


def independent_rk_phase(dev, card_line, heat_problem, soln):
    """Phase 27; returns the K3/K4 records of paths (c) and (d)."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch import errors
    from diffsol_tpu_torch.models import logistic, robertson
    from diffsol_tpu_torch.solvers.rk_independent import RkIndependentState

    def method(name, **kw):
        return lambda pr: dtt.solver(pr, name, **kw)

    # ---- (a) TR-BDF2 on the Robertson cell's members, to phase 17's t_eval
    te = robertson.SOLN[1:9, 0]
    problem = robertson.problem_ode()
    params = robertson_params(B_MAIN, np.random.default_rng(SEED), dev)
    trbdf2 = method("tr_bdf2")

    def run():
        return dtt.solve_dense_ensemble(trbdf2, problem, te, params, mode="independent",
                                        max_steps=20_000)

    sol, ms = timed_solve(run, LONG_REPS)
    st = sol.state
    if sol.tier != "independent" or not isinstance(st, RkIndependentState):
        raise AssertionError(f"(a): tier {sol.tier!r}, state {type(st).__name__}")
    if not bool((sol.stop_reason == errors.TSTOP_REACHED).all()):
        raise AssertionError(f"(a): stop reasons {sol.stop_reason.unique().tolist()}")
    check_soln("(a) member 0", sol.ys[:, 0])
    drawn = sorted(np.random.default_rng(SEED + 27).choice(
        np.arange(1, B_MAIN - 1), 6, replace=False).tolist())
    members = [0, B_MAIN - 1] + drawn
    worst, secs = member_stats_match("(a)", sol, trbdf2, problem, te, params, members,
                                     max_steps=20_000)
    lock_ms = timed_solve(lambda: dtt.solve_dense_ensemble(
        trbdf2, problem, te, params, mode="lockstep", max_steps=20_000))[1]
    loop_ms = float(np.mean(secs)) * 1e3
    steps = st.stats.steps
    print(f"[27a] independent TR-BDF2 Robertson, B={B_MAIN} to t=4e6: every member "
          f"TSTOP_REACHED, member 0 meets the CVODE table (rtol 5e-3); members {members} "
          f"against their single solves on the card: equal Stats, max abs {worst:.3e} "
          f"(bound {IND_ATOL:g} + {IND_RTOL:g}|ref|); call {ms:.1f} ms ({LONG_WHEN}, "
          f"CUDA events); {st.rounds} rounds, {st.host_reads} host reads "
          f"({st.host_reads / st.rounds:.2f} a round), {st.newton_sweeps} Newton sweeps; "
          f"members' accepted steps min {int(steps.min())} max {int(steps.max())}; "
          f"lockstep on the same problem "
          f"{lock_ms:.1f} ms (median of 3); the member loop {loop_ms:.1f} ms a member (mean "
          f"of {len(secs)} single solves), {loop_ms * B_MAIN / 1e3:.0f} s for B={B_MAIN} "
          f"extrapolated; card {card_line}", flush=True)

    # ---- (b) TSIT45 on phase 17's logistic rates, B = 10,000
    rng = np.random.default_rng(SEED)
    r = 1.0 + 0.1 * rng.uniform(-1.0, 1.0, B_MAIN)
    r[0] = 1.0
    lp = torch.tensor(np.stack([r, np.ones(B_MAIN), np.full(B_MAIN, 0.1)], axis=1), device=dev)
    tl = [1.0, 5.0, 10.0]
    lproblem = logistic.problem()
    tsit = method("tsit45")
    lsol, l_ms = timed_solve(lambda: dtt.solve_dense_ensemble(tsit, lproblem, tl, lp,
                                                              mode="independent"))
    exact = np.stack([logistic.soln(tl, p) for p in lp.cpu().numpy()], axis=1)
    err = float(np.max(np.abs(lsol.ys.cpu().numpy() - exact) / (np.abs(exact) + 1e-3)))
    check = 200 * float(lproblem.rtol)
    if not bool((lsol.stop_reason == errors.TSTOP_REACHED).all()) or not err < check:
        raise AssertionError(f"(b): stops {lsol.stop_reason.unique().tolist()}, error {err}")
    lmembers = sorted(set([0, B_MAIN - 1] + np.random.default_rng(SEED + 28).choice(
        np.arange(1, B_MAIN - 1), B_IND_LOGISTIC_MEMBERS - 2, replace=False).tolist()))
    lworst, _ = member_stats_match("(b)", lsol, tsit, lproblem, tl, lp, lmembers)
    lst = lsol.state
    print(f"[27b] independent TSIT45 logistic, B={B_MAIN}: every member within {err:.2e} of "
          f"the exact solution (< {check:g}); members {lmembers} vs their single solves: "
          f"equal Stats, max abs {lworst:.3e}; {l_ms:.1f} ms (median of 3, CUDA events); "
          f"{lst.rounds} rounds, {lst.host_reads} host reads; steps min "
          f"{int(lst.stats.steps.min())} max {int(lst.stats.steps.max())}; card {card_line}",
          flush=True)

    # ---- (c) ESDIRK34 on heat1d banded, n = 128, B = 1,024
    n = HEAT_MGRID + 1
    d = np.linspace(0.5, 2.0, B_BAND)
    hp = torch.tensor(d[:, None], device=dev)
    hmembers = [0, B_BAND // 3, 2 * B_BAND // 3, B_BAND - 1]
    esdirk = method("esdirk34")
    hs, k3c, k4c, c_ms = counted(lambda: dtt.solve_dense_ensemble(esdirk, heat_problem, HEAT_T_EVAL,
                                                            hp, mode="independent"))
    if k3c < 1 or k4c < 1:
        raise AssertionError(f"(c): launched K3 {k3c} and K4 {k4c} times")
    if not bool((hs.stop_reason == errors.TSTOP_REACHED).all()):
        raise AssertionError(f"(c): stop reasons {hs.stop_reason.unique().tolist()}")
    series = np.stack([soln(HEAT_T_EVAL, dd) for dd in d], axis=1)
    err_c = float(np.abs(hs.ys.cpu().numpy() - series).max())
    if not err_c < ANALYTIC_TOL:
        raise AssertionError(f"(c): off the analytic series by {err_c}")
    cworst, _ = member_stats_match("(c)", hs, esdirk, heat_problem, HEAT_T_EVAL, hp, hmembers)
    hst = hs.state
    print(f"[27c] independent ESDIRK34 heat1d banded, B={B_BAND}, n={n}: {k3c} K3 launches "
          f"(the refreshed members' M - gamma h J), {k4c} K4 launches (every stage's Newton "
          f"sweeps and error filter, each member against its own factors), {hst.rounds} "
          f"rounds, {hst.host_reads} host reads, {hst.newton_sweeps} Newton sweeps; the "
          f"call {c_ms:.1f} ms (one, CUDA events); every member vs the analytic series "
          f"{err_c:.3e} (bound {ANALYTIC_TOL:g}); members {hmembers} vs their single solves: "
          f"equal Stats, max abs {cworst:.3e}; steps min {int(hst.stats.steps.min())} max "
          f"{int(hst.stats.steps.max())}; card {card_line}", flush=True)
    gamma = dtt.solver(heat_problem, "esdirk34").gamma
    band_c = heat_problem.linear_solver.assemble(
        None, hst.jac, (gamma * hst.h_at_last_jac).view(-1, 1, 1))
    fc_rec, sc_rec = path_lu_records(dev, card_line, "c", band_c, 1)
    fc_rec.update(name="band_lu_factor:independent_rk", launches=k3c)
    sc_rec.update(name="band_lu_solve:independent_rk", launches=k4c)

    # ---- (d) BdfSolver(sens=True) on heat1d banded, one row, B = 1,024
    bdf_sens = method("bdf", sens=True)
    hr, k3d, k4d, d_ms = counted(lambda: dtt.solve_dense_ensemble(bdf_sens, heat_problem,
                                                            HEAT_T_EVAL, hp,
                                                            mode="independent"))
    if k3d < 1 or k4d < 1:
        raise AssertionError(f"(d): launched K3 {k3d} and K4 {k4d} times")
    if not bool((hr.stop_reason == errors.TSTOP_REACHED).all()):
        raise AssertionError(f"(d): stop reasons {hr.stop_reason.unique().tolist()}")
    if tuple(hr.sens.shape) != (len(HEAT_T_EVAL), 1, B_BAND, n):
        raise AssertionError(f"(d): rows {tuple(hr.sens.shape)}")
    rmembers = [0, B_BAND // 2, B_BAND - 1]
    oracle_err = sens_oracle_check("(d)", hr.sens, heat_problem, hp, rmembers, HEAT_T_EVAL,
                                   SENS_ODE_TOL)
    dworst, _ = member_stats_match("(d)", hr, bdf_sens, heat_problem, HEAT_T_EVAL, hp,
                                   rmembers)
    rst = hr.state
    print(f"[27d] independent BdfSolver(sens=True) heat1d banded, B={B_BAND}, 1 row: {k3d} "
          f"K3 and {k4d} K4 launches (the rows' Newton solves are K4 launches of naug B = "
          f"{B_BAND} right-hand sides against the B members' factors), {rst.rounds} rounds, "
          f"{rst.host_reads} host reads, {rst.newton_sweeps} Newton sweeps (state and rows); "
          f"the call {d_ms:.1f} ms (one, CUDA events); steps min "
          f"{int(rst.stats.steps.min())} max {int(rst.stats.steps.max())}; members {rmembers} vs "
          f"solve_dense_fwd_sens {oracle_err:.2e} of their largest (< {SENS_ODE_TOL:g}) and "
          f"vs their single solves: equal Stats, max abs {dworst:.3e}; card {card_line}",
          flush=True)
    band_d = heat_problem.linear_solver.assemble(None, rst.jac, rst.c_last.view(-1, 1, 1))
    fd_rec, sd_rec = path_lu_records(dev, card_line, "d", band_d, 1)
    fd_rec.update(name="band_lu_factor:independent_sens", launches=k3d)
    sd_rec.update(name="band_lu_solve:independent_sens", launches=k4d)

    # ---- (e) the g100 x b100 cell on the block tier (bench.py:614-646)
    narrow = robertson.problem_ode_groups(100)
    if narrow.linear_solver.name != "blockdiag(3,100)":
        raise AssertionError(f"(e): ngroups=100 routed to {narrow.linear_solver.name}")
    pb = torch.tensor(np.tile(np.array(robertson.P_DEFAULT), (B_IND_G100, 1)), device=dev)
    g_sol, g_ms = timed_solve(lambda: dtt.solve_dense_ensemble(
        dtt.BdfSolver, narrow, te, pb, mode="independent", max_steps=5000), LONG_REPS)
    if not bool((g_sol.stop_reason == errors.TSTOP_REACHED).all()):
        raise AssertionError(f"(e): stop reasons {g_sol.stop_reason.unique().tolist()}")
    check_soln("(e) every group", g_sol.ys.reshape(len(te), B_IND_G100, 100, 3))
    gworst, _ = member_stats_match("(e)", g_sol, dtt.BdfSolver, narrow, te, pb,
                                   [0, B_IND_G100 - 1], max_steps=5000)
    gst = g_sol.state
    print(f"[27e] independent BdfSolver robertson_ode g100 x b100 (blockdiag(3,100), each "
          f"member's 100 blocks in one (S 100, 3, 3) LU of the refreshed members): "
          f"{g_ms:.1f} ms ({LONG_WHEN}, CUDA events), {gst.rounds} rounds, "
          f"{int(gst.stats.steps.max())} steps, {int(gst.stats.linear_solver_setups.max())} "
          f"factorizations a member; every group of every member meets the CVODE table to "
          f"t=4e6 (rtol 5e-3); members 0 and {B_IND_G100 - 1} vs their single solves: equal "
          f"Stats, max abs {gworst:.3e}; card {card_line}", flush=True)
    return [fc_rec, sc_rec, fd_rec, sd_rec]


# ---------------------------------------------------------------------------
# phase 28: the last two member loops of mode="independent" made batched.
# (a) the Krylov tier, each member its own GMRES (ops/krylov.py's
# gmres_batched), on phase 24 (a)'s coupling; (b) the heat2d DAE on the
# Krylov tier with the batched matrix-free consistent ICs; (c) the
# independent gradient (adjoint_independent.py: one batched forward, one
# batched backward) on the Robertson cell's members; (d) the same on heat1d
# banded, its forward pass through K3/K4.

B_KRY_IND, B_KRY_IND_WARM = 64, 4
B_KRY_DAE = 16
B_ADJ_IND, B_ADJ_IND_CUT, B_ADJ_IND_WARM = B_MAIN, 1024, 64
# (c) runs B = 1,024 where ten times a B = 1,024 call passes this
ADJ_IND_BUDGET_S = 45.0
IND_DRAWN = 2


def drawn_members(B, seed):
    """Members 0 and B - 1 and IND_DRAWN more drawn with ``seed``."""
    drawn = np.random.default_rng(seed).choice(np.arange(1, B - 1), IND_DRAWN, replace=False)
    return [0, B - 1] + sorted(int(b) for b in drawn)


def ind_close(name, got, ref):
    """``got`` within 1e-12 + 1e-9 |ref| of ``ref`` (NaN where ``ref`` is
    NaN); returns the largest absolute difference."""
    ok = ((got - ref).abs() <= IND_ATOL + IND_RTOL * ref.abs()) | (ref.isnan() & got.isnan())
    if not bool(ok.all()):
        raise AssertionError(f"{name}: {int((~ok).sum())} entries off, max abs "
                             f"{float((got - ref).abs().max()):.3e}")
    return float(torch.nan_to_num(got - ref).abs().max())


def krylov_members(name, sol, problem, te, params, members):
    """Each of ``members`` against its single Krylov solve on the card:
    equal whole Stats, GMRES restarts and Arnoldi iterations, ys within
    1e-12 + 1e-9 |ref|; returns (largest abs difference, the single solves'
    seconds each)."""
    import dataclasses

    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.ops import krylov

    st, worst, secs = sol.state, 0.0, []
    for b in members:
        krylov.reset_gmres_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = dtt.solve_dense(dtt.BdfSolver(problem), te, params=params[b], max_steps=5000)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        c = krylov.gmres_counts()
        got = (dataclasses.asdict(st.member_stats(b)), int(st.gmres_restarts[b]),
               int(st.gmres_arnoldi[b]))
        want = (dataclasses.asdict(one.state.stats), c["restarts"], c["arnoldi"])
        if got != want:
            raise AssertionError(f"{name}: member {b} Stats/restarts/Arnoldi {got}, its "
                                 f"single solve {want}")
        worst = max(worst, ind_close(f"{name} member {b}", sol.ys[:, b], one.ys))
    return worst, secs


def gradient_members(name, fn, params, members, make_one):
    """Each of ``members`` of the independent gradient ``fn`` (just called)
    against its single ``make_differentiable_solve`` on the card: equal
    forward and backward Stats and statuses, the gradient within 1e-12 +
    1e-9 |ref|; returns (largest abs difference, seconds each)."""
    import dataclasses

    def sum_sq(ys):
        return (ys**2).sum()

    info, (_, g) = fn.info, fn.last
    worst, secs = 0.0, []
    for b in members:
        one = make_one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, g1 = grad_call(one, params[b], sum_sq)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        for key in ("forward", "backward"):
            got = {f.name: int(getattr(info[key], f.name)[b])
                   for f in dataclasses.fields(info[key])}
            if got != dataclasses.asdict(one.info[key]):
                raise AssertionError(f"{name}: member {b} {key} Stats {got}, its single "
                                     f"solve's {one.info[key]}")
        if (int(info["status"][b]), int(info["backward_status"][b])) != (
                one.info["status"], one.info["backward_status"]):
            raise AssertionError(f"{name}: member {b} statuses differ from its single solve")
        worst = max(worst, ind_close(f"{name} member {b}", g[b], g1))
    return worst, secs


def ind_result(fn):
    """The last call of an independent gradient ``fn`` (:func:`ind_gradient`)
    on the host: ys, gradient, forward and backward Stats and statuses."""
    info = fn.info
    return _host(dict(ys=fn.last[0], grad=fn.last[1], forward=info["forward"],
                      backward=info["backward"], status=info["status"],
                      backward_status=info["backward_status"]))


def ind_gradient(problem, te, B, mesh=None, device=None):
    """The independent gradient of sum ys^2 over B members (sharded over
    ``mesh``'s "dp" when given); ``fn.last`` keeps the last (ys,
    gradient)."""
    import diffsol_tpu_torch as dtt

    fn = dtt.make_differentiable_solve_ensemble(problem, te, B, mode="independent",
                                                mesh=mesh, device=device)

    def sum_sq(ys):
        return (ys**2).sum()

    def call(params):
        fn.last = grad_call(fn, params, sum_sq)
        return fn.last

    fn.call = call
    return fn


def events_ms(fn):
    """``fn()`` between CUDA events: (its result, ms)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def independent_krylov_adjoint_phase(dev, card_line, heat_problem):
    """Phase 28; returns the K3/K4 records of path (d)."""
    import scipy.linalg

    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch import errors
    from diffsol_tpu_torch.models import heat2d, robertson
    from diffsol_tpu_torch.ops import band_lu, krylov
    from diffsol_tpu_torch.solvers.bdf_independent import IndependentState

    # ---- (a) the coupling -p y + C y at n = 962 through krylov(lu32)
    n = KRYLOV_N
    C = np.random.default_rng(KRYLOV_SEED).uniform(-0.01, 0.01, (n, n))
    c_on = {}

    def rhs(t, y, p):
        Cd = c_on.get(y.device)
        if Cd is None:
            Cd = c_on[y.device] = torch.tensor(C, device=y.device)
        return -p[0] * y + Cd @ y

    problem = (dtt.OdeBuilder().rhs(rhs)
               .init(lambda t, p: torch.ones(n, dtype=torch.float64, device=p.device))
               .p([1.0]).rtol(1e-6).atol(1e-8).linear_solver("krylov").build())
    te = KRYLOV_T_EVAL
    pk = torch.linspace(0.5, 2.0, B_KRY_IND, dtype=torch.float64, device=dev)[:, None]

    def run_kry(params, t_eval=te):
        return dtt.solve_dense_ensemble(dtt.BdfSolver, problem, t_eval, params,
                                        mode="independent", max_steps=5000)

    run_kry(pk[:B_KRY_IND_WARM])  # the warm-up
    krylov.reset_gmres_counts()
    sol, ms = events_ms(lambda: run_kry(pk))
    counts = krylov.gmres_counts()
    st = sol.state
    if sol.tier != "independent" or not isinstance(st, IndependentState):
        raise AssertionError(f"[28a] tier {sol.tier!r}, state {type(st).__name__}")
    if not bool((sol.stop_reason == errors.TSTOP_REACHED).all()):
        raise AssertionError(f"[28a] stop reasons {sol.stop_reason.unique().tolist()}")
    expm = np.stack([scipy.linalg.expm(C * t) @ np.ones(n) for t in te])  # (neval, n)
    decay = np.exp(-pk[:, 0].cpu().numpy()[None, :] * np.asarray(te)[:, None])
    exact = decay[..., None] * expm[:, None, :]
    got = sol.ys.cpu().numpy()
    err = float(np.max(np.abs(got - exact) / (KRYLOV_EXPM_ATOL + KRYLOV_EXPM_RTOL * np.abs(exact))))
    if not err <= 1.0:
        raise AssertionError(f"[28a] a member {err:.3g} bounds from e^(-p t) expm(C t) y0")
    members = drawn_members(B_KRY_IND, SEED + 28)
    worst, secs = krylov_members("[28a]", sol, problem, te, pk, members)
    steps = st.stats.steps
    print(f"[28a] independent krylov(lu32), coupling n={n}, B={B_KRY_IND} (p linspace(0.5, 2)) "
          f"to t=1: every member within {err:.3f} of the e^(-p t) expm(C t) y0 bound (rtol "
          f"{KRYLOV_EXPM_RTOL:g}, atol {KRYLOV_EXPM_ATOL:g}); members {members} against their "
          f"single solves on the card: equal Stats, restarts and Arnoldi iterations, max abs "
          f"{worst:.3e}; {ms:.1f} ms (one call after a B={B_KRY_IND_WARM} warm-up, CUDA events); "
          f"{st.rounds} rounds, {st.host_reads} loop host reads + {counts['host_reads']} GMRES "
          f"host reads ({counts['calls']} GMRES calls), restarts {int(st.gmres_restarts.sum())}"
          f" and Arnoldi iterations {int(st.gmres_arnoldi.sum())} over the members (gmres_counts "
          f"{counts['restarts']} / {counts['arnoldi']}); steps min {int(steps.min())} max "
          f"{int(steps.max())}; the member loop {np.mean(secs) * 1e3:.1f} ms a member "
          f"(mean of {len(secs)} single solves), {np.mean(secs) * B_KRY_IND:.1f} s for "
          f"B={B_KRY_IND}; card {card_line}", flush=True)

    # ---- (b) heat2d DAE on the Krylov tier, the batched matrix-free ICs
    kry = krylov_heat2d()
    band = heat2d.make(KRYLOV_MGRID)
    ph = torch.linspace(0.5, 2.0, B_KRY_DAE, dtype=torch.float64, device=dev)[:, None]
    te2 = KRYLOV_HEAT2D_T_EVAL[:1]  # to the first output, for the script's budget
    krylov.reset_gmres_counts()
    ks, k_ms = events_ms(lambda: dtt.solve_dense_ensemble(
        dtt.BdfSolver, kry, te2, ph, mode="independent", max_steps=5000))
    kc = krylov.gmres_counts()
    bs, b_ms = events_ms(lambda: dtt.solve_dense_ensemble(
        dtt.BdfSolver, band, te2, ph, mode="independent", max_steps=5000))
    if not bool((ks.stop_reason >= 0).all()) or not bool((bs.stop_reason >= 0).all()):
        raise AssertionError(f"[28b] stops {ks.stop_reason.tolist()} / {bs.stop_reason.tolist()}")
    got, ref = ks.ys.cpu().numpy(), bs.ys.cpu().numpy()
    err_b = float(np.max(np.abs(got - ref) / (KRYLOV_BAND_ATOL + KRYLOV_BAND_RTOL * np.abs(ref))))
    if not err_b <= 1.0:
        raise AssertionError(f"[28b] krylov against banded: {err_b:.3g} bounds")
    worst_b, secs_b = krylov_members("[28b]", ks, kry, te2, ph, [0])
    print(f"[28b] independent heat2d DAE n={KRYLOV_MGRID ** 2}, B={B_KRY_DAE}: "
          f"krylov(lu32) {k_ms:.1f} ms ({ks.state.rounds} rounds, {kc['calls']} GMRES calls, the consistent "
          f"ICs' among them, restarts {int(ks.state.gmres_restarts.sum())}, Arnoldi "
          f"{int(ks.state.gmres_arnoldi.sum())}), the banded independent solve {b_ms:.1f} ms "
          f"(one call each, CUDA events, the first at its shapes); every member within "
          f"{err_b:.3f} of the bound (rtol {KRYLOV_BAND_RTOL:g}, atol {KRYLOV_BAND_ATOL:g}); "
          f"member 0 against its single Krylov solve: equal Stats and GMRES counts, max abs "
          f"{worst_b:.3e}, the single solve {secs_b[0]:.2f} s; card {card_line}", flush=True)

    # ---- (c) the independent gradient on the Robertson cell's members
    def sum_sq(ys):
        return (ys**2).sum()

    problem = robertson.problem_ode()
    te6 = robertson.T_EVAL_4E10[:8]
    params = robertson_params(B_ADJ_IND, np.random.default_rng(SEED), dev)
    # the warm-up runs the outputs to t = 0.4 (every code path, a fifth of
    # the rounds)
    ind_gradient(problem, te6[:1], B_ADJ_IND_WARM).call(params[:B_ADJ_IND_WARM])
    fn = ind_gradient(problem, te6, B_ADJ_IND_CUT)
    _, cut_ms = events_ms(lambda: fn.call(params[:B_ADJ_IND_CUT]))
    B = B_ADJ_IND_CUT
    if 10 * cut_ms / 1e3 > ADJ_IND_BUDGET_S:
        print(f"[28c] cut: B = {B_ADJ_IND_CUT}, not {B_ADJ_IND} (the B = {B_ADJ_IND_CUT} call "
              f"took {cut_ms:.0f} ms; ten times that passes {ADJ_IND_BUDGET_S:g} s)", flush=True)
        fb_ms = cut_ms
    else:
        B = B_ADJ_IND
        fn = ind_gradient(problem, te6, B)
        _, fb_ms = events_ms(lambda: fn.call(params))
    pc = params[:B]
    ys, g = fn.last
    info = fn.info
    if tuple(g.shape) != (B, 3) or g.device.type != dev.type:
        raise AssertionError(f"[28c] gradient {tuple(g.shape)} on {g.device}")
    # a member whose backward solve spends the 50 Newton failures is NaN
    # alone (at 4e6 the cell's members end near the limit, phase 22)
    bad = info["backward_status"] < 0
    finite = torch.isfinite(g).all(-1)
    if not bool((bad == ~finite).all()) or not bool((info["status"] >= 0).all()):
        raise AssertionError("[28c] NaN gradients and failed backward solves disagree")
    failed = int(bad.sum())
    # the drawn members and the first and last failed ones: a failed
    # member must be its single solve's failure, with its Stats
    fails = torch.nonzero(bad).squeeze(1).tolist()
    failed_held = sorted({fails[0], fails[-1]}) if fails else []
    members = drawn_members(B, SEED + 280)
    members += [b for b in failed_held if b not in members]
    worst_c, secs_c = gradient_members(
        "[28c]", fn, pc, members,
        lambda: dtt.make_differentiable_solve(problem, te6))
    oracle = robertson.problem_ode(rtol=SENS_ORACLE_RTOL, atol=SENS_ORACLE_ATOL)
    m0 = int(torch.nonzero(finite)[0])  # member 0 unless its backward solve failed
    o_ys, o_sens = dtt.solve_dense_fwd_sens(dtt.BdfSolver(oracle), te6, params=pc[m0],
                                            max_steps=20_000)
    ref0 = 2.0 * torch.einsum("tn,ptn->p", o_ys, o_sens)
    err0 = float(member_rel(g[m0:m0 + 1], ref0[None])[0])
    if not err0 < ADJ_ORACLE_TOL:
        raise AssertionError(f"[28c] member {m0} off its forward sensitivities by {err0:.3e}")
    fs, bk = info["forward"].steps.float(), info["backward"].steps.float()
    print(f"[28c] independent gradient, Robertson B={B} to t=4e6, loss sum ys^2: forward "
          f"+ backward {fb_ms:.1f} ms (one call after a B={B_ADJ_IND_WARM} warm-up, CUDA "
          f"events); forward steps min/median/max "
          f"{int(fs.min())}/{int(fs.median())}/{int(fs.max())}, backward "
          f"{int(bk.min())}/{int(bk.median())}/{int(bk.max())}, backward Newton failures max "
          f"{int(info['backward'].newton_fails.max())} (the limit 50), failed members "
          f"{failed} (NaN, TOO_MANY_NONLINEAR_SOLVER_FAILURES each); "
          f"{info['backward_rounds']} backward rounds, "
          f"{info['backward_host_reads']} backward host reads; table "
          f"{info['table_bytes'] / 2**20:.1f} MiB; members {members} against their single "
          f"make_differentiable_solve on the card: equal forward and backward Stats, max abs "
          f"{worst_c:.3e} (failed members {failed_held} among them: NaN and the same "
          f"statuses as their single solves); member {m0} within {err0:.2e} of 2 sum y.s "
          f"(< {ADJ_ORACLE_TOL:g}); "
          f"the member loop {np.mean(secs_c):.2f} s a member ({np.mean(secs_c) * B / 3600:.2f} "
          f"h for B={B}); card {card_line}", flush=True)

    # ---- (d) heat1d banded, B = 1,024: the forward pass through K3/K4
    nh = HEAT_MGRID + 1
    hp = torch.tensor(np.linspace(0.5, 2.0, B_BAND)[:, None], device=dev)
    heat = ind_gradient(heat_problem, HEAT_T_EVAL, B_BAND)

    def forward_h():
        with torch.no_grad():
            return heat(hp)

    _, k3, k4, hfwd_ms = counted(forward_h)  # the first call at its shapes
    if k3 < 1 or k4 < 1:
        raise AssertionError(f"[28d] the forward pass launched K3 {k3} and K4 {k4} times")
    (_, hg), k3b, k4b, hfb_ms = counted(lambda: heat.call(hp))
    if (k3b, k4b) != (k3, k4):
        raise AssertionError(f"[28d] K3/K4 launches: forward {k3}/{k4}, forward + backward "
                             f"{k3b}/{k4b} (the dense-table backward launches none)")
    if not bool(torch.isfinite(hg).all()):
        raise AssertionError("[28d] a gradient is not finite")
    # phase 30 (i)'s reference: the same members, sharded there
    PHASE_REFS["28d"] = ind_result(heat)
    worst_d, secs_d = gradient_members(
        "[28d]", heat, hp, [0, B_BAND - 1],
        lambda: dtt.make_differentiable_solve(heat_problem, HEAT_T_EVAL))
    hst = dtt.solve_dense_ensemble(dtt.BdfSolver, heat_problem, HEAT_T_EVAL, hp,
                                   mode="independent").state
    print(f"[28d] independent gradient, heat1d banded n={nh}, B={B_BAND}: forward {k3} K3 and "
          f"{k4} K4 launches (0 in the backward), forward alone {hfwd_ms:.1f} ms, forward + "
          f"backward {hfb_ms:.1f} ms (CUDA events, one call each, the forward's the first); backward "
          f"steps max {int(heat.info['backward'].steps.max())}; members [0, {B_BAND - 1}] "
          f"against their single gradients: equal Stats, max abs {worst_d:.3e}, "
          f"{np.mean(secs_d):.2f} s each; card {card_line}", flush=True)
    # the forward pass is this independent solve: its members' last M - c J
    band_h = heat_problem.linear_solver.assemble(None, hst.jac, hst.c_last.view(-1, 1, 1))
    PHASE_REFS["28d_band"] = band_h
    f_rec, s_rec = path_lu_records(dev, card_line, "d", band_h, 1, phase=28)
    return [dict(f_rec, name="band_lu_factor:independent_adjoint", launches=k3),
            dict(s_rec, name="band_lu_solve:independent_adjoint", launches=k4)]



# ---- phase 29: the examples on the card
# the fitting examples' loops cut to one iteration (the full counts run in
# scripts/torch_examples_card.py; each fit's losses end with its fitted
# parameters' loss, so one iteration shows a fall): predator_prey_fitting's
# Gauss-Newton loop (4 forward-mode solves, ~14 s an iteration on the H100),
# mass_spring_fitting_adjoint's descent (~6 s), diffsl_logistic_fit's (~4.7
# s), neural_ode's and mass_spring_fitting_ensemble's (~1 s)
EXAMPLE_CUTS = {name: {"iterations": 1} for name in (
    "predator_prey_fitting", "mass_spring_fitting_adjoint", "neural_ode",
    "diffsl_logistic_fit", "mass_spring_fitting_ensemble")}
# the adjoint examples' first gradient on the card against the same
# example's on the CPU (one iteration there)
EXAMPLE_GRADIENTS = ("mass_spring_fitting_adjoint", "neural_ode", "diffsl_logistic_fit",
                     "mass_spring_fitting_ensemble")
EXAMPLE_GRAD_RTOL = 1e-8


def example_fused_gate(name, sol_ys, lock_ys):
    """The fused result of a kernel example's first tile against the card's
    lockstep solve of the same members at §2's gate (MODES_ATOL + MODES_RTOL
    |ref|); returns the largest absolute difference."""
    diff = (sol_ys - lock_ys).abs()
    if not bool(torch.isfinite(sol_ys).all()) or bool(
            (diff > MODES_ATOL + MODES_RTOL * lock_ys.abs()).any()):
        raise AssertionError(f"{name}: fused and lockstep disagree: max abs "
                             f"{float(diff.max())}")
    return float(diff.max())


def example_robertson(dev, card_line, out, launches):
    """robertson_ensemble's K1 record: its first tile against lockstep, the
    kernel against its plain version on the example's members, times and
    the bound."""
    from diffsol_tpu_torch import BdfSolver, solve_dense_ensemble
    from diffsol_tpu_torch.examples import robertson_ensemble as ex
    from diffsol_tpu_torch.models import robertson
    from diffsol_tpu_torch.ops import fused_stepper as fs
    from diffsol_tpu_torch.ops.eqn_codegen import op_count, trace_model

    problem = robertson.problem_ode()
    B = out["nbatch"]
    params = ex.make_params(B).to(dev)
    fsolve = fs.make_fused_bdf_solve(problem, ex.T_EVAL, B, max_steps=5000)
    tile = fsolve.tile
    lock = solve_dense_ensemble(BdfSolver, problem, ex.T_EVAL, params[:tile],
                                mode="lockstep", device=dev)
    gate = example_fused_gate("robertson_ensemble", out["ys"][:, :tile], lock.ys)
    (ys_p, st_p, steps_p), plain_ms = events_ms(lambda: fsolve.reference(params))
    if int(st_p.min()) != fs.OK:
        raise AssertionError(f"robertson_ensemble: plain version status {st_p.tolist()}")
    err, share = check_close("robertson_ensemble", out["ys"].movedim(1, -1), ys_p,
                             out["tile_steps"], steps_p)

    def path():
        return solve_dense_ensemble(BdfSolver, problem, ex.T_EVAL, params, mode="auto",
                                    max_steps=5000, device=dev)

    ms = time_ms(path, 3)
    n = 3
    rhs_ops = op_count(trace_model(problem.eqn.rhs, None, n, 3).rhs)
    steps = out["tile_steps"].cpu().numpy()
    ops = B * float(np.mean(steps)) * bdf_step_ops(n, rhs_ops, 2 * n * n)
    bound_ms, bound_by = bound(8 * (params.numel() + out["ys"].numel() + len(ex.T_EVAL)), ops)
    print(f"[29] robertson_ensemble: B={B}, tier {out['tier']}, K1 launches {launches}, "
          f"first tile ({tile} members) vs lockstep max abs {gate:.3e}; kernel vs plain max "
          f"abs {err:.3e} ({share:.3e} of the bound, equal steps per tile); {ms:.3f} ms "
          f"median of 3, plain {plain_ms:.1f} ms (one run), least {bound_ms:.4f} ms by "
          f"{bound_by}; card {card_line}", flush=True)
    return k1_record("example_robertson", launches=launches, max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def example_heat1d(dev, card_line, out, launches):
    """heat1d_band_ensemble's K2 record, by the rule of example_robertson."""
    from diffsol_tpu_torch import BdfSolver, solve_dense_ensemble
    from diffsol_tpu_torch.examples import heat1d_band_ensemble as ex
    from diffsol_tpu_torch.ops import fused_band_stepper as fb
    from diffsol_tpu_torch.ops import fused_stepper as fs
    from diffsol_tpu_torch.ops.eqn_codegen import op_count, trace_model

    problem = ex.make_problem()
    B = out["nbatch"]
    params = torch.tensor(np.linspace(0.5, 2.0, B)[:, None], dtype=torch.float64, device=dev)
    fsolve = fb.make_fused_band_bdf_solve(problem, ex.T_EVAL, B)
    tile = fsolve.tile
    lock = solve_dense_ensemble(BdfSolver, problem, ex.T_EVAL, params[:tile],
                                mode="lockstep", device=dev)
    gate = example_fused_gate("heat1d_band_ensemble", out["ys"][:, :tile], lock.ys)
    (ys_p, st_p, steps_p), plain_ms = events_ms(lambda: fsolve.reference(params))
    if int(st_p.min()) != fs.OK:
        raise AssertionError(f"heat1d_band_ensemble: plain version status {st_p.tolist()}")
    err, share = check_close("heat1d_band_ensemble", out["ys"].movedim(1, -1), ys_p,
                             out["tile_steps"], steps_p)
    ms = time_ms(lambda: solve_dense_ensemble(BdfSolver, problem, ex.T_EVAL, params,
                                              mode="auto", device=dev), 3)
    rhs_ops = op_count(trace_model(problem.eqn.rhs, None, ex.N, 1).rhs)
    bound_ms, bound_by, _ = k2_bound(ex.N, 1, 1, rhs_ops, B, out["tile_steps"].cpu().numpy(),
                                     B, out["ys"].numel())
    print(f"[29] heat1d_band_ensemble: B={B}, n={ex.N}, tier {out['tier']}, K2 launches "
          f"{launches}, first tile ({tile} members) vs lockstep max abs {gate:.3e}; kernel vs "
          f"plain max abs {err:.3e} ({share:.3e} of the bound, equal steps per tile); "
          f"{ms:.3f} ms median of 3, plain {plain_ms:.1f} ms (one run), least "
          f"{bound_ms:.4f} ms by {bound_by}; card {card_line}", flush=True)
    return k2_record("fused_band_bdf:example_heat1d", launches=launches, max_abs_err=err,
                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def example_pde_heat(dev, card_line, out):
    """pde_heat's K3/K4 records: the kernels against their plain versions
    on its M - cJ (n = 51, c = 1e-3, one member), launches from its run."""
    from diffsol_tpu_torch.examples import pde_heat as ex

    problem, _ = ex.make_problem()
    n = problem.eqn.nstates
    jac = torch.func.vmap(problem.to(dev).eqn.jac, in_dims=(None, 0, 0))(
        torch.tensor(0.0, dtype=torch.float64, device=dev),
        torch.zeros(1, n, dtype=torch.float64, device=dev), problem.params.to(dev)[None])
    band = problem.linear_solver.assemble(None, jac, 1e-3)
    f_rec, s_rec = path_lu_records(dev, card_line, "example_pde_heat", band, 1, phase=29)
    f_rec["name"] += ":example_pde_heat"
    s_rec["name"] += ":example_pde_heat"
    f_rec["launches"] = out["band_lu_factor_launches"]
    s_rec["launches"] = out["band_lu_solve_launches"]
    return [f_rec, s_rec]


KERNEL_EXAMPLES = {"robertson_ensemble", "heat1d_band_ensemble", "pde_heat"}


def examples_phase(dev, card_line, after_records=None):
    """Phase 29; returns the kernel examples' records.  ``after_records``
    is called once the kernel examples' records are taken (the examples
    after them run no kernel of the port's)."""
    import importlib

    from diffsol_tpu_torch import examples
    from diffsol_tpu_torch.ops import band_lu
    from diffsol_tpu_torch.ops import fused_band_stepper as fb
    from diffsol_tpu_torch.ops import fused_stepper as fs

    records, seconds = [], {}
    for name in examples.NAMES:
        mod = importlib.import_module(f"diffsol_tpu_torch.examples.{name}")
        cut = EXAMPLE_CUTS.get(name, {})
        if cut:
            print(f"[29] {name}: cut to {cut['iterations']} of its {mod.ITERATIONS} iterations "
                  f"(all of them run in scripts/torch_examples_card.py)", flush=True)
        fs.launch_fused_bdf.launches = 0
        fb.launch_fused_band_bdf.launches = 0
        band_lu.launch_band_lu_factor.launches = 0
        band_lu.launch_band_lu_solve.launches = 0
        t0 = time.perf_counter()
        out = mod.main(device=dev, **cut)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        k1, k2 = fs.launch_fused_bdf.launches, fb.launch_fused_band_bdf.launches
        print(f"[29] {name}: {seconds[name]:.1f} s (host clock); K1 {k1}, K2 {k2}, K3 "
              f"{band_lu.launch_band_lu_factor.launches}, K4 "
              f"{band_lu.launch_band_lu_solve.launches} launches", flush=True)
        if name == "robertson_ensemble":
            if out["tier"] != "fused_small" or k1 < 1:
                raise AssertionError(f"robertson_ensemble: tier {out['tier']!r}, K1 {k1}")
            records.append(example_robertson(dev, card_line, out, k1))
        elif name == "heat1d_band_ensemble":
            if out["tier"] != "fused_band" or k2 < 1:
                raise AssertionError(f"heat1d_band_ensemble: tier {out['tier']!r}, K2 {k2}")
            records.append(example_heat1d(dev, card_line, out, k2))
        elif name == "pde_heat":
            if out["band_lu_factor_launches"] < 1 or out["band_lu_solve_launches"] < 1:
                raise AssertionError(f"pde_heat: band LU launches {out}")
            records += example_pde_heat(dev, card_line, out)
        if after_records is not None and KERNEL_EXAMPLES <= seconds.keys():
            after_records()
            after_records = None
        losses = out.get("losses", out.get("residuals"))
        if cut:
            if not losses[-1] < losses[0]:
                raise AssertionError(f"{name}: the loss did not fall: {losses}")
            print(f"[29] {name}: loss {losses[0]:.6e} -> {losses[-1]:.6e}", flush=True)
        if name in EXAMPLE_GRADIENTS:
            g = torch.as_tensor(out["first_grad"], dtype=torch.float64).cpu()
            gc = torch.as_tensor(mod.main(device="cpu", iterations=1)["first_grad"],
                                 dtype=torch.float64)
            rel = float((g - gc).abs().max() / gc.abs().max())
            if not rel <= EXAMPLE_GRAD_RTOL:
                raise AssertionError(f"{name}: the first gradient on the card is {rel:.3e} "
                                     f"(relative) from the CPU's")
            print(f"[29] {name}: first gradient, card vs CPU, {rel:.3e} relative to its "
                  f"largest entry (bound {EXAMPLE_GRAD_RTOL:g})", flush=True)
    print(f"[29] examples (host clock, s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; {sum(seconds.values()):.1f} s in all; card {card_line}", flush=True)
    return records


def fc_ball_height(t, g, e=0.8, h0=10.0):
    """The ball's height up to its second bounce (models/fused_cases.py)."""
    from diffsol_tpu_torch.models import fused_cases

    return fused_cases.ball_height(t, g=g, e=e, h0=h0)


# ---- phase 30: the ensemble sharded over a DeviceMesh (sharding.py)
# two ranks of a gloo mesh on the one card (NCCL refuses two ranks on one
# GPU), then a 1-rank NCCL mesh; the ranks share the card, so nothing here
# measures scaling across cards
B_SHARD = 1024
SHARD_TIMEOUT_S = 420
SHARD_GRAD_RTOL = 1e-10
# (g): the Krylov tier's sums over the mesh reorder the unsharded ones
SHARD_KRYLOV_RTOL = 1e-10
# (d), (e): Robertson's independent batch and lockstep gradient to t = 4e4
# (the script's budget)
SHARD_ROB_T_EVAL = [4.0 * 10.0**k for k in range(-1, 5)]
# (h): heat1d n = 2^20 states a member, sharded over "sp"
ERK_SHARD_MGRID = 2**20 - 1
ERK_SHARD_D = [[1.0], [0.5]]
ERK_SHARD_STEPS = 5
# (g): phase 24 b's Krylov lockstep (B = 256) cut to its first output for
# the script's budget; its unsharded reference is computed here
SHARD_KRYLOV_T_EVAL = KRYLOV_HEAT2D_T_EVAL[:1]
# (j): BdfSolver, then TR-BDF2, on the same 2^20 states a member (banded,
# ml = mu = 1), each held to the unsharded steps; the steps of each solver,
# the leading principal sub-band (columns) on which K3 and K4 meet their
# plain versions (a Python loop over the columns), and the full-n solve's
# residual bound
IMPLICIT_SHARD_STEPS = {"bdf": 6, "sdirk": 3}
SUB_BAND = 2**14
RESIDUAL_RTOL = 1e-10
# (k): the heat2d DAE (n = 400, nb = 41) and heat1d n = 128 with a root, a
# reset, out() and its quadrature, over the same (dp = 1, sp = 2) mesh
DAE_SHARD_T_EVAL = [0.01, 0.03]
EVENT_SHARD_T_EVAL = [0.02, 0.06, 0.1, 0.15]
# results of earlier phases that phase 30 shards (phase 28 d's gradient
# and its last M - cJ); a phase run alone computes its own
PHASE_REFS = {}


def shard_cells(dev):
    """Phase 30's cells, name -> run(mesh): with a mesh the call sharded on
    its "dp" axis, with None the unsharded call on ``dev``; and the cells'
    global inputs."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import heat1d, robertson

    rob = robertson.problem_ode()
    heat, _ = heat1d.make(HEAT_MGRID, rtol=1e-6, atol=1e-8, banded=True)
    te6 = SHARD_ROB_T_EVAL
    inputs = dict(
        rob=robertson_params(B_MAIN, np.random.default_rng(SEED + 30), dev),
        heat=torch.linspace(0.5, 2.0, B_BAND, dtype=torch.float64, device=dev)[:, None],
        ind=robertson_params(B_SHARD, np.random.default_rng(SEED + 31), dev),
        # phase 24 b's members and phase 28 d's
        kry=torch.ones((B_KRYLOV_CUT, 1), dtype=torch.float64, device=dev),
        heat_grad=torch.tensor(np.linspace(0.5, 2.0, B_BAND)[:, None], device=dev))

    def ens(problem, te, key, mode, **kw):
        def run(mesh):
            return dtt.solve_dense_ensemble(dtt.BdfSolver, problem, te, inputs[key], mode=mode,
                                            mesh=mesh, device=None if mesh else dev, **kw)
        return run

    def grad(mesh):
        fn = dtt.make_differentiable_solve_ensemble(rob, te6, B_SHARD, mesh=mesh,
                                                    device=None if mesh else dev)
        pb = inputs["ind"].clone().requires_grad_(True)
        ys = fn(pb)
        (ys ** 2).sum().backward()
        return dict(ys=ys.detach(), grad=pb.grad, forward=fn.info["forward"],
                    backward=fn.info["backward"], backward_status=fn.info["backward_status"])

    kry = krylov_heat2d()

    def krylov_lockstep(mesh):
        # phase 24 b's call to its first output: make_lockstep_problem +
        # solve_dense, max_steps 5000
        from diffsol_tpu_torch.ops import krylov

        krylov.reset_gmres_counts()
        sol = ens(kry, SHARD_KRYLOV_T_EVAL, "kry", "lockstep", max_steps=5000)(mesh)
        return dict(sol=sol, gmres=krylov.gmres_counts())

    def ind_grad(mesh):
        # phase 28 d's call
        fn = ind_gradient(heat, HEAT_T_EVAL, B_BAND, mesh=mesh, device=None if mesh else dev)
        fn.call(inputs["heat_grad"])
        return ind_result(fn)

    return {
        "robertson_fused": ens(rob, robertson.T_EVAL_4E10, "rob", "fused"),
        "heat1d_fused": ens(heat, HEAT_T_EVAL, "heat", "fused"),
        "heat2d_lockstep": ens(mol2d_problem("heat2d"), MOL2D["heat2d"][1], "heat",
                               "lockstep", max_steps=MOL2D["heat2d"][2]),
        "robertson_independent": ens(rob, te6, "ind", "independent"),
        "robertson_grad": grad,
        "heat2d_krylov_lockstep": krylov_lockstep,
        "heat1d_ind_grad": ind_grad,
    }, inputs


def _host(res):
    """A cell's result on the host: a Solution as its ys, stop, tile steps
    and Stats, a Stats as its fields."""
    import dataclasses

    from diffsol_tpu_torch.drivers import Solution

    if isinstance(res, Solution):
        return dict(ys=res.ys.cpu(), stop=_host(res.stop_reason), tier=res.tier,
                    tile_steps=_host(res.tile_steps),
                    stats=None if res.state is None else _host(res.state.stats))
    if isinstance(res, dict):
        return {k: _host(v) for k, v in res.items()}
    if isinstance(res, torch.Tensor):
        return res.detach().cpu()
    if dataclasses.is_dataclass(res) and not isinstance(res, type):
        return {f.name: _host(getattr(res, f.name)) for f in dataclasses.fields(res)}
    return res


def erk_state_cell(mesh, dev):
    """(h): heat1d lockstep ERK, n = 2^20 states a member, B = 2, with
    every member's states sharded over ``mesh``'s "sp" and the members over
    its "dp" (None: unsharded on ``dev``); ERK_SHARD_STEPS steps from
    init_state.  The final state and the steps' ms from a barrier of all
    ranks (CUDA events)."""
    from diffsol_tpu_torch.drivers import init_state
    from diffsol_tpu_torch.ensemble import make_lockstep_problem
    from diffsol_tpu_torch.models import heat1d
    from diffsol_tpu_torch.sharding import MemberAxis, StateAxis
    from diffsol_tpu_torch.solvers.erk import ErkSolver

    problem = heat1d.make(ERK_SHARD_MGRID)[0].to(dev)  # the solver steps on dev
    params = torch.tensor(ERK_SHARD_D, dtype=torch.float64, device=dev)
    maxis = saxis = None
    if mesh is not None:
        maxis = MemberAxis.of(mesh, "dp", len(ERK_SHARD_D))
        saxis = StateAxis.of(mesh, "sp", problem.eqn.nstates)
        params = maxis.split(params)
    solver = ErkSolver(make_lockstep_problem(problem, params.shape[0], axis=maxis,
                                             state_axis=saxis))
    state = init_state(solver, params, device=dev)
    if mesh is not None:
        barrier()

    def steps():
        st = state
        for _ in range(ERK_SHARD_STEPS):
            st = solver.step(st, params)
        return st

    with counted_all_gathers() as calls:
        state, ms = events_ms(steps)
    return dict(state=state, ms=ms, offset=0 if saxis is None else saxis.offset,
                all_gathers=calls[0])


def erk_state_rank(device_type, world, dev):
    """(h) in one rank: the cell over a (dp = 1, sp = ``world``) mesh of the
    ranks, its final state's block and numbers on the host."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh_sp = init_device_mesh(device_type, (1, world), mesh_dim_names=("dp", "sp"))
    cell = erk_state_cell(mesh_sp, dev)
    st = cell["state"]
    return dict(y=st.y.cpu(), dy=st.dy.cpu(), t=st.t, h=st.h, stats=_host(st.stats),
                ms=cell["ms"], offset=cell["offset"], all_gathers=cell["all_gathers"])


def check_erk_state(label, ranks, ref_st):
    """Every rank's block of y and dy, its t, h and Stats equal bit for bit
    to the unsharded state ``ref_st``'s."""
    y_ref, dy_ref = ref_st.y.cpu(), ref_st.dy.cpu()
    for r, got in enumerate(ranks):
        lo, k = got["offset"], got["y"].shape[-1]
        if not (torch.equal(got["y"], y_ref[:, lo:lo + k])
                and torch.equal(got["dy"], dy_ref[:, lo:lo + k])):
            raise AssertionError(f"{label} rank {r}: its block of y or dy differs from the "
                                 f"unsharded steps")
        if (got["t"], got["h"]) != (ref_st.t, ref_st.h):
            raise AssertionError(f"{label} rank {r}: t, h {got['t']}, {got['h']} against "
                                 f"{ref_st.t}, {ref_st.h}")
        same_stats(f"{label} rank {r}", got["stats"], _host(ref_st.stats))
    if ref_st.stats.steps != ERK_SHARD_STEPS or not bool(torch.isfinite(y_ref).all()):
        raise AssertionError(f"{label}: {ref_st.stats.steps} steps, or non-finite y")


def state_sharded(problem, params, mesh, dev):
    """``problem`` on ``dev`` lifted to lockstep over the (B, np)
    ``params`` with its members over ``mesh``'s "dp" and every member's
    states over its "sp" (None: unsharded): (lockstep problem, the rank's
    params, the state axis or None)."""
    from diffsol_tpu_torch.ensemble import make_lockstep_problem
    from diffsol_tpu_torch.sharding import MemberAxis, StateAxis

    problem = problem.to(dev)  # the solver steps on dev
    maxis = saxis = None
    if mesh is not None:
        maxis = MemberAxis.of(mesh, "dp", params.shape[0])
        saxis = StateAxis.of(mesh, "sp", problem.eqn.nstates)
        params = maxis.split(params)
    return (make_lockstep_problem(problem, params.shape[0], axis=maxis, state_axis=saxis),
            params, saxis)


def implicit_state_cell(mesh, dev):
    """(j): heat1d banded (ml = mu = 1), n = 2^20 states a member, B = 2,
    every member's states sharded over ``mesh``'s "sp" (None: unsharded on
    ``dev``): IMPLICIT_SHARD_STEPS BdfSolver steps from init_state, then
    TR-BDF2's.  For each solver its final state, its ms (CUDA events from a
    barrier of all ranks, init_state included), its K3/K4 launches and
    all-gathers."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.drivers import init_state
    from diffsol_tpu_torch.models import heat1d

    problem = heat1d.make(ERK_SHARD_MGRID, rtol=1e-6, atol=1e-8, banded=True)[0]
    params = torch.tensor(ERK_SHARD_D, dtype=torch.float64, device=dev)
    lp, params, saxis = state_sharded(problem, params, mesh, dev)
    out = dict(offset=0 if saxis is None else saxis.offset)
    for name, cls in (("bdf", dtt.BdfSolver), ("sdirk", dtt.SdirkSolver)):
        solver = cls(lp)

        def run():
            st = init_state(solver, params, device=dev)
            for _ in range(IMPLICIT_SHARD_STEPS[name]):
                st = solver.step(st, params)
            return st

        for w in kernel_wrappers():
            w.launches = 0
        if mesh is not None:
            barrier()
        with counted_all_gathers() as calls:
            state, ms = events_ms(run)
        out[name] = dict(state=state, ms=ms, all_gathers=calls[0],
                         launches=[w.launches for w in kernel_wrappers()[2:]])
    return out


def implicit_state_rank(device_type, world, dev):
    """(j) in one rank over a (dp = 1, sp = ``world``) mesh: each solver's
    blocks (y, dy, and BDF's D or TR-BDF2's stage values), its scalars,
    Stats and counts on the host, and BDF's last Jacobian and c, whole."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh_sp = init_device_mesh(device_type, (1, world), mesh_dim_names=("dp", "sp"))
    cell = implicit_state_cell(mesh_sp, dev)
    out = dict(offset=cell["offset"])
    for name in ("bdf", "sdirk"):
        c, st = cell[name], cell[name]["state"]
        out[name] = dict(y=st.y.cpu(), dy=st.dy.cpu(), t=st.t, h=st.h, stats=_host(st.stats),
                         diffs=(st.D if name == "bdf" else st.diff).cpu(),
                         order=getattr(st, "order", None), ms=c["ms"],
                         all_gathers=c["all_gathers"], launches=c["launches"])
    st = cell["bdf"]["state"]
    out["bdf"].update(jac=st.jac.cpu(), c_last=st.c_last)
    return out


def check_implicit_state(label, ranks, ref):
    """Every rank's blocks of y, dy and the difference matrix (BDF's D,
    TR-BDF2's stage values), its t, h, order and Stats equal bit for bit
    to the unsharded steps ``ref`` (:func:`implicit_state_cell`), BDF's
    whole Jacobian too; K3 and K4 launched on every rank, as often as
    unsharded."""
    for name in ("bdf", "sdirk"):
        st = ref[name]["state"]
        diffs = (st.D if name == "bdf" else st.diff).cpu()
        y_ref, dy_ref = st.y.cpu(), st.dy.cpu()
        for r, res in enumerate(ranks):
            got, lo = res[name], res["offset"]
            k = got["y"].shape[-1]
            for key, want in (("y", y_ref), ("dy", dy_ref), ("diffs", diffs)):
                if not torch.equal(got[key], want[..., lo:lo + k]):
                    raise AssertionError(f"{label} {name} rank {r}: its block of {key} differs "
                                         f"from the unsharded steps")
            if (got["t"], got["h"], got["order"]) != (st.t, st.h, getattr(st, "order", None)):
                raise AssertionError(f"{label} {name} rank {r}: t, h, order {got['t']}, "
                                     f"{got['h']}, {got['order']} against {st.t}, {st.h}")
            same_stats(f"{label} {name} rank {r}", got["stats"], _host(st.stats))
            if got["launches"] != ref[name]["launches"] or min(got["launches"]) < 1:
                raise AssertionError(f"{label} {name} rank {r}: K3, K4 launches "
                                     f"{got['launches']}, unsharded {ref[name]['launches']}")
        if st.stats.steps != IMPLICIT_SHARD_STEPS[name] or not bool(torch.isfinite(y_ref).all()):
            raise AssertionError(f"{label} {name}: {st.stats.steps} steps, or non-finite y")
    for r, res in enumerate(ranks):
        if not (torch.equal(res["bdf"]["jac"], ref["bdf"]["state"].jac.cpu())
                and res["bdf"]["c_last"] == ref["bdf"]["state"].c_last):
            raise AssertionError(f"{label} rank {r}: BDF's last Jacobian or c differs")


def sub_band(band, ncols, ml, mu):
    """The (B, nb, ncols) band of the leading principal ncols x ncols
    submatrix of a (B, nb, n) band: its first columns, with the entries
    of rows past the cut zeroed."""
    sub = band[..., :ncols].clone()
    for d in range(mu + 1, mu + ml + 1):
        sub[:, d, ncols - (d - mu):] = 0.0
    return sub


def implicit_lu_records(dev, card_line, band, launches, ml=1, mu=1):
    """K3 and K4 at (j)'s shape, B = 2 members of n = 2^20 columns, on
    rank 0's last M - cJ ``band``: against their plain versions on its
    leading principal SUB_BAND columns (a no-pivot LU of that submatrix is
    the leading part of the whole one), the full-n factors' columns the cut
    does not reach against that plain factor, and the full-n solve held to
    its residual |A x - b| <= RESIDUAL_RTOL max |b|.  Times: the full-n
    calls (CUDA events), the plain versions and torch.linalg's dense LU on
    the sub-band; the bound at full n."""
    from diffsol_tpu_torch.ops import band_lu

    B, nb, n = band.shape
    ns = SUB_BAND
    b = torch.tensor(np.random.default_rng(SEED + 32).standard_normal((B, n)), device=dev)
    F = band_lu.launch_band_lu_factor(band, ml, mu)
    x = band_lu.launch_band_lu_solve(F, b, ml, mu)
    resid = float((band_lu.band_matvec(band, x, ml, mu) - b).abs().max() / b.abs().max())
    if not resid <= RESIDUAL_RTOL:
        raise AssertionError(f"[30j] full-n K4: |A x - b| {resid:.3e} of max |b|")
    sub = sub_band(band, ns, ml, mu)
    bs = b[:, :ns].contiguous()
    F_s = band_lu.launch_band_lu_factor(sub, ml, mu)
    x_s = band_lu.launch_band_lu_solve(F_s, bs, ml, mu)
    F_p, k3_plain = events_ms(lambda: band_lu.band_lu_factor_reference(sub, ml, mu))
    x_p, k4_plain = events_ms(lambda: band_lu.band_lu_solve_reference(F_p, bs, ml, mu))
    ef = check_lu("[30j] factor on the sub-band", F_s, F_p)
    ex = check_lu("[30j] solve on the sub-band", x_s, x_p)
    ec = check_lu("[30j] full-n factor's leading columns", F[:ns - ml], F_p[:ns - ml])
    k3_ms = time_ms(lambda: band_lu.launch_band_lu_factor(band, ml, mu), 3)
    k4_ms = time_ms(lambda: band_lu.launch_band_lu_solve(F, b, ml, mu), 3)
    dense = dense_of(sub, ml, mu)
    lu, piv = torch.linalg.lu_factor(dense)
    lib_f = time_ms(lambda: torch.linalg.lu_factor(dense), 3)
    lib_s = time_ms(lambda: torch.linalg.lu_solve(lu, piv, bs.unsqueeze(-1)), 3)
    del dense, lu
    f_bound = bound(8 * B * (nb * n + (n + mu) * nb), B * n * 2 * ml * mu)
    s_bound = bound(8 * B * ((n - 1) * ml + n * (mu + 1) + 2 * n),
                    B * n * (2 * ml + 2 * mu + 1))
    print(f"[30j] K3/K4 on rank 0's last M - cJ (B={B}, n={n}, nb={nb}): on the leading "
          f"{ns} columns vs plain max abs factor {ef:.3e}, x {ex:.3e}; the full-n factor's "
          f"first {ns - ml} columns vs that plain factor max abs {ec:.3e} (bound "
          f"{LU_RTOL:g} relative); the full-n solve's |A x - b| {resid:.2e} of max |b| "
          f"(bound {RESIDUAL_RTOL:g}); full n: factor {k3_ms:.3f} ms, solve {k4_ms:.3f} ms "
          f"(medians of 3 after a warm-up; least {f_bound[0]:.4f} / {s_bound[0]:.4f} ms by "
          f"{f_bound[1]} / {s_bound[1]}); on the {ns} columns: plain {k3_plain:.1f} / "
          f"{k4_plain:.1f} ms (one run), torch.linalg.lu_factor / lu_solve on the dense "
          f"({B}, {ns}, {ns}) expansion {lib_f:.3f} / {lib_s:.3f} ms; card {card_line}",
          flush=True)
    common = {"route": "cuda", "source": "diffsol_tpu_torch/csrc/band_lu.cuh"}
    return [dict(name="band_lu_factor:sharded_state_bdf",
                 replaces="diffsol_tpu/ops/pallas_banded.py:51", launches=launches[0],
                 max_abs_err=max(ef, ec), ms=k3_ms, plain_ms=k3_plain, bound_ms=f_bound[0],
                 bound_by=f_bound[1], library_ms=lib_f, **common),
            dict(name="band_lu_solve:sharded_state_bdf",
                 replaces="diffsol_tpu/ops/pallas_banded.py:72", launches=launches[1],
                 max_abs_err=ex, ms=k4_ms, plain_ms=k4_plain, bound_ms=s_bound[0],
                 bound_by=s_bound[1], library_ms=lib_s, **common)]


def events_heat1d(mgrid, kind, banded=True):
    """heat1d (n = mgrid + 1, rtol 1e-6, atol 1e-8) with a root where
    mean(y) falls through 0.3 and a reset that doubles y (``kind``
    "reset"), or the root alone: the solve stops there ("stop"), each with
    out() = (mean y, mean y^2) integrated in the error test; or no root
    and the quadrature of the state itself ("state_quad")."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import heat1d

    tp, _ = heat1d.make(mgrid, banded=banded)
    b = (dtt.OdeBuilder().rhs(tp.eqn.rhs).init(tp.eqn.init).p([1.0]).rtol(1e-6).atol(1e-8)
         .linear_solver(tp.linear_solver).integrate_out(True))
    if kind == "state_quad":
        return b.build()
    b = (b.root(lambda t, y, p: (y.mean() - 0.3).reshape(1))
         .out(lambda t, y, p: torch.stack([y.mean(), (y * y).mean()]))
         .out_rtol(1e-6).out_atol(1e-8))
    if kind == "reset":
        b = b.reset(lambda t, y, p: 2.0 * y)
    return b.build()


def implicit_rest_cell(mesh, dev):
    """(k): solve_dense over a sharded state at test size: the heat2d DAE
    (diagonal mass, consistent initial conditions, out(); n = 400, nb = 41,
    B = 2) through BdfSolver, and heat1d n = 128 with a root, a reset,
    out() and its quadrature (B = 2, members 1e-7 apart) through BdfSolver
    and TR-BDF2; each solution on the host with its K3/K4 launches."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.drivers import solve_dense

    out = {}
    for name, problem, cls, te, d in (
            ("dae_bdf", mol2d_problem("heat2d"), dtt.BdfSolver, DAE_SHARD_T_EVAL, [1.0, 1.0]),
            ("events_bdf", events_heat1d(HEAT_MGRID, "reset"), dtt.BdfSolver,
             EVENT_SHARD_T_EVAL, [1.0, 1.0 + 1e-7]),
            ("events_sdirk", events_heat1d(HEAT_MGRID, "reset"), dtt.SdirkSolver,
             EVENT_SHARD_T_EVAL, [1.0, 1.0 + 1e-7])):
        params = torch.tensor(d, dtype=torch.float64, device=dev)[:, None]
        lp, params, _ = state_sharded(problem, params, mesh, dev)
        for w in kernel_wrappers():
            w.launches = 0
        sol = solve_dense(cls(lp), te, params=params, device=dev, max_steps=20_000)
        out[name] = dict(ys=sol.ys.cpu(), gs=sol.gs.cpu(), stop=sol.stop_reason,
                         root_t=sol.root_t, stats=_host(sol.state.stats), t=sol.state.t,
                         launches=[w.launches for w in kernel_wrappers()[2:]])
    return out


def implicit_rest_rank(device_type, world, dev):
    """(k) in one rank over a (dp = 1, sp = ``world``) mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    return implicit_rest_cell(
        init_device_mesh(device_type, (1, world), mesh_dim_names=("dp", "sp")), dev)


def implicit_state_checks(dev, card_line, ranks, ref_j):
    """(j) in the parent: every rank held to the unsharded steps ``ref_j``
    (:func:`implicit_state_cell`), and K3/K4 at this shape
    (:func:`implicit_lu_records`); returns the records."""
    from diffsol_tpu_torch.ops.banded import make_banded_solver

    nh2 = ERK_SHARD_MGRID + 1
    jr = [res["implicit_state"] for res in ranks]
    check_implicit_state("[30j]", jr, ref_j)
    for name, label in (("bdf", "BdfSolver"), ("sdirk", "SdirkSolver (TR-BDF2)")):
        st, steps = ref_j[name]["state"], IMPLICIT_SHARD_STEPS[name]
        lj, gj = jr[0][name]["launches"], jr[0][name]["all_gathers"]
        order = f", order {st.order}" if name == "bdf" else ""
        print(f"[30j] heat1d banded {label}, n={nh2} states a member sharded over a (dp = 1, "
              f"sp = 2) mesh as 2 x {nh2 // 2}, B={len(ERK_SHARD_D)}, {steps} steps from "
              f"init_state: every rank's block of y, dy and "
              f"{'D' if name == 'bdf' else 'the stage values'}, t, h and Stats equal bit for "
              f"bit to the unsharded steps ({st.stats.newton_iterations} Newton iterations, "
              f"{st.stats.linear_solver_setups} factorizations, {st.stats.jacobian_evals} "
              f"Jacobians{order}, t = {st.t:.6e}); K3 {lj[0]} / K4 {lj[1]} launches a rank, as "
              f"many as unsharded (each rank factors and solves the whole members); {gj} "
              f"all-gathers a rank = {gj / steps:.1f} a step; sharded {jr[0][name]['ms']:.1f} / "
              f"{jr[1][name]['ms']:.1f} ms on ranks 0 / 1, unsharded {ref_j[name]['ms']:.1f} ms "
              f"(CUDA events from a barrier, init_state included, the first call); card "
              f"{card_line}", flush=True)
    launches_j = [sum(res[name]["launches"][k] for res in jr for name in ("bdf", "sdirk"))
                  for k in (0, 1)]
    del ref_j
    band_j = make_banded_solver(1, 1).assemble(None, jr[0]["bdf"]["jac"].to(dev),
                                               jr[0]["bdf"]["c_last"]).contiguous()
    return implicit_lu_records(dev, card_line, band_j, launches_j)


def implicit_rest_checks(card_line, ranks, ref_k):
    """(k) in the parent: every rank's solves equal to the unsharded ones
    ``ref_k`` (:func:`implicit_rest_cell`)."""
    from diffsol_tpu_torch import errors

    for name, ref in ref_k.items():
        for r, res in enumerate(ranks):
            got = res["implicit_rest"][name]
            if not (torch.equal(got["ys"], ref["ys"]) and torch.equal(got["gs"], ref["gs"])):
                raise AssertionError(f"[30k] {name} rank {r}: ys or gs differ from the "
                                     f"unsharded solve's")
            if (got["stop"], got["t"]) != (ref["stop"], ref["t"]) or not _equal_nan(
                    got["root_t"], ref["root_t"]):
                raise AssertionError(f"[30k] {name} rank {r}: stop, t or root time differ")
            same_stats(f"[30k] {name} rank {r}", got["stats"], ref["stats"])
            if got["launches"] != ref["launches"] or min(got["launches"]) < 1:
                raise AssertionError(f"[30k] {name} rank {r}: K3, K4 launches "
                                     f"{got['launches']}, unsharded {ref['launches']}")
        if ref["stop"] != errors.TSTOP_REACHED or not bool(torch.isfinite(ref["ys"]).all()):
            raise AssertionError(f"[30k] {name}: stop {ref['stop']}, or non-finite ys")
        if name.startswith("events") and not float(ref["ys"][1:].mean(-1).min()) > 0.3:
            raise AssertionError(f"[30k] {name}: mean(y) at or under 0.3 after a reset")
        st, lk = ref["stats"], ranks[0]["implicit_rest"][name]["launches"]
        what = ("the heat2d DAE (mass diag, consistent ICs, out()), n = 400, nb = 41"
                if name == "dae_bdf" else
                "heat1d n = 128 with a root on mean(y), its reset, out() and its quadrature")
        print(f"[30k] {name}: {what}, B = 2, solve_dense over a (dp = 1, sp = 2) mesh: every "
              f"rank's ys, gs, stop, t and Stats equal bit for bit to the unsharded solve's "
              f"({st['steps']} steps, {st['newton_iterations']} Newton iterations); K3 {lk[0]} / "
              f"K4 {lk[1]} launches a rank, as unsharded; card {card_line}", flush=True)


def kernel_wrappers():
    """The launch wrappers of K1, K2, K3 and K4, each with its count."""
    from diffsol_tpu_torch.ops import band_lu
    from diffsol_tpu_torch.ops import fused_band_stepper as fb
    from diffsol_tpu_torch.ops import fused_stepper as fs

    return (fs.launch_fused_bdf, fb.launch_fused_band_bdf, band_lu.launch_band_lu_factor,
            band_lu.launch_band_lu_solve)


@contextlib.contextmanager
def counted_all_gathers():
    """``torch.distributed.all_gather`` counted while open: yields a
    one-element list holding the count (sharding.py calls it through the
    module, so every collective of a solve is seen)."""
    import torch.distributed as dist

    real, calls = dist.all_gather, [0]

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    dist.all_gather = counting
    try:
        yield calls
    finally:
        dist.all_gather = real


def barrier():
    """Every rank of the default group here, so that a call timed next
    starts on all ranks together (NCCL's barrier on the current card)."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def run_shard_cells(mesh, dev, names=None, again=("robertson_fused", "heat1d_fused")):
    """Phase 30's cells sharded over ``mesh``, each with every launch
    counter and the all-gathers set to 0 just before it and read just
    after: name -> result on the host, ms (CUDA events, the first call,
    from a barrier of all ranks: the whole sharded call, the gather
    included), [K1, K2, K3, K4] launches, all-gathers; the cells in
    ``again`` timed once more (``ms_warm``)."""
    cells, _ = shard_cells(dev)
    out = {}
    with counted_all_gathers() as calls:
        for name, run in cells.items():
            if names is not None and name not in names:
                continue
            for w in kernel_wrappers():
                w.launches = 0
            barrier()
            calls[0] = 0
            res, ms = events_ms(lambda: run(mesh))
            out[name] = dict(result=_host(res), ms=ms,
                             launches=[w.launches for w in kernel_wrappers()],
                             all_gathers=calls[0])
            if name in again:
                # past the first call (the kernels' trace and load)
                barrier()
                out[name]["ms_warm"] = events_ms(lambda: run(mesh))[1]
    return out


def gloo_cuda_check(rank, world):
    """gloo's all-reduce and all-gather called on the card's tensors
    directly (the port stages gloo's collectives through the host)."""
    import torch.distributed as dist

    out = {}
    t = torch.full((2,), float(rank + 1), dtype=torch.float64, device="cuda")
    try:
        dist.all_reduce(t)
        out["all_reduce"] = t.tolist() == [world * (world + 1) / 2] * 2
    except RuntimeError as e:
        out["all_reduce"] = f"raised {str(e).splitlines()[0]}"
    parts = [torch.empty(2, dtype=torch.float64, device="cuda") for _ in range(world)]
    try:
        dist.all_gather(parts, torch.full((2,), float(rank), dtype=torch.float64,
                                          device="cuda"))
        out["all_gather"] = [float(q[0]) for q in parts] == [float(r) for r in range(world)]
    except RuntimeError as e:
        out["all_gather"] = f"raised {str(e).splitlines()[0]}"
    return out


def spmd_rank(rank, world, store, out_dir, backend, timeout, body, args):
    """One rank of :func:`spawn_ranks`: joins the ``world``-rank process
    group (each collective bounded by ``timeout`` seconds) and saves
    ``body(rank, world, *args)``, a dict, or its traceback to
    ``out_dir``/rank<r>.pt."""
    import datetime
    import os
    import traceback

    import torch.distributed as dist

    path = os.path.join(out_dir, f"rank{rank}.pt")
    dist.init_process_group(backend, init_method=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        torch.save(body(rank, world, *args), path)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, path)
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(body, world, out_dir, args=(), backend="gloo", timeout=SHARD_TIMEOUT_S):
    """``world`` SPMD ranks of ``body(rank, world, *args)`` (a module-level
    function returning a dict), started with torch.multiprocessing's
    "spawn" on a ``file://`` store under ``out_dir``, joined by a deadline
    of ``timeout`` + 60 s and killed after it; every rank's dict.  Raises
    when a rank failed, hung or wrote nothing."""
    import os

    ctx = torch.multiprocessing.get_context("spawn")
    store = "file://" + os.path.join(out_dir, "store")
    procs = [ctx.Process(target=spmd_rank,
                         args=(r, world, store, out_dir, backend, timeout, body, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout + 60
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    res = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pt")
        res.append(torch.load(path, weights_only=False) if os.path.exists(path)
                   else {"error": "wrote nothing"})
    errs = [f"rank {r}: {x['error']}" for r, x in enumerate(res) if "error" in x]
    if hung or errs or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"SPMD ranks failed (hung {hung}, exit codes "
                           f"{[p.exitcode for p in procs]}):\n" + "\n".join(errs))
    return res


def shard_rank(rank, world, device_type):
    """One rank of phase 30's gloo mesh on the card (every rank on card 0):
    gloo on card tensors, then the cells."""
    from torch.distributed.device_mesh import init_device_mesh

    out = {}
    if device_type == "cuda":
        torch.cuda.set_device(0)
        out["gloo_cuda"] = gloo_cuda_check(rank, world)
    mesh = init_device_mesh(device_type, (world,), mesh_dim_names=("dp",))
    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    out.update(run_shard_cells(mesh, dev))
    # (h), (j) and (k) on a (dp = 1, sp = world) mesh of the same ranks
    for key, part in (("erk_state", erk_state_rank), ("implicit_state", implicit_state_rank),
                      ("implicit_rest", implicit_rest_rank)):
        t0 = time.perf_counter()
        out[key] = part(device_type, world, dev)
        out[key + ":seconds"] = time.perf_counter() - t0
    return out


def same_stats(name, got, ref):
    """Equal Stats (as dicts of ints or (B,) tensors)."""
    diff = {k: (got[k], ref[k]) for k in ref if not _equal(got[k], ref[k])}
    if diff or got.keys() != ref.keys():
        raise AssertionError(f"{name}: Stats differ from the unsharded call's: {diff}")


def _equal(a, b):
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def _equal_nan(a, b):
    """Equal numbers, NaN where NaN."""
    return a == b or (a != a and b != b)


def shard_close(name, got, ref):
    """ys within YS_ATOL + YS_RTOL |ref| (NaN where ref is NaN); the
    largest absolute difference."""
    nan = torch.isnan(ref)
    if not torch.equal(nan, torch.isnan(got)):
        raise AssertionError(f"{name}: NaN where the unsharded call has none, or the reverse")
    g, r = got[~nan], ref[~nan]
    if bool(((g - r).abs() > YS_ATOL + YS_RTOL * r.abs()).any()):
        raise AssertionError(f"{name}: sharded and unsharded differ by up to "
                             f"{float((g - r).abs().max()):.3e}")
    return float((g - r).abs().max()) if g.numel() else 0.0


def start_shard_ranks(dev):
    """Phase 30's two ranks (:func:`shard_rank`), started in the background
    so that they run beside the phases before it; :func:`sharding_phase`
    joins them.  Returns (executor, the ranks' future, their directory,
    the start time)."""
    import os
    import shutil

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase30")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ex = ThreadPoolExecutor(max_workers=1)
    return ex, ex.submit(spawn_ranks, shard_rank, 2, out_dir, (dev.type,)), out_dir, \
        time.perf_counter()


def sharding_phase(dev, card_line, soln, started=None):
    """Phase 30; returns the kernels' records on the sharded paths.
    ``started`` is :func:`start_shard_ranks`'s result where the ranks were
    started earlier (else they start here)."""
    import datetime
    import os
    from types import SimpleNamespace

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from diffsol_tpu_torch import errors
    from diffsol_tpu_torch.models import heat1d, robertson
    from diffsol_tpu_torch.ops import fused_band_stepper as fb
    from diffsol_tpu_torch.ops import fused_stepper as fs
    from diffsol_tpu_torch.ops.eqn_codegen import op_count, trace_model

    ex, spawned, out_dir, t_ranks = started or start_shard_ranks(dev)
    t0 = time.perf_counter()
    with ex:
        # the unsharded references while the ranks run: their times share
        # the card with the ranks'
        cells, inputs = shard_cells(dev)
        refs, ref_ms = {}, {}
        for name in ("heat2d_lockstep", "robertson_independent", "robertson_grad"):
            refs[name], ref_ms[name] = events_ms(lambda: cells[name](None))
        ref_g, ms_g = events_ms(lambda: _host(cells["heat2d_krylov_lockstep"](None)))
        ref_erk = erk_state_cell(None, dev)
        ref_j = implicit_state_cell(None, dev)
        ref_k = implicit_rest_cell(None, dev)
        ref_s = time.perf_counter() - t0
        ranks = spawned.result()
    print(f"[30] 2 ranks of a gloo mesh ('dp') on the one card: started {t0 - t_ranks:.1f} s "
          f"before this phase, joined {time.perf_counter() - t0:.1f} s into it (host clock; "
          f"the parent's unsharded references beside them, {ref_s:.1f} s); gloo's collectives "
          f"on card tensors: {ranks[0].get('gloo_cuda')}", flush=True)
    names = list(cells)
    for name in names:
        a, b = ranks[0][name]["result"], ranks[1][name]["result"]
        if "sol" in a:
            a, b = a["sol"], b["sol"]
        ya, yb = a.get("ys"), b.get("ys")
        if not torch.equal(ya.nan_to_num(7.0), yb.nan_to_num(7.0)):
            raise AssertionError(f"[30] {name}: the two ranks hold different results")
    for name in names:
        r0, r1 = ranks[0][name], ranks[1][name]
        warm = (f", again {r0['ms_warm']:.1f} / {r1['ms_warm']:.1f} ms" if "ms_warm" in r0
                else "")
        print(f"[30] {name}: the whole sharded call {r0['ms']:.1f} / {r1['ms']:.1f} ms on "
              f"ranks 0 / 1 (CUDA events from a barrier, the first call{warm}); launches K1, K2, K3, K4 rank 0 "
              f"{r0['launches']}, rank 1 {r1['launches']}; {r0['all_gathers']} all-gathers "
              f"a rank; card {card_line}", flush=True)
    records = []

    # ---- (a) Robertson fused, 2 x 5,000 members to 4e10 (K1 on each block)
    got = ranks[0]["robertson_fused"]["result"]
    half = B_MAIN // 2
    rob = robertson.problem_ode()
    te = robertson.T_EVAL_4E10
    blocks = [cells_block(rob, te, inputs["rob"][lo:lo + half]) for lo in (0, half)]
    ref_ys = torch.cat([b.ys for b in blocks], 1).cpu()
    ref_steps = torch.cat([b.tile_steps for b in blocks]).cpu()
    err_a, _ = check_close("[30a] sharded vs blocks", got["ys"].movedim(1, -1),
                           ref_ys.movedim(1, -1), got["tile_steps"], ref_steps)
    stop = min(b.stop_reason for b in blocks)
    if got["stop"] != stop or stop != errors.TSTOP_REACHED or got["tier"] != blocks[0].tier:
        raise AssertionError(f"[30a] stop {got['stop']} (blocks {stop}), tier {got['tier']!r}")
    need_launches("[30a] K1", [res["robertson_fused"]["launches"][0] for res in ranks])
    rows = robertson.SOLN[1:][robertson.SOLN[1:, 0] <= 4e6]
    y0 = got["ys"][: len(rows), 0, :].numpy()
    for s_, tol in enumerate(SOLN_TOL):
        if tol is not None:
            np.testing.assert_allclose(y0[:, s_], rows[:, 1 + s_], rtol=tol[0], atol=tol[1])
    solve0 = fs.make_fused_bdf_solve(rob, te, half)
    (ys_p, st_p, steps_p), plain_ms = events_ms(lambda: solve0.reference(inputs["rob"][:half]))
    if int(st_p.min()) != fs.OK:
        raise AssertionError(f"[30a] plain version status {st_p.tolist()}")
    k1_err, k1_share = check_close("[30a] K1 on rank 0's block vs plain",
                                   got["ys"][:, :half].movedim(1, -1), ys_p.cpu(),
                                   got["tile_steps"][: len(steps_p)], steps_p.cpu())
    n = 3
    rhs_ops = op_count(trace_model(rob.eqn.rhs, None, n, 3).rhs)
    steps0 = got["tile_steps"][: len(steps_p)].double().mean().item()
    b_ms, b_by = bound(8 * (half * 3 + len(te) * half * n + len(te)),
                       half * steps0 * bdf_step_ops(n, rhs_ops, 2 * n * n))
    k1 = ranks[0]["robertson_fused"]["launches"][0] + ranks[1]["robertson_fused"]["launches"][0]
    print(f"[30a] Robertson fused B={B_MAIN} as 2 x {half} to 4e10: each block equal to the "
          f"unsharded call on its members (steps per tile equal, max abs {err_a:.3e}), stop "
          f"TSTOP_REACHED, member 0 on robertson.SOLN; K1 {k1} launches over the ranks; rank "
          f"0's block vs plain max abs {k1_err:.3e} ({k1_share:.3e} of the bound), plain "
          f"{plain_ms:.1f} ms (one run), least {b_ms:.4f} ms by {b_by}; card {card_line}",
          flush=True)
    # the kernel's own time on one shard's block (its record's ms, as every
    # K1 record's); the sharded calls' times above are the whole call
    k1_ms = time_ms(lambda: solve0(inputs["rob"][:half]), 3)
    print(f"[30a] K1 on one shard's block ({half} members): {k1_ms:.3f} ms (median of 3 "
          f"after a warm-up, CUDA events); card {card_line}", flush=True)
    records.append(k1_record("sharded", launches=k1, max_abs_err=k1_err, ms=k1_ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))

    # ---- (b) heat1d fused, n = 128, B = 1,024 as 2 x 512 (K2 on each block)
    got = ranks[0]["heat1d_fused"]["result"]
    hb = B_BAND // 2
    heat, _ = heat1d.make(HEAT_MGRID, rtol=1e-6, atol=1e-8, banded=True)
    nh = heat.eqn.nstates
    blocks = [cells_block(heat, HEAT_T_EVAL, inputs["heat"][lo:lo + hb]) for lo in (0, hb)]
    ref_ys = torch.cat([b.ys for b in blocks], 1).cpu()
    ref_steps = torch.cat([b.tile_steps for b in blocks]).cpu()
    err_b, _ = check_close("[30b] sharded vs blocks", got["ys"].movedim(1, -1),
                           ref_ys.movedim(1, -1), got["tile_steps"], ref_steps)
    if got["tier"] != blocks[0].tier:
        raise AssertionError(f"[30b] tier {got['tier']!r}")
    need_launches("[30b] K2", [res["heat1d_fused"]["launches"][1] for res in ranks])
    d = inputs["heat"][:, 0].cpu().numpy()
    series = check_heat("[30b]", SimpleNamespace(stop_reason=got["stop"], ys=got["ys"]), soln,
                        d, nh)
    solve0 = fb.make_fused_band_bdf_solve(heat, HEAT_T_EVAL, hb)
    (ys_p, st_p, steps_p), plain_b = events_ms(lambda: solve0.reference(inputs["heat"][:hb]))
    if int(st_p.min()) != fs.OK:
        raise AssertionError(f"[30b] plain version status {st_p.tolist()}")
    k2_err, k2_share = check_close("[30b] K2 on rank 0's block vs plain",
                                   got["ys"][:, :hb].movedim(1, -1), ys_p.cpu(),
                                   got["tile_steps"][: len(steps_p)], steps_p.cpu())
    rhs_ops = op_count(trace_model(heat.eqn.rhs, None, nh, 1).rhs)
    b_ms, b_by, _ = k2_bound(nh, 1, 1, rhs_ops, hb, got["tile_steps"][: len(steps_p)].numpy(),
                             hb, len(HEAT_T_EVAL) * hb * nh)
    k2 = ranks[0]["heat1d_fused"]["launches"][1] + ranks[1]["heat1d_fused"]["launches"][1]
    print(f"[30b] heat1d fused n={nh}, B={B_BAND} as 2 x {hb}: each block equal to the "
          f"unsharded call on its members (steps per tile equal, max abs {err_b:.3e}), the "
          f"member nearest d = 1 {series:.2e} from the series; K2 {k2} launches over the "
          f"ranks; rank 0's block vs plain max abs {k2_err:.3e} ({k2_share:.3e} of the "
          f"bound), plain {plain_b:.1f} ms (one run), least {b_ms:.4f} ms by {b_by}; card "
          f"{card_line}", flush=True)
    k2_ms = time_ms(lambda: solve0(inputs["heat"][:hb]), 3)
    print(f"[30b] K2 on one shard's block ({hb} members): {k2_ms:.3f} ms (median of 3 after "
          f"a warm-up, CUDA events); card {card_line}", flush=True)
    records.append(k2_record("fused_band_bdf:sharded", launches=k2, max_abs_err=k2_err,
                             ms=k2_ms, plain_ms=plain_b, bound_ms=b_ms, bound_by=b_by))

    # ---- (c) heat2d lockstep on the banded tier, B = 1,024: one joint solve
    ref = refs["heat2d_lockstep"]
    ref_h = _host(ref)
    steps = int(ref.state.stats.steps)
    for r, res in enumerate(ranks):
        got = res["heat2d_lockstep"]["result"]
        same_stats(f"[30c] rank {r}", got["stats"], ref_h["stats"])
        err_c = shard_close(f"[30c] rank {r}", got["ys"], ref_h["ys"])
        if got["stop"] != ref.stop_reason or ref.stop_reason != errors.TSTOP_REACHED:
            raise AssertionError(f"[30c] stop {got['stop']} against {ref.stop_reason}")
    lk = [res["heat2d_lockstep"]["launches"] for res in ranks]
    need_launches("[30c] K3 and K4", [x[2] for x in lk] + [x[3] for x in lk])
    gathers = ranks[0]["heat2d_lockstep"]["all_gathers"]
    print(f"[30c] heat2d lockstep n=400 banded, B={B_BAND} as 2 x {B_BAND // 2}: every rank's "
          f"Stats equal to the unsharded solve's ({steps} steps, "
          f"{int(ref.state.stats.newton_iterations)} Newton iterations), ys max abs "
          f"{err_c:.3e}; K3 {lk[0][2]} / K4 {lk[0][3]} launches a rank; {gathers} all-gathers "
          f"a rank = {gathers / steps:.2f} a step; sharded {ranks[0]['heat2d_lockstep']['ms']:.1f}"
          f" ms, unsharded {ref_ms['heat2d_lockstep']:.1f} ms (one call each, CUDA events); "
          f"card {card_line}", flush=True)
    problem2 = mol2d_problem("heat2d").to(dev)
    ml, mu = problem2.linear_solver.meta
    mass = problem2.eqn.mass_repr(problem2.t0, problem2.params)  # the same for every member
    band = problem2.linear_solver.assemble(mass, ref.state.jac[: B_BAND // 2],
                                           ref.state.c_last).contiguous()
    records += shard_lu_records(dev, card_line, band, ml, mu,
                                (lk[0][2] + lk[1][2], lk[0][3] + lk[1][3]))

    # ---- (d) Robertson independent, B = 1,024 to 4e4
    ref_h = _host(refs["robertson_independent"])
    for r, res in enumerate(ranks):
        got = res["robertson_independent"]["result"]
        same_stats(f"[30d] rank {r}", got["stats"], ref_h["stats"])
        if not torch.equal(got["stop"], ref_h["stop"]):
            raise AssertionError(f"[30d] rank {r}: stop reasons differ")
        err_d = shard_close(f"[30d] rank {r}", got["ys"], ref_h["ys"])
    st = ref_h["stats"]["steps"]
    print(f"[30d] Robertson independent B={B_SHARD} to {SHARD_ROB_T_EVAL[-1]:g} as 2 x {B_SHARD // 2}: every "
          f"member's Stats (all {len(st)} of each counter) equal to the unsharded batch's, "
          f"ys max abs {err_d:.3e}; steps min {int(st.min())} max {int(st.max())}; sharded "
          f"{ranks[0]['robertson_independent']['ms']:.1f} ms, unsharded "
          f"{ref_ms['robertson_independent']:.1f} ms (one call each, CUDA events), "
          f"{ranks[0]['robertson_independent']['all_gathers']} all-gathers a rank (the "
          f"gather at the end); card {card_line}", flush=True)

    # ---- (e) the lockstep gradient, Robertson B = 1,024 to 4e4
    ref_h = _host(refs["robertson_grad"])
    for r, res in enumerate(ranks):
        got = res["robertson_grad"]["result"]
        same_stats(f"[30e] rank {r} forward", got["forward"], ref_h["forward"])
        same_stats(f"[30e] rank {r} backward", got["backward"], ref_h["backward"])
        g, gr = got["grad"], ref_h["grad"]
        if not torch.isfinite(gr).all():
            raise AssertionError(f"[30e] the unsharded gradient is not finite "
                                 f"(backward status {ref_h['backward_status']})")
        rel_e = float((g - gr).abs().max() / gr.abs().max())
        if not rel_e <= SHARD_GRAD_RTOL:
            raise AssertionError(f"[30e] rank {r}: gradient {rel_e:.3e} from the unsharded one")
    fwd, bwd = ref_h["forward"], ref_h["backward"]
    gathers = ranks[0]["robertson_grad"]["all_gathers"]
    print(f"[30e] lockstep gradient, Robertson B={B_SHARD} to {SHARD_ROB_T_EVAL[-1]:g}, loss sum ys^2, as 2 x "
          f"{B_SHARD // 2}: forward and backward Stats equal to the unsharded call's "
          f"({fwd['steps']} forward, {bwd['steps']} backward steps), gradient within "
          f"{rel_e:.2e} of it (bound {SHARD_GRAD_RTOL:g}, relative to its largest entry); "
          f"{gathers} all-gathers a rank = {gathers / (fwd['steps'] + bwd['steps']):.2f} a "
          f"step; sharded {ranks[0]['robertson_grad']['ms']:.1f} ms, unsharded "
          f"{ref_ms['robertson_grad']:.1f} ms (one call each, CUDA events); card "
          f"{card_line}", flush=True)

    # ---- (g) heat2d DAE lockstep on the Krylov tier, B = 256: one GMRES over both ranks
    ref_sol = ref_g["sol"]
    scale = float(ref_sol["ys"].abs().max())
    for r, res in enumerate(ranks):
        got = res["heat2d_krylov_lockstep"]["result"]
        same_stats(f"[30g] rank {r}", got["sol"]["stats"], ref_sol["stats"])
        if got["gmres"] != ref_g["gmres"]:
            raise AssertionError(f"[30g] rank {r}: GMRES counts {got['gmres']}, the "
                                 f"unsharded call's {ref_g['gmres']}")
        if got["sol"]["stop"] != ref_sol["stop"] or ref_sol["stop"] < 0:
            raise AssertionError(f"[30g] stop {got['sol']['stop']} against {ref_sol['stop']}")
        rel_g = float((got["sol"]["ys"] - ref_sol["ys"]).abs().max()) / scale
        if not rel_g <= SHARD_KRYLOV_RTOL:
            raise AssertionError(f"[30g] rank {r}: ys {rel_g:.3e} of the largest from "
                                 f"the unsharded call's")
    st, gm = ref_sol["stats"], ref_g["gmres"]
    gathers = ranks[0]["heat2d_krylov_lockstep"]["all_gathers"]
    print(f"[30g] heat2d DAE lockstep on the Krylov tier, n={KRYLOV_MGRID ** 2}, "
          f"B={B_KRYLOV_CUT} as 2 x {B_KRYLOV_CUT // 2}, to t = {SHARD_KRYLOV_T_EVAL[-1]:g} "
          f"(phase 24 b's first output), one GMRES over both ranks' members: every rank's "
          f"Stats ({st['steps']} steps, {st['newton_iterations']} Newton iterations) and GMRES "
          f"counts ({gm['calls']} calls, {gm['restarts']} restarts, {gm['arnoldi']} Arnoldi "
          f"iterations) equal to the unsharded call's, ys within {rel_g:.2e} of its largest "
          f"entry (bound {SHARD_KRYLOV_RTOL:g}); {gathers} all-gathers a rank = "
          f"{gathers / max(gm['arnoldi'], 1):.2f} an Arnoldi iteration; sharded "
          f"{ranks[0]['heat2d_krylov_lockstep']['ms']:.1f} ms, unsharded {ms_g:.1f} ms (CUDA "
          f"events, one call each); the preconditioner is torch.linalg's float32 LU, no "
          f"kernel of the port's; card {card_line}", flush=True)

    # ---- (h) heat1d ERK, 2^20 states a member sharded over "sp", B = 2
    ref_st = ref_erk["state"]
    check_erk_state("[30h]", [res["erk_state"] for res in ranks], ref_st)
    eh = ranks[0]["erk_state"]
    nh2 = ERK_SHARD_MGRID + 1
    print(f"[30h] heat1d ERK (TSIT45), n={nh2} states a member sharded over a (dp = 1, "
          f"sp = 2) mesh as 2 x {nh2 // 2}, B={len(ERK_SHARD_D)}, {ERK_SHARD_STEPS} steps: "
          f"every rank's block of y and dy, t, h and Stats equal bit for bit to the "
          f"unsharded steps ({ref_st.stats.error_test_failures} error-test failures, t = "
          f"{ref_st.t:.6e}); {eh['all_gathers']} all-gathers a rank = "
          f"{eh['all_gathers'] / ERK_SHARD_STEPS:.1f} a step (the rhs's state at every "
          f"stage, the norms' terms); sharded {eh['ms']:.1f} / {ranks[1]['erk_state']['ms']:.1f} "
          f"ms on ranks 0 / 1, unsharded {ref_erk['ms']:.1f} ms (CUDA events from a barrier, "
          f"the first call); no kernel of the port's; card {card_line}", flush=True)

    # ---- (j) heat1d banded BDF and TR-BDF2 over the same 2^20 states a member
    t0 = time.perf_counter()
    records += implicit_state_checks(dev, card_line, ranks, ref_j)
    t_j = time.perf_counter() - t0

    # ---- (k) the rest of the implicit path over a sharded state, at test size
    t0 = time.perf_counter()
    implicit_rest_checks(card_line, ranks, ref_k)
    print(f"[30] host seconds: (h), (j), (k) in rank 0 "
          + ", ".join(f"{ranks[0][k + ':seconds']:.1f}"
                      for k in ("erk_state", "implicit_state", "implicit_rest"))
          + f"; (j) and (k) in the parent {t_j:.1f}, {time.perf_counter() - t0:.1f}",
          flush=True)

    # ---- (i) heat1d banded independent gradient, B = 1,024 as 2 x 512
    ref_i = PHASE_REFS.get("28d")
    if ref_i is None:  # phase 30 run alone
        ref_i = _host(cells["heat1d_ind_grad"](None))
    for r, res in enumerate(ranks):
        got = res["heat1d_ind_grad"]["result"]
        for key in ("ys", "grad", "status", "backward_status"):
            if not torch.equal(got[key], ref_i[key]):
                raise AssertionError(f"[30i] rank {r}: {key} differs from phase 28 d's")
        same_stats(f"[30i] rank {r} forward", got["forward"], ref_i["forward"])
        same_stats(f"[30i] rank {r} backward", got["backward"], ref_i["backward"])
    if not bool(torch.isfinite(ref_i["grad"]).all()):
        raise AssertionError("[30i] a gradient of phase 28 d is not finite")
    li = [res["heat1d_ind_grad"]["launches"] for res in ranks]
    need_launches("[30i] K3 and K4", [x[2] for x in li] + [x[3] for x in li])
    gathers = ranks[0]["heat1d_ind_grad"]["all_gathers"]
    print(f"[30i] independent gradient, heat1d banded n={HEAT_MGRID + 1}, B={B_BAND} as 2 x "
          f"{B_BAND // 2}: every member's ys, gradient, forward and backward Stats and "
          f"statuses equal bit for bit to phase 28 d's; K3 {li[0][2]} / K4 {li[0][3]} launches "
          f"on rank 0, {li[1][2]} / {li[1][3]} on rank 1 (forward; none in the backward); "
          f"{gathers} all-gathers a rank (the results', none in the passes); sharded "
          f"{ranks[0]['heat1d_ind_grad']['ms']:.1f} / {ranks[1]['heat1d_ind_grad']['ms']:.1f} "
          f"ms on ranks 0 / 1 (CUDA events from a barrier, forward and backward); card "
          f"{card_line}", flush=True)
    band_i = PHASE_REFS.get("28d_band")
    if band_i is None:  # phase 30 run alone: the forward pass's last M - cJ
        import diffsol_tpu_torch as dtt

        heat, _ = heat1d.make(HEAT_MGRID, rtol=1e-6, atol=1e-8, banded=True)
        hst = dtt.solve_dense_ensemble(dtt.BdfSolver, heat, HEAT_T_EVAL, inputs["heat_grad"],
                                       mode="independent", device=dev).state
        band_i = heat.linear_solver.assemble(None, hst.jac, hst.c_last.view(-1, 1, 1))
    f_rec, s_rec = path_lu_records(dev, card_line, "i", band_i[: B_BAND // 2].contiguous(), 1,
                                   phase=30)
    records += [dict(f_rec, name="band_lu_factor:sharded_independent_adjoint",
                     launches=li[0][2] + li[1][2]),
                dict(s_rec, name="band_lu_solve:sharded_independent_adjoint",
                     launches=li[0][3] + li[1][3])]

    # ---- (f) a 1-rank NCCL mesh: heat2d lockstep with its collectives on the card
    dist.init_process_group("nccl", init_method="file://" + os.path.join(out_dir, "nccl"),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        mesh1 = init_device_mesh("cuda", (1,), mesh_dim_names=("dp",))
        one = run_shard_cells(mesh1, dev, names=("heat2d_lockstep",))["heat2d_lockstep"]
    finally:
        dist.destroy_process_group()
    ref_h = _host(refs["heat2d_lockstep"])
    same_stats("[30f]", one["result"]["stats"], ref_h["stats"])
    err_f = shard_close("[30f]", one["result"]["ys"], ref_h["ys"])
    print(f"[30f] heat2d lockstep B={B_BAND} over a 1-rank NCCL mesh: Stats equal to the "
          f"unsharded solve's, ys max abs {err_f:.3e}; {one['all_gathers']} all-gathers on the "
          f"card (NCCL), K3 {one['launches'][2]} / K4 {one['launches'][3]} launches; "
          f"{one['ms']:.1f} ms (CUDA events, one call); card {card_line}", flush=True)
    return records


def need_launches(name, counts):
    """Every rank launched the kernel on its path."""
    if min(counts) < 1:
        raise AssertionError(f"{name}: launches {counts}: a rank launched none")


def cells_block(problem, te, params):
    """The unsharded fused call on a block of members."""
    from diffsol_tpu_torch import BdfSolver, solve_dense_ensemble

    return solve_dense_ensemble(BdfSolver, problem, te, params, mode="fused",
                                device=params.device)


def shard_lu_records(dev, card_line, band, ml, mu, launches):
    """K3 and K4 against their plain versions on rank 0's block of the
    heat2d lockstep solve's last M - cJ (phase 14's bounds and library
    calls), with the launches of the sharded run over both ranks."""
    from diffsol_tpu_torch.ops import band_lu

    B, nb, n = band.shape
    b = torch.tensor(np.random.default_rng(SEED).standard_normal((B, n)), device=dev)
    F, x = lu_once(band, b, ml, mu)
    F_p = band_lu.band_lu_factor_reference(band, ml, mu)
    x_p = band_lu.band_lu_solve_reference(F_p, b, ml, mu)
    ef, ex = check_lu("[30c] factor", F.lu, F_p), check_lu("[30c] solve", x, x_p)
    k3_ms = time_ms(lambda: band_lu.launch_band_lu_factor(band, ml, mu), 10)
    k4_ms = time_ms(lambda: band_lu.launch_band_lu_solve(F.lu, b, ml, mu), 10)
    k3_plain = time_ms(lambda: band_lu.band_lu_factor_reference(band, ml, mu), 0)
    k4_plain = time_ms(lambda: band_lu.band_lu_solve_reference(F.lu, b, ml, mu), 0)
    dense = dense_of(band, ml, mu)
    lu, piv = torch.linalg.lu_factor(dense)
    lib_f = time_ms(lambda: torch.linalg.lu_factor(dense), 3)
    lib_s = time_ms(lambda: torch.linalg.lu_solve(lu, piv, b.unsqueeze(-1)), 3)
    f_bound = bound(8 * B * (nb * n + (n + mu) * nb), B * n * 2 * ml * mu)
    s_bound = bound(8 * B * ((n - 1) * ml + n * (mu + 1) + 2 * n),
                    B * n * (2 * ml + 2 * mu + 1))
    print(f"[30c] K3/K4 on rank 0's block of the solve's last M - cJ (B={B}, n={n}, nb={nb}): "
          f"vs plain max abs factor {ef:.3e}, x {ex:.3e}; factor {k3_ms:.4f} ms, solve "
          f"{k4_ms:.4f} ms (medians of 10; least {f_bound[0]:.4f} / {s_bound[0]:.4f} ms by "
          f"{f_bound[1]} / {s_bound[1]}); plain {k3_plain:.1f} / {k4_plain:.1f} ms (one run); "
          f"torch.linalg.lu_factor / lu_solve on the dense expansion {lib_f:.3f} / "
          f"{lib_s:.3f} ms; card {card_line}", flush=True)
    common = {"route": "cuda", "source": "diffsol_tpu_torch/csrc/band_lu.cuh"}
    return [dict(name="band_lu_factor:sharded_heat2d", replaces="diffsol_tpu/ops/pallas_banded.py:51",
                 launches=launches[0], max_abs_err=ef, ms=k3_ms, plain_ms=k3_plain,
                 bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=lib_f, **common),
            dict(name="band_lu_solve:sharded_heat2d", replaces="diffsol_tpu/ops/pallas_banded.py:72",
                 launches=launches[1], max_abs_err=ex, ms=k4_ms, plain_ms=k4_plain,
                 bound_ms=s_bound[0], bound_by=s_bound[1], library_ms=lib_s, **common)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffsol_tpu_torch import _build
    from diffsol_tpu_torch.models import heat1d, robertson
    from diffsol_tpu_torch.ops import fused_band_stepper as fb
    from diffsol_tpu_torch.ops import fused_stepper as fs

    t_start = time.perf_counter()
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
    from diffsol_tpu_torch.examples import heat1d_band_ensemble

    example_band = fb.make_fused_band_bdf_solve(heat1d_band_ensemble.make_problem(),
                                                heat1d_band_ensemble.T_EVAL, 256)
    t0 = time.perf_counter()
    diffsl = diffsl_models()
    diffsl_checks = diffsl_check_solves(diffsl)
    print(f"[2] DiffSL models compiled, built and traced in {time.perf_counter() - t0:.1f} s",
          flush=True)
    k1_solves = {"ode": check_solve, **check_solves, "mixed": mixed_check, "f32": f32_check,
                 **{k: v for k, v in diffsl_checks.items() if k in K1_DIFFSL}}
    band_solves = {"heat1d": band_check, **mol2d_checks,
                   **{k: v for k, v in diffsl_checks.items() if k not in K1_DIFFSL}}
    with ThreadPoolExecutor(max_workers=len(k1_solves) + len(band_solves) + 2) as ex:
        # one nvcc each, all started together; the widest first
        builds = [ex.submit(_build.load_fused_band_bdf, sv.header, sv.cfg.ml, sv.cfg.mu)
                  for sv in reversed(band_solves.values())]
        builds.append(ex.submit(_build.load_band_lu))
        # phase 29's heat1d example: its own rhs, so its own header
        builds.append(ex.submit(_build.load_fused_band_bdf, example_band.header, 1, 1))
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

    def timed(tag, fn):
        t_phase = time.perf_counter()
        out = fn()
        print(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s (host clock)",
              flush=True)
        return out

    shared, started = {}, []
    small_path, small_record = timed("3-5", lambda: robertson_phases(
        dev, rng, card_line, problem, check_solve, shared))
    dae_path, variant_records = timed(12, lambda: variant_phases(
        dev, rng, card_line, variants, check_solves, shared))
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
    band_paths, band_records = timed("7-10", lambda: band_phases(
        dev, card_line, heat_problem, soln, band_check))
    mol2d_paths, mol2d_records, lu_launches = timed(13, lambda: mol2d_phases(
        dev, card_line, mol2d_checks))
    wide_lu_records = timed(14, lambda: band_lu_wide_phase(dev, card_line, lu_launches))
    mixed_path, mixed_record = timed(15, lambda: mixed_phase(dev, card_line, problem, shared))
    timed(11, lambda: call_and_kernel(
        [small_path, dae_path] + band_paths + mol2d_paths + [mixed_path], card_line))
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
    for tag, phase in ((24, lambda: krylov_phase(dev, card_line)),
                       (25, lambda: capi_phase(card_line))):
        t_phase = time.perf_counter()
        phase()
        print(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s (host clock)",
              flush=True)
    t_phase = time.perf_counter()
    independent_records = independent_phase(dev, card_line, heat_problem, soln)
    print(f"[26] phase took {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)
    t_phase = time.perf_counter()
    independent_rk_records = independent_rk_phase(dev, card_line, heat_problem, soln)
    print(f"[27] phase took {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)
    t_phase = time.perf_counter()
    independent_adj_records = independent_krylov_adjoint_phase(dev, card_line, heat_problem)
    print(f"[28] phase took {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)
    # phase 30's ranks run beside phase 29 (host-bound eager paths: the
    # card is mostly idle), once its kernel records are taken
    t_phase = time.perf_counter()
    example_records = examples_phase(dev, card_line,
                                     after_records=lambda: started.append(
                                         start_shard_ranks(dev)))
    print(f"[29] phase took {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)
    t_phase = time.perf_counter()
    sharding_records = sharding_phase(dev, card_line, soln, started[0] if started else None)
    print(f"[30] phase took {time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)
    print(f"[1-30] the whole script {time.perf_counter() - t_start:.1f} s (host clock); card "
          f"{card_line}", flush=True)
    record = ([small_record] + variant_records + [mixed_record] + band_records
              + mol2d_records + wide_lu_records + diffsl_records + sens_records
              + adjoint_records + f32_records + independent_records + independent_rk_records
              + independent_adj_records + example_records + sharding_records)

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
