"""The ranks of the sharding tests: spawn an SPMD group of processes on a
``DeviceMesh`` (gloo), run named cases of the port's sharded entry points in
every rank, and bring each rank's results back through files.

No JAX here: the ranks import torch, the port and chip_smoke.py's spawn
harness only, so the CPU tests (tests/test_torch_sharding.py) and the
card's (tests/test_torch_cuda.py) share the cases.  Every case runs the
same way with ``mesh=None`` on one device, the unsharded call the sharded
one is held to.  Every spawn has a
time limit: ``init_process_group(timeout=)`` bounds each collective, so
ranks whose step sequences parted (mismatched collectives) fail instead of
hanging, and the parent joins with a deadline and kills what is left.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402  (the spawn harness and the counters)

F64 = torch.float64


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def stats_of(stats) -> dict:
    """A Stats as {field: int or (B,) array}."""
    return {f.name: _np(getattr(stats, f.name)) for f in dataclasses.fields(stats)}


def _solution(sol) -> dict:
    out = dict(ys=_np(sol.ys), stop=_np(sol.stop_reason), tier=sol.tier,
               root_t=_np(sol.root_t), root_idx=_np(sol.root_idx))
    for key in ("gs", "sens", "tile_steps"):
        if getattr(sol, key) is not None:
            out[key] = _np(getattr(sol, key))
    if sol.state is not None:
        out["stats"] = stats_of(sol.state.stats)
        out["t"] = _np(sol.state.t)
        if sol.tier == "independent":  # the gathered state, every tensor of it
            out["state"] = {f.name: _np(getattr(sol.state, f.name))
                            for f in dataclasses.fields(sol.state)
                            if isinstance(getattr(sol.state, f.name), torch.Tensor)}
    return out


def _decay_params(nbatch):
    a = np.linspace(0.05, 1.0, nbatch)
    return np.stack([a, np.ones_like(a)], axis=1)


def _rob_params(nbatch, spread=0.1):
    k1 = 0.04 * (1.0 + spread * np.linspace(-1.0, 1.0, nbatch))
    return np.stack([k1, np.full(nbatch, 1e4), np.full(nbatch, 3e7)], axis=1)


def _oscillator():
    import diffsol_tpu_torch as dtt

    def rhs(t, y, p):
        return torch.stack([y[1], -p[0] * y[0] - p[1] * y[1]])

    def init(t, p):
        return torch.tensor([1.0, 0.0], dtype=F64, device=p.device)

    return dtt.OdeBuilder().rhs(rhs).init(init).p([2.0, 0.4]).rtol(1e-6).atol(1e-8).build()


def _loop_bdf():
    from diffsol_tpu_torch.solvers.bdf import BdfSolver

    class LoopBdf(BdfSolver):
        """A BdfSolver the batched independent loop does not take."""

    return LoopBdf


def _krylov_heat1d(mgrid, rtol, atol):
    """heat1d on the matrix-free Krylov tier (tests/test_torch_krylov_lockstep.py)."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import heat1d

    tp, _ = heat1d.make(mgrid, rtol=rtol, atol=atol)
    return (dtt.OdeBuilder().rhs(tp.eqn.rhs).init(tp.eqn.init).p([1.0]).rtol(rtol)
            .atol(atol).linear_solver("krylov").build())


KRYLOV_MGRID = 4  # n = 5: a joint system of 20, so GMRES restarts at 20 iterations
KRYLOV_D = np.linspace(0.8, 1.2, 4)[:, None]
KRYLOV_T_EVAL = [0.05, 0.1]
ROB_GRAD_T_EVAL = [0.4, 4.0, 40.0]
ROB_GRAD_PARAMS = np.stack([0.04 * np.array([0.5, 1.0, 2.0, 1.5]), np.full(4, 1e4),
                            np.full(4, 3e7)], axis=1)
HEAT_GRAD_MGRID = 7  # n = 8: JAX's sharded gradient compiles in ~2/3 of n = 16's time
HEAT_GRAD_T_EVAL = [0.01, 0.05, 0.1]
HEAT_GRAD_PARAMS = np.array([[0.5], [1.0], [2.0], [1.5]])
ERK_MGRID = 255  # n = 256, JAX's program 2 (__graft_entry__.py:105-146)
ERK_D = np.array([[1.0], [0.5], [2.0], [1.5]])
ERK_T_EVAL = [2e-5, 5e-5]
# the implicit solves over a sharded state: heat1d n = 64, B = 2 (a member
# each "dp" rank), the heat2d DAE n = 36 (nb = 13 on the banded tier)
STATE_MGRID = 63
STATE_D = np.array([[1.0], [0.5]])
STATE_STEPS = 12  # past the first refreshes and an order change (BDF)
STATE_JAX_STEPS = 5
STATE_T_EVAL = [1e-3, 4e-3]
DAE_MGRID = 6
DENSE_MASS_MGRID = 15  # heat1d with a dense consistent mass, n = 16
DAE_T_EVAL = [0.01, 0.03]
# roots with a reset, out() and its quadrature: mean(y) falls through 0.3
# at t ~ 0.05, then the reset doubles y; members close enough to cross in
# one step
EVENT_D = np.array([[1.0], [1.0 + 1e-7]])
EVENT_T_EVAL = [0.02, 0.06, 0.1, 0.15]
# the card's case: n = 2^14, where K4 keeps x in device memory
CARD_STATE_MGRID = 2**14 - 1


def _ind_grad(problem, t_eval, pb, mesh, dev):
    """mode="independent"'s gradient of the sum of squares, with its
    per-member info."""
    from diffsol_tpu_torch.adjoint_ensemble import make_differentiable_solve_ensemble

    fn = make_differentiable_solve_ensemble(problem, t_eval, pb.shape[0], mode="independent",
                                            mesh=mesh, device=None if mesh else dev)
    p = torch.tensor(pb, dtype=F64, device=dev).requires_grad_(True)
    ys = fn(p)
    (ys ** 2).sum().backward()
    info = fn.info
    return dict(ys=_np(ys.detach()), grad=_np(p.grad), forward=stats_of(info["forward"]),
                backward=stats_of(info["backward"]), status=_np(info["status"]),
                backward_status=_np(info["backward_status"]))


def _erk_state(mesh, dev):
    """heat1d (n = 256, B = 4) lockstep ERK with every member's states
    sharded over "sp" and the members over "dp": five steps from
    init_state, then a short solve_dense; the rank's blocks, its
    coordinates and the all-gathers of the five steps."""
    from diffsol_tpu_torch.drivers import init_state, solve_dense
    from diffsol_tpu_torch.ensemble import make_lockstep_problem
    from diffsol_tpu_torch.models import heat1d
    from diffsol_tpu_torch.sharding import MemberAxis, StateAxis
    from diffsol_tpu_torch.solvers.erk import ErkSolver

    problem = heat1d.make(ERK_MGRID)[0].to(dev)  # the solver steps on dev
    n, B = problem.eqn.nstates, ERK_D.shape[0]
    params = torch.tensor(ERK_D, dtype=F64, device=dev)
    maxis = saxis = None
    coords = (0, 0)
    if mesh is not None:
        maxis, saxis = MemberAxis.of(mesh, "dp", B), StateAxis.of(mesh, "sp", n)
        params = maxis.split(params)
        coords = (mesh.get_local_rank("dp"), mesh.get_local_rank("sp"))
    solver = ErkSolver(make_lockstep_problem(problem, params.shape[0], axis=maxis,
                                             state_axis=saxis))
    state = init_state(solver, params, device=dev)
    with cs.counted_all_gathers() as calls:
        for _ in range(5):
            state = solver.step(state, params)
    sol = solve_dense(solver, ERK_T_EVAL, params=params, device=dev)
    return dict(coords=coords, y=_np(state.y), dy=_np(state.dy), t=state.t, h=state.h,
                stats=stats_of(state.stats), step_gathers=calls[0], ys=_np(sol.ys),
                stop=sol.stop_reason, sol_stats=stats_of(sol.state.stats),
                final_y=_np(sol.state.y))


def _state_errors(mesh):
    """What a state axis refuses: an n the axis does not divide, and
    (ROADMAP 20f) sens=True on every solver, the Krylov and block-diagonal
    tiers and the member-time lift."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.ensemble import make_lockstep_problem
    from diffsol_tpu_torch.models import heat1d, robertson
    from diffsol_tpu_torch.sharding import StateAxis

    def error(fn, kind):
        try:
            fn()
            return None
        except kind as e:
            return str(e)

    out = dict(uneven=error(lambda: StateAxis.of(mesh, "sp", 255), ValueError))
    problem, _ = heat1d.make(ERK_MGRID)
    saxis = StateAxis.of(mesh, "sp", 256)
    lp = make_lockstep_problem(problem, 2, state_axis=saxis)
    for name, cls in (("bdf", dtt.BdfSolver), ("sdirk", dtt.SdirkSolver),
                      ("erk", dtt.ErkSolver)):
        out[name + "_sens"] = error(lambda c=cls: c(lp, sens=True), NotImplementedError)
    out["independent"] = error(lambda: make_lockstep_problem(problem, 2, member_t=True,
                                                             state_axis=saxis),
                               NotImplementedError)
    out["krylov"] = error(lambda: make_lockstep_problem(_krylov_heat1d(ERK_MGRID, 1e-4, 1e-6),
                                                        2, state_axis=saxis),
                          NotImplementedError)
    out["blockdiag"] = error(lambda: make_lockstep_problem(
        robertson.problem_ode_groups(4), 2, state_axis=StateAxis.of(mesh, "sp", 12)),
        NotImplementedError)
    return out


def _state_sharded(problem, pb, mesh, dev):
    """``problem`` lifted to lockstep over ``pb``'s members, over ``mesh``'s
    "dp" (members) and "sp" (states) axes, or unsharded without a mesh
    (chip_smoke.state_sharded): (lockstep problem, the rank's params, its
    (dp, sp) coordinates)."""
    lp, params, _ = cs.state_sharded(problem, torch.tensor(pb, dtype=F64, device=dev), mesh,
                                     dev)
    coords = ((0, 0) if mesh is None
              else (mesh.get_local_rank("dp"), mesh.get_local_rank("sp")))
    return lp, params, coords


def _state_of(st) -> dict:
    """A BDF or RK state's tensors of the states (the rank's blocks), its
    scalars and Stats."""
    out = dict(y=_np(st.y), dy=_np(st.dy), t=st.t, h=st.h, stats=stats_of(st.stats))
    for key in ("D", "order", "diff", "g"):
        if hasattr(st, key):
            out[key] = _np(getattr(st, key))
    return out


def _steps_and_solve(make_solver, problem, pb, t_eval, mesh, dev, nsteps):
    """STATE_JAX_STEPS and then ``nsteps`` steps from init_state, the
    all-gathers of the steps, then solve_dense over ``t_eval``."""
    from diffsol_tpu_torch.drivers import init_state, solve_dense

    lp, params, coords = _state_sharded(problem, pb, mesh, dev)
    solver = make_solver(lp)
    state = init_state(solver, params, device=dev)
    out = dict(coords=coords, init=_state_of(state))
    with cs.counted_all_gathers() as calls:
        for k in range(nsteps):
            state = solver.step(state, params)
            if k + 1 == STATE_JAX_STEPS:
                out["five"] = _state_of(state)
    out.update(steps=_state_of(state), step_gathers=calls[0])
    sol = solve_dense(solver, t_eval, params=params, device=dev)
    out.update(_solution(sol), final=_state_of(sol.state))
    return out


def _implicit_state(mesh, dev):
    """heat1d n = 64, B = 2: BdfSolver and SdirkSolver (TR-BDF2) on the
    dense and banded tiers, each STATE_STEPS steps and a solve_dense."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import heat1d

    out = {}
    for tier in ("dense", "banded"):
        problem, _ = heat1d.make(STATE_MGRID, rtol=1e-6, atol=1e-8, banded=tier == "banded")
        for name, cls in (("bdf", dtt.BdfSolver), ("sdirk", dtt.SdirkSolver)):
            out[f"{name}_{tier}"] = _steps_and_solve(cls, problem, STATE_D, STATE_T_EVAL,
                                                     mesh, dev, STATE_STEPS)
    return out


def _dae_state(mesh, dev):
    """The heat2d DAE (diagonal mass, out()), n = 36, B = 2, on the dense
    and banded tiers (consistent initial conditions), and heat1d n = 16
    with a dense mass on the dense tier: BDF and SDIRK steps and a
    solve_dense."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import heat2d

    out = {}
    problems = [(tier, heat2d.make(DAE_MGRID, banded=tier == "banded"))
                for tier in ("dense", "banded")]
    problems.append(("dense_mass", _dense_mass_heat1d(DENSE_MASS_MGRID)))
    for tier, problem in problems:
        for name, cls in (("bdf", dtt.BdfSolver), ("sdirk", dtt.SdirkSolver)):
            out[f"{name}_{tier}"] = _steps_and_solve(cls, problem, [[1.0], [1.0]], DAE_T_EVAL,
                                                     mesh, dev, STATE_STEPS)
    return out


def _dense_mass_heat1d(mgrid):
    """heat1d (n = mgrid + 1) written M y' = M f(y) with the finite-element
    consistent mass M (2/3 on the diagonal, 1/6 beside it) as a dense
    (n, n) matrix: the solution is heat1d's, the mass is dense.  Its rhs
    stays elementwise (a member's matrix product would round apart between
    a rank's members and the whole batch)."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import heat1d

    hp, _ = heat1d.make(mgrid, rtol=1e-6, atol=1e-8)
    n = hp.eqn.nstates
    M = torch.tensor(np.eye(n) * 2.0 / 3.0 + (np.eye(n, k=1) + np.eye(n, k=-1)) / 6.0)
    f = hp.eqn.rhs

    def rhs(t, y, p):  # M f(y), row by row
        fy = f(t, y, p)
        fp = torch.nn.functional.pad(fy, (1, 1))
        return fy * (2.0 / 3.0) + (fp[..., :-2] + fp[..., 2:]) / 6.0

    return (dtt.OdeBuilder().rhs(rhs).init(hp.eqn.init).mass(lambda t, p: M.to(p.device))
            .p([1.0]).rtol(1e-6).atol(1e-8).build())


def _events_state(mesh, dev):
    """Roots, resets, out() and its quadrature over a sharded state:
    solve_dense with BDF and SDIRK (a reset at each crossing), BDF and ERK
    stopping at the first root, and BDF integrating the state itself."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.drivers import solve_dense

    out = {}
    for name, cls in (("bdf_reset", dtt.BdfSolver), ("sdirk_reset", dtt.SdirkSolver),
                      ("bdf_stop", dtt.BdfSolver), ("erk_stop", dtt.ErkSolver),
                      ("bdf_state_quad", dtt.BdfSolver)):
        problem = cs.events_heat1d(STATE_MGRID, name.split("_", 1)[1])
        lp, params, coords = _state_sharded(problem, EVENT_D, mesh, dev)
        sol = solve_dense(cls(lp), EVENT_T_EVAL, params=params, device=dev, max_steps=20_000)
        out[name] = dict(_solution(sol), coords=coords, final=_state_of(sol.state))
    return out


def _ensemble(make_solver, problem, t_eval, params, mode, mesh, dev, members=None, **kw):
    from diffsol_tpu_torch.ensemble import solve_dense_ensemble

    if members is not None:
        params = params[members]
    return _solution(solve_dense_ensemble(make_solver, problem, t_eval, params, mode=mode,
                                          mesh=mesh, device=None if mesh else dev, **kw))


def run_case(name: str, mesh=None, dev="cpu", scale: int = 1, members=None) -> dict:
    """Case ``name`` sharded over ``mesh`` (axis "dp"), or with ``mesh=None``
    unsharded on ``dev``, of the whole batch or of the slice ``members``
    of it (an ensemble case); numpy results.  ``scale`` multiplies the
    batch of the cases that take it (the card runs them wider)."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.models import exponential_decay as ted
    from diffsol_tpu_torch.models import heat1d, robertson
    from diffsol_tpu_torch.solvers.sdirk import SdirkSolver

    bdf = dtt.BdfSolver
    kw = {} if members is None else dict(members=members)
    if name == "decay_lockstep":  # tests/test_ensemble.py:73-87
        return _ensemble(bdf, ted.problem(rtol=1e-6, atol=1e-8), np.linspace(0.0, 1.0, 5),
                         _decay_params(32), "lockstep", mesh, dev, **kw)
    if name == "decay_sdirk_lockstep":
        return _ensemble(lambda pr: SdirkSolver(pr), ted.problem(rtol=1e-6, atol=1e-8),
                         np.linspace(0.0, 1.0, 5), _decay_params(8), "lockstep", mesh, dev, **kw)
    if name == "decay_sens_lockstep":
        pr = dataclasses.replace(ted.problem(rtol=1e-6, atol=1e-8),
                                 sens_rtol=torch.tensor(1e-6, dtype=F64),
                                 sens_atol=torch.tensor(1e-8, dtype=F64))
        return _ensemble(lambda p: bdf(p, sens=True), pr, np.linspace(0.0, 1.0, 5),
                         _decay_params(8), "lockstep", mesh, dev, **kw)
    if name == "decay_root_lockstep":
        # members close enough to cross y0 = 0.6 in one step: ROOT_FOUND
        # at member 0's polished crossing
        a = 0.1 * (1.0 + 1e-5 * np.linspace(-1.0, 1.0, 8))
        params = np.stack([a, np.ones_like(a)], axis=1)
        return _ensemble(bdf, ted.problem_with_root(rtol=1e-6, atol=1e-8),
                         np.linspace(0.0, 10.0, 6), params, "lockstep", mesh, dev, **kw)
    if name == "heat1d_lockstep":  # tests/test_ensemble.py:90-119, banded
        problem, _ = heat1d.make(12, banded=True)
        d = np.tile([1.0, 1.0, 0.5, 2.0], scale)[:, None]
        return _ensemble(bdf, problem, [0.51, 0.53], d, "lockstep", mesh, dev, **kw)
    if name == "blockdiag_lockstep":
        return _ensemble(bdf, robertson.problem_ode_groups(4), [0.4, 4.0], _rob_params(4),
                         "lockstep", mesh, dev, **kw)
    if name == "dae_lockstep":
        return _ensemble(bdf, robertson.problem_dae(), [0.4, 4.0], _rob_params(4),
                         "lockstep", mesh, dev, max_steps=20_000, **kw)
    if name == "robertson_fused":  # tests/test_pallas_stepper.py:166-194
        problem = robertson.problem_ode(rtol=1e-4, atol=(1e-8, 1e-6, 1e-6))
        return _ensemble(bdf, problem, [0.4, 4.0], _rob_params(4 * scale), "fused", mesh,
                         dev, **kw)
    if name == "heat1d_fused":
        problem, _ = heat1d.make(12, banded=True)
        d = np.tile([1.0, 1.0, 0.5, 2.0], scale)[:, None]
        return _ensemble(bdf, problem, [0.51, 0.53], d, "fused", mesh, dev, **kw)
    if name == "decay_independent":
        return _ensemble(bdf, ted.problem_with_root(rtol=1e-6, atol=1e-8),
                         np.linspace(0.0, 10.0, 6), _decay_params(8), "independent", mesh,
                         dev, **kw)
    if name == "decay_loop_independent":
        # a solver class the batched loop does not take: one solve a member
        return _ensemble(_loop_bdf(), ted.problem_with_root(rtol=1e-6, atol=1e-8),
                         np.linspace(0.0, 10.0, 6), _decay_params(8), "independent", mesh,
                         dev, **kw)
    if name in ("decay_sens_independent", "decay_sdirk_sens_independent"):
        # the rows' fields of the batched states (BDF's s and sD, the RK
        # loop's s, ds, s_prev and sdiff) gathered along their member axis
        pr = dataclasses.replace(ted.problem(rtol=1e-6, atol=1e-8),
                                 sens_rtol=torch.tensor(1e-6, dtype=F64),
                                 sens_atol=torch.tensor(1e-8, dtype=F64))
        cls = SdirkSolver if "sdirk" in name else bdf
        return _ensemble(lambda p: cls(p, sens=True), pr, np.linspace(0.0, 1.0, 5),
                         _decay_params(8), "independent", mesh, dev, **kw)
    if name == "decay_sdirk_independent":
        return _ensemble(lambda pr: SdirkSolver(pr), ted.problem(rtol=1e-6, atol=1e-8),
                         np.linspace(0.0, 1.0, 5), _decay_params(8), "independent", mesh,
                         dev, **kw)
    if name == "oscillator_grad":  # __graft_entry__.py:148-190
        from diffsol_tpu_torch.adjoint_ensemble import make_differentiable_solve_ensemble

        nb = 8
        ys_of = make_differentiable_solve_ensemble(
            _oscillator(), np.linspace(0.5, 3.0, 4), nb, max_steps=512, mesh=mesh,
            device=None if mesh else dev)
        k = np.linspace(2.5, 3.5, nb)
        pb = torch.tensor(np.stack([k, np.full(nb, 0.25)], axis=1), dtype=F64, device=dev)
        pb.requires_grad_(True)
        ys = ys_of(pb)
        ((ys - 0.5) ** 2).sum().backward()
        return dict(ys=_np(ys), grad=_np(pb.grad), forward=stats_of(ys_of.info["forward"]),
                    backward=stats_of(ys_of.info["backward"]))
    if name in ("heat1d_krylov_lockstep", "heat1d_krylov_sens_lockstep"):
        # one GMRES over every member (tests/test_torch_krylov_lockstep.py),
        # and with the sensitivity rows each row's own joint GMRES
        from diffsol_tpu_torch.ops import krylov as tk

        sens = "sens" in name
        problem = _krylov_heat1d(KRYLOV_MGRID, 1e-4, 1e-6)
        tk.reset_gmres_counts()
        out = _ensemble(lambda pr: bdf(pr, sens=sens), problem, KRYLOV_T_EVAL, KRYLOV_D,
                        "lockstep", mesh, dev, max_steps=2000, **kw)
        out["gmres"] = tk.gmres_counts()
        return out
    if name == "robertson_ind_grad":
        return _ind_grad(robertson.problem_ode(), ROB_GRAD_T_EVAL, ROB_GRAD_PARAMS, mesh, dev)
    if name == "heat1d_ind_grad":
        problem, _ = heat1d.make(HEAT_GRAD_MGRID, rtol=1e-6, atol=1e-8, banded=True)
        return _ind_grad(problem, HEAT_GRAD_T_EVAL, HEAT_GRAD_PARAMS, mesh, dev)
    if name == "heat1d_erk_state":
        return _erk_state(mesh, dev)
    if name == "state_errors":
        return _state_errors(mesh)
    if name == "implicit_state":
        return _implicit_state(mesh, dev)
    if name == "dae_state":
        return _dae_state(mesh, dev)
    if name == "events_state":
        return _events_state(mesh, dev)
    if name == "heat1d_bdf_state":  # on the card: K3/K4 on the whole members
        problem, _ = heat1d.make(CARD_STATE_MGRID, rtol=1e-6, atol=1e-8, banded=True)
        return _steps_and_solve(bdf, problem, STATE_D, STATE_T_EVAL, mesh, dev, STATE_STEPS)
    if name == "errors":
        from diffsol_tpu_torch.ensemble import solve_dense_ensemble

        out = {}
        problem = robertson.problem_ode()
        for key, kw in (("fused_uneven", dict(params_batch=_rob_params(5), mode="fused")),
                        ("lockstep_uneven", dict(params_batch=_rob_params(5))),
                        ("device", dict(params_batch=_rob_params(4), device="cuda:3"))):
            try:
                solve_dense_ensemble(bdf, problem, [0.4], mesh=mesh, **kw)
                out[key] = None
            except ValueError as e:
                out[key] = str(e)
        return out
    raise KeyError(name)


def _cases(rank, world, cases, shape, names, device):
    """One rank's body (chip_smoke.spawn_ranks): ``cases`` over a mesh of
    ``shape`` and ``names``, each with its time, its all-gathers and its
    kernel launches (K1, K2, K3, K4) counted around it.  One CPU thread a
    rank, so the ranks leave the other test workers their cores."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)  # every rank on the one card
    mesh = init_device_mesh(device, shape, mesh_dim_names=names)
    out = {}
    with cs.counted_all_gathers() as calls:
        for name, scale in cases:
            calls[0] = 0
            for w in cs.kernel_wrappers():
                w.launches = 0
            t0 = time.perf_counter()
            out[name] = run_case(name, mesh, device, scale)
            out[name + ":seconds"] = time.perf_counter() - t0
            out[name + ":all_gathers"] = calls[0]
            out[name + ":launches"] = [w.launches for w in cs.kernel_wrappers()]
    return out


def spawn(cases, out_dir, shape=(2,), names=("dp",), device="cpu", timeout=240) -> list:
    """Run ``cases`` ((name, scale) pairs) in prod(shape) gloo ranks of a
    mesh of ``shape`` and ``names``; returns each rank's {name: results}.
    Raises when a rank fails or outlives ``timeout`` seconds (then
    killed)."""
    return cs.spawn_ranks(_cases, int(np.prod(shape)), out_dir,
                          args=(list(cases), tuple(shape), tuple(names), device),
                          timeout=timeout)
