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
    """What a state axis refuses: an n the axis does not divide, an
    implicit solver."""
    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch.ensemble import make_lockstep_problem
    from diffsol_tpu_torch.models import heat1d
    from diffsol_tpu_torch.sharding import StateAxis

    out = {}
    try:
        StateAxis.of(mesh, "sp", 255)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    problem, _ = heat1d.make(ERK_MGRID)
    lp = make_lockstep_problem(problem, 2, state_axis=StateAxis.of(mesh, "sp", 256))
    try:
        dtt.BdfSolver(lp)
        out["bdf"] = None
    except NotImplementedError as e:
        out["bdf"] = str(e)
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
