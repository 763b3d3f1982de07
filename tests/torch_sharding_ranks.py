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
