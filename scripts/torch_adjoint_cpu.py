#!/usr/bin/env python3
"""The port's adjoint gradients against forward sensitivities on the CPU.

    python scripts/torch_adjoint_cpu.py horizons [--jax]
    python scripts/torch_adjoint_cpu.py rehearsal [--nbatch B] [--heat-nbatch B] [--jax]

``horizons``: Robertson ODE (``problem_ode()``, rtol 1e-4), one instance,
loss sum ys^2 over T_EVAL_4E10 cut at 4e4, 4e6, 4e8 and 4e10: the gradient
of ``make_differentiable_solve`` against 2 sum y.s from
``solve_dense_fwd_sens`` of the same problem, relative to the largest
component, with the forward and backward steps and the backward solve's
status and Newton failures (the port's gradient is NaN when that solve
fails: the BDF's cumulative limit of 50 Newton failures, which the restart
after each output jump spends).  ``--jax`` adds the JAX
package's ``make_differentiable_solve`` on the same problem (its jit
compiles take a minute or two).

Then two probes of the 4e10 case, the port only: the same loss with zero
weight on the outputs past 4e3 (the backward pass then crosses the early
transient at sigma ~ 4e10 with lambda = 0 above 4e3), against the 4e3
horizon's gradient; and the full loss at rtol 1e-6 and 1e-8.

``rehearsal``: the gates of ``chip_smoke.py`` phase 22 at a small batch.
(a) Robertson ODE lockstep, k1 spread +-10 % (numpy seed 0, member 0
nominal, the members of the chip run's B = 10,000 at 0, 4,999 and 9,999
among them; all 10,000 at --nbatch 10000) to t = 4e6: those three
members' gradients against 2 sum y.s of their own ``solve_dense_fwd_sens``
at rtol 1e-6, and at rtol 1e-10 (the truth), the backward solve's Newton
failures, and the checkpoint_interval=32 gradient against the dense
table's (``--jax``: the JAX package's two modes on one instance).  (b)
heat1d n = 128 banded lockstep, diffusivities linspace(0.5, 2.0), rtol
1e-6, atol 1e-8: each member's gradient against 2 sum y.s from
``BdfSolver(sens=True)`` lockstep rows.  Prints steps, the worst relative
errors and the seconds each part took.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import diffsol_tpu_torch as dtt  # noqa: E402
from diffsol_tpu_torch.models import heat1d, robertson  # noqa: E402

F64 = torch.float64
HORIZONS = (4e4, 4e6, 4e8, 4e10)


def _grad(fn, params, loss):
    p = torch.as_tensor(params, dtype=F64).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(fn(p)), p)
    return g.numpy()


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def horizons(with_jax: bool):
    problem = robertson.problem_ode()
    for t_top in HORIZONS:
        te = [t for t in robertson.T_EVAL_4E10 if t <= t_top]
        t0 = time.perf_counter()
        ys_of = dtt.make_differentiable_solve(problem, te, device="cpu")
        g = _grad(ys_of, problem.params, lambda ys: (ys**2).sum())
        ys, sens = dtt.solve_dense_fwd_sens(dtt.BdfSolver(problem), te, device="cpu")
        ref = (2.0 * torch.einsum("tn,ptn->p", ys, sens)).numpy()
        b = ys_of.info["backward"]
        line = (f"t_top {t_top:g}: adjoint {g.tolist()} fwd_sens {ref.tolist()} rel "
                f"{_rel(g, ref):.3e}; steps forward {ys_of.info['forward'].steps} backward "
                f"{b.steps}, backward status {ys_of.info['backward_status']} with "
                f"{b.newton_fails} Newton failures in its accepted steps; "
                f"{time.perf_counter() - t0:.1f} s")
        if with_jax:
            import jax
            import jax.numpy as jnp

            jax.config.update("jax_enable_x64", True)
            from diffsol_tpu.adjoint import make_differentiable_solve as jax_mds
            from diffsol_tpu.models import robertson as jrob

            import diffsol_tpu as dt

            fatal = []

            class Watched(dt.BdfSolver):
                """JAX's BDF solver noting each fatal step of the backward
                solve (its status and time in sigma)."""

                def step(self, state, params=None):
                    new = super().step(state, params)
                    jax.debug.callback(
                        lambda st, s: fatal.append((int(st), float(s))) if st < 0 else None,
                        new.status, new.t)
                    return new

            jp = jrob.problem_ode()
            jys_of = jax_mds(jp, jnp.asarray(te), solver_cls=dt.BdfSolver,
                             bwd_solver_cls=Watched)
            gj = np.asarray(jax.grad(lambda pp: jnp.sum(jys_of(pp) ** 2))(jp.params))
            line += (f"; JAX {gj.tolist()} rel {_rel(gj, ref):.3e}, port vs JAX "
                     f"{_rel(g, gj):.3e}; JAX's backward solve returned a fatal status "
                     f"{len(fatal)} times" + (f", first {fatal[0][0]} at t = "
                                              f"{t_top - fatal[0][1]:g}" if fatal else ""))
        print(line, flush=True)
    te = robertson.T_EVAL_4E10
    for cut in (3, 5):  # outputs to 40 and to 4e3
        w = torch.tensor([1.0] * cut + [0.0] * (len(te) - cut), dtype=F64)[:, None]
        short = dtt.make_differentiable_solve(problem, te[:cut], device="cpu")
        g_short = _grad(short, problem.params, lambda ys: (ys**2).sum())
        full = dtt.make_differentiable_solve(problem, te, device="cpu")
        g_full = _grad(full, problem.params, lambda ys: (w * ys**2).sum())
        print(f"zero weight past {te[cut - 1]:g}, t_top 4e10 against t_top {te[cut - 1]:g}: "
              f"{g_full.tolist()} vs {g_short.tolist()}, rel {_rel(g_full, g_short):.3e}",
              flush=True)
    for rtol, atol in ((1e-6, (1e-10, 1e-8, 1e-8)), (1e-8, (1e-12, 1e-10, 1e-10))):
        tight = robertson.problem_ode(rtol=rtol, atol=atol)
        ys_of = dtt.make_differentiable_solve(tight, te, max_steps=100_000, device="cpu")
        g = _grad(ys_of, tight.params, lambda ys: (ys**2).sum())
        print(f"t_top 4e10 at rtol {rtol:g}: adjoint {g.tolist()}; steps forward "
              f"{ys_of.info['forward'].steps} backward {ys_of.info['backward'].steps}, "
              f"backward status {ys_of.info['backward_status']}", flush=True)


def robertson_params(nbatch):
    """chip_smoke.robertson_params of the chip run's 10,000 members: all of
    them for nbatch = 10,000, else the first nbatch - 2 and members 4,999
    and 9,999."""
    rng = np.random.default_rng(0)
    u = rng.uniform(-1.0, 1.0, 10_000)
    u[0] = 0.0
    idx = list(range(10_000)) if nbatch == 10_000 else list(range(nbatch - 2)) + [4_999, 9_999]
    k1 = 0.04 * (1.0 + 0.1 * u[idx])
    return np.stack([k1, np.full(nbatch, 1e4), np.full(nbatch, 3e7)], axis=1), idx


def rehearsal(nbatch: int, heat_nbatch: int, with_jax: bool):
    te = robertson.T_EVAL_4E10[:8]
    pb, idx = robertson_params(nbatch)
    problem = robertson.problem_ode()
    t0 = time.perf_counter()
    fn = dtt.make_differentiable_solve_ensemble(problem, te, nbatch, device="cpu")
    g = _grad(fn, pb, lambda ys: (ys**2).sum())
    t_lock = time.perf_counter() - t0
    bounded = dtt.make_differentiable_solve_ensemble(problem, te, nbatch, device="cpu",
                                                     checkpoint_interval=32)
    g_bnd = _grad(bounded, pb, lambda ys: (ys**2).sum())
    named = [0, idx.index(4_999), idx.index(9_999)]
    for tag, rtol, atol in (("oracle rtol 1e-6", 1e-6, (1e-10, 1e-8, 1e-8)),
                            ("truth rtol 1e-10", 1e-10, (1e-14, 1e-12, 1e-12))):
        solver = dtt.BdfSolver(dtt.make_lockstep_problem(
            robertson.problem_ode(rtol=rtol, atol=atol), len(named)))
        ys, sens = dtt.solve_dense_fwd_sens(solver, te, params=pb[named], max_steps=50_000,
                                            device="cpu")
        ref = (2.0 * torch.einsum("tbn,ptbn->bp", ys, sens)).numpy()
        errs = [_rel(g[b], ref[k]) for k, b in enumerate(named)]
        print(f"(a) Robertson ODE lockstep B={nbatch} to 4e6 vs {tag}: members "
              f"{[idx[b] for b in named]} at {[f'{e:.3e}' for e in errs]}", flush=True)
    b = fn.info["backward"]
    print(f"(a) steps forward {fn.info['forward'].steps} backward {b.steps}, Newton "
          f"{b.newton_iterations}, Newton failures {b.newton_fails}, backward status "
          f"{fn.info['backward_status']}; table {fn.info['table_bytes']} B; {t_lock:.1f} s; "
          f"checkpoint_interval=32 vs the dense table {_rel(g_bnd, g):.3e} "
          f"({bounded.info['checkpoints']} checkpoints, {bounded.info['resolve_steps']} "
          f"re-solve steps)", flush=True)
    if with_jax:
        import jax
        import jax.numpy as jnp

        jax.config.update("jax_enable_x64", True)
        from diffsol_tpu.adjoint import make_differentiable_solve as jax_mds
        from diffsol_tpu.models import robertson as jrob

        jp = jrob.problem_ode()
        grads = [np.asarray(jax.grad(lambda pp, f=f: jnp.sum(f(pp) ** 2))(jp.params))
                 for f in (jax_mds(jp, jnp.asarray(te)),
                           jax_mds(jp, jnp.asarray(te), checkpoint_interval=32))]
        print(f"(c) the JAX package, one instance (member 0), checkpoint_interval=32 vs "
              f"the dense table: {_rel(grads[1], grads[0]):.3e}", flush=True)

    problem, _ = heat1d.make(127, rtol=1e-6, atol=1e-8, banded=True)
    d = np.linspace(0.5, 2.0, heat_nbatch)[:, None]
    t_eval = [0.001, 0.01, 0.05, 0.1, 0.2]
    t0 = time.perf_counter()
    fn = dtt.make_differentiable_solve_ensemble(problem, t_eval, heat_nbatch, device="cpu")
    g = _grad(fn, d, lambda ys: (ys**2).sum())
    t_heat = time.perf_counter() - t0
    sol = dtt.solve_dense_ensemble(lambda pr: dtt.BdfSolver(pr, sens=True), problem, t_eval,
                                   d, mode="lockstep", device="cpu")
    ref = (2.0 * torch.einsum("tbn,tpbn->bp", sol.ys, sol.sens)).numpy()
    errs = np.abs(g - ref).max(axis=1) / np.abs(ref).max(axis=1)
    print(f"(b) heat1d n=128 banded lockstep B={heat_nbatch}: steps forward "
          f"{fn.info['forward'].steps} backward {fn.info['backward'].steps}, Newton "
          f"{fn.info['backward'].newton_iterations}; vs the sens=True rows worst member "
          f"{float(errs.max()):.3e} (d={float(d[int(np.argmax(errs)), 0]):.4f}); "
          f"{t_heat:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("part", choices=("horizons", "rehearsal"))
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--nbatch", type=int, default=20)
    ap.add_argument("--heat-nbatch", type=int, default=16)
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.part == "horizons":
        horizons(args.jax)
    else:
        rehearsal(args.nbatch, args.heat_nbatch, args.jax)


if __name__ == "__main__":
    main()
