"""The port's matrix-free Newton-Krylov tier (ops/krylov.py) against the JAX
package: twins of the single-instance tests of tests/test_krylov.py, and
the port's GMRES against ``jax.scipy.sparse.linalg.gmres(solve_method=
"batched")``.  Inputs come from numpy seeds.  Each solve is held at the
JAX test's own tolerance against the dense or banded solve, and against
JAX's krylov solve: equal accepted steps and Newton iterations, ys within
1e-8 relative.  The sensitivity and lockstep twins are
tests/test_torch_krylov_lockstep.py.
"""

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import scipy.linalg
import torch

import diffsol_tpu as dt
from diffsol_tpu.models import heat1d as jheat
from diffsol_tpu.models import heat2d as jheat2d
from diffsol_tpu.ops import krylov as jk

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import heat1d as theat
from diffsol_tpu_torch.ops import krylov as tk

torch.set_num_threads(1)
F64 = torch.float64
TWIN_RTOL = 1e-8


def _twin(sol_t, sol_j, ys_t=None, ys_j=None):
    """Equal accepted steps and Newton iterations, ys within 1e-8."""
    assert sol_t.state.stats.steps == int(sol_j.state.stats.steps)
    assert sol_t.state.stats.newton_iterations == int(sol_j.state.stats.newton_iterations)
    ys_t = sol_t.ys.numpy() if ys_t is None else ys_t
    ys_j = np.asarray(sol_j.ys) if ys_j is None else ys_j
    np.testing.assert_allclose(ys_t, ys_j, rtol=TWIN_RTOL, atol=1e-14)


def test_tridiag_thomas_roundtrip():
    """Thomas factors and solve equal JAX's within 1e-13 (and solve the
    system), the three cyclic probes read the tridiagonal of a
    pentadiagonal operator as JAX's do, and the tridiag preconditioner's
    GMRES matches."""
    rng = np.random.default_rng(0)
    n = 40
    d = rng.uniform(2.0, 3.0, n)
    a = np.concatenate([[0.0], rng.uniform(-0.5, 0.5, n - 1)])
    c = np.concatenate([rng.uniform(-0.5, 0.5, n - 1), [0.0]])
    A = np.diag(d) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
    b = rng.standard_normal(n)
    fj = jk._thomas_factor(jnp.asarray(a), jnp.asarray(d), jnp.asarray(c))
    ft = tk._thomas_factor(torch.tensor(a), torch.tensor(d), torch.tensor(c))
    for x, y in zip(ft, fj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-13, atol=1e-15)
    xt = tk._thomas_solve(ft, torch.tensor(b)).numpy()
    np.testing.assert_allclose(xt, np.asarray(jk._thomas_solve(fj, jnp.asarray(b))),
                               rtol=1e-13)
    np.testing.assert_allclose(A @ xt, b, rtol=1e-10)
    # a pentadiagonal operator aliases into the probes identically
    P = A + np.diag(rng.uniform(-0.1, 0.1, n - 2), 2) + np.diag(rng.uniform(-0.1, 0.1, n - 2), -2)
    pj = jk._tridiag_probes(lambda v: jnp.asarray(P) @ v, n, jnp.float64)
    pt = tk._tridiag_probes(lambda v: torch.tensor(P) @ v, n, F64)
    for x, y in zip(pt, pj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-13, atol=1e-15)


def _jax_restarts(A, b, M, maxiter, **kw):
    """JAX's GMRES result and its restart count: the fewest restarts whose
    result equals the result at ``maxiter`` bit for bit (the loop stops at
    the restart test, so every larger maxiter gives the same x)."""
    xs = [np.asarray(jax.scipy.sparse.linalg.gmres(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b), M=M, maxiter=m,
        solve_method="batched", **kw)[0]) for m in range(1, maxiter + 1)]
    return xs[-1], next(m + 1 for m, x in enumerate(xs) if np.array_equal(x, xs[-1]))


@pytest.mark.parametrize("precond", ["none", "lu32"])
def test_gmres_matches_jax_batched_gmres(precond):
    """A seeded 40 x 40 non-symmetric system, restart 10, maxiter 3: the
    same restart count as JAX's batched GMRES and x within 1e-12
    relative, unpreconditioned (all three restarts) and with an f32-LU
    preconditioner (two)."""
    rng = np.random.default_rng(3)
    n = 40
    A = 2.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    Mj = Mt = None
    if precond == "lu32":
        lu = jsl.lu_factor(jnp.asarray(A, jnp.float32))

        def Mj(v):
            return jsl.lu_solve(lu, v.astype(jnp.float32)).astype(v.dtype)

        tlu, tpiv = torch.linalg.lu_factor(torch.tensor(A, dtype=torch.float32))

        def Mt(v):
            return torch.linalg.lu_solve(tlu, tpiv, v.float()[:, None])[:, 0].double()

    kw = dict(tol=1e-10, atol=0.0, restart=10)
    xj, rj = _jax_restarts(A, b, Mj, 3, **kw)
    xt, rt, arnoldi = tk.gmres(lambda v: torch.tensor(A) @ v, torch.tensor(b), M=Mt,
                               maxiter=3, **kw)
    assert rt == rj == (3 if precond == "none" else 2)
    assert int(arnoldi) == 10 * rt  # no breakdown
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-12, atol=1e-12 * np.abs(xj).max())
    # a zero right-hand side takes no restart and returns zeros
    x0, r0, _ = tk.gmres(lambda v: torch.tensor(A) @ v, torch.zeros(n, dtype=F64), **kw)
    assert r0 == 0 and not x0.any()


def test_krylov_heat1d_matches_dense():
    """Stiff MOL diffusion (heat1d, n = 32) through ``krylov(lu32)`` matches
    the dense-LU solve (rtol 1e-4, atol 1e-8) and JAX's krylov solve."""
    ref, _ = jheat.make(mgrid=31)
    jkry = (dt.OdeBuilder().rhs(ref.eqn.rhs).init(ref.eqn.init)
            .p(np.asarray(ref.params)).rtol(1e-6).atol(1e-8).linear_solver("krylov").build())
    tp, _ = theat.make(31, rtol=1e-6, atol=1e-8)
    kry = (dtt.OdeBuilder().rhs(tp.eqn.rhs).init(tp.eqn.init).p([1.0])
           .rtol(1e-6).atol(1e-8).linear_solver("krylov").build())
    assert kry.linear_solver.name == jkry.linear_solver.name == "krylov(lu32)"
    # the colored preconditioner extractor, as JAX's builder picks it
    assert kry.linear_solver.meta[4] is not None and jkry.linear_solver.meta[4] is not None
    assert kry.eqn.rhs_jac.jvp_probes == 0
    te = [0.05, 0.1]
    sol = dtt.solve_dense(dtt.BdfSolver(kry), te, max_steps=2000, device="cpu")
    assert sol.stop_reason >= 0
    dense = dtt.solve_dense(dtt.BdfSolver(tp), te, max_steps=2000, device="cpu")
    np.testing.assert_allclose(sol.ys.numpy(), dense.ys.numpy(), rtol=1e-4, atol=1e-8)
    jsol = dt.solve_dense(dt.BdfSolver(jkry), jnp.asarray(te), max_steps=2000)
    _twin(sol, jsol)


def _coupled(lib, n, C):
    def rhs(t, y, p):
        roll = jnp.roll if lib is jnp else torch.roll
        lap = roll(y, 1) - 2.0 * y + roll(y, -1)
        return p[0] * lap * (n * n) + C @ y

    def init(t, p):
        if lib is jnp:
            x = jnp.linspace(0.0, 1.0, n)
            return jnp.sin(2.0 * jnp.pi * x) + 0.5
        x = torch.linspace(0.0, 1.0, n, dtype=F64, device=p.device)
        return torch.sin(2.0 * torch.pi * x) + 0.5

    return rhs, init


def test_krylov_handles_nondiagonal_coupling():
    """Diffusion plus a weak dense global coupling (n = 24): krylov
    matches the dense solve (rtol 1e-5, atol 1e-9) and JAX's krylov."""
    n = 24
    C = np.random.default_rng(1).uniform(-0.02, 0.02, (n, n))
    te = [0.02, 0.05]
    sols = {}
    for ls in (True, False):
        rhs, init = _coupled(torch, n, torch.tensor(C))
        b = dtt.OdeBuilder().rhs(rhs).init(init).p([0.05]).rtol(1e-7).atol(1e-9)
        if ls:
            b = b.linear_solver("krylov")
        sols[ls] = dtt.solve_dense(dtt.BdfSolver(b.build()), te, max_steps=2000, device="cpu")
    assert sols[True].stop_reason >= 0
    np.testing.assert_allclose(sols[True].ys.numpy(), sols[False].ys.numpy(),
                               rtol=1e-5, atol=1e-9)
    rhs, init = _coupled(jnp, n, jnp.asarray(C))
    jkry = (dt.OdeBuilder().rhs(rhs).init(init).p([0.05]).rtol(1e-7).atol(1e-9)
            .linear_solver("krylov").build())
    _twin(sols[True], dt.solve_dense(dt.BdfSolver(jkry), jnp.asarray(te), max_steps=2000))


def test_auto_route_large_unstructured_to_krylov():
    """use_coloring on a dense n = 300 pattern keeps the dense tier off a
    TPU, as JAX's builder does on the CPU (and the port on the card); the
    explicit krylov solve meets expm within 1e-4 and JAX's krylov solve."""
    n = 300
    C = np.random.default_rng(2).uniform(-0.01, 0.01, (n, n))
    Ct = torch.tensor(C)

    def build(lib_builder, rhs, init, ls):
        b = lib_builder().rhs(rhs).init(init).p([1.0]).rtol(1e-6).atol(1e-8)
        return (b.linear_solver("krylov") if ls else b.use_coloring()).build()

    trhs = lambda t, y, p: -p[0] * y + Ct @ y  # noqa: E731
    tinit = lambda t, p: torch.ones(n, dtype=F64, device=p.device)  # noqa: E731
    auto = build(dtt.OdeBuilder, trhs, tinit, False)
    assert auto.linear_solver.name == "dense"
    jC = jnp.asarray(C)
    jauto = build(dt.OdeBuilder, lambda t, y, p: -p[0] * y + jC @ y,
                  lambda t, p: jnp.ones((n,)), False)
    assert jauto.linear_solver.name == "dense"
    kry = build(dtt.OdeBuilder, trhs, tinit, True)
    assert kry.linear_solver.name == "krylov(lu32)"
    assert kry.linear_solver.meta[4] is None  # ncolors = n: jacfwd
    te = [0.5, 1.0]
    sol = dtt.solve_dense(dtt.BdfSolver(kry), te, max_steps=2000, device="cpu")
    assert sol.stop_reason >= 0
    y1 = scipy.linalg.expm((C - np.eye(n)) * 1.0) @ np.ones(n)
    np.testing.assert_allclose(sol.ys[1].numpy(), y1, rtol=1e-4, atol=1e-7)
    jkry = build(dt.OdeBuilder, lambda t, y, p: -p[0] * y + jC @ y,
                 lambda t, p: jnp.ones((n,)), True)
    _twin(sol, dt.solve_dense(dt.BdfSolver(jkry), jnp.asarray(te), max_steps=2000))


def test_krylov_dae_diag_mass_heat2d():
    """The singular-diagonal-mass heat2d DAE (n = 100) through krylov(lu32):
    the DiagMass operator branch and the matrix-free consistent ICs; the
    trajectory meets the banded solve (rtol 1e-3, atol 1e-6) and JAX's
    krylov solve.  The problem crosses over by ``problem_from_jax``, which
    carries the krylov spec by its meta."""
    ref = jheat2d.make(mgrid=10)
    jkry = (dt.OdeBuilder().rhs(ref.eqn.rhs).init(ref.eqn.init).mass(ref.eqn.mass)
            .p(np.asarray(ref.params)).rtol(1e-5).atol(1e-5).linear_solver("krylov").build())
    kry = problem_from_jax(jkry, model="heat2d")
    assert kry.linear_solver.name == "krylov(lu32)"
    assert kry.linear_solver.meta[:4] == jkry.linear_solver.meta[:4]
    assert kry.eqn.mass_diag_fn is not None
    band = problem_from_jax(ref, model="heat2d")
    te = [0.01, 0.1]
    sol = dtt.solve_dense(dtt.BdfSolver(kry), te, max_steps=2000, device="cpu")
    assert sol.stop_reason >= 0
    solb = dtt.solve_dense(dtt.BdfSolver(band), te, max_steps=2000, device="cpu")
    np.testing.assert_allclose(sol.ys.numpy(), solb.ys.numpy(), rtol=1e-3, atol=1e-6)
    _twin(sol, dt.solve_dense(dt.BdfSolver(jkry), jnp.asarray(te), max_steps=2000))
