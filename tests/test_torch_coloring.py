"""Sparsity detection, greedy coloring and ``OdeBuilder.use_coloring``: the
port against the JAX package (tests/test_coloring.py).

The native colorer (the port's own ``csrc/coloring.cpp``, built with g++
at first use) is held equal to its plain version (the pure-Python greedy)
and to the JAX package's colorer on sparsity patterns from numpy seeds;
``detect_sparsity`` and the colored Jacobian are compared with JAX's on
the same problems; and ``build`` routes a narrow band to the banded
tier exactly as the JAX OdeBuilder does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsol_tpu as dt
from diffsol_tpu.ops import coloring as jcol

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import _build
from diffsol_tpu_torch.interop import problem_from_jax
from diffsol_tpu_torch.models import heat1d as theat
from diffsol_tpu_torch.ops.blockdiag import detect_blocks
from diffsol_tpu_torch.ops import coloring as tcol

torch.set_num_threads(1)
F64 = torch.float64


def _pattern(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        n = 40
        pat = rng.random((n, n)) < 0.08
    elif kind == "banded":
        n = 50
        i, j = np.indices((n, n))
        pat = (np.abs(i - j) <= 3) & (rng.random((n, n)) < 0.9)
    elif kind == "blocks":
        n = 12
        pat = np.kron(np.eye(4, dtype=bool), np.ones((3, 3), dtype=bool))
    else:  # an arrow: a dense first row and column
        n = 15
        pat = np.eye(n, dtype=bool)
        pat[0, :] = pat[:, 0] = True
    np.fill_diagonal(pat, True)
    rows, cols = np.nonzero(pat)
    return rows, cols, n


@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 1), ("banded", 2),
                                       ("blocks", 3), ("arrow", 4)])
def test_greedy_color_native_equals_python_equals_jax(kind, seed):
    rows, cols, n = _pattern(kind, seed)
    colors, nc = tcol.greedy_color(rows, cols, n, n)
    colors_p, nc_p = tcol.greedy_color_reference(rows, cols, n, n)
    colors_j, nc_j = jcol.greedy_color(rows, cols, n, n)
    assert nc == nc_p == nc_j
    assert colors.tolist() == colors_p.tolist() == np.asarray(colors_j).tolist()
    # a valid coloring: the columns of a row all differ
    for r in range(n):
        cs = colors[cols[rows == r]]
        assert len(cs) == len(set(cs.tolist()))
    assert nc == {"blocks": 3, "arrow": n}.get(kind, nc)


def test_native_colorer_is_built_from_the_ports_source_and_refuses_bad_input():
    lib = _build.load_coloring()
    assert lib is _build.load_coloring()  # loaded once
    built = list(_build.BUILD_DIR.glob("coloring_*.so"))
    assert built and (_build.CSRC / "coloring.cpp").exists()
    with pytest.raises(ValueError, match="invalid"):
        tcol.greedy_color(np.array([5]), np.array([0]), 3, 3)
    with pytest.raises(ValueError, match="invalid"):
        tcol.greedy_color_reference(np.array([5]), np.array([0]), 3, 3)


def _groups_rhs(lib, ngroups):
    """ngroups independent Robertson systems side by side
    (models/misc.robertson_ode_groups)."""
    def rhs(t, y, p):
        u = y.reshape(ngroups, 3)
        x, yy, z = u[:, 0], u[:, 1], u[:, 2]
        d0 = -p[0] * x + p[1] * yy * z
        d2 = p[2] * yy * yy
        return lib.stack([d0, -d0 - d2, d2], 1).reshape(-1)
    return rhs


def test_detect_sparsity_and_colored_jac_match_jax():
    """The same three probes (numpy seed 0) give the same pattern, and the
    colored Jacobian equals ``jacfwd`` and JAX's colored Jacobian."""
    ng = 4
    p = np.array([0.04, 1e4, 3e7])
    y0 = np.tile(np.array([1.0, 0.0, 0.0]), ng)
    jr = _groups_rhs(jnp, ng)
    tr = _groups_rhs(torch, ng)
    rows_j, cols_j = jcol.detect_sparsity(jr, jnp.asarray(0.0), jnp.asarray(y0),
                                          jnp.asarray(p), 3 * ng)
    t0 = torch.tensor(0.0, dtype=F64)
    rows, cols = tcol.detect_sparsity(tr, t0, torch.tensor(y0), torch.tensor(p), 3 * ng)
    assert rows.tolist() == np.asarray(rows_j).tolist()
    assert cols.tolist() == np.asarray(cols_j).tolist()
    assert detect_blocks(rows, cols, 3 * ng) is not None
    jac, ncolors = tcol.colored_jac_for_problem(tr, t0, torch.tensor(y0), torch.tensor(p))
    jac_j, ncolors_j = jcol.colored_jac_for_problem(jr, jnp.asarray(0.0), jnp.asarray(y0),
                                                    jnp.asarray(p))
    assert ncolors == ncolors_j == 3 and jac.jvp_probes == 3
    y = y0 + 0.1 + 0.01 * np.random.default_rng(5).uniform(size=3 * ng)
    got = jac(t0, torch.tensor(y), torch.tensor(p))
    dense = torch.func.jacfwd(tr, argnums=1)(t0, torch.tensor(y), torch.tensor(p))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(jac_j(jnp.asarray(0.0), jnp.asarray(y),
                                                            jnp.asarray(p))), rtol=1e-12)
    # it composes with vmap over members, as the lockstep ensemble needs
    ys = torch.tensor(np.stack([y, 1.1 * y]))
    both = torch.func.vmap(jac, in_dims=(None, 0, None))(t0, ys, torch.tensor(p))
    np.testing.assert_allclose(both[0].numpy(), dense.numpy(), rtol=1e-12)


def test_use_coloring_routes_a_narrow_band_to_the_banded_tier_as_jax_does():
    """heat1d with ``use_coloring``: both builders detect the tridiagonal
    pattern and route to banded(1, 1); the solves agree to 1e-6; and a JAX
    problem routed this way arrives in the port with that band."""
    n, h = 16, 1.0 / 17

    def jrhs(t, y, p):
        z = jnp.zeros_like(y[:1])
        return p[0] * (jnp.concatenate([z, y[:-1]]) - 2.0 * y
                       + jnp.concatenate([y[1:], z])) / (h * h)

    def trhs(t, y, p):
        z = torch.zeros_like(y[:1])
        return p[0] * (torch.cat([z, y[:-1]]) - 2.0 * y + torch.cat([y[1:], z])) / (h * h)

    x = (np.arange(n) + 1.0) * h
    u0 = 4.0 * x * (1.0 - x)
    jp = (dt.OdeBuilder().rhs(jrhs).init(lambda t, p: jnp.asarray(u0)).p([1.0])
          .rtol(1e-6).atol(1e-8).use_coloring().build())
    tp = (dtt.OdeBuilder().rhs(trhs).init(lambda t, p: torch.tensor(u0)).p([1.0])
          .rtol(1e-6).atol(1e-8).use_coloring().build())
    assert jp.linear_solver.name.startswith("banded")
    assert tuple(jp.linear_solver.meta[:2]) == tuple(tp.linear_solver.meta) == (1, 1)
    assert tp.eqn.rhs_jac.jvp_probes == 3
    carried = problem_from_jax(jp, trhs, lambda t, p: torch.tensor(u0))
    assert carried.linear_solver.name == tp.linear_solver.name == "banded(1,1)"
    te = [0.02, 0.1]
    ref = dt.solve_dense(dt.BdfSolver(jp), jnp.asarray(te))
    sol = dtt.solve_dense(dtt.BdfSolver(tp), te, device="cpu")
    assert sol.stop_reason == dtt.errors.TSTOP_REACHED
    # the JAX band tier here is its f32-preconditioned one: solver tolerance
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), rtol=5e-4, atol=1e-6)
    plain = dtt.solve_dense(dtt.BdfSolver(
        dtt.OdeBuilder().rhs(trhs).init(lambda t, p: torch.tensor(u0)).p([1.0])
        .rtol(1e-6).atol(1e-8).build()), te, device="cpu")
    np.testing.assert_allclose(sol.ys.numpy(), plain.ys.numpy(), rtol=1e-6, atol=1e-9)


def test_use_coloring_keeps_a_wide_pattern_dense_and_colored():
    """An arrow pattern (dense first row and column) is no narrow band and
    no set of blocks: the Jacobian stays dense, evaluated from colored
    probes, in both packages, and the solves agree."""
    n = 10

    def jrhs(t, y, p):
        return -y + p[0] * y[0] + jnp.concatenate([jnp.sum(y)[None], jnp.zeros(n - 1)])

    def trhs(t, y, p):
        return -y + p[0] * y[0] + torch.cat([y.sum().reshape(1),
                                             torch.zeros(n - 1, dtype=y.dtype)])

    u0 = np.arange(1.0, n + 1.0)
    jp = (dt.OdeBuilder().rhs(jrhs).init(lambda t, p: jnp.asarray(u0)).p([0.5])
          .use_coloring().build())
    tp = (dtt.OdeBuilder().rhs(trhs).init(lambda t, p: torch.tensor(u0)).p([0.5])
          .use_coloring().build())
    assert jp.linear_solver.name == tp.linear_solver.name == "dense"
    assert tp.eqn.rhs_jac.jvp_probes == jp.eqn.rhs_jac.jvp_probes == n
    carried = problem_from_jax(jp, trhs, lambda t, p: torch.tensor(u0))
    assert carried.eqn.rhs_jac is not None and carried.eqn.rhs_jac.jvp_probes == n
    y, t = torch.tensor(u0) * 0.3, torch.tensor(0.0, dtype=F64)
    np.testing.assert_allclose(
        tp.eqn.rhs_jac(t, y, tp.params).numpy(),
        torch.func.jacfwd(trhs, argnums=1)(t, y, tp.params).numpy(), rtol=1e-13)
    te = [0.1, 0.5]
    ref = dt.solve_dense(dt.BdfSolver(jp), jnp.asarray(te))
    sol = dtt.solve_dense(dtt.BdfSolver(tp), te, device="cpu")
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), rtol=1e-6)


def test_use_coloring_names_the_tiers_that_are_not_ported():
    """Independent blocks go to the block-diagonal tier, as in the JAX
    OdeBuilder; ``"krylov"`` builds the matrix-free tier, ``krylov(lu32)``,
    whose preconditioner takes the colored extractor where coloring pays,
    as in the JAX OdeBuilder (once the last tier the port lacked)."""
    tr = _groups_rhs(torch, 4)
    b = (dtt.OdeBuilder().rhs(tr)
         .init(lambda t, p: torch.tensor(np.tile([1.0, 0.0, 0.0], 4)))
         .p([0.04, 1e4, 3e7]).use_coloring())
    assert b.build().linear_solver.name == "blockdiag(3,4)"
    kry = (dtt.OdeBuilder().rhs(tr)
           .init(lambda t, p: torch.tensor(np.tile([1.0, 0.0, 0.0], 4)))
           .p([0.04, 1e4, 3e7]).linear_solver("krylov").use_coloring().build())
    assert kry.linear_solver.name == "krylov(lu32)"
    jac_fn = kry.linear_solver.meta[4]
    assert jac_fn is not None and jac_fn.jvp_probes == 3  # 3 colors < max(12 // 2, 8)
    y = torch.tensor(np.tile([1.0, 2e-5, 1e-4], 4))
    t = torch.tensor(0.0, dtype=F64)
    np.testing.assert_allclose(
        jac_fn(t, y, kry.params).numpy(),
        torch.func.jacfwd(tr, argnums=1)(t, y, kry.params).numpy(), rtol=1e-13)
    with pytest.raises(TypeError, match="krylov"):
        dtt.OdeBuilder().linear_solver("lu")
    # an explicit banded solver wins over use_coloring, as in the JAX OdeBuilder
    pr, _ = theat.make(7, banded=True)
    again = (dtt.OdeBuilder().rhs(pr.eqn.rhs).init(pr.eqn.init).p([1.0])
             .linear_solver(pr.linear_solver).use_coloring().build())
    assert again.linear_solver.name == "banded(1,1)"
