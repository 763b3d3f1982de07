"""The port's SDE solvers (diffsol_tpu_torch.solvers.sde) against the JAX
package's: twins of the three tests of tests/test_sde.py (moments, strong
order, noise kinds), each with the port's own ``torch.Generator``, and the
schemes step for step on the JAX package's own Brownian increments
(``jax.random.split`` and ``normal``, as JAX sde.py:50-62 draws them),
within SDE_RTOL: one float64 algorithm, the same operations a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsol_tpu.solvers import sde as jsde

from diffsol_tpu_torch.solvers import sde

torch.set_num_threads(1)

SDE_RTOL = 1e-12


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def test_em_ornstein_uhlenbeck_moments():
    """OU process dX = -theta X dt + sigma dW: stationary variance
    sigma^2/(2 theta) within 10 %, mean within 0.02 (test_sde.py:11-31),
    4,096 paths stepped together."""
    theta, sigma = 1.5, 0.4

    def rhs(t, y, p):
        return -p[0] * y

    def diff(t, y, p):
        return torch.full_like(y, 1.0) * p[1]

    sols = sde.solve_em_ensemble(rhs, diff, torch.zeros(1, dtype=torch.float64), 0.0, 8.0,
                                 2000, [theta, sigma], _gen(0), 4096, device="cpu")
    assert sols.ys.shape == (4096, 2001, 1) and sols.ts.shape == (4096, 2001)
    tail = sols.ys[:, -500:, 0].numpy()
    np.testing.assert_allclose(tail.var(), sigma**2 / (2 * theta), rtol=0.1)
    assert abs(tail.mean()) < 0.02


def test_milstein_gbm_strong_order():
    """Geometric Brownian motion from the same increments as its exact
    solution: Milstein beats Euler-Maruyama and is within 0.01
    (test_sde.py:34-66).  The increments are the generator's first 400
    normal draws times sqrt(h), as solve_em and solve_milstein take them."""
    mu, sigma = 0.05, 0.5

    def rhs(t, y, p):
        return p[0] * y

    def diff(t, y, p):
        return p[1] * y

    nsteps = 400
    h = 1.0 / nsteps
    dws = torch.randn((nsteps, 1), generator=_gen(42), dtype=torch.float64) * np.sqrt(h)
    w = float(dws[:, 0].sum())
    exact_final = np.exp((mu - 0.5 * sigma**2) * 1.0 + sigma * w)
    y0 = torch.ones(1, dtype=torch.float64)
    em = sde.solve_em(rhs, diff, y0, 0.0, 1.0, nsteps, [mu, sigma], _gen(42), device="cpu")
    mil = sde.solve_milstein(rhs, diff, y0, 0.0, 1.0, nsteps, [mu, sigma], _gen(42),
                             device="cpu")
    err_em = abs(float(em.ys[-1, 0]) - exact_final)
    err_mil = abs(float(mil.ys[-1, 0]) - exact_final)
    assert err_mil < err_em
    assert err_mil < 0.01


_KINDS = {
    # name: (torch diffusion, JAX diffusion, y0, kind) as test_sde.py:69-107
    "additive": (lambda t, y, pp: torch.full_like(y, 0.3),
                 lambda t, y, pp: jnp.full_like(y, 0.3), [1.0, 2.0, 3.0], "additive"),
    "diagonal": (lambda t, y, pp: pp[0] * y, lambda t, y, pp: pp[0] * y,
                 [1.0, 2.0, 3.0], "diagonal"),
    "scalar": (lambda t, y, pp: (pp[0] * y)[:, None], lambda t, y, pp: (pp[0] * y)[:, None],
               [1.0, 2.0, 3.0], "scalar"),
    "one_state": (lambda t, y, pp: pp[0] * y, lambda t, y, pp: pp[0] * y, [1.0], "scalar"),
    "coupled_diagonal_form": (lambda t, y, pp: pp[0] * torch.roll(y, 1),
                              lambda t, y, pp: pp[0] * jnp.roll(y, 1), [1.0, 2.0, 3.0],
                              "diagonal"),
    "zero": (lambda t, y, pp: torch.zeros((3, 0), dtype=y.dtype),
             lambda t, y, pp: jnp.zeros((3, 0)), [1.0, 2.0, 3.0], "zero"),
    "matrix_diagonal": (lambda t, y, pp: torch.diag(pp[0] * y),
                        lambda t, y, pp: jnp.diag(pp[0] * y), [1.0, 2.0, 3.0], "diagonal"),
    "matrix_other": (lambda t, y, pp: pp[0] * torch.outer(y, y),
                     lambda t, y, pp: pp[0] * jnp.outer(y, y), [1.0, 2.0, 3.0], "other"),
}


@pytest.mark.parametrize("name", sorted(_KINDS))
def test_classify_noise_kinds(name):
    """The reference's StochOpKind (op/stoch.rs:6-66), the eight cases of
    test_sde.py:69-107: the port returns JAX's kind and the test's."""
    tdiff, jdiff, y0, kind = _KINDS[name]
    got = sde.classify_noise(tdiff, y0, [0.5], device="cpu")
    assert got == jsde.classify_noise(jdiff, jnp.asarray(y0), jnp.asarray([0.5])) == kind


def _ou(t, y, p):
    return -p[0] * y + jnp.sin(t) if isinstance(y, jax.Array) else -p[0] * y + torch.sin(t)


def _mult(t, y, p):
    return p[1] * y * (1.0 + 0.1 * y * y)


def _matrix(t, y, p):
    """(3, 2): two Wiener processes driving three states."""
    lib = jnp if isinstance(y, jax.Array) else torch
    return lib.stack([p[1] * y, 0.3 * lib.cos(y) + 0.1 * t], axis=-1)


@pytest.mark.parametrize("scheme,diffusion", [
    pytest.param("em", _mult, id="em_diagonal"),
    pytest.param("em", _matrix, id="em_matrix_n3_m2"),
    pytest.param("milstein", _mult, id="milstein_diagonal"),
])
def test_schemes_step_for_step_on_jax_increments(scheme, diffusion):
    """JAX's solve_em / solve_milstein with a key, and the port's stepping
    on the increments that key gives (split into nsteps keys, one normal
    draw each, times sqrt(h)): equal within 1e-12 relative."""
    nsteps, t0, t1 = 200, 0.0, 2.0
    params = np.array([0.7, 0.4])
    y0 = np.array([1.0, 0.5, -0.3])
    key = jax.random.key(7)
    jfn = jsde.solve_em if scheme == "em" else jsde.solve_milstein
    jsol = jfn(_ou, diffusion, jnp.asarray(y0), t0, t1, nsteps, jnp.asarray(params), key)
    h = (jnp.asarray(t1, jnp.float64) - jnp.asarray(t0, jnp.float64)) / nsteps
    shape = (2,) if diffusion is _matrix else y0.shape
    keys = jax.random.split(key, nsteps)
    dws = np.asarray(jnp.stack([jax.random.normal(k, shape, jnp.float64) for k in keys])
                     * jnp.sqrt(h))
    steps = sde._em_steps if scheme == "em" else sde._milstein_steps
    ts = torch.tensor(np.asarray(jsol.ts))
    ys = steps(_ou, diffusion, torch.tensor(y0), ts, torch.tensor(dws), torch.tensor(params),
               torch.tensor(float(h), dtype=torch.float64))
    jys = np.asarray(jsol.ys)
    assert ys.shape == jys.shape == (nsteps + 1, 3)
    np.testing.assert_allclose(ys.numpy(), jys, rtol=SDE_RTOL, atol=SDE_RTOL * np.abs(jys).max())
    # the public solve on the same grid: ts as JAX's
    tsol = (sde.solve_em if scheme == "em" else sde.solve_milstein)(
        _ou, diffusion, y0, t0, t1, nsteps, params, _gen(0), device="cpu")
    np.testing.assert_allclose(tsol.ts.numpy(), np.asarray(jsol.ts), rtol=1e-15)
    assert torch.isfinite(tsol.ys).all()


def test_em_ensemble_steps_every_path_at_once():
    """solve_em_ensemble draws (npaths, m) increments a step in one call
    and steps all paths with the vmapped callables: each path equals the
    single-path stepping on its own column of those draws; the layout is
    JAX's vmap over keys, ts (npaths, nsteps + 1), ys (npaths, nsteps + 1,
    n)."""
    nsteps, npaths = 50, 6
    params = np.array([0.7, 0.4])
    y0 = torch.tensor([1.0, 0.5, -0.3], dtype=torch.float64)
    sols = sde.solve_em_ensemble(_ou, _matrix, y0, 0.0, 1.0, nsteps, params, _gen(3), npaths,
                                 device="cpu")
    jsols = jsde.solve_em_ensemble(_ou, _matrix, jnp.asarray(y0.numpy()), 0.0, 1.0, nsteps,
                                   jnp.asarray(params), jax.random.key(3), npaths)
    assert sols.ys.shape == jsols.ys.shape == (npaths, nsteps + 1, 3)
    assert sols.ts.shape == jsols.ts.shape == (npaths, nsteps + 1)
    g = _gen(3)
    sqrt_h = torch.sqrt(torch.tensor(1.0 / nsteps, dtype=torch.float64))
    draws = torch.stack([torch.randn((npaths, 2), generator=g, dtype=torch.float64) * sqrt_h
                         for _ in range(nsteps)])
    for i in range(npaths):
        one = sde._em_steps(_ou, _matrix, y0, sols.ts[i], draws[:, i],
                            torch.tensor(params), torch.tensor(1.0 / nsteps, dtype=torch.float64))
        np.testing.assert_allclose(sols.ys[i].numpy(), one.numpy(), rtol=SDE_RTOL, atol=1e-14)
