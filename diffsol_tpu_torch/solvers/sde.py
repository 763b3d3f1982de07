"""SDE solvers: Euler-Maruyama and Milstein (counterpart of
``diffsol_tpu.solvers.sde``).

The reference defines the stochastic operator interface (op/stoch.rs
`StochOp`, noise kinds Zero/Scalar/Diagonal/Additive found by probing) but
ships no stepper; the JAX package completes it with fixed-step schemes
over

    dy = f(t, y, p) dt + g(t, y, p) dW

and this module ports them.  The Brownian increments come from an
explicit ``torch.Generator`` on the solve's device, where the JAX package
splits a key: the two give different numbers from the same seed, so the
tests feed both packages the same increments through :func:`_em_steps` and
:func:`_milstein_steps`, which take them as arguments.  A Monte Carlo
ensemble (:func:`solve_em_ensemble`) steps every path at once, the
callables ``vmap``-ed over the paths and one (npaths, n[, m]) draw a step,
where the JAX package ``vmap``s whole solves over keys; the layouts are the
same.  Every entry point runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..drivers import resolve_device


class SdeSolution(NamedTuple):
    ts: torch.Tensor  # (nsteps + 1,); (npaths, nsteps + 1) for an ensemble
    ys: torch.Tensor  # (nsteps + 1, n); (npaths, nsteps + 1, n) for an ensemble


def _setup(y0, t0, t1, nsteps, params, generator, device, who):
    """y0 and params on the solve's device in y0's dtype (float64 unless
    y0 is a float32 tensor), the grid ts and the step h."""
    dev = resolve_device(device, who)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"{who}: the generator lies on {generator.device}, "
                         f"the solve on {dev}")
    if not isinstance(y0, torch.Tensor) or not y0.is_floating_point():
        y0 = torch.as_tensor(np.asarray(y0, np.float64))
    y0 = y0.to(dev)
    dtype = y0.dtype
    if not isinstance(params, torch.Tensor):
        params = torch.as_tensor(np.asarray(params, np.float64))
    params = params.to(dev, dtype)
    t0 = torch.as_tensor(t0, dtype=dtype, device=dev)
    t1 = torch.as_tensor(t1, dtype=dtype, device=dev)
    h = (t1 - t0) / nsteps
    ts = t0 + h * torch.arange(nsteps + 1, dtype=dtype, device=dev)
    return y0, params, ts, h


def _noise_shape(diffusion, ts, y0, params):
    """The shape of one step's increment: y's for diagonal noise (g of
    y's shape), (m,) for an (n, m) diffusion."""
    g = diffusion(ts[0], y0, params)
    return tuple(y0.shape) if g.shape == y0.shape else (int(g.shape[-1]),)


def _em_step(rhs, diffusion, t, y, dw, params, h):
    """One Euler-Maruyama step: y + h f + g dW, with g dW elementwise for
    diagonal noise and a matrix-vector product for an (n, m) diffusion;
    y may carry leading path axes when the callables act on them."""
    g = diffusion(t, y, params)
    noise = g * dw if g.shape == y.shape else (g @ dw.unsqueeze(-1)).squeeze(-1)
    return y + h * rhs(t, y, params) + noise


def _em_steps(rhs, diffusion, y0, ts, dws, params, h):
    """Euler-Maruyama over the grid ``ts`` with the increments ``dws``
    (nsteps, n) for diagonal noise or (nsteps, m) for an (n, m) diffusion,
    already scaled by sqrt(h).  Returns ys (nsteps + 1, n)."""
    ys = y0.new_empty((dws.shape[0] + 1,) + tuple(y0.shape))
    ys[0] = y0
    for k in range(dws.shape[0]):
        ys[k + 1] = _em_step(rhs, diffusion, ts[k], ys[k], dws[k], params, h)
    return ys


def _milstein_steps(rhs, diffusion, y0, ts, dws, params, h):
    """Milstein for diagonal noise over the grid ``ts`` with the
    increments ``dws`` (nsteps, *y0.shape): y + h f + g dW + 1/2 g g'
    (dW^2 - h), g g' = (dg/dy) g from one ``torch.func.jvp`` (JAX's one
    ``jax.jvp``).  Returns ys (nsteps + 1, *y0.shape)."""
    nsteps = dws.shape[0]
    ys = y0.new_empty((nsteps + 1,) + tuple(y0.shape))
    ys[0] = y0
    y = y0
    for k in range(nsteps):
        t, dw = ts[k], dws[k]
        g = diffusion(t, y, params)
        _, gg = torch.func.jvp(lambda yy: diffusion(t, yy, params), (y,), (g,))
        y = y + h * rhs(t, y, params) + g * dw + 0.5 * gg * (dw * dw - h)
        ys[k + 1] = y
    return ys


def solve_em(rhs: Callable, diffusion: Callable, y0, t0, t1, nsteps: int,
             params, generator: torch.Generator, device=None) -> SdeSolution:
    """Euler-Maruyama with ``nsteps`` fixed steps on [t0, t1].

    ``diffusion(t, y, p)`` returns (n,) for diagonal noise or (n, m) for m
    driving Wiener processes.  The increments are normal draws from
    ``generator``, which lies on the solve's device: the card unless
    ``device="cpu"``."""
    y0, params, ts, h = _setup(y0, t0, t1, nsteps, params, generator, device, "solve_em")
    shape = _noise_shape(diffusion, ts, y0, params)
    dws = torch.randn((nsteps,) + shape, generator=generator, dtype=y0.dtype,
                      device=y0.device) * torch.sqrt(h)
    return SdeSolution(ts=ts, ys=_em_steps(rhs, diffusion, y0, ts, dws, params, h))


def solve_milstein(rhs: Callable, diffusion: Callable, y0, t0, t1, nsteps: int,
                   params, generator: torch.Generator, device=None) -> SdeSolution:
    """Milstein scheme for diagonal noise (strong order 1.0), ``nsteps``
    fixed steps on [t0, t1]; ``generator`` and ``device`` as in
    :func:`solve_em`."""
    y0, params, ts, h = _setup(y0, t0, t1, nsteps, params, generator, device,
                               "solve_milstein")
    dws = torch.randn((nsteps,) + tuple(y0.shape), generator=generator, dtype=y0.dtype,
                      device=y0.device) * torch.sqrt(h)
    return SdeSolution(ts=ts, ys=_milstein_steps(rhs, diffusion, y0, ts, dws, params, h))


def solve_em_ensemble(rhs, diffusion, y0, t0, t1, nsteps, params, generator, npaths,
                      device=None) -> SdeSolution:
    """A Monte Carlo ensemble of ``npaths`` Euler-Maruyama paths from y0.

    Every path steps at once: ``rhs`` and ``diffusion`` (written for one
    path) are ``vmap``-ed over the paths, and each step draws its
    (npaths, n) (or (npaths, m)) increments in one call.  Returns ts
    (npaths, nsteps + 1) and ys (npaths, nsteps + 1, n), the layout of the
    JAX package's ``vmap`` over keys."""
    y0, params, ts, h = _setup(y0, t0, t1, nsteps, params, generator, device,
                               "solve_em_ensemble")
    shape = _noise_shape(diffusion, ts, y0, params)
    sqrt_h = torch.sqrt(h)
    over = dict(in_dims=(None, 0, None))
    rhs_b = torch.func.vmap(rhs, **over)
    diff_b = torch.func.vmap(diffusion, **over)
    yb = y0.expand((npaths,) + tuple(y0.shape)).contiguous()
    ys = yb.new_empty((nsteps + 1, npaths) + tuple(y0.shape))
    ys[0] = yb
    for k in range(nsteps):
        dw = torch.randn((npaths,) + shape, generator=generator, dtype=y0.dtype,
                         device=y0.device) * sqrt_h
        ys[k + 1] = _em_step(rhs_b, diff_b, ts[k], ys[k], dw, params, h)
    return SdeSolution(ts=ts.expand(npaths, -1), ys=ys.movedim(0, 1))


def classify_noise(diffusion: Callable, y0, params, t=0.0, device=None) -> str:
    """Noise kind (reference op/stoch.rs:6-66 `StochOpKind`): ``"zero"``,
    ``"scalar"``, ``"additive"``, ``"diagonal"`` or ``"other"``, read off
    ``torch.func.jacfwd`` of the diffusion at the JAX package's randomized
    states (``np.random.default_rng(0)``), on the card unless
    ``device="cpu"``.  A (n,) diffusion is the diagonal storage form (one
    process a state), (n, m) the general form."""
    dev = resolve_device(device, "classify_noise")
    if not isinstance(y0, torch.Tensor) or not y0.is_floating_point():
        y0 = torch.as_tensor(np.asarray(y0, np.float64))
    y0 = y0.to(dev)
    if not isinstance(params, torch.Tensor):
        params = torch.as_tensor(np.asarray(params, np.float64))
    params = params.to(dev, y0.dtype)
    n = int(y0.shape[-1])
    t = torch.as_tensor(t, dtype=y0.dtype, device=dev)
    g_shape = tuple(diffusion(t, y0, params).shape)
    diag_form = len(g_shape) == 1
    nprocess = n if diag_form else g_shape[-1]
    if nprocess == 0:
        return "zero"
    if nprocess == 1:
        return "scalar"

    rng = np.random.default_rng(0)
    dep = gpat = None  # dg/dy's and g's nonzero patterns
    y0_np = y0.cpu().numpy()
    for _ in range(2):
        y = torch.as_tensor(y0_np + rng.uniform(0.5, 1.5, size=(n,)),
                            device=dev).to(y0.dtype)
        jac = torch.func.jacfwd(lambda yy: diffusion(t, yy, params))(y).cpu().numpy()
        g = diffusion(t, y, params).cpu().numpy()
        dep = (jac != 0.0) if dep is None else (dep | (jac != 0.0))
        gpat = (g != 0.0) if gpat is None else (gpat | (g != 0.0))
    if not dep.any():
        return "additive"
    if diag_form:
        # the diagonal storage form pairs process i with state i; coupling
        # between states inside g_i does not demote the kind (stoch.rs:43-63)
        return "diagonal"
    # the matrix form is diagonal when process k drives state k alone
    if g_shape[-1] == n and not (gpat & ~np.eye(n, dtype=bool)).any():
        return "diagonal"
    return "other"
