"""Sparse-Jacobian compression by graph coloring (counterpart of
``diffsol_tpu.ops.coloring``).

The general-sparsity companion of the banded tier: detect the Jacobian's
sparsity pattern once at set-up, color the column-conflict graph greedily
(reference crates/diffsol/src/jacobian/coloring.rs and
greedy_coloring.rs), then evaluate the full Jacobian with ``ncolors`` JVP
probes and a precomputed scatter (the reference's
``JacobianColoring::jacobian_inplace``, jacobian/mod.rs:218-260).

Where the reference detects sparsity with NaN probing, this evaluates the
Jacobian concretely at a few states around the initial one at set-up:
exact under the same assumption (a structure independent of y) and
without NaN hazards.

The greedy colorer has two implementations with identical semantics
(first fit in natural column order): the native one,
``csrc/coloring.cpp``, built with ``g++`` at first use and bound with
ctypes, which :func:`greedy_color` calls, and the pure-Python
:func:`greedy_color_reference`, its plain version.  A failed build raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

F64 = torch.float64


def greedy_color_reference(rows, cols, n_rows: int, n_cols: int):
    """Pure-Python first-fit coloring of the column-conflict graph:
    ``(colors (n_cols,) int64, ncolors)``."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if n_cols <= 0 or ((rows < 0) | (rows >= n_rows) | (cols < 0) | (cols >= n_cols)).any():
        raise ValueError("invalid sparsity pattern")
    row_cols = [[] for _ in range(n_rows)]
    for r, c in zip(rows, cols):
        row_cols[r].append(int(c))
    adj = [set() for _ in range(n_cols)]
    for rc in row_cols:
        for a in range(len(rc)):
            for b in range(a + 1, len(rc)):
                adj[rc[a]].add(rc[b])
                adj[rc[b]].add(rc[a])
    colors = np.full(n_cols, -1, dtype=np.int64)
    for c in range(n_cols):
        used = {colors[nb] for nb in adj[c] if colors[nb] >= 0}
        pick = 0
        while pick in used:
            pick += 1
        colors[c] = pick
    return colors, int(colors.max()) + 1


def greedy_color(rows, cols, n_rows: int, n_cols: int):
    """Color the column-conflict graph of a sparsity pattern with the
    native colorer: ``(colors (n_cols,) int64, ncolors)``."""
    from .._build import load_coloring

    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    lib = load_coloring()
    colors = np.empty(n_cols, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    nc = lib.diffsol_greedy_color(
        rows.ctypes.data_as(i64p), cols.ctypes.data_as(i64p), len(rows),
        n_rows, n_cols, colors.ctypes.data_as(i64p))
    if nc <= 0:
        raise ValueError("invalid sparsity pattern")
    return colors, int(nc)


def detect_sparsity(rhs, t0, y0, params, n: int):
    """Structural sparsity by concrete Jacobian evaluation: ``(rows, cols)``.

    The pattern is the union over three probes, drawn as the JAX package
    draws them (numpy seed 0): y0 itself, a small relative perturbation of
    it, which catches entries that merely vanish at y0 without leaving the
    model's physical region, and a generic absolute shift.  A probe whose
    Jacobian has non-finite entries is discarded (one NaN row would light
    the whole pattern); if every probe is, the pattern is dense.  As with
    the reference's NaN probing, input-dependent control flow can hide
    structure."""
    rng = np.random.default_rng(0)
    y0 = torch.as_tensor(y0)
    if not y0.is_floating_point():
        y0 = y0.to(F64)
    y0_np = y0.detach().cpu().numpy()
    scale = np.maximum(np.abs(y0_np), 1.0)
    candidates = [
        y0_np,
        y0_np * (1.0 + rng.uniform(-1e-3, 1e-3, size=y0_np.shape))
        + 1e-6 * scale * rng.uniform(-1.0, 1.0, size=y0_np.shape),
        y0_np + rng.uniform(0.5, 1.5, size=y0_np.shape),
    ]
    pattern = np.zeros((n, n), dtype=bool)
    any_finite = False
    for y_probe in candidates:
        jac = torch.func.jacfwd(rhs, argnums=1)(
            t0, torch.as_tensor(y_probe, device=y0.device).to(y0.dtype), params)
        jac = jac.detach().cpu().numpy()
        if not np.all(np.isfinite(jac)):
            continue
        pattern |= jac != 0.0
        any_finite = True
    if not any_finite:
        pattern[:] = True
    return np.nonzero(pattern)


def make_colored_jac(rhs, rows, cols, colors, ncolors: int, n: int):
    """Dense Jacobian from ``ncolors`` JVP probes and a precomputed gather:
    a callable (t, y, p) -> (n, n) that composes with ``torch.func.vmap``
    over members.  With ncolors << n (method-of-lines stencils) it replaces
    n jacfwd columns."""
    colors = np.asarray(colors, dtype=np.int64)
    seeds_np = np.zeros((ncolors, n))
    seeds_np[colors, np.arange(n)] = 1.0
    pattern = np.zeros((n, n), dtype=bool)
    pattern[np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64)] = True
    on = {}  # device -> (seeds, the color of each column, the pattern)

    def jac(t, y, p):
        dev = y.device
        if dev not in on:
            on[dev] = (torch.as_tensor(seeds_np, dtype=F64, device=dev),
                       torch.as_tensor(colors, device=dev),
                       torch.as_tensor(pattern, device=dev))
        seeds, color_of, mask = on[dev]
        probes = torch.stack([
            torch.func.jvp(lambda yy: rhs(t, yy, p), (y,), (seeds[c].to(y.dtype),))[1]
            for c in range(ncolors)
        ])  # (ncolors, n): J @ seed_c
        # column j is the probe of its color, on the rows of the pattern
        return torch.where(mask, probes[color_of].transpose(-1, -2), 0.0)

    jac.jvp_probes = ncolors  # Stats.jac_mul_evals accounting
    return jac


def colored_jac_for_problem(rhs, t0, y0, params):
    """Detect the pattern, color it natively and build the extractor:
    ``(jac, ncolors)``."""
    n = int(y0.shape[-1])
    rows, cols = detect_sparsity(rhs, t0, y0, params, n)
    colors, ncolors = greedy_color(rows, cols, n, n)
    return make_colored_jac(rhs, rows, cols, colors, ncolors, n), ncolors
