"""Banded linear-solver tier: no-pivot banded LU and colored band
Jacobians (counterpart of ``diffsol_tpu.ops.banded``).

For method-of-lines PDE systems, whose Jacobians are banded, in place of
the reference's sparse LU backends (KLU, faer sparse).

* Band storage: ``band[d, j] = A[j + d - mu, j]`` for d in [0, ml+mu], so
  ``band[mu]`` is the main diagonal.  A lockstep ensemble stacks members
  first, (B, nb, n), as the port's state is member-major (B, n).
* The Jacobian comes from ml+mu+1 structurally orthogonal JVP probes
  (cyclic coloring, the optimal coloring of a band).
* The LU does not pivot: the ``M - c*J`` matrices implicit steppers build
  from parabolic MOL operators are diagonally dominant (the reference's
  KLU pivots, which a fixed-shape band code cannot).

The JAX tier's ``kernel=`` switch (an f32 Pallas preconditioner on the
TPU, the f64 XLA loop elsewhere) collapses into one path in the problem's
dtype whose device decides, as in :mod:`.band_lu`: CUDA tensors launch
the band LU kernels (K3, K4; a float32 problem their float build), CPU
tensors run their plain versions.  The factors keep the assembled band
beside them, so forward mode (``torch.func.jvp``, as in
``solve_dense_fwd_sens``) passes through the solve.
"""

from __future__ import annotations

import numpy as np
import torch

from ..equations import DiagMass
from .band_lu import band_lu_factor, band_lu_solve
from .linsol import LinearSolverSpec


def _band_index(n: int, ml: int, mu: int):
    """Row index i = j + d - mu of band entry (d, j), clipped, and its
    validity mask, as (nb, n) numpy arrays."""
    d = np.arange(ml + mu + 1)[:, None]
    j = np.arange(n)[None, :]
    i = j + d - mu
    return np.clip(i, 0, n - 1), (i >= 0) & (i < n)


def dense_to_band(a: torch.Tensor, ml: int, mu: int) -> torch.Tensor:
    """The (..., ml+mu+1, n) band of a dense (..., n, n) matrix."""
    n = a.shape[-1]
    i_c, valid = _band_index(n, ml, mu)
    j = np.broadcast_to(np.arange(n)[None, :], i_c.shape).copy()
    band = a[..., torch.as_tensor(i_c, device=a.device), torch.as_tensor(j, device=a.device)]
    return torch.where(torch.as_tensor(valid, device=a.device), band, 0.0)


def band_to_dense(band: torch.Tensor, ml: int, mu: int) -> torch.Tensor:
    """Expand a (ml+mu+1, n) band to dense (2-D only; a test helper)."""
    n = band.shape[-1]
    out = torch.zeros((n, n), dtype=band.dtype, device=band.device)
    for d in range(ml + mu + 1):
        offset = d - mu  # row - col
        vals = band[d]
        if offset >= 0:
            out = out + torch.diag(vals[: n - offset], -offset)
        else:
            out = out + torch.diag(vals[-offset:], -offset)
    return out


def make_banded_jac(rhs, ml: int, mu: int):
    """Banded Jacobian df/dy from ml+mu+1 cyclically colored JVP probes:
    a callable (t, y, p) -> (ml+mu+1, n) band (the role of the
    reference's JacobianColoring, jacobian/mod.rs:218-260, for a band).
    It composes with ``torch.func.vmap`` over members; and where ``rhs``
    itself acts on a member-major batch y (..., n), member by member, the
    seeds are broadcast over the members and the band is (..., ml+mu+1, n)
    (the consistent-IC residual of a lockstep batch)."""
    nc = ml + mu + 1

    def jac(t, y, p):
        n = y.shape[-1]
        cols = torch.arange(n, device=y.device) % nc
        probes = torch.stack([
            torch.func.jvp(lambda yy: rhs(t, yy, p), (y,),
                           ((cols == c).to(y.dtype).expand_as(y).contiguous(),))[1]
            for c in range(nc)
        ], dim=-2)  # (..., nc, n): J @ seed_c
        # band[d, j] = (J e_{j mod nc})[j + d - mu]
        i_c, valid = _band_index(n, ml, mu)
        color = np.broadcast_to(np.arange(n)[None, :] % nc, i_c.shape).copy()
        dev = y.device
        band = probes[..., torch.as_tensor(color, device=dev),
                      torch.as_tensor(i_c, device=dev)]
        return torch.where(torch.as_tensor(valid, device=y.device), band, 0.0)

    jac.jvp_probes = nc  # Stats.jac_mul_evals accounting
    return jac


def make_banded_solver(ml: int, mu: int) -> LinearSolverSpec:
    """A :class:`LinearSolverSpec` for matrices of bandwidth (ml, mu).

    Its matrix representation through assemble/factor is the (nb, n) band,
    or (B, nb, n) for a lockstep ensemble; the equations' ``rhs_jac`` must
    produce it (the OdeBuilder installs :func:`make_banded_jac` when this
    tier is selected).  Factors are the column-leading (n+mu, nb, B) band
    of :mod:`.band_lu` and the assembled band itself, whose tangent the
    solve's forward-mode rule reads.  ``solve`` takes (n,), lockstep
    (B, n), or the augmented rows (naug, n) and (naug, B, n): the rows go
    naug-major into one (naug B, n) solve, row r against factorization r
    mod B (the JAX tier folds them into K4's lanes, banded.py:231-243).
    """
    ml, mu = int(ml), int(mu)
    if ml < 0 or mu < 0:
        raise ValueError(f"band widths must be >= 0, got ({ml}, {mu})")

    def assemble(mass, jac_band, c):
        if mass is None or isinstance(mass, DiagMass):
            # identity or diagonal mass straight onto the main-diagonal row
            diag = 1.0 if mass is None else mass.d
            m_band = torch.zeros_like(jac_band)
            m_band[..., mu, :] = diag
        else:
            # dense (n, n) or lockstep (B, n, n) blocks
            m_band = dense_to_band(mass, ml, mu)
        return m_band - c * jac_band

    def factor(a_band):
        return band_lu_factor(a_band, ml, mu)

    def solve(factors, b):
        n = b.shape[-1]
        return band_lu_solve(factors, b.reshape(-1, n), ml, mu).reshape(b.shape)

    return LinearSolverSpec(
        name=f"banded({ml},{mu})", assemble=assemble, factor=factor,
        solve=solve, meta=(ml, mu),
    )
