"""Block-diagonal linear-solver tier: a sparsity pattern that falls apart
into small independent components, solved as a stack of dense blocks
(counterpart of ``diffsol_tpu.ops.blockdiag``; the role of the reference's
KLU for robertson_ode's ngroups layout, suitesparse/klu.rs:1-245).

* :func:`detect_blocks` finds the connected components of the pattern
  (union-find).  Components smaller than the largest are padded with
  identity rows and columns to one block size nb.
* The Jacobian is the (K, nb, nb) block stack from nb JVP probes, one per
  position within a block (columns of different blocks never share a row),
  so an n = 3,000 robertson_ode Jacobian costs 3 probes.
* The iteration matrices factor with one batched, pivoting
  ``torch.linalg.lu_factor`` over the stack; a lockstep ensemble fuses its
  member axis B with the block axis into one (B K, nb, nb) stack.  (The
  JAX package lays the blocks out batch-last, (nb, nb, K), for the TPU and
  factors them with its unrolled ``smalllu``.)
* States are gathered into block order only at the two linear-solve
  boundaries; residuals stay in natural order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..equations import DiagMass
from .linsol import LinearSolverSpec

MAX_BLOCK = 16  # beyond this, block compression loses to the banded/dense tiers


def detect_blocks(rows, cols, n):
    """Connected components of the sparsity graph: ``(perm, nb, K)``, where
    ``perm`` (K nb,) maps padded block positions to states (-1 = padding),
    ``nb`` is the padded block size and ``K`` the number of components;
    None when the pattern does not decompose (one component, or a block
    larger than MAX_BLOCK)."""
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for r, c in zip(np.asarray(rows), np.asarray(cols)):
        ra, ca = find(int(r)), find(int(c))
        if ra != ca:
            parent[ra] = ca
    comp = {}
    for i in range(n):
        comp.setdefault(find(i), []).append(i)
    comps = list(comp.values())
    if len(comps) < 2:
        return None
    nb = max(len(c) for c in comps)
    if nb > MAX_BLOCK:
        return None
    K = len(comps)
    perm = np.full((K * nb,), -1, dtype=np.int64)
    for k, members in enumerate(comps):
        perm[k * nb: k * nb + len(members)] = sorted(members)
    return perm, nb, K


class _Layout:
    """The block layout's index tensors, copied to a device once.
    ``identity``: the blocks are the states in order, unpadded (robertson_ode
    groups), so the gathers and scatters are reshapes."""

    def __init__(self, perm, nb: int, K: int):
        perm = np.asarray(perm)
        valid = perm >= 0
        self.nb, self.K = nb, K
        self.identity = bool(np.array_equal(perm, np.arange(perm.size)))
        self._host = dict(
            gather=torch.as_tensor(np.where(valid, perm, 0).reshape(K, nb)),
            vmask=torch.as_tensor(valid.reshape(K, nb)),
            scatter=torch.as_tensor(perm[valid]),
            take=torch.as_tensor(np.flatnonzero(valid)),
        )
        self._on = {}

    def on(self, device, dtype=torch.float64) -> dict:
        """The index tensors on ``device``, the identity blocks in
        ``dtype``."""
        got = self._on.get((device, dtype))
        if got is None:
            got = {k: v.to(device) for k, v in self._host.items()}
            eye = torch.eye(self.nb, dtype=dtype, device=device)
            got["eye"] = eye
            # identity on the padding's diagonal keeps the LU nonsingular
            got["pad_diag"] = torch.diag_embed((~got["vmask"]).to(dtype))
            got["pad"] = ~(got["vmask"][:, :, None] & got["vmask"][:, None, :])
            self._on[(device, dtype)] = got
        return got

    def gather(self, v, lay):
        """(..., n) states in natural order -> (..., K, nb) in block order,
        zero on the padding."""
        if self.identity:
            return v.reshape(v.shape[:-1] + (self.K, self.nb))
        return v[..., lay["gather"]] * lay["vmask"]


def make_blockdiag_jac(rhs, perm, nb: int, K: int, n: int):
    """Jacobian df/dy as the (K, nb, nb) block stack from nb probes:
    ``block[k, i, c] = (J e_c)[perm[k nb + i]]``, where seed c has a one at
    every state that is column c of its block.  It composes with
    ``torch.func.vmap`` over members."""
    perm_np = np.asarray(perm)
    seeds_np = np.zeros((nb, n))
    for c in range(nb):
        idx = perm_np[c::nb]
        seeds_np[c, idx[idx >= 0]] = 1.0
    layout = _Layout(perm, nb, K)
    seeds_host = torch.as_tensor(seeds_np)
    seeds_on = {}

    def jac(t, y, p):
        lay = layout.on(y.device, y.dtype)
        seeds = seeds_on.get((y.device, y.dtype))
        if seeds is None:
            seeds = seeds_on[(y.device, y.dtype)] = seeds_host.to(y.device, y.dtype)
        probes = torch.stack([
            torch.func.jvp(lambda yy: rhs(t, yy, p), (y,),
                           (seeds[c].expand_as(y).contiguous(),))[1]
            for c in range(nb)
        ], dim=-2)  # (..., nb, n): J @ seed_c
        if layout.identity:
            return probes.reshape(probes.shape[:-1] + (K, nb)).movedim(-3, -1)
        block = probes[..., lay["gather"]]  # (..., c, K, i)
        block = block.movedim(-3, -1)  # (..., K, i, c)
        return torch.where(lay["vmask"][:, :, None], block, 0.0)

    jac.jvp_probes = nb  # Stats.jac_mul_evals accounting
    return jac


def _spec(perm, nb: int, K: int, name: str, meta: tuple) -> LinearSolverSpec:
    """The tier's vtable.  Matrices are (..., K, nb, nb) block stacks,
    right-hand sides (..., n) states in natural order; every leading axis
    of a matrix (a lockstep ensemble's members) joins the one batched LU,
    and the leading axes a right-hand side has beyond the matrix's (the
    augmented rows) broadcast over it in the same ``lu_solve`` call."""
    layout = _Layout(perm, nb, K)

    def assemble(mass, jac, c):
        lay = layout.on(jac.device, jac.dtype)
        a = -c * jac
        if mass is None:
            a = a + lay["eye"]
        elif isinstance(mass, DiagMass):
            db = layout.gather(mass.d, lay)  # (..., K, nb)
            a = a + torch.diag_embed(db)
        else:
            # the dense mass's block entries M[perm_i, perm_j]
            g = lay["gather"]
            mb = mass[..., g[:, :, None], g[:, None, :]]  # (..., K, nb, nb)
            a = torch.where(lay["pad"], 0.0, a) + torch.where(lay["pad"], 0.0, mb)
        return a if layout.identity else a + lay["pad_diag"]

    def factor(a):
        return torch.linalg.lu_factor_ex(a.reshape(-1, nb, nb))[:2]

    def solve(factors, b):
        lay = layout.on(b.device, b.dtype)
        bb = layout.gather(b, lay)  # (..., K, nb)
        lu, piv = factors
        x = torch.linalg.lu_solve(
            lu, piv, bb.reshape(-1, lu.shape[0], nb, 1)).reshape(bb.shape)
        if layout.identity:
            return x.reshape(b.shape)
        flat = x.reshape(bb.shape[:-2] + (K * nb,))[..., lay["take"]]
        out = torch.zeros_like(b)
        out[..., lay["scatter"]] = flat
        return out

    return LinearSolverSpec(name=name, assemble=assemble, factor=factor,
                            solve=solve, meta=meta)


def make_blockdiag_solver(perm, nb: int, K: int) -> LinearSolverSpec:
    """The block tier of one problem: ``blockdiag(nb,K)``, meta ``(nb, K,
    perm)``; its Jacobian is :func:`make_blockdiag_jac`'s."""
    return _spec(perm, nb, K, f"blockdiag({nb},{K})", (nb, K, np.asarray(perm)))


def make_blockdiag_solver_lockstep(perm, nb: int, K: int, B: int) -> LinearSolverSpec:
    """The block tier of a B-member lockstep ensemble: the member axis and
    the block axis fuse into one (B K, nb, nb) LU stack (the reference's
    per-batch LU over the nbatch context, cuda/lu.rs:69-96)."""
    return _spec(perm, nb, K, f"blockdiag_lockstep({nb},{K},{B})",
                 (nb, K, np.asarray(perm), B))
