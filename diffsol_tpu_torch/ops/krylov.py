"""Matrix-free Newton-Krylov linear-solver tier (counterpart of
``diffsol_tpu.ops.krylov``).

The iteration matrix ``A = M - c*J`` is never formed: GMRES solves
``A x = b`` with the operator applied as

    A v = mass_mul(v) - c * jvp(rhs, y)(v)

one rhs JVP (``torch.func.jvp``) an Arnoldi iteration.  The tier's
"factorization" is the frozen linearization point (t, y, p, c) plus a
preconditioner: ``"lu32"`` (the default), a float32 LU of the exact
``M - cJ`` whose Jacobian comes from the colored-probe extractor when the
builder found one and from ``torch.func.jacfwd`` otherwise (the JAX package
computes this LU outside any Pallas kernel too); ``"tridiag"``, the Thomas
factorization of the tridiagonal part read off three cyclic probes; or
``"none"``.

:func:`gmres` is the algorithm of ``jax.scipy.sparse.linalg.gmres`` with
``solve_method="batched"``: restarts of a full Arnoldi process (classical
Gram-Schmidt, a breakdown test against ``eps * |v|``), the small
least-squares problem by its normal equations and a Cholesky factor, and
the restart test on the preconditioned residual against
``max(tol * |b|, atol)``.  The Arnoldi loop never leaves early on the
host: a breakdown is a flag that masks the rows of H that follow, as JAX's
``while_loop`` leaves them.  So a GMRES call reads the device once before
its first restart and once after each.  The algorithm is written once,
over a (B, n) batch of independent systems (:func:`gmres_batched`: each
member its own norms, breakdown flag, restart test and counts, as JAX's
batched GMRES under ``vmap``; a member that is done is frozen while the
others go on, and the batch still reads the device once a restart round);
every reduction runs along a member's own row, so the single solve
(:func:`gmres`, a batch of one) and any member of a batch take the same
arithmetic.

A lockstep ensemble (:func:`make_krylov_solver_lockstep`) runs ONE GMRES
over the joint B*n system with joint norms, as the JAX package does, here
on the member-major (B, n) state; its float32 LU stack (B, n, n) is the
preconditioner.  Sharded over a mesh (``axis``, a
:class:`~diffsol_tpu_torch.sharding.MemberAxis`), the rank's (B_local, n)
block is its part of that joint vector: every dot product and norm is the
sum of the ranks' partial sums (``axis.sum``; the norm before
orthogonalization and the Gram-Schmidt dots in one collective, the norm
after it in another), so H, the least-squares solve and the restart test
are the same on every rank, while the operator and the preconditioner act
on the rank's own members.  An independent ensemble
(:func:`make_krylov_solver_independent`) gives every member its own frozen
point, preconditioner and GMRES.  Augmented rows (``(naug, n)``,
``(naug, B, n)``) each get their own GMRES, as JAX's ``vmap`` of a
``while_loop`` gives them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..equations import DiagMass
from .linsol import LinearSolverSpec

F32 = torch.float32

# what the GMRES calls of this process did: calls, host reads, and
# the restarts and Arnoldi iterations of every member (a count on each
# device, read at read time)
_COUNTS = {"calls": 0, "restarts": {}, "host_reads": 0, "arnoldi": {}}


def reset_gmres_counts() -> None:
    _COUNTS.update(calls=0, restarts={}, host_reads=0, arnoldi={})


def gmres_counts() -> dict:
    """GMRES calls, restarts, host reads and Arnoldi iterations since the
    last :func:`reset_gmres_counts` (the restarts and Arnoldi iterations
    summed over every member of a batched call; a device read)."""
    return dict(calls=_COUNTS["calls"], host_reads=_COUNTS["host_reads"],
                **{k: sum(int(a) for a in _COUNTS[k].values())
                   for k in ("restarts", "arnoldi")})


# ---- the tridiagonal preconditioner ---------------------------------------


def _tridiag_probes(op, n, dtype, device=None, batch=()):
    """The tridiagonal part of a linear operator from 3 cyclic probes:
    ``(a_sub, d_main, c_sup)``, band[d, j] = (A e_{j mod 3})[j + d - 1];
    ``batch`` leading member axes, each member's operator probed at once."""
    idx = torch.arange(n, device=device)
    probes = torch.stack([op((idx % 3 == c).to(dtype).expand(batch + (n,)))
                          for c in range(3)], dim=-2)  # (*batch, 3, n)
    zero = probes.new_zeros(batch + (1,))
    dmain = probes[..., idx % 3, idx]
    a_sub = torch.cat([zero, probes[..., idx[:-1] % 3, idx[1:]]], -1)  # A[j, j-1]
    c_sup = torch.cat([probes[..., idx[1:] % 3, idx[:-1]], zero], -1)  # A[j, j+1]
    return a_sub, dmain, c_sup


def _thomas_factor(a, d, c):
    """No-pivot LU of a tridiagonal system (the last axis; leading axes are
    members), ``(w, dd, c)``; pivots below 1e-30 become 1 (the tridiagonal
    is only ever a preconditioner)."""
    w, dd = [torch.zeros_like(d[..., 0])], [d[..., 0]]
    for j in range(1, d.shape[-1]):
        wj = a[..., j] / dd[-1]
        dn = d[..., j] - wj * c[..., j - 1]
        dd.append(torch.where(dn.abs() < 1e-30, torch.ones_like(dn), dn))
        w.append(wj)
    return torch.stack(w, -1), torch.stack(dd, -1), c


def _thomas_solve(factors, b):
    w, dd, c = factors
    n = b.shape[-1]
    y = [b[..., 0]]
    for j in range(1, n):
        y.append(b[..., j] - w[..., j] * y[-1])
    x = [y[-1] / dd[..., -1]]
    for j in range(n - 2, -1, -1):
        x.append((y[j] - c[..., j] * x[-1]) / dd[..., j])
    return torch.stack(x[::-1], -1)


# ---- GMRES -----------------------------------------------------------------
#
# One algorithm over a (B, n) batch of independent systems, each member with
# its own norms, breakdown flag, restart test and counts (JAX's batched GMRES
# under ``vmap``).  Every reduction runs along a member's own row (a sum over
# its last axis, or over its basis vectors), so a member's arithmetic does not
# depend on the batch around it: the single solve is the batch of one.


def _norm(x, axis=None):
    """Each row's 2-norm, (B,); over a mesh ``axis`` each row is the rank's
    block of one joint row, its squares summed over the ranks."""
    s = torch.sum(x * x, dim=-1)
    return torch.sqrt(s if axis is None else axis.sum(s))


def _safe_normalize(x, thresh=None, axis=None, norm=None):
    """``(x / |x|, |x|)`` row by row, or zeros where |x| <= thresh (the
    dtype's eps by default), as JAX's ``_safe_normalize``; ``norm`` is
    |x| where the caller has it."""
    if norm is None:
        norm = _norm(x, axis)
    if thresh is None:
        thresh = torch.finfo(norm.dtype).eps
    use = norm > thresh
    return (torch.where(use[:, None], x / torch.where(use, norm, 1.0)[:, None], 0.0),
            torch.where(use, norm, 0.0))


def _gmres_restart(A, M, b, x0, unit_residual, residual_norm, restart, axis=None):
    """One restart of batched GMRES (JAX ``_gmres_batched``) for every
    member: ``restart`` Arnoldi iterations, the rows after a member's
    breakdown left as the identity's, then the projected solution.  Returns
    ``(x, unit_residual, residual_norm, arnoldi)``, each a member's; over a
    mesh ``axis`` each row is the rank's block of one joint row."""
    B = b.shape[0]
    eps = torch.finfo(b.dtype).eps
    eye = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    V = b.new_zeros((B, restart + 1) + b.shape[1:])
    V[:, 0] = unit_residual
    H = b.new_zeros((B, restart, restart + 1))
    broken = torch.zeros(B, dtype=torch.bool, device=b.device)
    arnoldi = torch.zeros(B, dtype=torch.int64, device=b.device)
    for k in range(restart):
        v = M(A(V[:, k]))
        # classical Gram-Schmidt; JAX's second pass never runs (its loop
        # test k < max_iterations - 1 fails after the first)
        Q = V[:, :k + 1]
        if axis is None:
            _, v_norm_0 = _safe_normalize(v)
            h = torch.sum(Q * v[:, None], dim=-1)  # (B, k + 1)
        else:
            # |v|^2 and the dots in one collective
            s = axis.sum(torch.cat([torch.sum(v * v, dim=-1)[:, None],
                                    torch.sum(Q * v[:, None], dim=-1)], -1))
            _, v_norm_0 = _safe_normalize(v, norm=torch.sqrt(s[:, 0]))
            h = s[:, 1:]
        v = v - torch.sum(h[..., None] * Q, dim=1)
        unit_v, v_norm_1 = _safe_normalize(v, eps * v_norm_0, axis)
        V[:, k + 1] = unit_v
        row = torch.cat([h, v_norm_1[:, None], h.new_zeros((B, restart - k - 1))], -1)
        H[:, k] = torch.where(broken[:, None], eye[k], row)
        arnoldi = arnoldi + (~broken).to(torch.int64)
        broken = broken | (v_norm_1 == 0.0)
    # least squares min |H^T y - beta e_0| by the normal equations (JAX's
    # _lstsq, assume_a='pos')
    a2 = torch.sum(H[:, :, None, :] * H[:, None, :, :], dim=-1)
    b2 = H[:, :, 0] * residual_norm[:, None]
    L = torch.linalg.cholesky_ex(a2)[0]
    z = torch.linalg.solve_triangular(L, b2[..., None], upper=False)
    y = torch.linalg.solve_triangular(L.transpose(-1, -2), z, upper=True)[..., 0]
    x = x0 + torch.sum(y[..., None] * V[:, :-1], dim=1)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)), axis=axis)
    return x, unit_residual, residual_norm, arnoldi


def _count(key, x):
    dev = x.device
    _COUNTS[key][dev] = _COUNTS[key].get(dev, 0) + x.sum()


def gmres_batched(op, b, *, tol=1e-5, atol=0.0, restart=20, maxiter=None, M=None,
                  active=None, counts=None, axis=None):
    """Solve ``op(x) = b`` for every member of a (B, n) batch by restarted
    GMRES from x0 = 0, each member on its own (the algorithm of
    ``jax.scipy.sparse.linalg.gmres(solve_method="batched")`` under
    ``vmap``): a member restarts while its preconditioned residual
    |M(b - A x)| exceeds ``max(tol |b|, atol)`` and it has taken fewer than
    ``maxiter`` restarts (default 10 n) of ``min(restart, n)`` Arnoldi
    iterations, and is frozen once done.  ``op`` and ``M`` act on (B, n)
    row by row.  Members outside ``active`` (a (B,) mask) take no restart
    and return zeros.  The device is read once before the first restart
    and once after each, whatever B.  Returns ``(x, restarts, arnoldi,
    rounds)``: the (B,) restarts and Arnoldi iterations before breakdown
    of each member, and the restart rounds; ``counts`` (a dict) adds the
    two (B,) counts to its ``"restarts"`` and ``"arnoldi"``.  Over a mesh
    ``axis`` each row of ``b`` is the rank's block of one joint row of
    ``axis.count`` equal blocks, and every rank takes the same restarts."""
    B, n = b.shape
    if axis is not None:
        n *= axis.count
    maxiter = 10 * n if maxiter is None else maxiter
    restart = min(restart, n)
    Mf = (lambda v: v) if M is None else M
    atol_t = torch.clamp(tol * _norm(b, axis), min=atol)
    x = torch.zeros_like(b)
    unit, rnorm = _safe_normalize(Mf(b - op(x)), axis=axis)
    go = rnorm > atol_t
    if active is not None:
        go = go & active
    restarts = torch.zeros(B, dtype=torch.int64, device=b.device)
    arnoldi = torch.zeros_like(restarts)
    rounds = 0
    _COUNTS["calls"] += 1
    while rounds < maxiter:
        _COUNTS["host_reads"] += 1
        if not bool(go.any()):
            break
        x_n, unit_n, rnorm_n, arn = _gmres_restart(op, Mf, b, x, unit, rnorm, restart, axis)
        x = torch.where(go[:, None], x_n, x)
        unit = torch.where(go[:, None], unit_n, unit)
        rnorm = torch.where(go, rnorm_n, rnorm)
        restarts = restarts + go.to(torch.int64)
        arnoldi = arnoldi + torch.where(go, arn, 0)
        rounds += 1
        go = go & (rnorm > atol_t)
    _count("restarts", restarts)
    _count("arnoldi", arnoldi)
    if counts is not None:
        for key, v in (("restarts", restarts), ("arnoldi", arnoldi)):
            counts[key] = v if counts.get(key) is None else counts[key] + v
    return x, restarts, arnoldi, rounds


def gmres(op, b, *, tol=1e-5, atol=0.0, restart=20, maxiter=None, M=None, axis=None):
    """Solve ``op(x) = b`` by restarted GMRES: :func:`gmres_batched` on one
    member.  ``b`` may have any shape (the system is over all its entries,
    one joint norm; over a mesh ``axis`` over every rank's ``b``, the
    rank's block of the joint system); ``M`` is a preconditioner callable
    of the same shape.  Returns ``(x, restarts, arnoldi)``: the restarts
    taken and the Arnoldi iterations before breakdown (a 0-d device
    tensor)."""
    shape = b.shape

    def A(v):
        return op(v.reshape(shape)).reshape(1, -1)

    Mf = None if M is None else (lambda v: M(v.reshape(shape)).reshape(1, -1))
    x, _, arnoldi, rounds = gmres_batched(A, b.reshape(1, -1), tol=tol, atol=atol,
                                          restart=restart, maxiter=maxiter, M=Mf, axis=axis)
    return x.reshape(shape), rounds, arnoldi[0]


# ---- the tier ----------------------------------------------------------------


def _eye32(n, device):
    return torch.eye(n, dtype=F32, device=device)


def _lu32(a):
    return torch.linalg.lu_factor(a.to(F32))


def _lu32_apply(pre, v):
    lu, piv = pre
    return torch.linalg.lu_solve(lu, piv, v.to(F32).unsqueeze(-1)).squeeze(-1).to(v.dtype)


def _rows(solve_one, b, ndim):
    """Each augmented row its own solve."""
    if b.ndim == ndim:
        return solve_one(b)
    return torch.stack([solve_one(r) for r in b])


def make_krylov_solver(rhs, *, gmres_tol: float = 1e-6, restart: int = 30,
                       maxiter: int = 10, precond: str = "lu32",
                       jac_fn=None) -> LinearSolverSpec:
    """Matrix-free GMRES tier over ``rhs(t, y, p)``; the equations'
    ``rhs_jac`` must be :func:`make_krylov_jac` (the builder installs it).
    ``jac_fn(t, y, p) -> (n, n)`` (optional) is the dense-Jacobian
    extractor of the ``lu32`` preconditioner in place of ``jacfwd``: the
    builder passes the colored-probe one when coloring pays."""
    if precond not in ("lu32", "tridiag", "none"):
        raise ValueError(f"unknown preconditioner {precond!r}")

    def assemble(mass, jac, c):
        t, y, p = jac  # the frozen point of make_krylov_jac
        return (mass, t, y, p, c)

    def _op(mass, t, y, p, c, v):
        jv = torch.func.jvp(lambda yy: rhs(t, yy, p), (y,), (v,))[1]
        if mass is None:
            mv = v
        elif isinstance(mass, DiagMass):
            mv = v * mass.d
        else:
            mv = mass @ v
        return mv - c * jv

    def factor(a):
        mass, t, y, p, c = a
        n = y.shape[-1]
        if precond == "none":
            pre = None
        elif precond == "lu32":
            if jac_fn is not None:
                jac = jac_fn(t, y, p)
            else:
                jac = torch.func.jacfwd(lambda yy: rhs(t, yy, p))(y)
            if mass is None:
                m32 = _eye32(n, y.device)
            elif isinstance(mass, DiagMass):
                m32 = torch.diag_embed(mass.d.to(F32))
            else:
                m32 = mass.to(F32)
            pre = _lu32(m32 - torch.as_tensor(c, dtype=F32) * jac.to(F32))
        else:
            sub, dmain, sup = _tridiag_probes(
                lambda v: _op(mass, t, y, p, c, v), n, y.dtype, y.device)
            # an identity row where the tridiagonal pivot vanishes
            dmain = torch.where(dmain.abs() < 1e-30, torch.ones_like(dmain), dmain)
            pre = _thomas_factor(sub, dmain, sup)
        return (mass, t, y, p, c, pre)

    def solve(factors, b):
        mass, t, y, p, c, pre = factors
        if pre is None:
            M = None
        elif precond == "lu32":
            def M(v):
                return _lu32_apply(pre, v)
        else:
            def M(v):
                return _thomas_solve(pre, v)

        def one(v):
            return gmres(lambda w: _op(mass, t, y, p, c, w), v, tol=gmres_tol,
                         atol=0.0, restart=restart, maxiter=maxiter, M=M)[0]

        return _rows(one, b, 1)

    return LinearSolverSpec(
        name=f"krylov({precond})", assemble=assemble, factor=factor, solve=solve,
        # jac_fn rides along so that make_lockstep_problem can rebuild the
        # colored-probe preconditioner for each member
        meta=(gmres_tol, restart, maxiter, precond, jac_fn),
    )


def _member_columns(f, x):
    """Per-member Jacobians (B, n, n) of a function acting on each member
    of a (B, n) state on its own: n basis-vector JVPs, each broadcast over
    the members (one column of every member's Jacobian)."""
    n = x.shape[-1]
    cols = []
    for j in range(n):
        v = torch.zeros_like(x)
        v[:, j] = 1.0
        cols.append(torch.func.jvp(f, (x,), (v,))[1])
    return torch.stack(cols, dim=-1)


def make_krylov_solver_lockstep(rhs_b, nbatch: int, *, gmres_tol: float = 1e-6,
                                restart: int = 30, maxiter: int = 10,
                                precond: str = "lu32",
                                member_jac_fn=None, axis=None) -> LinearSolverSpec:
    """Lockstep lift of the tier over the member-major (B, n) state:
    ``rhs_b(t, (B, n), (B, np)) -> (B, n)`` is the batched rhs.  One GMRES
    runs over the joint B*n system (the members' blocks are independent,
    so the joint Krylov space converges like the worst member); the lu32
    preconditioner is a (B, n, n) float32 LU stack from ``member_jac_fn``
    over the members, or else from n column probes of the batched
    operator.  ``axis`` (a mesh's member axis) makes the state the rank's
    block of B members: the GMRES stays one over all members (its sums
    over the axis), the preconditioner the rank's own members'."""
    if precond not in ("lu32", "none"):
        raise ValueError(
            f"lockstep krylov supports lu32/none preconditioning, got {precond!r}")

    def assemble(mass, jac, c):
        t, Y, Pb = jac
        return (mass, t, Y, Pb, c)

    def _mass_mul(mass, v):
        if mass is None:
            return v
        if isinstance(mass, DiagMass):
            return v * mass.d  # (B, n)
        return torch.einsum("bij,bj->bi", mass, v)  # dense (B, n, n)

    def _op(mass, t, Y, Pb, c, v):
        jv = torch.func.jvp(lambda yy: rhs_b(t, yy, Pb), (Y,), (v,))[1]
        return _mass_mul(mass, v) - c * jv

    def factor(a):
        mass, t, Y, Pb, c = a
        if precond == "none":
            return (mass, t, Y, Pb, c, None)
        n = Y.shape[-1]
        if member_jac_fn is not None:
            jac = torch.func.vmap(member_jac_fn, in_dims=(None, 0, 0))(t, Y, Pb)
        else:
            jac = _member_columns(lambda yy: rhs_b(t, yy, Pb), Y)
        if mass is None:
            m32 = _eye32(n, Y.device).expand(jac.shape)
        elif isinstance(mass, DiagMass):
            m32 = torch.diag_embed(mass.d.to(F32))
        else:
            m32 = mass.to(F32)
        pre = _lu32(m32 - torch.as_tensor(c, dtype=F32) * jac.to(F32))
        return (mass, t, Y, Pb, c, pre)

    def solve(factors, b):
        mass, t, Y, Pb, c, pre = factors
        M = None if pre is None else (lambda v: _lu32_apply(pre, v))

        def one(v):
            return gmres(lambda w: _op(mass, t, Y, Pb, c, w), v, tol=gmres_tol,
                         atol=0.0, restart=restart, maxiter=maxiter, M=M, axis=axis)[0]

        return _rows(one, b, 2)

    return LinearSolverSpec(
        name=f"krylov_lockstep({precond})", assemble=assemble, factor=factor,
        solve=solve, meta=(gmres_tol, restart, maxiter, precond, nbatch),
    )


class MemberPoint(NamedTuple):
    """The frozen linearization points of a batch, a member each: ``t``
    (B,), ``y`` (B, n), ``p`` (B, nparams), taken and written by member
    like a Jacobian stack (``ndim`` 1: the step's ``c`` stays (B,))."""

    t: torch.Tensor
    y: torch.Tensor
    p: torch.Tensor
    ndim = 1

    def index_select(self, dim, idx):
        return MemberPoint(*(x.index_select(dim, idx) for x in self))

    def index_copy_(self, dim, idx, src):
        for x, s in zip(self, src):
            x.index_copy_(dim, idx, s)
        return self


class MemberFactors(tuple):
    """A factorization of an independent ensemble whose every tensor has
    the member axis first (the per-member tier's (mass, t, y, p, c, pre),
    the matrix-free consistent ICs' (x, pre)): written member by member."""


def _mass_mul_b(mass, v):
    """A member's mass times its row of v: none, a DiagMass (B, n) or a
    dense (B, n, n) stack."""
    if mass is None:
        return v
    if isinstance(mass, DiagMass):
        return v * mass.d
    return torch.einsum("bij,bj->bi", mass, v)


def make_krylov_solver_independent(rhs_b, member_rhs, nbatch: int, *,
                                   gmres_tol: float = 1e-6, restart: int = 30,
                                   maxiter: int = 10, precond: str = "lu32",
                                   member_jac_fn=None) -> LinearSolverSpec:
    """The tier of an independent ensemble (each member at its own time,
    :mod:`~diffsol_tpu_torch.solvers.independent`): every member its own
    frozen point, preconditioner and GMRES, as the single solve of that
    member has them.  ``rhs_b(t (B,), (B, n), (B, np))`` is the member-time
    lift of ``member_rhs``.  The Jacobian representation is a
    :class:`MemberPoint`; the factors are (mass, t, y, p, c, pre) with c
    (B,) and pre a (B, n, n) float32 LU stack (``lu32``, from
    ``member_jac_fn`` or ``jacfwd`` of each member), the (B, n) Thomas
    factors of each member's tridiagonal (``tridiag``), or None.
    ``solve(factors, b, active)`` runs :func:`gmres_batched` on the (B, n)
    right-hand side, or on each of the (naug, B, n) rows in turn, for the
    members of ``active``; ``meta[-1]`` holds the (B,) restarts and Arnoldi
    iterations of every call (``"restarts"``, ``"arnoldi"``)."""
    if precond not in ("lu32", "tridiag", "none"):
        raise ValueError(f"unknown preconditioner {precond!r}")
    counts = {"restarts": None, "arnoldi": None}
    jac_of = member_jac_fn or torch.func.jacfwd(member_rhs, argnums=1)

    def assemble(mass, jac, c):
        t, y, p = jac
        return (mass, t, y, p, c)

    def _op(mass, t, Y, Pb, c, v):
        jv = torch.func.jvp(lambda yy: rhs_b(t, yy, Pb), (Y,), (v,))[1]
        return _mass_mul_b(mass, v) - c[:, None] * jv

    def factor(a):
        mass, t, Y, Pb, c = a
        B, n = Y.shape
        # the factors are written member by member: no stride-0 mass
        if isinstance(mass, DiagMass):
            mass = DiagMass(mass.d.contiguous())
        elif mass is not None:
            mass = mass.contiguous()
        if precond == "none":
            pre = None
        elif precond == "lu32":
            jac = torch.func.vmap(jac_of, in_dims=(0, 0, 0))(t, Y, Pb)
            if mass is None:
                m32 = _eye32(n, Y.device).expand(jac.shape)
            elif isinstance(mass, DiagMass):
                m32 = torch.diag_embed(mass.d.to(F32))
            else:
                m32 = mass.to(F32)
            pre = _lu32(m32 - c.to(F32)[:, None, None] * jac.to(F32))
        else:
            sub, dmain, sup = _tridiag_probes(
                lambda v: _op(mass, t, Y, Pb, c, v), n, Y.dtype, Y.device, (B,))
            dmain = torch.where(dmain.abs() < 1e-30, torch.ones_like(dmain), dmain)
            pre = _thomas_factor(sub, dmain, sup)
        return MemberFactors((mass, t, Y, Pb, c, pre))

    def solve(factors, b, active=None):
        mass, t, Y, Pb, c, pre = factors
        if pre is None:
            M = None
        elif precond == "lu32":
            def M(v):
                return _lu32_apply(pre, v)
        else:
            def M(v):
                return _thomas_solve(pre, v)

        def one(v):
            return gmres_batched(lambda w: _op(mass, t, Y, Pb, c, w), v, tol=gmres_tol,
                                 atol=0.0, restart=restart, maxiter=maxiter, M=M,
                                 active=active, counts=counts)[0]

        return _rows(one, b, 2)

    return LinearSolverSpec(
        name=f"krylov_independent({precond})", assemble=assemble, factor=factor,
        solve=solve, meta=(gmres_tol, restart, maxiter, precond, nbatch, counts),
    )


def make_krylov_jac():
    """The tier's ``rhs_jac``: the Jacobian "representation" is the frozen
    linearization point ``(t, y, p)``; no matrix is formed."""

    def jac(t, y, p):
        return (t, y, p)

    jac.jvp_probes = 0  # no probes at evaluation time (JVPs happen per solve)
    return jac


def make_matfree_residual_solver(residual, gmres_tol: float = 1e-8,
                                 restart: int = 30, maxiter: int = 20,
                                 per_member: bool = False, counts=None, axis=None):
    """``(factorize, solve)`` for Newton on a residual F(x) without a
    full-precision factorization (the consistent initial conditions of a
    matrix-free problem): ``factorize(x)`` freezes the point and builds the
    float32 LU of the exact dF/dx, (n, n), or (B, n, n) for a lockstep
    (B, n) state from n column probes broadcast over the members;
    ``solve(factors, v)`` runs preconditioned GMRES on the JVP operator,
    jointly over the members (over every rank's members under a mesh
    ``axis``).  With ``per_member`` (an independent
    ensemble) each member of the (B, n) state is its own system:
    ``factorize(x, f)`` freezes the members' points of their residual ``f``
    (default ``residual``) and ``solve(factors, v, active)`` runs
    :func:`gmres_batched` for the members of ``active``, adding the (B,)
    counts to ``counts``."""

    if per_member:
        def factorize_b(x, f=residual):
            return MemberFactors((x, _lu32(_member_columns(f, x))))

        def solve_b(factors, v, active=None):
            x0, pre = factors
            return gmres_batched(lambda w: torch.func.jvp(residual, (x0,), (w,))[1], v,
                                 tol=gmres_tol, atol=0.0, restart=restart, maxiter=maxiter,
                                 M=lambda w: _lu32_apply(pre, w), active=active,
                                 counts=counts)[0]

        return factorize_b, solve_b

    def factorize(x):
        if x.ndim == 2:
            jac = _member_columns(residual, x)
        else:
            jac = torch.func.jacfwd(residual)(x)
        return (x, _lu32(jac))

    def solve(factors, v):
        x0, pre = factors
        return gmres(lambda w: torch.func.jvp(residual, (x0,), (w,))[1], v,
                     tol=gmres_tol, atol=0.0, restart=restart, maxiter=maxiter,
                     M=lambda w: _lu32_apply(pre, w), axis=axis)[0]

    return factorize, solve
