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
its first restart and once after each.

A lockstep ensemble (:func:`make_krylov_solver_lockstep`) runs ONE GMRES
over the joint B*n system with joint norms, as the JAX package does, here
on the member-major (B, n) state; its float32 LU stack (B, n, n) is the
preconditioner.  Augmented rows (``(naug, n)``, ``(naug, B, n)``) each get
their own GMRES, as JAX's ``vmap`` of a ``while_loop`` gives them.
"""

from __future__ import annotations

import torch

from ..equations import DiagMass
from .linsol import LinearSolverSpec

F32 = torch.float32

# what the GMRES calls of this process did: calls, restarts, host reads and
# the Arnoldi iterations (a count on each device, read at read time)
_COUNTS = {"calls": 0, "restarts": 0, "host_reads": 0, "arnoldi": {}}


def reset_gmres_counts() -> None:
    _COUNTS.update(calls=0, restarts=0, host_reads=0, arnoldi={})


def gmres_counts() -> dict:
    """GMRES calls, restarts, host reads and Arnoldi iterations since the
    last :func:`reset_gmres_counts` (the Arnoldi count is a device read)."""
    return dict(calls=_COUNTS["calls"], restarts=_COUNTS["restarts"],
                host_reads=_COUNTS["host_reads"],
                arnoldi=sum(int(a) for a in _COUNTS["arnoldi"].values()))


# ---- the tridiagonal preconditioner ---------------------------------------


def _tridiag_probes(op, n, dtype, device=None):
    """The tridiagonal part of a linear operator from 3 cyclic probes:
    ``(a_sub, d_main, c_sup)``, band[d, j] = (A e_{j mod 3})[j + d - 1]."""
    idx = torch.arange(n, device=device)
    probes = torch.stack([op((idx % 3 == c).to(dtype)) for c in range(3)])  # (3, n)
    zero = probes.new_zeros(1)
    dmain = probes[idx % 3, idx]
    a_sub = torch.cat([zero, probes[idx[:-1] % 3, idx[1:]]])  # A[j, j-1]
    c_sup = torch.cat([probes[idx[1:] % 3, idx[:-1]], zero])  # A[j, j+1]
    return a_sub, dmain, c_sup


def _thomas_factor(a, d, c):
    """No-pivot LU of a tridiagonal system, ``(w, dd, c)``; pivots below
    1e-30 become 1 (the tridiagonal is only ever a preconditioner)."""
    w, dd = [d.new_zeros(())], [d[0]]
    for j in range(1, d.shape[0]):
        wj = a[j] / dd[-1]
        dn = d[j] - wj * c[j - 1]
        dd.append(torch.where(dn.abs() < 1e-30, torch.ones_like(dn), dn))
        w.append(wj)
    return torch.stack(w), torch.stack(dd), c


def _thomas_solve(factors, b):
    w, dd, c = factors
    n = b.shape[0]
    y = [b[0]]
    for j in range(1, n):
        y.append(b[j] - w[j] * y[-1])
    x = [y[-1] / dd[-1]]
    for j in range(n - 2, -1, -1):
        x.append((y[j] - c[j] * x[-1]) / dd[j])
    return torch.stack(x[::-1])


# ---- GMRES -----------------------------------------------------------------


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


def _safe_normalize(x, thresh=None):
    """``(x / |x|, |x|)``, or zeros where |x| <= thresh (the dtype's eps by
    default), as JAX's ``_safe_normalize``."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(norm.dtype).eps
    use = norm > thresh
    return (torch.where(use, x / torch.where(use, norm, 1.0), 0.0),
            torch.where(use, norm, 0.0))


def _gmres_restart(A, M, b, x0, unit_residual, residual_norm, restart):
    """One restart of batched GMRES (JAX ``_gmres_batched``): ``restart``
    Arnoldi iterations, the rows after a breakdown left as the identity's,
    then the projected solution.  Returns ``(x, unit_residual,
    residual_norm, arnoldi)``."""
    eps = torch.finfo(b.dtype).eps
    eye = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    V = [unit_residual]
    rows = []
    broken = torch.zeros((), dtype=torch.bool, device=b.device)
    arnoldi = torch.zeros((), dtype=torch.int64, device=b.device)
    for k in range(restart):
        v = M(A(V[k]))
        _, v_norm_0 = _safe_normalize(v)
        # classical Gram-Schmidt; JAX's second pass never runs (its loop
        # test k < max_iterations - 1 fails after the first)
        Q = torch.stack(V)
        h = Q @ v
        v = v - h @ Q
        unit_v, v_norm_1 = _safe_normalize(v, eps * v_norm_0)
        V.append(unit_v)
        row = torch.cat([h, v_norm_1[None], h.new_zeros(restart - k - 1)])
        rows.append(torch.where(broken, eye[k], row))
        arnoldi = arnoldi + (~broken).to(torch.int64)
        broken = broken | (v_norm_1 == 0.0)
    H = torch.stack(rows)  # (restart, restart + 1)
    # least squares min |H^T y - beta e_0| by the normal equations (JAX's
    # _lstsq, assume_a='pos')
    a2 = H @ H.T
    b2 = H[:, 0] * residual_norm
    L = torch.linalg.cholesky_ex(a2)[0]
    z = torch.linalg.solve_triangular(L, b2[:, None], upper=False)
    y = torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]
    x = x0 + y @ torch.stack(V[:-1])
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm, arnoldi


def gmres(op, b, *, tol=1e-5, atol=0.0, restart=20, maxiter=None, M=None):
    """Solve ``op(x) = b`` by restarted GMRES, the algorithm of
    ``jax.scipy.sparse.linalg.gmres(solve_method="batched")`` from x0 = 0.

    ``b`` may have any shape (the system is over all its entries, one
    joint norm); ``M`` is a preconditioner callable of the same shape.
    At most ``maxiter`` restarts (default 10 * b.numel()) of
    ``min(restart, b.numel())`` Arnoldi iterations each, while the
    preconditioned residual |M(b - A x)| exceeds ``max(tol |b|, atol)``.
    Returns ``(x, restarts, arnoldi)``: the restarts taken and the Arnoldi
    iterations before breakdown (a 0-d device tensor)."""
    shape = b.shape
    size = b.numel()
    maxiter = 10 * size if maxiter is None else maxiter
    restart = min(restart, size)

    def A(v):
        return op(v.reshape(shape)).reshape(-1)

    def Mf(v):
        return v if M is None else M(v.reshape(shape)).reshape(-1)

    bf = b.reshape(-1)
    atol_t = torch.clamp(tol * _norm(bf), min=atol)
    x = torch.zeros_like(bf)
    unit, rnorm = _safe_normalize(Mf(bf - A(x)))
    arnoldi = torch.zeros((), dtype=torch.int64, device=b.device)
    k = 0
    _COUNTS["calls"] += 1
    while k < maxiter:
        _COUNTS["host_reads"] += 1
        if not bool(rnorm > atol_t):
            break
        x, unit, rnorm, arn = _gmres_restart(A, Mf, bf, x, unit, rnorm, restart)
        arnoldi = arnoldi + arn
        k += 1
    _COUNTS["restarts"] += k
    dev = arnoldi.device
    _COUNTS["arnoldi"][dev] = _COUNTS["arnoldi"].get(dev, 0) + arnoldi
    return x.reshape(shape), k, arnoldi


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
                                member_jac_fn=None) -> LinearSolverSpec:
    """Lockstep lift of the tier over the member-major (B, n) state:
    ``rhs_b(t, (B, n), (B, np)) -> (B, n)`` is the batched rhs.  One GMRES
    runs over the joint B*n system (the members' blocks are independent,
    so the joint Krylov space converges like the worst member); the lu32
    preconditioner is a (B, n, n) float32 LU stack from ``member_jac_fn``
    over the members, or else from n column probes of the batched
    operator."""
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
                         atol=0.0, restart=restart, maxiter=maxiter, M=M)[0]

        return _rows(one, b, 2)

    return LinearSolverSpec(
        name=f"krylov_lockstep({precond})", assemble=assemble, factor=factor,
        solve=solve, meta=(gmres_tol, restart, maxiter, precond, nbatch),
    )


def make_krylov_jac():
    """The tier's ``rhs_jac``: the Jacobian "representation" is the frozen
    linearization point ``(t, y, p)``; no matrix is formed."""

    def jac(t, y, p):
        return (t, y, p)

    jac.jvp_probes = 0  # no probes at evaluation time (JVPs happen per solve)
    return jac


def make_matfree_residual_solver(residual, gmres_tol: float = 1e-8,
                                 restart: int = 30, maxiter: int = 20):
    """``(factorize, solve)`` for Newton on a residual F(x) without a
    full-precision factorization (the consistent initial conditions of a
    matrix-free problem): ``factorize(x)`` freezes the point and builds the
    float32 LU of the exact dF/dx, (n, n), or (B, n, n) for a lockstep
    (B, n) state from n column probes broadcast over the members;
    ``solve(factors, v)`` runs preconditioned GMRES on the JVP operator,
    jointly over the members."""

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
                     M=lambda w: _lu32_apply(pre, w))[0]

    return factorize, solve
