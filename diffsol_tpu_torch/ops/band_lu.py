"""No-pivot banded LU, factor (K3) and solve (K4) (counterpart of
``diffsol_tpu.ops.pallas_banded``).

The factored band is column-leading ``(n + mu, nb, B)`` with the member
index fastest: ``F[k, d, m] = A_m[k + d - mu, k]``, multipliers below band
row ``mu`` (the main diagonal) and U in and above it, LAPACK gbtrf style,
plus ``mu`` unit-diagonal pad columns.  The public functions take the
port's member-major ``(B, nb, n)`` band (``band[m, d, j] = A_m[j + d - mu,
j]``) and ``(B, n)`` right-hand sides.

Two implementations of the same algorithm, each in float64 and in
float32 (the dtype of the band; mixed dtypes raise a ``TypeError``):

* the CUDA kernels of ``csrc/band_lu.cuh`` (a warp a member, the active
  window in shared memory), built with ``nvcc`` at first use and launched
  by :func:`launch_band_lu_factor` and :func:`launch_band_lu_solve` for
  CUDA tensors.  The factor reads the member-major band and writes the
  column-leading factors itself; the solve reads and writes ``(R, n)``
  against ``fb`` factorizations, ``R`` a multiple of ``fb``, right-hand
  side ``r`` with factorization ``r % fb``: one for every right-hand side,
  one a member, or a lockstep ensemble's augmented rows stacked
  naug-major over the members, without a copy of the factors;
* the plain PyTorch versions :func:`band_lu_factor_reference` and
  :func:`band_lu_solve_reference`, a Python loop over columns vectorized
  over members, for CPU tensors and as the kernels' yardstick on the card.

A CUDA tensor always goes to the kernel: a build or launch failure raises,
and nothing falls back to the plain version or to the CPU.  A launch reads
raw device memory, so the launch wrappers refuse a tensor under a
``torch.func`` transform (``jvp``, ``vmap``): the kernel would drop its
tangent.  The tier's entry points :func:`band_lu_factor` and
:func:`band_lu_solve` carry forward mode themselves: each goes through a
``torch.autograd.Function`` with a ``jvp`` rule, on the card and on the
CPU alike.  The factors carry no tangent; :func:`band_lu_factor` returns
them with the band they came from (:class:`BandFactors`), and the solve
gives x' = A^-1 (b' - A' x), one more solve on the same factors after a
band mat-vec.  The Pallas kernels are float32
(Mosaic has no f64), so there the LU is a Newton preconditioner; here it
is an exact solver in the problem's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F64 = torch.float64
DTYPES = (torch.float64, torch.float32)


def npadx(ml: int, mu: int) -> int:
    """Pad rows of the solve's work vector past row n-1."""
    return max(ml, mu, 1)


def factor_columns(F: torch.Tensor, n: int, ml: int, mu: int,
                   growth: bool = False):
    """Factor ``F`` (n+mu, nb, M) in place; columns 0..n-1 hold the band,
    the pad columns are written here.  With ``growth``, returns each
    member's largest |Schur-update element| (M,), NaN-propagating, for
    the fused stepper's element-growth test (csrc/band_lu.cuh
    warp_band_factor)."""
    F[n:] = 0.0
    F[n:, mu] = 1.0
    gmax = torch.zeros(F.shape[-1], dtype=F.dtype, device=F.device) if growth else None
    if ml == 0:
        return gmax
    for k in range(n):
        inv = 1.0 / F[k, mu]
        lk = F[k, mu + 1: mu + 1 + ml] * inv  # (ml, M)
        F[k, mu + 1: mu + 1 + ml] = lk
        for dj in range(1, mu + 1):
            u = F[k + dj, mu - dj]
            e = F[k + dj, mu + 1 - dj: mu + 1 + ml - dj] - lk * u
            F[k + dj, mu + 1 - dj: mu + 1 + ml - dj] = e
            if growth:
                gmax = torch.maximum(gmax, e.abs().amax(0))
    return gmax


def solve_columns(F: torch.Tensor, x: torch.Tensor, n: int, ml: int, mu: int):
    """Solve in place: ``x`` (n + npadx, M) holds b in rows 0..n-1 and the
    solution on return (csrc/band_lu.cuh band_lu_solve_kernel and
    warp_band_solve, whose back sweep runs column by column)."""
    x[n:] = 0.0
    if ml > 0:
        for k in range(n - 1):
            x[k + 1: k + 1 + ml] = x[k + 1: k + 1 + ml] - F[k, mu + 1: mu + 1 + ml] * x[k]
        # the forward sweep writes past row n-1 (pallas_stepper_band.py:481-485)
        x[n:] = 0.0
    for k in range(n - 1, -1, -1):
        acc = x[k]
        for dj in range(1, mu + 1):
            acc = acc - F[k + dj, mu - dj] * x[k + dj]
        x[k] = acc / F[k, mu]


def _as_members(band: torch.Tensor, ml: int, mu: int) -> torch.Tensor:
    band3 = band if band.ndim == 3 else band.unsqueeze(0)
    if band3.ndim != 3 or band3.shape[1] != ml + mu + 1:
        raise ValueError(f"band must be (B, {ml + mu + 1}, n) or "
                         f"({ml + mu + 1}, n), got {tuple(band.shape)}")
    if band3.dtype not in DTYPES:
        raise TypeError(f"band must be float64 or float32, got {band3.dtype}")
    return band3


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def band_lu_factor_reference(band: torch.Tensor, ml: int, mu: int) -> torch.Tensor:
    """(B, nb, n) or (nb, n) band -> factored (n+mu, nb, B) on its device."""
    band3 = _as_members(band, ml, mu)
    B, nb, n = band3.shape
    F = band3.new_empty((n + mu, nb, B))
    F[:n] = band3.permute(2, 1, 0)
    factor_columns(F, n, ml, mu)
    return F


def band_lu_solve_reference(F: torch.Tensor, b: torch.Tensor, ml: int,
                            mu: int) -> torch.Tensor:
    """factored (n+mu, nb, fb), b (R, n) with R a multiple of fb -> x (R,
    n); right-hand side r uses factorization r % fb."""
    n, fb = F.shape[0] - mu, F.shape[2]
    _check_rows(fb, n, b)
    R = b.shape[0]
    if fb != R:
        F = F[:, :, torch.arange(R, device=F.device) % fb]
    x = b.new_empty((n + npadx(ml, mu), R))
    x[:n] = b.t()
    solve_columns(F, x, n, ml, mu)
    return x[:n].t()


def _check_rows(fb: int, n: int, b: torch.Tensor):
    if b.ndim != 2 or b.shape[1] != n or b.shape[0] % fb:
        raise ValueError(f"b must be (R, {n}) with R a multiple of the {fb} "
                         f"factorizations, got {tuple(b.shape)}")


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _refuse_transformed(*tensors):
    """A kernel launch reads raw memory: under ``torch.func.jvp`` it would
    return tensors without a tangent, which the transform reads as zero
    sensitivity.  Raise instead (the entry points below carry the
    tangent around the launch)."""
    from torch._C._functorch import is_functorch_wrapped_tensor

    if any(is_functorch_wrapped_tensor(t) for t in tensors):
        raise RuntimeError(
            "the band LU launch wrappers cannot run under a torch.func transform "
            "(jvp, vmap): the launch would drop the tangent.  Call band_lu_factor "
            "and band_lu_solve, which carry forward mode, or use "
            "the continuous sensitivity equations, BdfSolver(problem, sens=True)")


def launch_band_lu_factor(band: torch.Tensor, ml: int, mu: int) -> torch.Tensor:
    """K3 on ``torch.cuda.current_stream()``: a (B, nb, n) float64 or
    float32 CUDA band -> factored (n+mu, nb, B) of its dtype (the kernel's
    double or float build).  Builds the kernel at first use; raises on a
    build or launch error."""
    from .._build import load_band_lu

    _refuse_transformed(band)
    band3 = _as_members(band, ml, mu)
    if not band3.is_cuda:
        raise ValueError("launch_band_lu_factor needs a CUDA tensor")
    B, nb, n = band3.shape
    lib = load_band_lu()
    dev = band3.device
    with torch.cuda.device(dev):
        band3 = band3.contiguous()
        F = torch.empty((n + mu, nb, B), dtype=band3.dtype, device=dev)
        launch = (lib.band_lu_factor_launch if band3.dtype == F64
                  else lib.band_lu_factor_launch_f32)
        rc = launch(band3.data_ptr(), F.data_ptr(), n, ml, mu, B, _stream(dev))
        launch_band_lu_factor.launches += 1
        if band3.dtype != F64:
            launch_band_lu_factor.launches_f32 += 1
    if rc != 0:
        raise RuntimeError(f"band_lu_factor kernel launch failed: CUDA error {rc}")
    return F


launch_band_lu_factor.launches = 0
launch_band_lu_factor.launches_f32 = 0  # of which the float build


def launch_band_lu_solve(F: torch.Tensor, b: torch.Tensor, ml: int,
                         mu: int) -> torch.Tensor:
    """K4 on ``torch.cuda.current_stream()``: factored (n+mu, nb, fb) and
    b (R, n), R a multiple of fb, both float64 or both float32 on one CUDA
    device -> x (R, n), right-hand side r solved with factorization r %
    fb.  Raises on a build or launch error."""
    from .._build import load_band_lu

    _refuse_transformed(F, b)
    nb = ml + mu + 1
    if not (F.is_cuda and b.is_cuda) or F.device != b.device:
        raise ValueError("launch_band_lu_solve needs CUDA tensors on one device")
    _same_dtype(F, b)
    if F.ndim != 3 or F.shape[1] != nb or not F.is_contiguous():
        raise ValueError(f"factors must be contiguous (n+mu, {nb}, B), got "
                         f"{tuple(F.shape)}")
    n, fb = F.shape[0] - mu, F.shape[2]
    _check_rows(fb, n, b)
    B = b.shape[0]
    lib = load_band_lu()
    dev = F.device
    with torch.cuda.device(dev):
        b = b.contiguous()
        x = torch.empty((B, n), dtype=F.dtype, device=dev)
        launch = (lib.band_lu_solve_launch if F.dtype == F64
                  else lib.band_lu_solve_launch_f32)
        rc = launch(F.data_ptr(), fb, b.data_ptr(), x.data_ptr(), n, ml, mu, B,
                    _stream(dev))
        launch_band_lu_solve.launches += 1
        if F.dtype != F64:
            launch_band_lu_solve.launches_f32 += 1
    if rc != 0:
        raise RuntimeError(f"band_lu_solve kernel launch failed: CUDA error {rc}")
    return x


launch_band_lu_solve.launches = 0
launch_band_lu_solve.launches_f32 = 0  # of which the float build


def _same_dtype(*tensors):
    """The kernels and their plain versions run in one dtype, float64 or
    float32; a mix is refused, never cast."""
    dts = {t.dtype for t in tensors}
    if len(dts) != 1 or not dts <= set(DTYPES):
        raise TypeError("the band LU takes float64 or float32 tensors of one dtype, "
                        f"got {sorted(str(d) for d in dts)}")


# ---------------------------------------------------------------------------
# the tier's entry points: the device of the tensors decides, and forward
# mode passes through them
# ---------------------------------------------------------------------------

def band_matvec(band: torch.Tensor, x: torch.Tensor, ml: int, mu: int) -> torch.Tensor:
    """A x for a (fb, nb, n) member-major band and x (R, n), R a multiple
    of fb, row r with member r % fb."""
    n = x.shape[-1]
    fb = band.shape[0]
    if fb != x.shape[0]:
        band = band[torch.arange(x.shape[0], device=band.device) % fb]
    y = torch.zeros_like(x)
    for d in range(ml + mu + 1):
        lo, hi = max(0, mu - d), min(n, n + mu - d)  # 0 <= j + d - mu < n
        if lo < hi:
            y[:, lo + d - mu: hi + d - mu] += band[:, d, lo:hi] * x[:, lo:hi]
    return y


def _factor_raw(band, ml, mu):
    if band.is_cuda:
        return launch_band_lu_factor(band, ml, mu)
    return band_lu_factor_reference(band, ml, mu)


def _solve_raw(F, b2, ml, mu):
    if F.is_cuda:
        return launch_band_lu_solve(F, b2, ml, mu)
    return band_lu_solve_reference(F, b2, ml, mu)


class _BandFactor(torch.autograd.Function):
    """K3 (or its plain version) with a forward-mode rule: the factors
    carry no tangent; :class:`_BandSolve` takes the band's instead."""

    @staticmethod
    def forward(band, ml, mu):
        return _factor_raw(band, ml, mu)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def jvp(ctx, dband, dml, dmu):
        return None


class _BandSolve(torch.autograd.Function):
    """K4 (or its plain version) for x = A^-1 b with the forward-mode rule
    x' = A^-1 (b' - A' x): a band mat-vec and one more solve on the same
    factors.  ``band`` is A's (fb, nb, n) band, which holds the tangent
    A'."""

    @staticmethod
    def forward(F, band, b2, ml, mu):
        return _solve_raw(F, b2, ml, mu)

    @staticmethod
    def setup_context(ctx, inputs, output):
        F, band, _b2, ml, mu = inputs
        ctx.ml, ctx.mu = ml, mu
        ctx.save_for_forward(F, band, output)

    @staticmethod
    def jvp(ctx, dF, dband, db2, dml, dmu):
        F, band, x = ctx.saved_tensors
        rhs = torch.zeros_like(x) if db2 is None else db2
        if dband is not None:
            rhs = rhs - band_matvec(dband, x, ctx.ml, ctx.mu)
        return _BandSolve.apply(F, band, rhs, ctx.ml, ctx.mu)


class BandFactors(NamedTuple):
    """:func:`band_lu_factor`'s result: the factors and the band they came
    from, whose tangent :func:`band_lu_solve`'s forward-mode rule reads."""

    lu: torch.Tensor  # (n+mu, nb, B), column-leading (K3's output)
    band: torch.Tensor  # (B, nb, n), member-major


def band_lu_factor(band: torch.Tensor, ml: int, mu: int) -> BandFactors:
    """Factor a (B, nb, n) or (nb, n) float64 or float32 band: K3 for a
    CUDA tensor, the plain version for a CPU tensor.  Returns the (n+mu,
    nb, B) factors in the band's dtype, which carry no tangent under
    ``torch.func.jvp``, beside the (B, nb, n) band, which does."""
    band3 = _as_members(band, ml, mu)
    return BandFactors(_BandFactor.apply(band3, ml, mu), band3)


def band_lu_solve(factors: BandFactors, b: torch.Tensor, ml: int,
                  mu: int) -> torch.Tensor:
    """Solve with :func:`band_lu_factor`'s output (fb factorizations) for
    b (R, n), R a multiple of fb, or (n,): K4 for CUDA tensors, the plain
    version for CPU tensors.  Right-hand side r uses factorization r % fb,
    so one factorization serves every right-hand side
    (pallas_banded.py:156-157) and the naug-major rows (naug B, n) of a
    lockstep ensemble's sensitivities go in one launch (banded.py:231-243).
    Under ``torch.func.jvp`` the band's tangent enters x' = A^-1 (b' -
    A' x), a second solve (a second K4 launch on the card)."""
    F, band = factors
    b2 = b if b.ndim == 2 else b.unsqueeze(0)
    _same_dtype(F, band, b2)
    x = _BandSolve.apply(F, band, b2, ml, mu)
    return x if b.ndim == 2 else x[0]
