// No-pivot banded LU, factor and solve, CUDA C++ for sm_90a.
//
// Replaces diffsol_tpu/ops/pallas_banded.py: band_lu_factor -> _factor_kernel
// (:51, called at :131) and band_lu_solve -> _solve_kernel (:72, called at
// :159).  The factored band is COLUMN-LEADING, F[k][d] = A[k+d-mu][k] for
// column k and band row d (band row mu is the main diagonal), with mu
// unit-diagonal pad columns so the update windows never run off the end.
// In gbtrf form the multipliers L[k+i][k] sit in F[k][mu+i] and U above
// them.  No pivoting: the iteration matrices M - cJ of parabolic
// method-of-lines operators are diagonally dominant (the trade LAPACK's
// dgtsv-style fast paths make; the fused band stepper guards it with an
// element-growth test).
//
// One thread per member.  A member's band is strided by `s` doubles, the
// number of members, so member m reads F[(k*nb + d)*s + m]: a warp's 32
// members touch 32 neighbouring doubles of one column row, a coalesced
// 256-byte access.  Everything is double (the Pallas kernels are f32
// because Mosaic has no f64; there the LU is a Newton preconditioner, here
// an exact solver).
//
// What bounds it on the H100: each member's column loop is a serial chain
// of n dependent steps (a divide, then ml*mu multiply-adds), so at the
// main path's B = 1024, n = 128 (8 blocks of 128 threads) the kernel is
// latency-bound: a few microseconds of bytes at 3.35 TB/s against a chain
// of some n * (divide + FMA) latencies.  The design keeps the member axis
// coalesced and leaves wider parallelism (more members per SM, a
// cyclic-reduction split of the column chain) to later work.
//
// The __device__ functions serve this file's thin __global__ wrappers
// (K3, K4) and the fused band stepper (fused_band_bdf.cuh), which includes
// this header with DIFFSOL_BAND_LU_NO_ENTRY defined.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "bdf_common.cuh"

namespace diffsol_band {

// Factor one member's band in place.  F holds columns 0..n-1 of the band
// (column-leading, stride s); the mu pad columns n..n+mu-1 are written
// here.  Returns the largest |Schur-update element| this member produced
// (NaN if any was NaN), for the caller's element-growth test.
__device__ __forceinline__ double band_factor(double* F, size_t s, int n, int ml, int mu) {
  const int nb = ml + mu + 1;
  for (int k = n; k < n + mu; ++k)
    for (int d = 0; d < nb; ++d) F[((size_t)k * nb + d) * s] = (d == mu) ? 1.0 : 0.0;
  double gmax = 0.0;
  for (int k = 0; k < n; ++k) {
    double* col = F + (size_t)k * nb * s;
    const double inv = 1.0 / col[(size_t)mu * s];
    for (int i = 1; i <= ml; ++i) col[(size_t)(mu + i) * s] = col[(size_t)(mu + i) * s] * inv;
    for (int dj = 1; dj <= mu; ++dj) {
      double* cj = F + (size_t)(k + dj) * nb * s;
      const double u = cj[(size_t)(mu - dj) * s];
      for (int i = 1; i <= ml; ++i) {
        const double e = cj[(size_t)(mu + i - dj) * s] - col[(size_t)(mu + i) * s] * u;
        cj[(size_t)(mu + i - dj) * s] = e;
        gmax = diffsol_fused::nan_max(gmax, fabs(e));
      }
    }
  }
  return gmax;
}

// Solve A x = b with band_factor's output.  x holds b in rows 0..n-1 and
// has n + max(ml, mu, 1) rows (stride s); the pad rows are set here.
__device__ __forceinline__ void band_solve(const double* F, double* x, size_t s, int n,
                                           int ml, int mu) {
  const int nb = ml + mu + 1;
  const int npadx = n + (ml > mu ? (ml > 1 ? ml : 1) : (mu > 1 ? mu : 1));
  for (int r = n; r < npadx; ++r) x[(size_t)r * s] = 0.0;
  if (ml > 0) {
    for (int k = 0; k < n - 1; ++k) {
      const double* col = F + (size_t)k * nb * s;
      const double bk = x[(size_t)k * s];
      for (int i = 1; i <= ml; ++i)
        x[(size_t)(k + i) * s] = x[(size_t)(k + i) * s] - col[(size_t)(mu + i) * s] * bk;
    }
    // the forward sweep writes past row n-1: re-zero the pad so the back
    // sweep's out-of-range u*x terms vanish (pallas_stepper_band.py:481-485)
    for (int r = n; r < npadx; ++r) x[(size_t)r * s] = 0.0;
  }
  for (int k = n - 1; k >= 0; --k) {
    double acc = x[(size_t)k * s];
    for (int dj = 1; dj <= mu; ++dj)
      acc = acc - F[((size_t)(k + dj) * nb + mu - dj) * s] * x[(size_t)(k + dj) * s];
    x[(size_t)k * s] = acc / F[((size_t)k * nb + mu) * s];
  }
}

}  // namespace diffsol_band

#ifndef DIFFSOL_BAND_LU_NO_ENTRY

namespace diffsol_band {

constexpr int THREADS = 128;

// K3: F is (n+mu, nb, B) with columns 0..n-1 filled; factored in place.
__global__ void __launch_bounds__(THREADS)
band_lu_factor_kernel(double* __restrict__ F, int n, int ml, int mu, int B) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= B) return;
  band_factor(F + m, (size_t)B, n, ml, mu);
}

// K4: F (n+mu, nb, B) factored, b (n, B), x (n + max(ml, mu, 1), B) out.
__global__ void __launch_bounds__(THREADS)
band_lu_solve_kernel(const double* __restrict__ F, const double* __restrict__ b,
                     double* __restrict__ x, int n, int ml, int mu, int B) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= B) return;
  for (int r = 0; r < n; ++r) x[(size_t)r * B + m] = b[(size_t)r * B + m];
  band_solve(F + m, x + m, (size_t)B, n, ml, mu);
}

}  // namespace diffsol_band

// The C entry points, bound with ctypes (ops/band_lu.py).  Pointers are
// device pointers; each launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int band_lu_factor_launch(double* F, int n, int ml, int mu, int B, void* stream) {
  using namespace diffsol_band;
  if (n < 1 || ml < 0 || mu < 0 || B < 1) return (int)cudaErrorInvalidValue;
  band_lu_factor_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      F, n, ml, mu, B);
  return (int)cudaGetLastError();
}

extern "C" int band_lu_solve_launch(const double* F, const double* b, double* x, int n,
                                    int ml, int mu, int B, void* stream) {
  using namespace diffsol_band;
  if (n < 1 || ml < 0 || mu < 0 || B < 1) return (int)cudaErrorInvalidValue;
  band_lu_solve_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      F, b, x, n, ml, mu, B);
  return (int)cudaGetLastError();
}

#endif  // DIFFSOL_BAND_LU_NO_ENTRY
