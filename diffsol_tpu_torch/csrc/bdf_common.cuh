// Helpers shared by the fused BDF kernels (fused_bdf.cuh, fused_band_bdf.cuh)
// and the band LU (band_lu.cuh): NaN-propagating max/min, the PI controller
// and the R(f).U transform of the difference matrix.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace diffsol_fused {

constexpr int ND = 8;         // rows of the difference matrix D
constexpr int MAX_ORDER = 5;

// status codes, as pallas_stepper.py:82-89
constexpr int OK = 0;
constexpr int ROOT_STOP = 1;  // a root without a reset operator stops the tile
constexpr int FAIL_STEP_TOO_SMALL = -1;
constexpr int FAIL_MAX_STEPS = -2;
constexpr int FAIL_NEWTON = -3;
constexpr int FAIL_ERRTEST = -4;
constexpr int FAIL_ROOT_INCONS = -5;  // the tile's members disagree on a root
constexpr int FAIL_LU_GROWTH = -6;

// NaN-propagating max/min, as torch.maximum / jnp.maximum
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ double nan_min(double a, double b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ double nan_clamp(double x, double lo, double hi) {
  return x != x ? x : fmin(fmax(x, lo), hi);
}

// ops/controller.py pi_controller_raw on squared norms; each power is
// taken only where the result uses it
__device__ __forceinline__ double pi_raw(double err, double prev, double ki_num,
                                         double kp_num, int eff_order) {
  const double ki = ki_num / eff_order;
  const double err_safe = nan_clamp(err, 1e-30, 1e30);
  if (kp_num == 0.0 || prev != prev) return pow(err_safe, -ki);
  const double kp = kp_num / eff_order;
  const double prev_safe = nan_clamp(prev, 1e-30, 1e30);
  return pow(err_safe, -(ki + kp)) * pow(prev_safe, kp);
}

// RU = R(f) U on rows/columns <= order, identity outside
// (pallas_stepper.py:309-345); the block's threads fill the 8 x 8 entries
// of the shared matrix together, then one barrier.  The caller guarantees
// that every thread has passed a block barrier since the last reads of ru
// (each step of both kernels takes a tile reduction before its rescale).
// R's factors ((m - 1) - f k) / m multiply by the constant 1/m: loops
// unrolled, so the chain holds no division.
__device__ void compute_ru(int order, double f, const double (*U)[ND], double (*ru)[ND]) {
  for (int e = threadIdx.x; e < ND * ND; e += blockDim.x) {
    const int i = e / ND, j = e % ND;
    double v = (i == j) ? 1.0 : 0.0;
    if (i <= order && j <= order) {
      v = 0.0;
#pragma unroll
      for (int k = 0; k < ND; ++k) {  // U[k][j] = 0 for k > j
        if (k <= j) {
          double r = 1.0;
#pragma unroll
          for (int m = 1; m < ND; ++m)
            if (m <= i) r = r * (((m - 1.0) - f * k) * (1.0 / m));
          v += r * U[k][j];
        }
      }
    }
    ru[i][j] = v;
  }
  __syncthreads();
}

}  // namespace diffsol_fused
