// Helpers shared by the fused BDF kernels (fused_bdf.cuh, fused_band_bdf.cuh)
// and the band LU (band_lu.cuh): NaN-propagating max/min, the tile-wide
// block reduction, the PI controller and the R(f).U transform of the
// difference matrix.
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

// Tile-wide max: warp shuffle, then one value per warp through shared
// memory.  Every thread of the block must call it (blockDim % 32 == 0).
__device__ __forceinline__ double block_max(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  double r = red[0];
  for (int w = 1; w < nw; ++w) r = nan_max(r, red[w]);
  return r;
}

// Thread 0's value to every thread of the block, through one shared slot.
// Every thread must call it.
__device__ __forceinline__ double bcast0(double v, double* slot) {
  __syncthreads();  // earlier readers of the slot are done
  if (threadIdx.x == 0) *slot = v;
  __syncthreads();
  return *slot;
}

// ops/controller.py pi_controller_raw on squared norms
__device__ __forceinline__ double pi_raw(double err, double prev, double ki_num,
                                         double kp_num, int eff_order) {
  const double ki = ki_num / eff_order;
  const double kp = kp_num / eff_order;
  const double err_safe = nan_clamp(err, 1e-30, 1e30);
  const double i_only = pow(err_safe, -ki);
  if (kp_num == 0.0) return i_only;
  if (prev != prev) return i_only;
  const double prev_safe = nan_clamp(prev, 1e-30, 1e30);
  return pow(err_safe, -(ki + kp)) * pow(prev_safe, kp);
}

// RU = R(f) U on rows/columns <= order, identity outside
// (pallas_stepper.py:309-345); the block's threads fill the 8 x 8 entries
// of the shared matrix together.
__device__ void compute_ru(int order, double f, const double (*U)[ND], double (*ru)[ND]) {
  __syncthreads();  // earlier readers of ru are done
  for (int e = threadIdx.x; e < ND * ND; e += blockDim.x) {
    const int i = e / ND, j = e % ND;
    double v = (i == j) ? 1.0 : 0.0;
    if (i <= order && j <= order) {
      v = 0.0;
      for (int k = 0; k <= j; ++k) {  // U[k][j] = 0 for k > j
        double r = 1.0;
        for (int m = 1; m <= i; ++m) r = r * (((m - 1.0) - f * k) / m);
        v += r * U[k][j];
      }
    }
    ru[i][j] = v;
  }
  __syncthreads();
}

}  // namespace diffsol_fused
