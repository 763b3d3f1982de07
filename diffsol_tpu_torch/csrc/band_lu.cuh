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
// element-growth test).  The fused band stepper's loops are double; K3 and
// K4 are templates on the scalar, built for double and for float (the
// float32 problems of OdeBuilder.dtype, the counterpart of the f32 Pallas
// kernels: Mosaic has no f64, so there the LU is a Newton preconditioner,
// here an exact solver in the problem's precision).
//
// Two parts:
//
// * warp_band_factor / warp_band_solve, K3's and K4's column loops for ONE
//   member a warp whose band and factors lie member-major in device memory
//   (column c's nb entries contiguous), with the shapes fixed at compile
//   time and the factor's window on chip (or, for a band too wide for it,
//   in device memory).  The fused band stepper (fused_band_bdf.cuh) includes this header
//   with DIFFSOL_BAND_LU_NO_ENTRY defined and runs them inside its step
//   loop, each warp of a block on its own member.
//
// * K3 and K4, band_lu_factor_kernel / band_lu_solve_kernel below: a warp
//   a member, G = 4 members (warps) a block, so B = 1,024 members make 256
//   blocks over all 132 SMs.
//
// What bounds K3/K4 on the H100.  At the 2-D models' width (n = 400,
// ml = mu = 20, nb = 41, B = 1,024) the bytes: the band in and the factors
// out once is 8 B (nb n + (n + mu) nb) B = 275 MB, 0.082 ms at 3.35 TB/s
// (the solve reads the factor elements its sweeps use, (n-1) ml + n (mu+1)
// a member, and b, and writes x: 0.042 ms); the f64 work,
// 2 ml mu n B = 0.33 GFLOP, is 0.01 ms at 34 TFLOP/s.  At heat1d's nb = 3
// the bytes take 2 us and the column chain sets the pace: n dependent
// steps a member, each a reciprocal and a few shared-memory round trips.
//
// The design.
//
// * K3 keeps a member's active window on chip: at column k only columns
//   k .. k+mu change, so W = mu + 2C columns of nb doubles (C = 16 columns
//   a chunk at wide bands, 32 at narrow ones) live in shared memory: 17 KB
//   a member at nb = 41, whatever n is.  The warp copies the next chunk's
//   C columns from the member-major (B, nb, n) band (contiguous along the
//   columns) with cp.async while it eliminates the current chunk, then
//   slides the window by C columns; the block writes each finished chunk
//   once into the member-fastest (n+mu, nb, B) layout, G = 4 members to a
//   32-byte sector.  A column step is one __syncwarp: every lane takes the
//   reciprocal of the pivot (no broadcast), then lane i updates
//   sub-diagonal row i (32 / ml lanes share a row when ml < 32), e = e -
//   l*u with l = a[i]*inv, four updates at a time with every load before
//   the stores.  In the sliding window a lane's updates sit a constant
//   stride apart (a ring addressed modulo its length spent more issue
//   slots on addresses than on the arithmetic).  The scaled multipliers
//   are written at the chunk's write-out from the unscaled column and the
//   saved reciprocal: the same product, so each element sees the plain
//   version's operations in its order (FMA contraction is the only
//   difference).
//
// * K4 streams the factors through shared memory, each element once: the
//   forward sweep reads the ml multiplier rows of columns 0 .. n-2, the back
//   sweep the mu+1 rows of U from column n-1 down; a block copies chunks of
//   C columns (~8 KB a member) with cp.async into two buffers, one ahead
//   of use.  x (n doubles a member) sits in shared memory.  The forward
//   sweep's ml updates of a step are split over the lanes, in the plain
//   version's order.  The back sweep is COLUMN-oriented: once x[k] is
//   final, lane dj does x[k-dj] -= U[k-dj][k] x[k], and x[k] is the sum
//   times a reciprocal formed a chunk at a time off the chain.  That
//   reverses the order of each row's sum against the plain version's row
//   loop and puts an ulp between the product and its division; both are
//   held to the same 1e-12 relative as the rest.  Right-hand side r reads
//   factorization r mod f_members, so one factorization serves every
//   right-hand side and the naug-major augmented rows (naug B of them) of
//   a lockstep ensemble share their member's factors in one launch, with
//   no copy of the factors: each member's factors are read naug times (a
//   block whose warps share one member's window is later work).
//
// * Shapes past the shared memory at four members a block and the chunk
//   above (a factor window over 58 KB a member, (mu + 32) nb > ~7,250
//   doubles at nb > 8, so ml = mu > 45, or > ~14,500 floats, ml = mu > 71;
//   x over ~7,000 doubles or ~14,200 floats a member at heat1d's width)
//   take the same loops with the window in device memory (the <T, false>
//   instantiations): slower, not refused.  The float build halves the
//   bytes of every bound below.  No model of the port
//   runs there, so the plan does not search for a smaller on-chip layout.
//
// Measured on an H100 80GB HBM3 at 700.00 W (chip_smoke.py phases 7, 11
// and 14; B = 1,024): at n = 400, nb = 41 a call of K3 takes 0.443 ms and
// of K4 0.212 ms (device time 0.41 and 0.18 ms), against bounds of 0.082
// and 0.042 ms and torch.linalg's dense lu_factor / lu_solve at 37.6 and
// 2.8 ms; at heat1d's n = 128, nb = 3 0.097 and 0.101 ms (device 0.050
// and 0.056 ms) against 0.0019 and 0.0016 ms.  The one-thread-a-member
// kernels these replaced took 32.5 / 3.87 ms and 0.126 / 0.135 ms.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cuda_pipeline.h>

#include "bdf_common.cuh"

namespace diffsol_band {

constexpr int WARP = 32;

// K3's column loop for one member: factor A = M - cval J, where J (N, NB)
// holds the member's Jacobian band column-leading in device memory
// (J[j NB + d] = df_{j+d-MU}/dy_j) and M is the identity or the diagonal
// mdiag, into F (N + MU, NB), the same layout with the MU unit pad columns.
// ON_CHIP: a window of MU + 2C columns and C reciprocals (factor_doubles(C)
// doubles at `win`, shared memory) slides along the band as K3's does: the
// next chunk's columns of J arrive by cp.async while the current chunk is
// eliminated, each column is assembled (M - cJ) once it has arrived, and
// each finished chunk is written once.  Otherwise (a band whose window does
// not fit) the same loop runs in place in F.  Every element sees the plain
// version's operations in its order (ops/band_lu.py factor_columns).  Each
// lane returns the largest |A| and the largest |Schur update| of the
// elements it touched, NaN-propagating; the caller reduces them.
template <int ML, int MU>
__host__ __device__ constexpr int factor_doubles(int C) {
  return (MU + 2 * C) * (ML + MU + 1) + C;
}

template <int N, int ML, int MU, bool ON_CHIP>
__device__ __forceinline__ void warp_band_factor(const double* __restrict__ J,
                                                 const double* __restrict__ mdiag, double cval,
                                                 double* __restrict__ F, double* win, int C,
                                                 int lane, double& amax_out, double& gmax_out) {
  using diffsol_fused::nan_max;
  constexpr int NB = ML + MU + 1, NCOLS = N + MU;
  double amax = 0.0, gmax = 0.0;

  // lane -> sub-diagonal row i and its updates dj = js+1, js+1+S, ...: S =
  // 32 / ML lanes share a row (K3).  The update of (row k+i, column k+dj)
  // sits dj (NB - 1) doubles after that of (k+i, k).
  constexpr int MLX = ML > 0 ? ML : 1;
  constexpr int S = (ML > 0 && ML < WARP) ? WARP / ML : 1;
  const int i0 = (ML > 0 && lane < S * ML) ? lane % MLX + 1 : 0;  // 0: no row
  const int js = lane / MLX;
  constexpr int st = S * (NB - 1);
  // the column step at column ck with pivot reciprocal inv: e = e - l u,
  // l = a inv, four at a time with every load before the stores
  auto eliminate = [&](double* const ck, const double inv) {
    for (int i = i0; i >= 1 && i <= ML; i += WARP) {
      const double l = ck[MU + i] * inv;
      // u = U[k][k+dj] at up[0], e = A[k+i][k+dj] at up[i]
      double* up = ck + MU + (js + 1) * (NB - 1);
      int dj = js + 1;
      for (; dj + 3 * S <= MU; dj += 4 * S, up += 4 * st) {
        double u[4], v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          u[t] = up[t * st];
          v[t] = up[t * st + i];
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const double e = v[t] - l * u[t];
          up[t * st + i] = e;
          gmax = nan_max(gmax, fabs(e));
        }
      }
      for (; dj <= MU; dj += S, up += st) {
        const double e = up[i] - l * up[0];
        up[i] = e;
        gmax = nan_max(gmax, fabs(e));
      }
    }
  };

  if constexpr (!ON_CHIP) {
    for (int e = lane; e < N * NB; e += WARP) {
      const int d = e % NB;
      const double v = (d == MU ? (mdiag != nullptr ? mdiag[e / NB] : 1.0) : 0.0) - cval * J[e];
      F[e] = v;
      amax = nan_max(amax, fabs(v));
    }
    for (int e = lane; e < MU * NB; e += WARP) F[(size_t)N * NB + e] = e % NB == MU ? 1.0 : 0.0;
    for (int k = 0; k < N; ++k) {
      __syncwarp();
      double* const ck = F + (size_t)k * NB;
      const double inv = 1.0 / ck[MU];
      eliminate(ck, inv);
      __syncwarp();
      // the multipliers, as the product l = a * inv the updates used
      if (js == 0)
        for (int i = i0; i >= 1 && i <= ML; i += WARP) ck[MU + i] = ck[MU + i] * inv;
    }
    __syncwarp();
  } else {
    const int W = MU + 2 * C;
    double* const invs = win + W * NB;  // this chunk's pivot reciprocals
    int wbase = 0, done = 0;  // the window's first column; columns < done are assembled
    // columns [a, b) of J into the window, pad columns unit
    auto load = [&](int a, int b) {
      for (int e = lane; e < (b - a) * NB; e += WARP) {
        const int c = a + e / NB, d = e % NB;
        double* dst = win + (c - wbase) * NB + d;
        if (c >= N)
          *dst = d == MU ? 1.0 : 0.0;
        else
          __pipeline_memcpy_async(dst, J + (size_t)c * NB + d, sizeof(double));
      }
      __pipeline_commit();
    };

    load(0, min(MU + C, NCOLS));
    for (int k0 = 0; k0 < N; k0 += C) {
      const int k1 = min(k0 + C, N);
      __pipeline_wait_prior(0);
      __syncwarp();
      if (k0 > 0) {
        // slide by C columns, [C, 2C + MU) -> [0, C + MU), in passes of C
        // columns so that no pass reads what it writes
        for (int p0 = 0; p0 < C + MU; p0 += C) {
          const int cnt = min(C, C + MU - p0) * NB;
          const double* from = win + (p0 + C) * NB;
          double* to = win + p0 * NB;
          for (int e = lane; e < cnt; e += WARP) to[e] = from[e];
          __syncwarp();
        }
        wbase = k0;
      }
      // A = M - cJ on the columns that arrived (assemble_and_factor :391)
      const int upto = min(k1 + MU, N);
      for (int e = lane; e < (upto - done) * NB; e += WARP) {
        const int c = done + e / NB, d = e % NB;
        double* const a = win + (c - wbase) * NB + d;
        const double v = (d == MU ? (mdiag != nullptr ? mdiag[c] : 1.0) : 0.0) - cval * *a;
        *a = v;
        amax = nan_max(amax, fabs(v));
      }
      done = upto;
      __syncwarp();
      // the next chunk's new columns, in flight while this one is eliminated
      load(k1 + MU, min(k1 + C, N) + MU);
      for (int k = k0; k < k1; ++k) {
        __syncwarp();
        double* const ck = win + (k - wbase) * NB;
        const double inv = 1.0 / ck[MU];
        if (lane == 0) invs[k - k0] = inv;
        eliminate(ck, inv);
      }
      __syncwarp();
      // columns k0 .. k1-1 are final (and, after the last chunk, the pads):
      // write them once, each multiplier as the product l = a * inv the
      // updates used
      const int c1 = k1 == N ? NCOLS : k1;
      for (int e = lane; e < (c1 - k0) * NB; e += WARP) {
        const int c = k0 + e / NB, d = e % NB;
        double v = win[(c - wbase) * NB + d];
        if (d > MU && c < k1) v *= invs[c - k0];
        F[(size_t)c * NB + d] = v;
      }
    }
  }
  amax_out = amax;
  gmax_out = gmax;
}

// K4's sweeps for one member: solve A x = b in place of xs (shared memory,
// holding b in its N doubles) with warp_band_factor's factors F in device
// memory.  Behind xs lie C pivot reciprocals and two buffers of C columns
// by max(ML, MU + 1) factor rows (solve_doubles(C) doubles in all), which
// cp.async fills a chunk ahead of use: the forward sweep's multipliers over
// columns 0 .. N-2, then the back sweep's rows of U from column N-1 down.
// The back sweep is column-oriented, as K4's (x[k] is the sum times a
// reciprocal formed a chunk at a time off the chain, within an ulp of the
// plain version's row loop).
template <int N, int ML, int MU>
__host__ __device__ constexpr int solve_doubles(int C) {
  return N + C + 2 * C * (ML > MU + 1 ? ML : MU + 1);
}

template <int N, int ML, int MU>
__device__ __forceinline__ void warp_band_solve(const double* __restrict__ F, double* xs, int C,
                                                int lane) {
  constexpr int NB = ML + MU + 1, ROWS = ML > MU + 1 ? ML : MU + 1, MLX = ML > 0 ? ML : 1;
  const int cap = C * ROWS;
  double* const rinv = xs + N;  // a back chunk's 1 / U[k][k]
  double* const bufs = rinv + C;
  const int nf = (ML > 0 && N > 1) ? (N - 1 + C - 1) / C : 0;
  const int nq = nf + (N + C - 1) / C;
  // chunk q's columns [c0, c1): forward ones hold the ML multiplier rows,
  // back ones the MU + 1 rows of U
  auto span = [&](int q, int& c0, int& c1) {
    if (q < nf) {
      c0 = q * C;
      c1 = min(c0 + C, N - 1);
    } else {
      c1 = N - (q - nf) * C;
      c0 = max(c1 - C, 0);
    }
  };
  auto fetch = [&](int q) {
    int c0, c1;
    span(q, c0, c1);
    double* buf = bufs + (q & 1) * cap;
    if (q < nf) {
      for (int e = lane; e < (c1 - c0) * ML; e += WARP)
        __pipeline_memcpy_async(buf + e, F + (size_t)(c0 + e / MLX) * NB + MU + 1 + e % MLX,
                                sizeof(double));
    } else {
      for (int e = lane; e < (c1 - c0) * (MU + 1); e += WARP)
        __pipeline_memcpy_async(buf + e, F + (size_t)(c0 + e / (MU + 1)) * NB + e % (MU + 1),
                                sizeof(double));
    }
    __pipeline_commit();
  };

  fetch(0);
  double pending = 0.0;  // x[k+1] of the back sweep, stored one step late
  for (int q = 0; q < nq; ++q) {
    if (q + 1 < nq) {
      fetch(q + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    int c0, c1;
    span(q, c0, c1);
    const double* buf = bufs + (q & 1) * cap;
    if (q < nf) {
      // forward: x[k+i] -= L[k+i][k] x[k], i = 1 .. ML split over the lanes
      for (int k = c0; k < c1; ++k) {
        __syncwarp();
        const double xk = xs[k];
        const double* lk = buf + (k - c0) * ML;  // lk[i-1] = F[k][MU+i]
        for (int i = lane + 1; i <= ML && k + i < N; i += WARP)
          xs[k + i] = xs[k + i] - lk[i - 1] * xk;
      }
    } else {
      // back, column by column: x[k] = acc * (1 / U[k][k]); then x[k-dj]
      // -= U[k-dj][k] x[k], dj = 1 .. MU split over the lanes.  No lane
      // reads x[k+1] at step k, so lane 0 stores it then.
      for (int c = c0 + lane; c < c1; c += WARP)
        rinv[c - c0] = 1.0 / buf[(c - c0) * (MU + 1) + MU];
      for (int k = c1 - 1; k >= c0; --k) {
        __syncwarp();
        const double* uk = buf + (k - c0) * (MU + 1);  // uk[d] = F[k][d]
        const double xk = xs[k] * rinv[k - c0];
        if (lane == 0 && k + 1 < N) xs[k + 1] = pending;
        pending = xk;
        for (int dj = lane + 1; dj <= MU && k - dj >= 0; dj += WARP)
          xs[k - dj] = xs[k - dj] - uk[MU - dj] * xk;
      }
    }
    __syncwarp();
  }
  if (lane == 0) xs[0] = pending;
  __syncwarp();
}

}  // namespace diffsol_band


#ifndef DIFFSOL_BAND_LU_NO_ENTRY

#include <type_traits>

namespace diffsol_band {

constexpr int MEMBERS = 4;           // members a block, a warp each
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may take on sm_90

// How a launch lays out shared memory: MEMBERS members a block, C columns
// a chunk, `stride` elements a member (odd, so that the members' copies of
// one element sit in different banks), the window on chip or in device
// memory.  `elem` is the scalar's bytes (8: double, 4: float), so the
// float build's windows take half the bytes and stay on chip to wider
// bands (ml = mu <= 71 for the factor, against 45 for double).
struct Plan {
  int C, stride;
  bool on_chip;
  int elem;
  size_t bytes() const { return (size_t)MEMBERS * stride * elem; }
  bool fits() const { return bytes() <= SMEM_MAX; }
};

inline int odd(size_t v) { return (int)(v | 1); }
inline int chunk_cols(int nb) { return nb <= 8 ? 32 : 16; }
// K4 streams about 8 KB of factors a member a chunk: enough bytes in
// flight per SM to cover the memory latency
inline int solve_cols(int rows) { return rows <= 16 ? 64 : (rows < 1024 ? 1024 / rows : 1); }

// K3: a window of mu + 2C columns of nb doubles and C reciprocals a member;
// past the shared memory, the window is the factors' own columns in
// device memory and only the reciprocals stay on chip.
inline Plan factor_plan(int ml, int mu, int elem = sizeof(double)) {
  const int nb = ml + mu + 1, C = chunk_cols(nb);
  const Plan p{C, odd((size_t)(mu + 2 * C) * nb + C), true, elem};
  return p.fits() ? p : Plan{C, odd(C), false, elem};
}

// K4: two buffers of C columns by max(ml, mu + 1) factor rows, C pivot
// reciprocals and x, a member; past the shared memory, x stays in device
// memory (the output).  Neither fits past max(ml, mu + 1) = 3,631 (double;
// float: 7,263).  At heat1d's width x stays on chip to n ~ 6,900 (double)
// and ~ 14,200 (float).
inline Plan solve_plan(int n, int ml, int mu, int elem = sizeof(double)) {
  const int rows = ml > mu + 1 ? ml : mu + 1, C = solve_cols(rows);
  const Plan p{C, odd((size_t)(2 * rows + 1) * C + n), true, elem};
  return p.fits() ? p : Plan{C, odd((size_t)(2 * rows + 1) * C), false, elem};
}

// K3: band (B, nb, n) member-major, band[m][d][j] = A_m[j+d-mu][j] ->
// F (n+mu, nb, B) factored, pad columns included.  Warp g of the block
// factors member blockIdx.x * G + g.  T is double, or float for a float32
// problem (the counterpart of the float32 Pallas band LU); every cp.async
// piece is one element, aligned to its own size.
template <typename T, bool ON_CHIP>
__global__ void __launch_bounds__(MEMBERS * WARP)
band_lu_factor_kernel(const T* __restrict__ band, T* __restrict__ F, int n, int ml,
                      int mu, int B, int C, int stride) {
  // offsets: int within shared memory, size_t within F
  using Off = typename std::conditional<ON_CHIP, int, size_t>::type;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* const smem = reinterpret_cast<T*>(smem_bytes);
  const int nb = ml + mu + 1, ncols = n + mu, W = mu + 2 * C;
  constexpr int G = MEMBERS;
  const int g = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int m0 = blockIdx.x * G, m = m0 + g;
  const bool active = m < B;
  T* const mine = smem + (size_t)g * stride;
  T* const invs = ON_CHIP ? mine + (size_t)W * nb : mine;  // this chunk's reciprocals
  // row d of column c: base[(c - wbase) * cs + d * es], where the window
  // starts at column wbase (on chip) or is F itself (wbase = 0)
  T* const base = ON_CHIP ? mine : F + m;
  const Off es = ON_CHIP ? 1 : (Off)B, cs = (Off)nb * es;
  const T* const src = band + (size_t)m * nb * n;
  int wbase = 0;

  // columns [a, b) of this member into the window; pad columns are unit
  auto load = [&](int a, int b) {
    for (int c = a + lane; c < b; c += WARP) {
      T* dst = base + (Off)(c - wbase) * cs;
      for (int d = 0; d < nb; ++d) {
        if (c >= n) {
          dst[d * es] = (d == mu) ? T(1) : T(0);
        } else if constexpr (ON_CHIP) {
          __pipeline_memcpy_async(dst + d, src + (size_t)d * n + c, sizeof(T));
        } else {
          dst[d * es] = src[(size_t)d * n + c];
        }
      }
    }
  };

  // lane -> sub-diagonal row i (rows i, i+32, ... when ml > 32) and its
  // updates dj = js+1, js+1+S, ...: S = 32 / ml lanes share a row.  The
  // update of (row k+i, column k+dj) sits dj (nb - 1) rows after that of
  // (k+i, k), so a lane's addresses step by a constant.
  const int S = (ml > 0 && ml < WARP) ? WARP / ml : 1;
  const int i0 = (ml > 0 && lane < S * ml) ? lane % ml + 1 : 0;  // 0: no row
  const int js = ml > 0 ? lane / ml : 0;
  const Off st = (Off)S * (nb - 1) * es;

  if (active) load(0, min(mu + C, ncols));
  __pipeline_commit();
  for (int k0 = 0; k0 < n; k0 += C) {
    const int k1 = min(k0 + C, n);
    __pipeline_wait_prior(0);
    __syncthreads();
    if (ON_CHIP && k0 > 0) {
      // slide the window by C columns, [C, 2C + mu) -> [0, C + mu), in
      // passes of C columns so that no pass reads what it writes
      if (active)
        for (int p0 = 0; p0 < C + mu; p0 += C) {
          const int cnt = min(C, C + mu - p0) * nb;
          const T* from = mine + (p0 + C) * nb;
          T* to = mine + p0 * nb;
          for (int e = lane; e < cnt; e += WARP) to[e] = from[e];
          __syncwarp();
        }
      wbase = k0;
    }
    // the next chunk's new columns, in flight while this one is eliminated
    if (active) load(k1 + mu, min(k1 + C, n) + mu);
    __pipeline_commit();
    if (active) {
      for (int k = k0; k < k1; ++k) {
        __syncwarp();
        T* const ck = base + (Off)(k - wbase) * cs;
        const T inv = T(1) / ck[mu * es];
        if (lane == 0) invs[k - k0] = inv;
        for (int i = i0; i >= 1 && i <= ml; i += WARP) {
          const T l = ck[(mu + i) * es] * inv;
          // u = U[k][k+dj] at up[0], e = A[k+i][k+dj] at up[i es]; four
          // at a time, every load before the stores
          T* up = ck + mu * es + (Off)(js + 1) * (nb - 1) * es;
          const Off ie = (Off)i * es;
          int dj = js + 1;
          for (; dj + 3 * S <= mu; dj += 4 * S, up += 4 * st) {
            T u[4], v[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              u[t] = up[t * st];
              v[t] = up[t * st + ie];
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) up[t * st + ie] = v[t] - l * u[t];
          }
          for (; dj <= mu; dj += S, up += st) up[ie] = up[ie] - l * up[0];
        }
      }
    }
    __syncthreads();
    // columns k0 .. k1-1 are final (and, after the last chunk, the pads):
    // write them once, each multiplier as the product l = a * inv the
    // updates used
    if constexpr (ON_CHIP) {
      const int c1 = (k1 == n) ? ncols : k1;
      const int gg = threadIdx.x % G, dd = threadIdx.x / G;  // dd < 32
      const T* win = smem + (size_t)gg * stride;
      const T* sc = win + (size_t)W * nb;
      if (m0 + gg < B)
        for (int c = k0; c < c1; ++c) {
          const T* cc = win + (c - k0) * nb;
          for (int d = dd; d < nb; d += WARP) {
            T v = cc[d];
            if (d > mu && c < k1) v *= sc[c - k0];
            F[((size_t)c * nb + d) * B + m0 + gg] = v;
          }
        }
    } else if (active) {
      for (int e = lane; e < (k1 - k0) * ml; e += WARP) {
        const int c = k0 + e / ml, d = mu + 1 + e % ml;
        F[((size_t)c * nb + d) * B + m] *= invs[c - k0];
      }
    }
  }
}

// K4: F (n+mu, nb, fm) factored, b (B, n) -> x (B, n) with B a multiple
// of fm: right-hand side r reads factorization r % fm (fm = 1: one for
// every right-hand side; fm = B: one each; fm = B / naug: the naug-major
// augmented rows of a lockstep ensemble).  Warp g of the block solves
// right-hand side blockIdx.x * G + g.  T as K3's.
template <typename T, bool ON_CHIP>
__global__ void __launch_bounds__(MEMBERS * WARP)
band_lu_solve_kernel(const T* __restrict__ F, int fm, const T* __restrict__ b,
                     T* __restrict__ x, int n, int ml, int mu, int B, int C, int stride) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* const smem = reinterpret_cast<T*>(smem_bytes);
  const int nb = ml + mu + 1;
  const size_t fs = (size_t)fm;  // elements between F's (column, row) pairs
  constexpr int G = MEMBERS;
  const int g = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int m0 = blockIdx.x * G, m = m0 + g;
  const bool active = m < B;
  const int rows = ml > mu + 1 ? ml : mu + 1, cap = C * rows;
  T* const mine = smem + (size_t)g * stride;
  T* const rinv = mine + 2 * cap;  // a back chunk's 1 / U[k][k]
  T* const xs = ON_CHIP ? rinv + C : x + (size_t)m * n;
  // the chunks: nf forward ones over columns 0 .. n-2 (the ml multiplier
  // rows), then the backward ones over columns n-1 .. 0 (the mu+1 rows of U)
  const int nf = (ml > 0 && n > 1) ? (n - 1 + C - 1) / C : 0;
  const int nq = nf + (n + C - 1) / C;
  auto span = [&](int q, int& c0, int& c1, int& d0, int& nr) {
    if (q < nf) {
      c0 = q * C;
      c1 = min(c0 + C, n - 1);
      d0 = mu + 1;
      nr = ml;
    } else {
      c1 = n - (q - nf) * C;
      c0 = max(c1 - C, 0);
      d0 = 0;
      nr = mu + 1;
    }
  };
  // the block copies chunk q into buffer q & 1 of every member, G members
  // to a sector
  auto fetch = [&](int q) {
    int c0, c1, d0, nr;
    span(q, c0, c1, d0, nr);
    const int gg = threadIdx.x % G, dd = threadIdx.x / G;  // dd < 32
    if (m0 + gg < B) {
      T* buf = smem + (size_t)gg * stride + (q & 1) * cap;
      const T* f = F + (size_t)d0 * fs + (size_t)((m0 + gg) % fm);
      for (int c = c0; c < c1; ++c)
        for (int d = dd; d < nr; d += WARP)
          __pipeline_memcpy_async(buf + (c - c0) * nr + d, f + ((size_t)c * nb + d) * fs,
                                  sizeof(T));
    }
    __pipeline_commit();
  };

  if (active)
    for (int r = lane; r < n; r += WARP) xs[r] = b[(size_t)m * n + r];
  fetch(0);
  T pending = T(0);  // x[k+1] of the back sweep, stored one step late
  for (int q = 0; q < nq; ++q) {
    if (q + 1 < nq) {
      fetch(q + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    int c0, c1, d0, nr;
    span(q, c0, c1, d0, nr);
    const T* buf = mine + (q & 1) * cap;
    if (active && q < nf) {
      // forward: x[k+i] -= L[k+i][k] x[k], i = 1 .. ml split over the lanes
      for (int k = c0; k < c1; ++k) {
        __syncwarp();
        const T xk = xs[k];
        const T* lk = buf + (k - c0) * nr;  // lk[i-1] = F[k][mu+i]
        for (int i = lane + 1; i <= ml && k + i < n; i += WARP)
          xs[k + i] = xs[k + i] - lk[i - 1] * xk;
      }
    } else if (active) {
      // back, column by column: x[k] = acc * (1 / U[k][k]), the reciprocals
      // formed a chunk at a time off the chain (within an ulp of acc /
      // U[k][k]); then x[k-dj] -= U[k-dj][k] x[k], dj = 1 .. mu split over
      // the lanes.  No lane reads x[k+1] at step k, so lane 0 stores it then.
      for (int c = c0 + lane; c < c1; c += WARP) rinv[c - c0] = T(1) / buf[(c - c0) * nr + mu];
      for (int k = c1 - 1; k >= c0; --k) {
        __syncwarp();
        const T* uk = buf + (k - c0) * nr;  // uk[d] = F[k][d]
        const T xk = xs[k] * rinv[k - c0];
        if (lane == 0 && k + 1 < n) xs[k + 1] = pending;
        pending = xk;
        for (int dj = lane + 1; dj <= mu && k - dj >= 0; dj += WARP)
          xs[k - dj] = xs[k - dj] - uk[mu - dj] * xk;
      }
    }
    __syncthreads();
  }
  if (active) {
    if (lane == 0) xs[0] = pending;
    if (ON_CHIP) {
      __syncwarp();
      for (int r = lane; r < n; r += WARP) x[(size_t)m * n + r] = xs[r];
    }
  }
}

template <typename Kernel>
int allow_shared(Kernel kernel, const Plan& p) {
  if (p.bytes() <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)p.bytes());
}

}  // namespace diffsol_band

namespace diffsol_band {

template <typename T>
int factor_launch(const T* band, T* F, int n, int ml, int mu, int B, void* stream) {
  if (n < 1 || ml < 0 || mu < 0 || B < 1) return (int)cudaErrorInvalidValue;
  const Plan p = factor_plan(ml, mu, sizeof(T));
  auto kernel = p.on_chip ? band_lu_factor_kernel<T, true> : band_lu_factor_kernel<T, false>;
  if (const int rc = allow_shared(kernel, p)) return rc;
  kernel<<<(B + MEMBERS - 1) / MEMBERS, MEMBERS * WARP, p.bytes(), (cudaStream_t)stream>>>(
      band, F, n, ml, mu, B, p.C, p.stride);
  return (int)cudaGetLastError();
}

template <typename T>
int solve_launch(const T* F, int f_members, const T* b, T* x, int n, int ml, int mu, int B,
                 void* stream) {
  if (n < 1 || ml < 0 || mu < 0 || B < 1 || f_members < 1 || B % f_members != 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = solve_plan(n, ml, mu, sizeof(T));
  if (!p.fits()) return (int)cudaErrorInvalidValue;
  auto kernel = p.on_chip ? band_lu_solve_kernel<T, true> : band_lu_solve_kernel<T, false>;
  if (const int rc = allow_shared(kernel, p)) return rc;
  kernel<<<(B + MEMBERS - 1) / MEMBERS, MEMBERS * WARP, p.bytes(), (cudaStream_t)stream>>>(
      F, f_members, b, x, n, ml, mu, B, p.C, p.stride);
  return (int)cudaGetLastError();
}

}  // namespace diffsol_band

// The C entry points, bound with ctypes (ops/band_lu.py), the double build
// and the float build (_f32).  Pointers are device pointers; each launches
// on `stream` and returns the CUDA error of the shared-memory request or
// of the launch (0 = launched).
extern "C" int band_lu_factor_launch(const double* band, double* F, int n, int ml, int mu,
                                     int B, void* stream) {
  return diffsol_band::factor_launch(band, F, n, ml, mu, B, stream);
}

extern "C" int band_lu_factor_launch_f32(const float* band, float* F, int n, int ml, int mu,
                                         int B, void* stream) {
  return diffsol_band::factor_launch(band, F, n, ml, mu, B, stream);
}

// f_members factorizations, any divisor of the B right-hand sides:
// right-hand side r reads factorization r % f_members
extern "C" int band_lu_solve_launch(const double* F, int f_members, const double* b, double* x,
                                    int n, int ml, int mu, int B, void* stream) {
  return diffsol_band::solve_launch(F, f_members, b, x, n, ml, mu, B, stream);
}

extern "C" int band_lu_solve_launch_f32(const float* F, int f_members, const float* b,
                                        float* x, int n, int ml, int mu, int B, void* stream) {
  return diffsol_band::solve_launch(F, f_members, b, x, n, ml, mu, B, stream);
}

// The dynamic shared memory a block of the factor (solve = 0) or of the
// solve (solve = 1) takes at these shapes, for the build report; elem is
// the scalar's bytes (8: the double build, 4: the float build).
extern "C" int band_lu_shared_bytes(int n, int ml, int mu, int solve, int elem) {
  using namespace diffsol_band;
  return (int)(solve ? solve_plan(n, ml, mu, elem) : factor_plan(ml, mu, elem)).bytes();
}

#endif  // DIFFSOL_BAND_LU_NO_ENTRY
