// Fused whole-solve BDF kernel for small-n ensembles, CUDA C++ for sm_90a.
//
// Replaces diffsol_tpu/ops/pallas_stepper.py::make_pallas_bdf_solve (the
// Pallas kernel body at pallas_stepper.py:656).  One thread block solves
// one member TILE, one thread per member: the whole adaptive NDF(1-5)
// solve -- prediction from the difference matrix D, stale-Jacobian Newton
// with dual-number Jacobian columns and a partial-pivot LU, the WRMS error
// test, the PI controller, the difference update, order selection, the
// R.U rescale of D and dense output at t_eval -- in one launch.  The
// tile's members share one step sequence (tiled lockstep): every WRMS norm
// is the max over the tile, so every control decision is uniform across the
// block and the block never diverges around a __syncthreads.  The plain
// PyTorch version of the same algorithm is
// diffsol_tpu_torch/ops/fused_stepper.py::fused_bdf_reference.
//
// Beside the plain ODE solve the kernel computes, each switched on at
// compile time by the generated model header so that a problem without it
// instantiates the ODE kernel unchanged:
//  * a diagonal mass (MODEL_HAS_MASS): Newton matrix diag(m) - cJ and
//    residual m (x - y_pred + psi) - c f(x); a constant diagonal is literal
//    assignments in model_mass and folds away, a t- or p-dependent one is
//    re-evaluated at every step's t_pred (pallas_stepper.py:801);
//  * quadrature of MODEL_NQUAD outputs (model_out, or the state itself): a
//    second difference matrix gD beside D, with or without a share in the
//    error test (pallas_stepper.py:1268-1325);
//  * MODEL_NROOT root functions (pallas_stepper.py:1436-1760): after an
//    accepted step every member scans its own sign changes, the tile must
//    agree (else FAIL_ROOT_INCONS), member 0's crossing is polished by the
//    modified secant -- every thread runs member 0's polish on member 0's
//    difference matrix and parameters, shared once behind one barrier, so
//    each iteration's decisions are uniform too -- and the tile is pinned
//    to the shared root time, where it stops (ROOT_STOP) or applies
//    model_reset and restarts the difference matrices at order 1.
//
// What bounds it on the H100: not bytes -- a member's state, D (8 x N),
// J, the LU and its pivots live in the thread's registers for the whole
// solve, and device memory sees only the parameters in and ys out -- and
// not the member's own arithmetic either.  The main path (10,000 Robertson
// members, tile 128) is 79 blocks of 4 warps, one warp for each of an SM's
// four schedulers, so every dependent operation costs its full latency,
// and the step is one chain.  Measured by phase (scripts/torch_k1_phases.py,
// clock64 on thread 0 of each tile, H100 80GB HBM3 at 700 W), the chain
// was ~18,600 cycles an attempt, and the member's rhs, Jacobian probes, LU
// and solves 7 % of it; the tile-uniform control around them took the
// rest: three f64 pow calls a Newton iteration (~1,000 cycles each: a
// call to __internal_accurate_pow, a chain of some hundred f64
// operations), one in every error test and three in order selection, two
// barriers and five shuffle rounds in every tile reduction, and the
// divisions of the WRMS weights and of R.U.  So the design shortens the
// chain that one warp per scheduler walks alone:
//  * a power only where the result is used: none in a Newton iteration
//    until the third (the rate of the second is a ratio, the projected
//    norm's integer power a product, eta a quotient); the first
//    iteration's eta^0.8 once a launch for the two reset values, a power a
//    step only for a remembered eta; the error test's PI factor only for a
//    failed step; order selection's three factors one a warp, side by side;
//  * a tile reduction is two 32-bit redux instructions a warp (the max of
//    doubles >= 0 by their bit patterns), one slot a warp in shared memory
//    and one barrier, the slots alternating between consecutive reductions
//    (TileRed); reductions whose inputs are ready together share it (the
//    initial norms, order selection's two estimates, the quadrature's error
//    share, the root scan's flags and crossing indices);
//  * the error weights 1 / (|y_pred| rtol + atol) once a step, for every
//    Newton norm and the error norm; R(f)'s factors multiply by constant
//    reciprocals; D is updated and rescaled in place;
//  * the member's LU swaps rows, and the solve its right-hand side, by
//    compare-and-select, so they stay in registers.
// The chain fell to ~9,100 cycles an attempt and the main path's kernel
// from 2.9 to 1.2 ms (PERF.md).  The member work stays on one
// thread: split over lanes it would shorten a part that is a fifth of the
// step at n = 8 and less at n = 3.  Registers are the scarce resource: at
// N = 8 a thread holds D, J and the LU, some 200 doubles, and ptxas spills
// (chip_smoke.py phase 2 prints registers, stack frame and spill bytes).
//
// Everything is double: the state, D, J, the LU and every heuristic (the
// Pallas kernel keeps its heuristics in f32 and its state in double-float
// pairs because Mosaic has no f64).  With MODEL_MIXED (the Pallas kernel's
// precision="mixed", pallas_stepper.py:463-471) the Newton MATRIX path is
// float: the Jacobian probes instantiate the model with Dual<float>, J, the
// LU and its reciprocal diagonal are float, and each Newton residual is
// rounded to float for the triangular solves and the correction widened
// back; the state, D, the residual, time and every norm stay double.  An
// inexact Newton matrix costs convergence rate, not accuracy.  Without the
// switch the matrix type is double and the kernel is the all-double one.
//
// The translation unit that includes this header first includes the model
// header generated by eqn_codegen, which defines MODEL_N, MODEL_NP, the
// switches above and diffsol_model::model_rhs<T> / model_init<T> and, as
// switched on, model_mass, model_root, model_reset and model_out.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "bdf_common.cuh"
#include "dual.cuh"

namespace diffsol_fused {

// Two instantiations by block size: tiles up to 256 threads leave each up
// to 255 registers (__launch_bounds__(256)); larger tiles, up to the
// block limit of 1024, get 64 registers a thread and spill.
constexpr int SMALL_TILE = 256;
constexpr int MAX_TILE = 1024;

constexpr bool HAS_MASS = MODEL_HAS_MASS != 0;
constexpr int NROOT = MODEL_NROOT;
constexpr bool HAS_RESET = MODEL_HAS_RESET != 0;
constexpr int NQ = MODEL_NQUAD;  // quadrature rows
constexpr bool OUT_IN_ERR = MODEL_OUT_IN_ERR != 0;
// array extents that stay legal when a feature is off
constexpr int NRX = NROOT > 0 ? NROOT : 1;
constexpr int NQX = NQ > 0 ? NQ : 1;
// the scalar type of the Newton matrix path: J, LU and the linear solve
#ifndef MODEL_MIXED
#define MODEL_MIXED 0
#endif
constexpr bool MIXED = MODEL_MIXED != 0;
#if MODEL_MIXED
typedef float MT;
#else
typedef double MT;
#endif

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ double mt_abs(double x) { return fabs(x); }
__device__ __forceinline__ float mt_abs(float x) { return fabsf(x); }

// Every number of the solve.  The host fills it as the ctypes.Structure
// fused_stepper.py::CConfig, which mirrors this layout field for field
// (the wrapper checks sizeof(Config) through fused_bdf_config_size).
struct Config {
  double t0, rtol, nl_tol, ki, kp, min_timestep, thresh_update_jac, eta_floor;
  double atol[8];
  double alpha[MAX_ORDER + 1], gamma[MAX_ORDER + 1], ec2[MAX_ORDER + 1];
  double U[ND][ND];
  double min_shrink, max_growth, dead_lo, dead_hi, eta_reset_jac, eta_reset_step;
  int max_steps, max_newton_iter, max_newton_fails, max_err_fails;
  int update_jac_after, update_rhs_jac_after, jac_reuse;
  int neval, nbatch, tile, ntiles;
  int max_secant_iters, pad_;
  double out_rtol, out_atol[8];
};

// 1 / (|y| rtol + atol): the error weights of a WRMS norm, once for all
// the norms that divide by the same y
template <int N>
__device__ __forceinline__ void inv_weights(const double* y, const Config& c, double* w) {
#pragma unroll
  for (int s = 0; s < N; ++s) w[s] = 1.0 / (fabs(y[s]) * c.rtol + c.atol[s]);
}

// this member's mean over states of (x w)^2
template <int N>
__device__ __forceinline__ double wrms_local(const double* x, const double* w) {
  double acc = 0.0;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const double q = x[s] * w[s];
    acc += q * q;
  }
  return acc * (1.0 / N);
}

// Tile reductions, one barrier each.  Lane 0 of every warp writes its
// warp's value into slot[parity]; after the barrier every thread combines
// the NW slots (NW = the build's warps a block; slots of warps the block
// does not have hold 0, which changes no result).  A thread rewrites
// slot[parity] two reductions later, after the barrier of the one in
// between, which no thread passes before it has read this one.
template <int NW>
struct TileRed {
  unsigned long long (*slot)[2][NW];  // shared: [parity][value][warp]
  int parity;

  // every slot 0, then a barrier: call once, before the first reduction
  __device__ __forceinline__ void init() {
    for (int e = threadIdx.x; e < 2 * 2 * NW; e += blockDim.x) (&slot[0][0][0])[e] = 0ull;
    __syncthreads();
  }

  // a warp's max of doubles >= +0 (or NaN) by their bit patterns, which
  // order as the values do (a NaN above +inf, as nan_max keeps it): two
  // 32-bit redux instructions in place of five shuffle rounds
  static __device__ __forceinline__ unsigned long long warp_max_bits(double v) {
    const unsigned long long b = (unsigned long long)__double_as_longlong(v);
    const unsigned hi = (unsigned)(b >> 32);
    const unsigned mhi = __reduce_max_sync(0xffffffffu, hi);
    const unsigned mlo = __reduce_max_sync(0xffffffffu, hi == mhi ? (unsigned)b : 0u);
    return ((unsigned long long)mhi << 32) | mlo;
  }

  static __device__ __forceinline__ unsigned long long umax(unsigned long long a,
                                                            unsigned long long b) {
    return a > b ? a : b;
  }

  __device__ __forceinline__ unsigned long long combine_max(int v) const {
    unsigned long long a[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) a[w] = slot[parity][v][w];
#pragma unroll
    for (int h = NW / 2; h > 0; h >>= 1)
#pragma unroll
      for (int w = 0; w < h; ++w) a[w] = umax(a[w], a[w + h]);
    return a[0];
  }

  // the tile's max of a >= +0 (or NaN), and of the pair (a, b)
  __device__ __forceinline__ double max(double a) {
    const unsigned long long wa = warp_max_bits(a);
    if ((threadIdx.x & 31) == 0) slot[parity][0][threadIdx.x >> 5] = wa;
    __syncthreads();
    const double r = __longlong_as_double((long long)combine_max(0));
    parity ^= 1;
    return r;
  }
  __device__ __forceinline__ double2 max2(double a, double b) {
    const unsigned long long wa = warp_max_bits(a), wb = warp_max_bits(b);
    if ((threadIdx.x & 31) == 0) {
      slot[parity][0][threadIdx.x >> 5] = wa;
      slot[parity][1][threadIdx.x >> 5] = wb;
    }
    __syncthreads();
    const double2 r = make_double2(__longlong_as_double((long long)combine_max(0)),
                                   __longlong_as_double((long long)combine_max(1)));
    parity ^= 1;
    return r;
  }

  // the tile's OR of `bits`, with the max of `hi` and of `lo`: (or, hi, lo)
  __device__ __forceinline__ uint3 or_max_max(unsigned bits, unsigned hi, unsigned lo) {
    const unsigned wo = __reduce_or_sync(0xffffffffu, bits);
    const unsigned wh = __reduce_max_sync(0xffffffffu, hi);
    const unsigned wl = __reduce_max_sync(0xffffffffu, lo);
    if ((threadIdx.x & 31) == 0) {
      slot[parity][0][threadIdx.x >> 5] = ((unsigned long long)wh << 32) | wo;
      slot[parity][1][threadIdx.x >> 5] = wl;
    }
    __syncthreads();
    uint3 r = make_uint3(0u, 0u, 0u);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned long long a = slot[parity][0][w];
      r.x |= (unsigned)a;
      r.y = ::max(r.y, (unsigned)(a >> 32));
      r.z = ::max(r.z, (unsigned)slot[parity][1][w]);
    }
    parity ^= 1;
    return r;
  }
};

// J[r][c] = df_r/dy_c from N dual probes in the scalar type S
// (pallas_stepper.py:755-775; jac_cols32 for float)
template <int N, int NP, typename S>
__device__ __forceinline__ void jacobian(double t, const double* y, const double* p, S (*J)[N]) {
  constexpr int NPX = NP > 0 ? NP : 1;
  const Dual<S> td((S)t, (S)0.0);
  Dual<S> pd[NPX], yd[N], out[N];
#pragma unroll
  for (int j = 0; j < NP; ++j) pd[j] = Dual<S>((S)p[j], (S)0.0);
#pragma unroll
  for (int c = 0; c < N; ++c) {
#pragma unroll
    for (int r = 0; r < N; ++r) yd[r] = Dual<S>((S)y[r], r == c ? (S)1.0 : (S)0.0);
    diffsol_model::model_rhs<Dual<S> >(td, yd, pd, out);
#pragma unroll
    for (int r = 0; r < N; ++r) J[r][c] = out[r].d;
  }
}

// LU with partial pivoting of A = M - c J, M the identity or diag(md)
// (_lu_factor_df, pallas_stepper.py:144-194, with real row swaps): the row
// of largest |A[r][k]| (first on ties) becomes the pivot row and piv[k] its
// index, as LAPACK's ipiv; rdiag[k] = 1/U[k][k].  Every array index is a
// compile-time constant: each row swap is a compare-and-select over the
// candidate rows, so A, piv and rdiag stay in registers.
template <int N, typename S>
__device__ __forceinline__ void lu_factor(const S (*J)[N], S c, const S* md, S (*A)[N],
                                          int* piv, S* rdiag) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    piv[r] = r;
#pragma unroll
    for (int q = 0; q < N; ++q)
      A[r][q] = (r == q ? (HAS_MASS ? md[r] : (S)1.0) : (S)0.0) - c * J[r][q];
  }
#pragma unroll
  for (int k = 0; k < N - 1; ++k) {
    int pk = k;
    S bm = mt_abs(A[k][k]);
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const S mag = mt_abs(A[r][k]);
      if (mag > bm) pk = r;
      bm = nan_max(mag, bm);
    }
    piv[k] = pk;
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const bool sw = r == pk;
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const S a = A[k][q], b = A[r][q];
        A[k][q] = sw ? b : a;
        A[r][q] = sw ? a : b;
      }
    }
    const S inv = (S)1.0 / A[k][k];
    rdiag[k] = inv;
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const S l = A[r][k] * inv;
      A[r][k] = l;
#pragma unroll
      for (int q = k + 1; q < N; ++q) A[r][q] -= l * A[k][q];
    }
  }
  rdiag[N - 1] = (S)1.0 / A[N - 1][N - 1];
}

// solve with lu_factor's output (_lu_solve_df, pallas_stepper.py:197-216):
// b's rows swapped as the factor swapped A's, in the same order and by the
// same compare-and-select, then the two triangular sweeps
template <int N, typename S>
__device__ __forceinline__ void lu_solve(const S (*A)[N], const int* piv, const S* rdiag,
                                         const S* b, S* out) {
  S xs[N];
#pragma unroll
  for (int r = 0; r < N; ++r) xs[r] = b[r];
#pragma unroll
  for (int k = 0; k < N - 1; ++k) {
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const bool sw = r == piv[k];
      const S a = xs[k], c = xs[r];
      xs[k] = sw ? c : a;
      xs[r] = sw ? a : c;
    }
  }
#pragma unroll
  for (int r = 1; r < N; ++r) {
    S acc = xs[r];
#pragma unroll
    for (int j = 0; j < r; ++j) acc -= A[r][j] * xs[j];
    xs[r] = acc;
  }
#pragma unroll
  for (int r = N - 1; r >= 0; --r) {
    S acc = xs[r];
#pragma unroll
    for (int j = r + 1; j < N; ++j) acc -= A[r][j] * out[j];
    out[r] = acc * rdiag[r];
  }
}

// The Newton matrix in the build's matrix type MT: factor M - cJ, and solve
// with the residual rounded to MT and the correction widened back
// (_lu_factor_f32 / _lu_solve_f32 under precision="mixed",
// pallas_stepper.py:1046-1086, :1201-1210).
template <int N>
__device__ __forceinline__ void factor_newton(const MT (*J)[N], double c, const double* md,
                                              MT (*A)[N], int* piv, MT* rdiag) {
  if constexpr (MIXED) {
    float mdf[N];
    if constexpr (HAS_MASS) {
#pragma unroll
      for (int s = 0; s < N; ++s) mdf[s] = (float)md[s];
    }
    lu_factor<N, float>(J, (float)c, mdf, A, piv, rdiag);
  } else {
    lu_factor<N, double>(J, c, md, A, piv, rdiag);
  }
}

template <int N>
__device__ __forceinline__ void solve_newton(const MT (*A)[N], const int* piv, const MT* rdiag,
                                             const double* b, double* out) {
  if constexpr (MIXED) {
    float bf[N], of[N];
#pragma unroll
    for (int s = 0; s < N; ++s) bf[s] = (float)b[s];
    lu_solve<N, float>(A, piv, rdiag, bf, of);
#pragma unroll
    for (int s = 0; s < N; ++s) out[s] = (double)of[s];
  } else {
    lu_solve<N, double>(A, piv, rdiag, b, out);
  }
}

// the quadrature's integrand: model_out, or the state itself
template <int N>
__device__ __forceinline__ void eval_out(double t, const double* y, const double* p,
                                         double* o) {
#if MODEL_HAS_OUT
  diffsol_model::model_out<double>(t, y, p, o);
#else
#pragma unroll
  for (int s = 0; s < NQ; ++s) o[s] = y[s];
#endif
}

// the accepted step's interpolation polynomial at te (D rows of width M)
template <int M>
__device__ __forceinline__ void interp(const double (*D)[M], double t_new, double h,
                                       int order, double te, double* out) {
#pragma unroll
  for (int s = 0; s < M; ++s) out[s] = D[0][s];
  double tf = 1.0;
#pragma unroll
  for (int i = 0; i < MAX_ORDER; ++i) {
    const double tf_new = tf * ((te - (t_new - h * i)) / (h * (1 + i)));
    if (i < order) {
#pragma unroll
      for (int s = 0; s < M; ++s) out[s] += tf_new * D[i + 1][s];
      tf = tf_new;
    }
  }
}

#if MODEL_NROOT > 0
// Sign-change scan between two sets of root values (ops/rootfind.py
// root_finding): any crossing, any exact zero in g1, and the strongest
// crossing's index (first on ties).
__device__ __forceinline__ void root_scan(const double* g0, const double* g1, bool* found,
                                          bool* zero, int* imax) {
  bool f = false, z = false;
  int im = 0;
  double best = 0.0;
#pragma unroll
  for (int r = 0; r < NROOT; ++r) {
    const bool crossed = g0[r] * g1[r] < 0.0;
    const double frac = crossed ? fabs(g1[r] / (g1[r] - g0[r])) : 0.0;
    f = f || crossed;
    z = z || g1[r] == 0.0;
    if (r == 0) {
      best = frac;
    } else {
      if (frac > best) im = r;
      best = nan_max(frac, best);
    }
  }
  *found = f;
  *zero = z;
  *imax = im;
}

__device__ __forceinline__ double pick(const double* g, int idx) {
  double v = g[0];
#pragma unroll
  for (int r = 1; r < NROOT; ++r)
    if (idx == r) v = g[r];
  return v;
}
#endif

template <int N, int NP, int MAXT>
__global__ void __launch_bounds__(MAXT)
fused_bdf_kernel(const double* __restrict__ params, const double* __restrict__ t_eval,
                 double* __restrict__ ys, double* __restrict__ gs, int* __restrict__ info,
                 double* __restrict__ root_t_out, const Config c) {
  constexpr int NPX = NP > 0 ? NP : 1;
  constexpr int NW = MAXT / 32;
  __shared__ unsigned long long red_slots[2][2][NW];
  __shared__ double ru[ND][ND];
  __shared__ double sel_f[3];  // order selection's PI factors, a warp each
#if MODEL_NROOT > 0
  // member 0's difference matrix and root values, for the root polish
  __shared__ double bc[ND * N + 2 * NROOT + 1];
#endif
  TileRed<NW> red{red_slots, 0};
  red.init();

  // threads past the tile (blockDim is a multiple of 32) replicate the
  // tile's last member, so they never change a tile-wide max
  const int tid = (int)threadIdx.x;
  const int lane = tid < c.tile ? tid : c.tile - 1;
  const int m = blockIdx.x * c.tile + lane;  // this thread's member
  const bool writer = tid < c.tile && m < c.nbatch;
  // the last tile's pad members replicate the last member
  // (pallas_stepper.py:2037-2039)
  const int mp = m < c.nbatch ? m : c.nbatch - 1;
  double p[NPX];
#pragma unroll
  for (int j = 0; j < NP; ++j) p[j] = params[(size_t)mp * NP + j];
  // the first Newton iteration's eta after a refactor or a step change:
  // the same two powers every step, taken once
  const double eta_jac_first = pow(nan_max(c.eta_reset_jac, c.eta_floor), 0.8);
  const double eta_step_first = pow(nan_max(c.eta_reset_step, c.eta_floor), 0.8);

  // ---- initial state and step size (pallas_stepper.py:837-907)
  double t = c.t0;
  double h;
  double D[ND][N];
  {
    double y0[N], dy0[N], y1[N], f1[N], w0[N];
    diffsol_model::model_init<double>(t, p, y0);
    diffsol_model::model_rhs<double>(t, y0, p, dy0);
#if MODEL_HAS_MASS
    {
      // dy0 = f/m on the differential rows and 0 on the algebraic ones: the
      // host probe saw consistent initial conditions
      double m0[N];
      diffsol_model::model_mass<double>(t, p, m0);
#pragma unroll
      for (int s = 0; s < N; ++s) dy0[s] = m0[s] != 0.0 ? dy0[s] / m0[s] : 0.0;
    }
#endif
    inv_weights<N>(y0, c, w0);
    const double2 d01 = red.max2(wrms_local<N>(y0, w0), wrms_local<N>(dy0, w0));
    const double d0 = sqrt(d01.x), d1 = sqrt(d01.y);
    const double h0 = (d0 < 1e-5 || d1 < 1e-5) ? 1e-6 : 0.01 * (d0 / d1);
#pragma unroll
    for (int s = 0; s < N; ++s) y1[s] = y0[s] + h0 * dy0[s];
    diffsol_model::model_rhs<double>(t + h0, y1, p, f1);
#pragma unroll
    for (int s = 0; s < N; ++s) f1[s] = f1[s] - dy0[s];
    const double d2 = sqrt(red.max(wrms_local<N>(f1, w0))) / fabs(h0);
    const double max_d = nan_max(d1, d2);
    const double h1 = max_d < 1e-15 ? nan_max(h0 * 1e-3, 1e-6) : pow(0.01 / max_d, 0.5);
    h = nan_min(100.0 * h0, h1);
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int s = 0; s < N; ++s) D[i][s] = 0.0;
#pragma unroll
    for (int s = 0; s < N; ++s) {
      D[0][s] = y0[s];
      D[1][s] = h * dy0[s];
    }
  }
  // the quadrature's difference matrix: g(t0) = 0, gD[1] = h out(t0, y0)
  double gD[ND][NQX];
  if constexpr (NQ > 0) {
    double dg0[NQX];
    eval_out<N>(t, D[0], p, dg0);
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int s = 0; s < NQ; ++s) gD[i][s] = i == 1 ? h * dg0[s] : 0.0;
  }
  // the root function at the current point, and the last root
  double rootg[NRX];
  int n_roots = 0, root_idx = -1;
  double root_t = NAN;
#if MODEL_NROOT > 0
  diffsol_model::model_root<double>(t, D[0], p, rootg);
  // member 0 of the tile, whose crossing the polish follows
  double p0[NPX];
#pragma unroll
  for (int j = 0; j < NP; ++j) p0[j] = params[(size_t)blockIdx.x * c.tile * NP + j];
#endif

  // ---- the step loop; every branch below is uniform across the block
  {
    int k = 0, steps = 0, status = OK, nxt = 0, order = 1, n_equal = 0;
    int conv_fail = 0, newton_fails = 0, err_fails = 0, h_changed = 0;
    double prev_err = NAN, c_last = 0.0, eta_mem = c.eta_reset_jac;
    int ssj = 0, ssrj = 0;
    MT J[N][N], LU[N][N], rdiag[N];
    int piv[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      piv[r] = r;
      rdiag[r] = (MT)0.0;
#pragma unroll
      for (int q = 0; q < N; ++q) J[r][q] = LU[r][q] = (MT)0.0;
    }
    const double mnewt = (double)c.max_newton_iter;
    // the next output time, kept in a register
    double te_next = t_eval[0];

    while (status == OK && k < c.max_steps && nxt < c.neval) {
      const double alpha_k = c.alpha[order];
      const double cval = h * alpha_k;
      const double t_pred = t + h;

      // ---- predict + psi from D
      double y_pred[N], psi[N];
#pragma unroll
      for (int s = 0; s < N; ++s) {
        double a = D[0][s];
        double b = c.gamma[1] * D[1][s];
#pragma unroll
        for (int i = 1; i <= MAX_ORDER; ++i) {
          if (i <= order) a += D[i][s];
          if (i >= 2 && i <= order) b += c.gamma[i] * D[i][s];
        }
        y_pred[s] = a;
        psi[s] = b * alpha_k;
      }
      // the step's error weights: every Newton norm and the error norm
      double w[N];
      inv_weights<N>(y_pred, c, w);

      double md[N];
#if MODEL_HAS_MASS
      diffsol_model::model_mass<double>(t_pred, p, md);
#endif

      // ---- stale-Jacobian policy (pallas_stepper.py:1094-1174)
      double eta0, eta_first;  // eta_first = max(eta0, floor)^0.8
      if (c.jac_reuse) {
        const double rel = fabs(cval / (c_last == 0.0 ? cval : c_last) - 1.0);
        const bool refresh = k == 0 || conv_fail > 0 || ssrj >= c.update_rhs_jac_after;
        const bool refactor = refresh || rel > c.thresh_update_jac || ssj >= c.update_jac_after;
        eta0 = refactor ? c.eta_reset_jac : (h_changed == 1 ? c.eta_reset_step : eta_mem);
        // a power only for a remembered eta
        if (refactor) eta_first = eta_jac_first;
        else if (h_changed == 1) eta_first = eta_step_first;
        else eta_first = pow(nan_max(eta_mem, c.eta_floor), 0.8);
        if (refresh) jacobian<N, NP, MT>(t_pred, y_pred, p, J);
        if (refactor) factor_newton<N>(J, cval, md, LU, piv, rdiag);
        if (refactor) c_last = cval;
        ssj = refactor ? 0 : ssj + 1;
        ssrj = refresh ? 0 : ssrj + 1;
      } else {
        jacobian<N, NP, MT>(t_pred, y_pred, p, J);
        factor_newton<N>(J, cval, md, LU, piv, rdiag);
        eta0 = c.eta_reset_jac;
        eta_first = eta_jac_first;
      }

      // ---- Newton on M (x - y_pred + psi) - c f(x) (pallas_stepper.py:1176-1265)
      double ypp[N], x[N];
#pragma unroll
      for (int s = 0; s < N; ++s) {
        ypp[s] = psi[s] - y_pred[s];
        x[s] = y_pred[s];
      }
      double first_nrm = 0.0, eta_run = eta0;
      int niter = 0, nstat = 0;
      while (nstat == 0 && niter < c.max_newton_iter) {
        double fx[N], res[N], delta[N];
        diffsol_model::model_rhs<double>(t_pred, x, p, fx);
#pragma unroll
        for (int s = 0; s < N; ++s)
          res[s] = (HAS_MASS ? md[s] * (x[s] + ypp[s]) : (x[s] + ypp[s])) - cval * fx[s];
        solve_newton<N>(LU, piv, rdiag, res, delta);
#pragma unroll
        for (int s = 0; s < N; ++s) x[s] = x[s] - delta[s];
        const double nrm = sqrt(red.max(wrms_local<N>(delta, w)));
        niter += 1;
        // the first iteration has no rate: eta is eta_first.  Later ones:
        // rate = (nrm / first_nrm)^(1 / (niter - 1)), a power only from the
        // third iteration on; divergence when rate > 0.9 or when the
        // projected norm rate^left / (1 - rate) nrm, an integer power taken
        // by multiplication, passes the tolerance
        double eta_new;
        bool diverged = false;
        if (niter == 1) {
          eta_new = eta_first;
          first_nrm = nrm;
        } else {
          const double ratio = nan_max(nrm / nan_max(first_nrm, 0.0), 1e-30);
          double rate = niter == 2 ? ratio : pow(ratio, 1.0 / (double)(niter - 1));
          if (!isfinite(rate)) rate = INFINITY;
          eta_new = rate / (1.0 - rate);
          diverged = rate > 0.9;
          if (!diverged) {
            double rl = 1.0;
            for (int i = niter; i < c.max_newton_iter; ++i) rl *= rate;
            diverged = rl / (1.0 - rate) * nrm > c.nl_tol;
          }
        }
        const bool converged = (eta_new * nrm < c.nl_tol) && !diverged;
        nstat = diverged ? 2 : (converged ? 1 : 0);
        eta_run = eta_new;
      }
      const bool solve_ok = nstat == 1;
      double d[N];
#pragma unroll
      for (int s = 0; s < N; ++s) d[s] = x[s] - y_pred[s];

      // ---- quadrature delta d_g = c dg - psi_g (pallas_stepper.py:1268-1279)
      double g_delta[NQX];
      if constexpr (NQ > 0) {
        double dg[NQX];
        eval_out<N>(t_pred, y_pred, p, dg);
#pragma unroll
        for (int s = 0; s < NQ; ++s) {
          double b = c.gamma[1] * gD[1][s];
#pragma unroll
          for (int i = 2; i <= MAX_ORDER; ++i)
            if (i <= order) b += c.gamma[i] * gD[i][s];
          g_delta[s] = cval * dg[s] - b * alpha_k;
        }
      }

      // ---- error test and step-size control (pallas_stepper.py:1281-1319)
      double err;
      if constexpr (OUT_IN_ERR) {
        // the quadrature joins the max with the NEXT error constant; both
        // norms in one reduction
        double acc = 0.0;
#pragma unroll
        for (int s = 0; s < NQ; ++s) {
          const double q = g_delta[s] / (fabs(gD[0][s]) * c.out_rtol + c.out_atol[s]);
          acc += q * q;
        }
        const double2 e2 = red.max2(wrms_local<N>(d, w), acc * (1.0 / NQX));
        err = nan_max(e2.x * c.ec2[order - 1], e2.y * c.ec2[order]);
      } else {
        err = red.max(wrms_local<N>(d, w)) * c.ec2[order - 1];
      }
      const bool accepted = solve_ok && err <= 1.0;
      const bool second = !solve_ok && conv_fail == 1;
      const bool err_fail = solve_ok && !accepted;
      newton_fails += solve_ok ? 0 : 1;
      // the PI factor only shrinks a failed step
      double factor_r = 0.3;
      if (err_fail) {  // uniform
        const double safety = 0.9 * (2.0 * mnewt + 1.0) / (2.0 * mnewt + niter);
        factor_r = nan_max(safety * pi_raw(err, prev_err, c.ki, c.kp, order + 1), c.min_shrink);
      }
      const bool do_rescale = err_fail || second;

      // ---- accepted-step difference update (pallas_stepper.py:416-438), in
      // place: a rejected step keeps D as it was, so no second copy of D
      // lives through the rest of the step
      if (accepted) {  // uniform
#pragma unroll
        for (int s = 0; s < N; ++s) {
          double dold = 0.0;
#pragma unroll
          for (int i = 0; i < ND; ++i)
            if (i == order + 1) dold = D[i][s];
          double acc = 0.0;
#pragma unroll
          for (int i = ND - 1; i >= 0; --i) {
            const double di = D[i][s];
            if (i <= order) acc += di;
            double v = i <= order ? acc + d[s] : di;
            if (i == order + 1) v = d[s];
            if (i == order + 2) v = d[s] - dold;
            D[i][s] = v;
          }
        }
        if constexpr (NQ > 0) {
#pragma unroll
          for (int s = 0; s < NQ; ++s) {
            double dold = 0.0;
#pragma unroll
            for (int i = 0; i < ND; ++i)
              if (i == order + 1) dold = gD[i][s];
            double acc = 0.0;
#pragma unroll
            for (int i = ND - 1; i >= 0; --i) {
              const double gi = gD[i][s];
              if (i <= order) acc += gi;
              double v = i <= order ? acc + g_delta[s] : gi;
              if (i == order + 1) v = g_delta[s];
              if (i == order + 2) v = g_delta[s] - dold;
              gD[i][s] = v;
            }
          }
        }
      }

      // ---- order selection every order+1 equal steps (pallas_stepper.py:1329-1369)
      const int n_equal_acc = (h_changed == 1 || do_rescale) ? 1 : n_equal + 1;
      const bool do_sel = accepted && n_equal_acc > order;
      bool do_change = false;
      double sel_factor = 1.0;
      int new_order = order;
      if (do_sel) {  // uniform: order and accepted are the tile's
        // the error estimates at order - 1 and order + 1 against the new
        // state, in one reduction
        double wn[N], rm[N], rp[N];
        inv_weights<N>(D[0], c, wn);
#pragma unroll
        for (int s = 0; s < N; ++s) {
          rm[s] = rp[s] = 0.0;
#pragma unroll
          for (int i = 0; i < ND; ++i) {
            if (i == order) rm[s] = D[i][s];
            if (i == order + 2) rp[s] = D[i][s];
          }
        }
        const double2 e2 = red.max2(wrms_local<N>(rm, wn), wrms_local<N>(rp, wn));
        const double em = order > 1 ? e2.x * c.ec2[order - 1] : INFINITY;
        const double ep = order < MAX_ORDER ? e2.y * c.ec2[order + 1] : INFINITY;
        const double safety = 0.9 * (2.0 * mnewt + 1.0) / (2.0 * mnewt + niter);
        // the three PI factors at orders - 1, 0, + 1: with three warps or
        // more, warp w takes factor w and they meet behind one barrier, so
        // the step waits for one power, not three
        double f_m, f_0, f_p;
        if (blockDim.x >= 96) {
          const int wid = tid >> 5;
          if (wid < 3) {
            const double f = pi_raw(wid == 0 ? em : (wid == 1 ? err : ep), err, c.ki, c.kp,
                                    order + wid);
            if ((tid & 31) == 0) sel_f[wid] = f;
          }
          __syncthreads();
          f_m = sel_f[0];
          f_0 = sel_f[1];
          f_p = sel_f[2];
        } else {
          f_m = pi_raw(em, err, c.ki, c.kp, order);
          f_0 = pi_raw(err, err, c.ki, c.kp, order + 1);
          f_p = pi_raw(ep, err, c.ki, c.kp, order + 2);
        }
        const int best = (f_m >= f_0 && f_m >= f_p) ? 0 : (f_0 >= f_p ? 1 : 2);
        const double best_f = best == 0 ? f_m : (best == 1 ? f_0 : f_p);
        sel_factor = nan_clamp(safety * best_f, c.min_shrink, c.max_growth);
        do_change = sel_factor >= c.dead_hi || sel_factor <= c.dead_lo || best != 1;
        new_order = order + best - 1;
        new_order = new_order < 1 ? 1 : (new_order > MAX_ORDER ? MAX_ORDER : new_order);
      }

      // ---- root check on the accepted interpolant (pallas_stepper.py:1436-1743)
      bool do_root = false, incons = false;
      double t_r = t_pred;
      int ridx = -1;
      double g1[NRX], y_plus[N], dy_plus[N], g_root[NQX], dg_plus[NQX];
#if MODEL_NROOT > 0
      if (accepted) {  // uniform
        diffsol_model::model_root<double>(t_pred, D[0], p, g1);
        bool found_l, zero_l;
        int imax_l;
        root_scan(rootg, g1, &found_l, &zero_l, &imax_l);
        // the tile's flags and crossing indices in one reduction: OR of
        // (found, !found, zero, !zero), the max of imax + 1 and of
        // NROOT - imax over the members that cross
        const uint3 rr = red.or_max_max(
            (found_l ? 1u : 2u) | (zero_l ? 4u : 8u),
            found_l ? (unsigned)imax_l + 1u : 0u, found_l ? (unsigned)(NROOT - imax_l) : 0u);
        const bool f_any = rr.x & 1u, f_all = !(rr.x & 2u);
        const bool z_any = rr.x & 4u, z_all = !(rr.x & 8u);
        const bool same_im = rr.y == (unsigned)NROOT + 1u - rr.z;  // im_hi == im_lo
        incons = (f_any && !f_all) || (f_all && !same_im) || (z_any && !z_all && !f_any);
        const bool do_cross = f_all && same_im;
        const bool do_zero = !f_any && z_all;
        do_root = (do_cross || do_zero) && !incons;
        if (do_root) {  // uniform
          // member 0's difference matrix and root values to every thread,
          // behind one barrier; every thread then runs member 0's polish
          // itself, on the same values, so its decisions are the tile's
          if (tid == 0) {
#pragma unroll
            for (int i = 0; i < ND; ++i)
#pragma unroll
              for (int s = 0; s < N; ++s) bc[i * N + s] = D[i][s];
#pragma unroll
            for (int r = 0; r < NROOT; ++r) {
              bc[ND * N + r] = rootg[r];
              bc[ND * N + NROOT + r] = g1[r];
            }
            bc[ND * N + 2 * NROOT] = (double)imax_l;
          }
          __syncthreads();
          double g0s[NROOT], g1s[NROOT];
#pragma unroll
          for (int r = 0; r < NROOT; ++r) {
            g0s[r] = bc[ND * N + r];
            g1s[r] = bc[ND * N + NROOT + r];
          }
          if (do_cross) {
            double D0[ND][N];
#pragma unroll
            for (int i = 0; i < ND; ++i)
#pragma unroll
              for (int s = 0; s < N; ++s) D0[i][s] = bc[i * N + s];
            // modified secant (root.rs:60-165) on member 0's interpolant
            int im = (int)bc[ND * N + 2 * NROOT];
            const double tol = 100.0 * DBL_EPSILON * (fabs(t_pred) + fabs(t_pred - t));
            double t0_ = t, t1_ = t_pred, alpha = 1.0, res_t = t_pred;
            bool sc0 = false, sc1 = true, done = false;
            int res_i = im, it = 0;
            while (!done && fabs(t1_ - t0_) > tol && it < c.max_secant_iters) {
              const double g1v = pick(g1s, im), g0v = pick(g0s, im);
              const double dt_br = t1_ - t0_;
              double t_mid = t1_ - dt_br * (g1v / (g1v - alpha * g0v));
              // keep t_mid off the bracket's ends
              const double fracint = fabs(dt_br) / tol;
              const double fracsub = fracint > 5.0 ? 0.1 : 0.5 / fracint;
              if (fabs(t_mid - t0_) < 0.5 * tol) t_mid = t0_ + fracsub * dt_br;
              if (fabs(t1_ - t_mid) < 0.5 * tol) t_mid = t1_ - fracsub * dt_br;
              double ymid[N], gmid[NROOT];
              interp<N>(D0, t_pred, h, order, t_mid, ymid);
              diffsol_model::model_root<double>(t_mid, ymid, p0, gmid);
              bool lower, rootfnd;
              int im2;
              root_scan(g0s, gmid, &lower, &rootfnd, &im2);
              if (lower) {
                t1_ = t_mid;
                im = im2;
#pragma unroll
                for (int r = 0; r < NROOT; ++r) g1s[r] = gmid[r];
              } else if (rootfnd) {
                res_t = t_mid;
                res_i = im;
                done = true;
              } else {
                t0_ = t_mid;
#pragma unroll
                for (int r = 0; r < NROOT; ++r) g0s[r] = gmid[r];
              }
              if (it % 2 == 0) sc0 = lower; else sc1 = lower;
              if (it >= 2) alpha = sc0 != sc1 ? 1.0 : (sc0 ? 0.5 * alpha : 2.0 * alpha);
              ++it;
            }
            t_r = done ? res_t : t1_;
            ridx = done ? res_i : im;
          } else {
            // a zero at the step's end: the smallest |g1| of member 0
            int zi = 0;
            double zb = fabs(g1s[0]);
#pragma unroll
            for (int r = 1; r < NROOT; ++r) {
              const double mag = fabs(g1s[r]);
              if (mag < zb) zi = r;
              zb = nan_min(mag, zb);
            }
            ridx = zi;
          }
          // pin back to the root, reset, and the pieces of the restart at
          // order 1 (pallas_stepper.py:1684-1706)
          double y_root[N];
          interp<N>(D, t_pred, h, order, t_r, y_root);
#if MODEL_HAS_RESET
          diffsol_model::model_reset<double>(t_r, y_root, p, y_plus);
#else
#pragma unroll
          for (int s = 0; s < N; ++s) y_plus[s] = y_root[s];
#endif
          diffsol_model::model_rhs<double>(t_r, y_plus, p, dy_plus);
          diffsol_model::model_root<double>(t_r, y_plus, p, g1);
          if constexpr (NQ > 0) {
            interp<NQX>(gD, t_pred, h, order, t_r, g_root);
            eval_out<N>(t_r, y_plus, p, dg_plus);
          }
        }
      }
#endif
      // a root ends the step at the root time
      const double t_wr = do_root ? t_r : t_pred;

      // ---- dense output inside the accepted step (pallas_stepper.py:1749-1828)
      if (accepted) {
        while (nxt < c.neval && te_next <= t_wr) {
          const double te = te_next;
          double yv[N];
          interp<N>(D, t_pred, h, order, te, yv);
          if (writer) {
#pragma unroll
            for (int s = 0; s < N; ++s)
              ys[((size_t)nxt * N + s) * c.nbatch + m] = yv[s];
          }
          if constexpr (NQ > 0) {
            double gv[NQX];
            interp<NQX>(gD, t_pred, h, order, te, gv);
            if (writer) {
#pragma unroll
              for (int s = 0; s < NQ; ++s)
                gs[((size_t)nxt * NQ + s) * c.nbatch + m] = gv[s];
            }
          }
          ++nxt;
          if (nxt < c.neval) te_next = t_eval[nxt];
        }
      }

      // ---- one shared D rescale for the rejected and accepted paths
      const double ru_factor = accepted ? sel_factor : factor_r;
      const int ru_order = accepted ? new_order : order;
      const bool do_ru = accepted ? do_change : do_rescale;
      if (do_ru) {  // uniform
        // this step's error-norm reduction is the barrier compute_ru needs
        // behind the last step's reads of ru
        compute_ru(ru_order, ru_factor, c.U, ru);
        // D <- RU^T D, a state (column of D) at a time
#pragma unroll
        for (int s = 0; s < N; ++s) {
          double v[ND];
#pragma unroll
          for (int i = 0; i < ND; ++i) v[i] = D[i][s];
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            double acc = ru[0][j] * v[0];
#pragma unroll
            for (int i = 1; i < ND; ++i) acc += ru[i][j] * v[i];
            D[j][s] = acc;
          }
        }
        if constexpr (NQ > 0) {
#pragma unroll
          for (int s = 0; s < NQ; ++s) {
            double v[ND];
#pragma unroll
            for (int i = 0; i < ND; ++i) v[i] = gD[i][s];
#pragma unroll
            for (int j = 0; j < ND; ++j) {
              double acc = ru[0][j] * v[0];
#pragma unroll
              for (int i = 1; i < ND; ++i) acc += ru[i][j] * v[i];
              gD[j][s] = acc;
            }
          }
        }
      }
      const double h_out = h * (do_ru ? ru_factor : 1.0);

      // ---- bookkeeping and status (pallas_stepper.py:1830-1895)
      err_fails = accepted ? 0 : err_fails + (err_fail ? 1 : 0);
      int status_n = status;
      if (err_fail && err_fails >= c.max_err_fails) status_n = FAIL_ERRTEST;
      if (!solve_ok && newton_fails > c.max_newton_fails) status_n = FAIL_NEWTON;
      if (do_rescale && fabs(h_out) < c.min_timestep) status_n = FAIL_STEP_TOO_SMALL;
      if (k + 1 >= c.max_steps && nxt < c.neval && status_n == OK) status_n = FAIL_MAX_STEPS;
      if constexpr (NROOT > 0) {
        // a crossing the members disagree on is a hard error; a root
        // without a reset operator stops the tile
        if (incons) status_n = FAIL_ROOT_INCONS;
        if (!HAS_RESET && do_root && status_n == OK) status_n = ROOT_STOP;
      }
      k += 1;
      steps += accepted ? 1 : 0;
      if (accepted) {
        t = t_pred;
        order = do_change ? new_order : order;
        n_equal = do_change ? 0 : n_equal_acc;
      }
      h = h_out;
      prev_err = accepted ? err : NAN;
      if constexpr (NROOT > 0) {
        if (accepted) {
#pragma unroll
          for (int r = 0; r < NROOT; ++r) rootg[r] = g1[r];
        }
        if (do_root) {
          // restart the difference matrices at order 1 from the post-reset
          // state (pallas_stepper.py:1835-1870, :1916-1937)
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int s = 0; s < N; ++s)
              D[i][s] = i == 0 ? y_plus[s] : (i == 1 ? h_out * dy_plus[s] : 0.0);
          if constexpr (NQ > 0) {
#pragma unroll
            for (int i = 0; i < ND; ++i)
#pragma unroll
              for (int s = 0; s < NQ; ++s)
                gD[i][s] = i == 0 ? g_root[s] : (i == 1 ? h_out * dg_plus[s] : 0.0);
          }
          t = t_r;
          order = 1;
          n_equal = 0;
          prev_err = NAN;
          n_roots += 1;
          root_t = t_r;
          root_idx = ridx;
        }
      }
      conv_fail = accepted ? 0 : (solve_ok ? conv_fail : 1);
      h_changed = accepted ? 0 : (do_rescale ? 1 : h_changed);
      if (c.jac_reuse) eta_mem = eta_run;
      status = status_n;
    }

    if (status == OK && nxt < c.neval) status = FAIL_MAX_STEPS;
    if (threadIdx.x == 0) {
      int* row = info + (size_t)blockIdx.x * 6;
      row[0] = status;
      row[1] = steps;
      row[2] = k;
      row[3] = nxt;
      row[4] = n_roots;
      row[5] = root_idx;
      if constexpr (NROOT > 0) root_t_out[blockIdx.x] = root_t;
    }
  }
}

}  // namespace diffsol_fused

// The C entry points, bound with ctypes.  params, t_eval, ys, gs (null
// without quadrature), info and root_t (null without roots) are device
// pointers; cfg is a host Config.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int fused_bdf_config_size() { return (int)sizeof(diffsol_fused::Config); }

extern "C" int fused_bdf_launch(const double* params, const double* t_eval, double* ys,
                                double* gs, int* info, double* root_t,
                                const diffsol_fused::Config* cfg, void* stream) {
  using namespace diffsol_fused;
  const Config& c = *cfg;
  if (c.tile < 1 || c.tile > MAX_TILE || c.ntiles < 1) return (int)cudaErrorInvalidValue;
  const int threads = ((c.tile + 31) / 32) * 32;
  if (threads <= SMALL_TILE)
    fused_bdf_kernel<MODEL_N, MODEL_NP, SMALL_TILE>
        <<<c.ntiles, threads, 0, (cudaStream_t)stream>>>(params, t_eval, ys, gs, info,
                                                         root_t, c);
  else
    fused_bdf_kernel<MODEL_N, MODEL_NP, MAX_TILE>
        <<<c.ntiles, threads, 0, (cudaStream_t)stream>>>(params, t_eval, ys, gs, info,
                                                         root_t, c);
  return (int)cudaGetLastError();
}
