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
// is the max over the tile, taken as a warp-shuffle reduction plus a
// shared-memory reduction, so every control decision is uniform across the
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
//    modified secant with its g values broadcast from thread 0 -- so each
//    iteration's decisions are uniform too -- and the tile is pinned to the
//    shared root time, where it stops (ROOT_STOP) or applies model_reset
//    and restarts the difference matrices at order 1.
//
// What bounds it on the H100: not bytes -- a member's state, D (8 x N),
// J, the LU and its pivots live in the thread's registers and local memory
// for the whole solve, and device memory sees only the parameters in and
// ys out.  The bound is the latency of the serial per-step chain of
// dependent f64 operations (rhs, N dual rhs probes, the N x N LU, the
// triangular solves, every Newton iteration), plus one block reduction
// (two __syncthreads) per norm: three a step and one a Newton iteration.
// The design answers it with parallelism across members and tiles: the
// 128-member default tile gives 79 blocks for the 10,000-member main path,
// one per SM, whose warps hide each other's FMA latency, and the
// tile-wide reductions stay short because the tile is small.  Registers
// are the scarce resource: at N = 8 a thread holds some 200 doubles, so
// the build prints ptxas's register and spill counts.  Shared-memory
// residency, wgmma for the LU and fewer reductions are later work.
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

// this member's mean over states of (x / (|y| rtol + atol))^2
template <int N>
__device__ __forceinline__ double wrms_local(const double* x, const double* y,
                                             const Config& c) {
  double acc = 0.0;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const double q = x[s] / (fabs(y[s]) * c.rtol + c.atol[s]);
    acc += q * q;
  }
  return acc / N;
}

// J[r][c] = df_r/dy_c from N dual probes in the scalar type S
// (pallas_stepper.py:755-775; jac_cols32 for float)
template <int N, int NP, typename S>
__device__ void jacobian(double t, const double* y, const double* p, S (*J)[N]) {
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
// of largest |A[r][k]| (first on ties) becomes the pivot row;
// rdiag[k] = 1/U[k][k].
template <int N, typename S>
__device__ void lu_factor(S (*J)[N], S c, const S* md, S (*A)[N], int* perm, S* rdiag) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    perm[r] = r;
#pragma unroll
    for (int q = 0; q < N; ++q)
      A[r][q] = (r == q ? (HAS_MASS ? md[r] : (S)1.0) : (S)0.0) - c * J[r][q];
  }
  for (int k = 0; k < N - 1; ++k) {
    int pk = k;
    S bm = mt_abs(A[k][k]);
    for (int r = k + 1; r < N; ++r) {
      const S mag = mt_abs(A[r][k]);
      if (mag > bm) pk = r;
      bm = nan_max(mag, bm);
    }
    if (pk != k) {
      for (int q = 0; q < N; ++q) {
        const S tmp = A[k][q];
        A[k][q] = A[pk][q];
        A[pk][q] = tmp;
      }
      const int tp = perm[k];
      perm[k] = perm[pk];
      perm[pk] = tp;
    }
    const S inv = (S)1.0 / A[k][k];
    rdiag[k] = inv;
    for (int r = k + 1; r < N; ++r) {
      const S l = A[r][k] * inv;
      A[r][k] = l;
      for (int q = k + 1; q < N; ++q) A[r][q] -= l * A[k][q];
    }
  }
  rdiag[N - 1] = (S)1.0 / A[N - 1][N - 1];
}

// solve with lu_factor's output (_lu_solve_df, pallas_stepper.py:197-216)
template <int N, typename S>
__device__ void lu_solve(S (*A)[N], const int* perm, const S* rdiag, const S* b, S* out) {
  S xs[N];
  for (int r = 0; r < N; ++r) xs[r] = b[perm[r]];
  for (int r = 1; r < N; ++r) {
    S acc = xs[r];
    for (int j = 0; j < r; ++j) acc -= A[r][j] * xs[j];
    xs[r] = acc;
  }
  for (int r = N - 1; r >= 0; --r) {
    S acc = xs[r];
    for (int j = r + 1; j < N; ++j) acc -= A[r][j] * out[j];
    out[r] = acc * rdiag[r];
  }
}

// The Newton matrix in the build's matrix type MT: factor M - cJ, and solve
// with the residual rounded to MT and the correction widened back
// (_lu_factor_f32 / _lu_solve_f32 under precision="mixed",
// pallas_stepper.py:1046-1086, :1201-1210).
template <int N>
__device__ __forceinline__ void factor_newton(MT (*J)[N], double c, const double* md,
                                              MT (*A)[N], int* perm, MT* rdiag) {
  if constexpr (MIXED) {
    float mdf[N];
    if constexpr (HAS_MASS) {
#pragma unroll
      for (int s = 0; s < N; ++s) mdf[s] = (float)md[s];
    }
    lu_factor<N, float>(J, (float)c, mdf, A, perm, rdiag);
  } else {
    lu_factor<N, double>(J, c, md, A, perm, rdiag);
  }
}

template <int N>
__device__ __forceinline__ void solve_newton(MT (*A)[N], const int* perm, const MT* rdiag,
                                             const double* b, double* out) {
  if constexpr (MIXED) {
    float bf[N], of[N];
#pragma unroll
    for (int s = 0; s < N; ++s) bf[s] = (float)b[s];
    lu_solve<N, float>(A, perm, rdiag, bf, of);
#pragma unroll
    for (int s = 0; s < N; ++s) out[s] = (double)of[s];
  } else {
    lu_solve<N, double>(A, perm, rdiag, b, out);
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
__device__ __forceinline__ void interp(const double (*Dacc)[M], double t_new, double h,
                                       int order, double te, double* out) {
#pragma unroll
  for (int s = 0; s < M; ++s) out[s] = Dacc[0][s];
  double tf = 1.0;
#pragma unroll
  for (int i = 0; i < MAX_ORDER; ++i) {
    const double tf_new = tf * ((te - (t_new - h * i)) / (h * (1 + i)));
    if (i < order) {
#pragma unroll
      for (int s = 0; s < M; ++s) out[s] += tf_new * Dacc[i + 1][s];
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
  __shared__ double red[32];
  __shared__ double ru[ND][ND];
#if MODEL_NROOT > 0
  __shared__ double bc;
#endif

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

  // ---- initial state and step size (pallas_stepper.py:837-907)
  double t = c.t0;
  double h;
  double D[ND][N];
  {
    double y0[N], dy0[N], y1[N], f1[N];
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
    const double d0 = sqrt(block_max(wrms_local<N>(y0, y0, c), red));
    const double d1 = sqrt(block_max(wrms_local<N>(dy0, y0, c), red));
    const double h0 = (d0 < 1e-5 || d1 < 1e-5) ? 1e-6 : 0.01 * (d0 / d1);
#pragma unroll
    for (int s = 0; s < N; ++s) y1[s] = y0[s] + h0 * dy0[s];
    diffsol_model::model_rhs<double>(t + h0, y1, p, f1);
#pragma unroll
    for (int s = 0; s < N; ++s) f1[s] = f1[s] - dy0[s];
    const double d2 = sqrt(block_max(wrms_local<N>(f1, y0, c), red)) / fabs(h0);
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
#endif

  // ---- the step loop; every branch below is uniform across the block
  {
    int k = 0, steps = 0, status = OK, nxt = 0, order = 1, n_equal = 0;
    int conv_fail = 0, newton_fails = 0, err_fails = 0, h_changed = 0;
    double prev_err = NAN, c_last = 0.0, eta_mem = c.eta_reset_jac;
    int ssj = 0, ssrj = 0;
    MT J[N][N], LU[N][N], rdiag[N];
    int perm[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      perm[r] = r;
      rdiag[r] = (MT)0.0;
#pragma unroll
      for (int q = 0; q < N; ++q) J[r][q] = LU[r][q] = (MT)0.0;
    }
    const double mnewt = (double)c.max_newton_iter;

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

      double md[N];
#if MODEL_HAS_MASS
      diffsol_model::model_mass<double>(t_pred, p, md);
#endif

      // ---- stale-Jacobian policy (pallas_stepper.py:1094-1174)
      double eta0;
      if (c.jac_reuse) {
        const double rel = fabs(cval / (c_last == 0.0 ? cval : c_last) - 1.0);
        const bool refresh = k == 0 || conv_fail > 0 || ssrj >= c.update_rhs_jac_after;
        const bool refactor = refresh || rel > c.thresh_update_jac || ssj >= c.update_jac_after;
        if (refresh) jacobian<N, NP, MT>(t_pred, y_pred, p, J);
        if (refactor) factor_newton<N>(J, cval, md, LU, perm, rdiag);
        if (refactor) c_last = cval;
        ssj = refactor ? 0 : ssj + 1;
        ssrj = refresh ? 0 : ssrj + 1;
        eta0 = refactor ? c.eta_reset_jac : (h_changed == 1 ? c.eta_reset_step : eta_mem);
      } else {
        jacobian<N, NP, MT>(t_pred, y_pred, p, J);
        factor_newton<N>(J, cval, md, LU, perm, rdiag);
        eta0 = c.eta_reset_jac;
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
        solve_newton<N>(LU, perm, rdiag, res, delta);
#pragma unroll
        for (int s = 0; s < N; ++s) x[s] = x[s] - delta[s];
        const double nrm = sqrt(block_max(wrms_local<N>(delta, y_pred, c), red));
        niter += 1;
        const bool is_first = niter == 1;
        const double kk = (double)(niter - 1 > 1 ? niter - 1 : 1);
        double rate = pow(nan_max(nrm / nan_max(first_nrm, 0.0), 1e-30), 1.0 / kk);
        if (!isfinite(rate)) rate = INFINITY;
        const int left = c.max_newton_iter - niter;
        const double proj = pow(rate, (double)(left > 0 ? left : 0)) / (1.0 - rate) * nrm;
        const double eta_new =
            is_first ? pow(nan_max(eta0, c.eta_floor), 0.8) : rate / (1.0 - rate);
        const bool diverged = !is_first && (rate > 0.9 || proj > c.nl_tol);
        const bool converged = (eta_new * nrm < c.nl_tol) && !diverged;
        nstat = diverged ? 2 : (converged ? 1 : 0);
        if (is_first) first_nrm = nrm;
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
      double err = block_max(wrms_local<N>(d, y_pred, c), red) * c.ec2[order - 1];
      if constexpr (OUT_IN_ERR) {
        // the quadrature joins the max with the NEXT error constant
        double acc = 0.0;
#pragma unroll
        for (int s = 0; s < NQ; ++s) {
          const double q = g_delta[s] / (fabs(gD[0][s]) * c.out_rtol + c.out_atol[s]);
          acc += q * q;
        }
        err = nan_max(err, block_max(acc / NQX, red) * c.ec2[order]);
      }
      const bool accepted = solve_ok && err <= 1.0;
      const double safety = 0.9 * (2.0 * mnewt + 1.0) / (2.0 * mnewt + niter);
      const bool second = !solve_ok && conv_fail == 1;
      const bool err_fail = solve_ok && !accepted;
      newton_fails += solve_ok ? 0 : 1;
      const double raw = pi_raw(err, prev_err, c.ki, c.kp, order + 1);
      const double rej_factor = nan_max(safety * raw, c.min_shrink);
      const double factor_r = err_fail ? rej_factor : 0.3;
      const bool do_rescale = err_fail || second;

      // ---- accepted-step difference update (pallas_stepper.py:416-438)
      double Dacc[ND][N];
#pragma unroll
      for (int s = 0; s < N; ++s) {
        double dold = 0.0;
#pragma unroll
        for (int i = 0; i < ND; ++i)
          if (i == order + 1) dold = D[i][s];
        double acc = 0.0;
#pragma unroll
        for (int i = ND - 1; i >= 0; --i) {
          if (i <= order) acc += D[i][s];
          double v = i <= order ? acc + d[s] : D[i][s];
          if (i == order + 1) v = d[s];
          if (i == order + 2) v = d[s] - dold;
          Dacc[i][s] = v;
        }
      }

      double gDacc[ND][NQX];
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
            if (i <= order) acc += gD[i][s];
            double v = i <= order ? acc + g_delta[s] : gD[i][s];
            if (i == order + 1) v = g_delta[s];
            if (i == order + 2) v = g_delta[s] - dold;
            gDacc[i][s] = v;
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
        double em = INFINITY, ep = INFINITY;
        if (order > 1) {
          double row[N];
#pragma unroll
          for (int s = 0; s < N; ++s) {
            row[s] = 0.0;
#pragma unroll
            for (int i = 0; i < ND; ++i)
              if (i == order) row[s] = Dacc[i][s];
          }
          em = block_max(wrms_local<N>(row, Dacc[0], c), red) * c.ec2[order - 1];
        }
        if (order < MAX_ORDER) {
          double row[N];
#pragma unroll
          for (int s = 0; s < N; ++s) {
            row[s] = 0.0;
#pragma unroll
            for (int i = 0; i < ND; ++i)
              if (i == order + 2) row[s] = Dacc[i][s];
          }
          ep = block_max(wrms_local<N>(row, Dacc[0], c), red) * c.ec2[order + 1];
        }
        const double f_m = pi_raw(em, err, c.ki, c.kp, order);
        const double f_0 = pi_raw(err, err, c.ki, c.kp, order + 1);
        const double f_p = pi_raw(ep, err, c.ki, c.kp, order + 2);
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
        diffsol_model::model_root<double>(t_pred, Dacc[0], p, g1);
        bool found_l, zero_l;
        int imax_l;
        root_scan(rootg, g1, &found_l, &zero_l, &imax_l);
        const bool f_any = block_max(found_l ? 1.0 : 0.0, red) > 0.0;
        const bool f_all = !(block_max(found_l ? 0.0 : 1.0, red) > 0.0);
        const bool z_any = block_max(zero_l ? 1.0 : 0.0, red) > 0.0;
        const bool z_all = !(block_max(zero_l ? 0.0 : 1.0, red) > 0.0);
        const double im_hi = block_max(found_l ? (double)imax_l : -INFINITY, red);
        const double im_lo = -block_max(found_l ? -(double)imax_l : -INFINITY, red);
        incons = (f_any && !f_all) || (f_all && im_hi != im_lo) || (z_any && !z_all && !f_any);
        const bool do_cross = f_all && im_hi == im_lo;
        const bool do_zero = !f_any && z_all;
        do_root = (do_cross || do_zero) && !incons;
        if (do_root) {  // uniform
          // member 0's root values, the same in every thread
          double g0s[NROOT], g1s[NROOT];
#pragma unroll
          for (int r = 0; r < NROOT; ++r) {
            g0s[r] = bcast0(rootg[r], &bc);
            g1s[r] = bcast0(g1[r], &bc);
          }
          if (do_cross) {
            // modified secant (root.rs:60-165); every quantity below is
            // the tile's, so the loop is uniform
            int im = (int)bcast0((double)imax_l, &bc);
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
              double ymid[N], gm[NROOT], gmid[NROOT];
              interp<N>(Dacc, t_pred, h, order, t_mid, ymid);
              diffsol_model::model_root<double>(t_mid, ymid, p, gm);
#pragma unroll
              for (int r = 0; r < NROOT; ++r) gmid[r] = bcast0(gm[r], &bc);
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
          interp<N>(Dacc, t_pred, h, order, t_r, y_root);
#if MODEL_HAS_RESET
          diffsol_model::model_reset<double>(t_r, y_root, p, y_plus);
#else
#pragma unroll
          for (int s = 0; s < N; ++s) y_plus[s] = y_root[s];
#endif
          diffsol_model::model_rhs<double>(t_r, y_plus, p, dy_plus);
          diffsol_model::model_root<double>(t_r, y_plus, p, g1);
          if constexpr (NQ > 0) {
            interp<NQX>(gDacc, t_pred, h, order, t_r, g_root);
            eval_out<N>(t_r, y_plus, p, dg_plus);
          }
        }
      }
#endif
      // a root ends the step at the root time
      const double t_wr = do_root ? t_r : t_pred;

      // ---- dense output inside the accepted step (pallas_stepper.py:1749-1828)
      if (accepted) {
        while (nxt < c.neval && t_eval[nxt] <= t_wr) {
          const double te = t_eval[nxt];
          double yv[N];
#pragma unroll
          for (int s = 0; s < N; ++s) yv[s] = Dacc[0][s];
          double tf = 1.0;
#pragma unroll
          for (int i = 0; i < MAX_ORDER; ++i) {
            const double tf_new = tf * ((te - (t_pred - h * i)) / (h * (1 + i)));
            if (i < order) {
#pragma unroll
              for (int s = 0; s < N; ++s) yv[s] += tf_new * Dacc[i + 1][s];
              tf = tf_new;
            }
          }
          if (writer) {
#pragma unroll
            for (int s = 0; s < N; ++s)
              ys[((size_t)nxt * N + s) * c.nbatch + m] = yv[s];
          }
          if constexpr (NQ > 0) {
            double gv[NQX];
            interp<NQX>(gDacc, t_pred, h, order, te, gv);
            if (writer) {
#pragma unroll
              for (int s = 0; s < NQ; ++s)
                gs[((size_t)nxt * NQ + s) * c.nbatch + m] = gv[s];
            }
          }
          ++nxt;
        }
      }

      // ---- one shared D rescale for the rejected and accepted paths
      const double ru_factor = accepted ? sel_factor : factor_r;
      const int ru_order = accepted ? new_order : order;
      const bool do_ru = accepted ? do_change : do_rescale;
      if (accepted) {
#pragma unroll
        for (int i = 0; i < ND; ++i)
#pragma unroll
          for (int s = 0; s < N; ++s) D[i][s] = Dacc[i][s];
        if constexpr (NQ > 0) {
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int s = 0; s < NQ; ++s) gD[i][s] = gDacc[i][s];
        }
      }
      if (do_ru) {  // uniform
        compute_ru(ru_order, ru_factor, c.U, ru);
        double Dn[ND][N];
#pragma unroll
        for (int j = 0; j < ND; ++j)
#pragma unroll
          for (int s = 0; s < N; ++s) {
            double acc = ru[0][j] * D[0][s];
#pragma unroll
            for (int i = 1; i < ND; ++i) acc += ru[i][j] * D[i][s];
            Dn[j][s] = acc;
          }
#pragma unroll
        for (int i = 0; i < ND; ++i)
#pragma unroll
          for (int s = 0; s < N; ++s) D[i][s] = Dn[i][s];
        if constexpr (NQ > 0) {
          double gDn[ND][NQX];
#pragma unroll
          for (int j = 0; j < ND; ++j)
#pragma unroll
            for (int s = 0; s < NQ; ++s) {
              double acc = ru[0][j] * gD[0][s];
#pragma unroll
              for (int i = 1; i < ND; ++i) acc += ru[i][j] * gD[i][s];
              gDn[j][s] = acc;
            }
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int s = 0; s < NQ; ++s) gD[i][s] = gDn[i][s];
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
