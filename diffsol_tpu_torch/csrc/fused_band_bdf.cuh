// Fused whole-solve BDF kernel for banded medium-n ensembles, CUDA C++ for
// sm_90a.
//
// Replaces diffsol_tpu/ops/pallas_stepper_band.py::make_pallas_band_bdf_solve
// (the Pallas kernel body at pallas_stepper_band.py:290).  One thread block
// solves one member TILE, one thread per member, and one launch covers every
// tile (the Pallas version launches once per tile): the adaptive NDF(1-5)
// solve of fused_bdf.cuh -- prediction, stale-Jacobian Newton, the WRMS
// error test, the PI controller, the difference update, order selection,
// the R.U rescale and dense output -- with the Jacobian as a band from
// ML+MU+1 cyclically colored dual probes of the rhs, and Newton's matrix
// M - cJ factored by the no-pivot band LU of band_lu.cuh under a tile-wide
// element-growth guard (status FAIL_LU_GROWTH).  Every WRMS norm and the
// growth are maxima over the tile, so every control decision is uniform
// across the block and no __syncthreads sits in divergent code.  The plain
// PyTorch version of the same algorithm is
// diffsol_tpu_torch/ops/fused_band_stepper.py::fused_band_bdf_reference.
//
// Layout: at n = 128 a member's vectors (D is 8 x n, the J band and its
// factors 3n each, the solve vector and four state vectors) come to some
// 20 KB, far beyond registers, so they live in a global scratch the wrapper
// allocates, laid out with the members of a block fastest: row r of thread
// tid is scratch[(block * PER + r) * blockDim + tid], and a warp's loads
// and stores of one row are coalesced.  At B = 1024 the scratch is ~20 MB,
// inside the H100's 50 MB L2.  At the 2-D models' width (heat2d n = 400,
// ML = MU = 20: a J band and a factored band of 41 diagonals) a member
// takes 310 KB and B = 1024 members 318 MB, so every walk goes to device
// memory; all offsets into the scratch are size_t.  The generated rhs
// (eqn_codegen) reads and writes that layout directly through the strided
// accessors below, so no per-thread copy of the state is made.
//
// What bounds it on the H100: the serial per-step chain.  Each step walks
// a member's n-vectors several times (predict, rhs, residual, the band
// solve's two sweeps, norms, the difference update), each walk a chain of
// dependent L2 loads and f64 operations, with one block reduction (two
// __syncthreads) per norm.  At the main path's B = 1024 and tile 128 the
// launch has 8 blocks of 128 threads on 132 SMs, so the card is mostly
// idle: the tile is the JAX kernel's, kept so results stay comparable, and
// a layout that fills the card is later work.
//
// The translation unit that includes this header first defines BAND_ML and
// BAND_MU and includes the model header generated by eqn_codegen, which
// defines MODEL_N, MODEL_NP and diffsol_model::model_rhs<T, Y, O>.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "bdf_common.cuh"
#include "dual.cuh"
#define DIFFSOL_BAND_LU_NO_ENTRY
#include "band_lu.cuh"

namespace diffsol_fused_band {

using namespace diffsol_fused;

// one build, __launch_bounds__(256): up to 255 registers a thread
constexpr int MAX_TILE = 256;

// Every number of the solve.  The host fills it as the ctypes.Structure
// fused_band_stepper.py::CBandConfig, which mirrors this layout field for
// field (the wrapper checks sizeof(BandConfig) before each launch).
struct BandConfig {
  double t0, rtol, nl_tol, ki, kp, min_timestep, thresh_update_jac, eta_floor;
  double max_lu_growth;
  double alpha[MAX_ORDER + 1], gamma[MAX_ORDER + 1], ec2[MAX_ORDER + 1];
  double U[ND][ND];
  double min_shrink, max_growth, dead_lo, dead_hi, eta_reset_jac, eta_reset_step;
  int max_steps, max_newton_iter, max_newton_fails, max_err_fails;
  int update_jac_after, update_rhs_jac_after;
  int neval, nbatch, tile, ntiles;
};

// A member's n-vector in scratch: element i at p[i * s].
struct Col {
  double* p;
  size_t s;
  __device__ __forceinline__ double& operator[](int i) const { return p[(size_t)i * s]; }
};

// The rhs input of the dual probe of color `color`: the member's value,
// with tangent 1 on the states j with j % NB == color.
template <int NB>
struct SeedIn {
  const double* p;
  size_t s;
  int color;
  __device__ __forceinline__ Dual<double> operator[](int i) const {
    return Dual<double>(p[(size_t)i * s], (i % NB == color) ? 1.0 : 0.0);
  }
};

// The rhs output of that probe: row i's tangent is df_i/dy_j for the one
// column j of the probe's color in row i's band, stored as the band entry
// J[j][d], d = i - j + MU (band[j][d] = J[j+d-MU][j], jac_band :349).
template <int N, int NB, int MU>
struct BandOut {
  double* J;
  size_t s;
  int color;
  struct Ref {
    double* J;
    size_t s;
    int i, color;
    __device__ __forceinline__ void operator=(const Dual<double>& v) const {
      int d = (i + MU - color) % NB;
      if (d < 0) d += NB;
      const int j = i + MU - d;
      if (j >= 0 && j < N) J[((size_t)j * NB + d) * s] = v.d;
    }
  };
  __device__ __forceinline__ Ref operator[](int i) const { return Ref{J, s, i, color}; }
};

// this member's sum over states of (x / (|y| rtol + atol))^2
__device__ __forceinline__ double wrms_sum(const Col& x, const Col& y, int n,
                                           const double* atol, double rtol) {
  double acc = 0.0;
  for (int s = 0; s < n; ++s) {
    const double q = x[s] / (fabs(y[s]) * rtol + atol[s]);
    acc += q * q;
  }
  return acc;
}

template <int N, int NP, int ML, int MU>
__global__ void __launch_bounds__(MAX_TILE)
fused_band_bdf_kernel(const double* __restrict__ params, const double* __restrict__ init,
                      const double* __restrict__ h_tile, const double* __restrict__ t_eval,
                      const double* __restrict__ atol, const double* __restrict__ mdiag,
                      double* __restrict__ ys, int* __restrict__ info,
                      double* __restrict__ scratch, const BandConfig c) {
  constexpr int NPX = NP > 0 ? NP : 1;
  constexpr int NB = ML + MU + 1;
  constexpr int PAD = ML > MU ? (ML > 1 ? ML : 1) : (MU > 1 ? MU : 1);
  // scratch rows of one member
  constexpr int OFF_J = ND * N;               // J band, (N, NB)
  constexpr int OFF_F = OFF_J + N * NB;       // factored band, (N + MU, NB)
  constexpr int OFF_X = OFF_F + (N + MU) * NB;  // solve vector, N + PAD
  constexpr int OFF_YP = OFF_X + N + PAD;     // y_pred
  constexpr int OFF_PSI = OFF_YP + N;
  constexpr int OFF_XN = OFF_PSI + N;         // the Newton iterate
  constexpr int OFF_FX = OFF_XN + N;          // rhs value
  constexpr int PER = OFF_FX + N;
  __shared__ double red[32];
  __shared__ double ru[ND][ND];

  // threads past the tile (blockDim is a multiple of 32) replicate the
  // tile's last member, so they never change a tile-wide max
  const int tid = (int)threadIdx.x;
  const int lane = tid < c.tile ? tid : c.tile - 1;
  const int m = blockIdx.x * c.tile + lane;  // this thread's (padded) member
  const bool writer = tid < c.tile && m < c.nbatch;
  const int mp = m < c.nbatch ? m : c.nbatch - 1;
  const size_t S = blockDim.x;
  const size_t padb = (size_t)c.ntiles * c.tile;
  double* const base = scratch + (size_t)blockIdx.x * PER * S + tid;
  const Col Dm{base, S};  // D[i][s] = Dm[i * N + s]
  double* const J = base + (size_t)OFF_J * S;
  double* const F = base + (size_t)OFF_F * S;
  const Col X{base + (size_t)OFF_X * S, S};
  const Col YP{base + (size_t)OFF_YP * S, S};
  const Col PSI{base + (size_t)OFF_PSI * S, S};
  const Col XN{base + (size_t)OFF_XN * S, S};
  const Col FX{base + (size_t)OFF_FX * S, S};

  double p[NPX];
  Dual<double> pd[NPX];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    p[j] = params[(size_t)mp * NP + j];
    pd[j] = Dual<double>(p[j], 0.0);
  }

  // ---- the host's initial state: y0 and h y0' (pallas_stepper_band.py:509-527)
  for (int s = 0; s < N; ++s) {
    Dm[s] = init[(size_t)s * padb + m];
    Dm[N + s] = init[(size_t)(N + s) * padb + m];
    for (int i = 2; i < ND; ++i) Dm[i * N + s] = 0.0;
  }
  // band entries outside the matrix are never written by a probe
  for (int r = 0; r < N * NB; ++r) J[(size_t)r * S] = 0.0;
  double t = c.t0;
  double h = h_tile[blockIdx.x];

  int k = 0, steps = 0, status = OK, nxt = 0, order = 1, n_equal = 0;
  int conv_fail = 0, newton_fails = 0, err_fails = 0, h_changed = 0;
  int ssj = 0, ssrj = 0;
  double prev_err = NAN, c_last = 0.0, eta_mem = c.eta_reset_jac, growth = 1.0;
  const double mnewt = (double)c.max_newton_iter;

  // every branch below is uniform across the block
  while (status == OK && k < c.max_steps && nxt < c.neval) {
    const double alpha_k = c.alpha[order];
    const double cval = h * alpha_k;
    const double t_pred = t + h;

    // ---- predict + psi from D
    for (int s = 0; s < N; ++s) {
      double a = Dm[s];
      double b = c.gamma[1] * Dm[N + s];
#pragma unroll
      for (int i = 1; i <= MAX_ORDER; ++i) {
        if (i <= order) a += Dm[i * N + s];
        if (i >= 2 && i <= order) b += c.gamma[i] * Dm[i * N + s];
      }
      YP[s] = a;
      PSI[s] = b * alpha_k;
    }

    // ---- stale-Jacobian policy (pallas_stepper_band.py:610-647)
    const double rel = fabs(cval / (c_last == 0.0 ? cval : c_last) - 1.0);
    const bool refresh = k == 0 || conv_fail > 0 || ssrj >= c.update_rhs_jac_after;
    const bool refactor = refresh || rel > c.thresh_update_jac || ssj >= c.update_jac_after;
    if (refresh) {  // NB colored dual probes (jac_band :349)
      const Dual<double> td(t_pred, 0.0);
#pragma unroll 1
      for (int col = 0; col < NB; ++col)
        diffsol_model::model_rhs<Dual<double> >(td, SeedIn<NB>{YP.p, S, col}, pd,
                                                BandOut<N, NB, MU>{J, S, col});
    }
    if (refactor) {  // A = M - cJ, factored in place (assemble_and_factor :391)
      double amax = 0.0;
      for (int j = 0; j < N; ++j)
        for (int d = 0; d < NB; ++d) {
          const double mjd = d == MU ? (mdiag != nullptr ? mdiag[j] : 1.0) : 0.0;
          const double a = mjd - cval * J[((size_t)j * NB + d) * S];
          F[((size_t)j * NB + d) * S] = a;
          amax = nan_max(amax, fabs(a));
        }
      const double upd = diffsol_band::band_factor(F, S, N, ML, MU);
      const double a0 = nan_max(block_max(amax, red), 1e-30);
      growth = nan_max(a0, block_max(upd, red)) / a0;
      c_last = cval;
    }
    // element growth beyond the limit means the no-pivot factorization is
    // meaningless (a NaN fails the test too; :637-639)
    const bool lu_bad = !(growth <= c.max_lu_growth);
    ssj = refactor ? 0 : ssj + 1;
    ssrj = refresh ? 0 : ssrj + 1;
    const double eta0 =
        refactor ? c.eta_reset_jac : (h_changed == 1 ? c.eta_reset_step : eta_mem);

    // ---- Newton on M (x - y_pred + psi) - c f(x) (:649-701)
    for (int s = 0; s < N; ++s) XN[s] = YP[s];
    double first_nrm = 0.0, eta_run = eta0;
    int niter = 0, nstat = 0;
    while (nstat == 0 && niter < c.max_newton_iter) {
      diffsol_model::model_rhs<double>(t_pred, XN, p, FX);
      for (int s = 0; s < N; ++s) {
        double tmp = (XN[s] - YP[s]) + PSI[s];
        if (mdiag != nullptr) tmp = mdiag[s] * tmp;
        X[s] = tmp - cval * FX[s];
      }
      diffsol_band::band_solve(F, X.p, S, N, ML, MU);
      double acc = 0.0;
      for (int s = 0; s < N; ++s) {
        const double dl = X[s];
        XN[s] = XN[s] - dl;
        const double q = dl / (fabs(YP[s]) * c.rtol + atol[s]);
        acc += q * q;
      }
      const double nrm = sqrt(block_max(acc / N, red));
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

    // ---- error test and step-size control (:705-721)
    double eacc = 0.0;
    for (int s = 0; s < N; ++s) {
      const double q = (XN[s] - YP[s]) / (fabs(YP[s]) * c.rtol + atol[s]);
      eacc += q * q;
    }
    const double err = block_max(eacc / N, red) * c.ec2[order - 1];
    const bool accepted = solve_ok && err <= 1.0;
    const double safety = 0.9 * (2.0 * mnewt + 1.0) / (2.0 * mnewt + niter);
    const bool second = !solve_ok && conv_fail == 1;
    const bool err_fail = solve_ok && !accepted;
    newton_fails += solve_ok ? 0 : 1;
    const double raw = pi_raw(err, prev_err, c.ki, c.kp, order + 1);
    const double rej_factor = nan_max(safety * raw, c.min_shrink);
    const double factor_r = err_fail ? rej_factor : 0.3;
    const bool do_rescale = err_fail || second;

    // ---- accepted-step difference update, in place (:723-744)
    if (accepted) {
      for (int s = 0; s < N; ++s) {
        const double d = XN[s] - YP[s];
        const double dold = Dm[(order + 1) * N + s];
        double acc = 0.0;
        for (int i = order; i >= 0; --i) {
          acc += Dm[i * N + s];
          Dm[i * N + s] = acc + d;
        }
        Dm[(order + 1) * N + s] = d;
        if (order + 2 < ND) Dm[(order + 2) * N + s] = d - dold;
      }
    }

    // ---- order selection every order+1 equal steps (:746-780)
    const int n_equal_acc = (h_changed == 1 || do_rescale) ? 1 : n_equal + 1;
    const bool do_sel = accepted && n_equal_acc > order;
    bool do_change = false;
    double sel_factor = 1.0;
    int new_order = order;
    if (do_sel) {
      const Col y_new{Dm.p, S};
      double em = INFINITY, ep = INFINITY;
      if (order > 1) {
        const Col row{Dm.p + (size_t)order * N * S, S};
        em = block_max(wrms_sum(row, y_new, N, atol, c.rtol) / N, red) * c.ec2[order - 1];
      }
      if (order < MAX_ORDER) {
        const Col row{Dm.p + (size_t)(order + 2) * N * S, S};
        ep = block_max(wrms_sum(row, y_new, N, atol, c.rtol) / N, red) * c.ec2[order + 1];
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

    // ---- dense output inside the accepted step (:797-822)
    if (accepted) {
      while (nxt < c.neval && t_eval[nxt] <= t_pred) {
        const double te = t_eval[nxt];
        double tfs[MAX_ORDER];
        double tf = 1.0;
#pragma unroll
        for (int i = 0; i < MAX_ORDER; ++i) {
          const double tf_new = tf * ((te - (t_pred - h * i)) / (h * (1 + i)));
          tfs[i] = tf_new;
          if (i < order) tf = tf_new;
        }
        for (int s = 0; s < N; ++s) {
          double yv = Dm[s];
#pragma unroll
          for (int i = 0; i < MAX_ORDER; ++i)
            if (i < order) yv += tfs[i] * Dm[(i + 1) * N + s];
          if (writer) ys[((size_t)nxt * N + s) * c.nbatch + m] = yv;
        }
        ++nxt;
      }
    }

    // ---- one shared D rescale for the rejected and accepted paths (:782-795)
    const double ru_factor = accepted ? sel_factor : factor_r;
    const int ru_order = accepted ? new_order : order;
    const bool do_ru = accepted ? do_change : do_rescale;
    if (do_ru) {
      compute_ru(ru_order, ru_factor, c.U, ru);
      for (int s = 0; s < N; ++s) {
        double v[ND];
#pragma unroll
        for (int i = 0; i < ND; ++i) v[i] = Dm[i * N + s];
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          double acc = ru[0][j] * v[0];
#pragma unroll
          for (int i = 1; i < ND; ++i) acc += ru[i][j] * v[i];
          Dm[j * N + s] = acc;
        }
      }
    }
    const double h_out = h * (do_ru ? ru_factor : 1.0);

    // ---- bookkeeping and status (:824-851)
    err_fails = accepted ? 0 : err_fails + (err_fail ? 1 : 0);
    int status_n = status;
    if (err_fail && err_fails >= c.max_err_fails) status_n = FAIL_ERRTEST;
    if (!solve_ok && newton_fails > c.max_newton_fails) status_n = FAIL_NEWTON;
    if (do_rescale && fabs(h_out) < c.min_timestep) status_n = FAIL_STEP_TOO_SMALL;
    if (k + 1 >= c.max_steps && nxt < c.neval && status_n == OK) status_n = FAIL_MAX_STEPS;
    if (lu_bad) status_n = FAIL_LU_GROWTH;
    k += 1;
    steps += accepted ? 1 : 0;
    if (accepted) {
      t = t_pred;
      order = do_change ? new_order : order;
      n_equal = do_change ? 0 : n_equal_acc;
    }
    h = h_out;
    prev_err = accepted ? err : NAN;
    conv_fail = accepted ? 0 : (solve_ok ? conv_fail : 1);
    h_changed = accepted ? 0 : (do_rescale ? 1 : h_changed);
    eta_mem = eta_run;
    status = status_n;
  }

  if (status == OK && nxt < c.neval) status = FAIL_MAX_STEPS;
  if (threadIdx.x == 0) {
    int* row = info + (size_t)blockIdx.x * 4;
    row[0] = status;
    row[1] = steps;
    row[2] = k;
    row[3] = nxt;
  }
}

}  // namespace diffsol_fused_band

// The C entry points, bound with ctypes.  Every pointer but cfg (a host
// BandConfig) is a device pointer; mdiag is null for an identity mass.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fused_band_bdf_config_size() {
  return (int)sizeof(diffsol_fused_band::BandConfig);
}

extern "C" int fused_band_bdf_launch(const double* params, const double* init,
                                     const double* h_tile, const double* t_eval,
                                     const double* atol, const double* mdiag, double* ys,
                                     int* info, double* scratch,
                                     const diffsol_fused_band::BandConfig* cfg,
                                     void* stream) {
  using namespace diffsol_fused_band;
  const BandConfig& c = *cfg;
  if (c.tile < 1 || c.tile > MAX_TILE || c.ntiles < 1) return (int)cudaErrorInvalidValue;
  const int threads = ((c.tile + 31) / 32) * 32;
  fused_band_bdf_kernel<MODEL_N, MODEL_NP, BAND_ML, BAND_MU>
      <<<c.ntiles, threads, 0, (cudaStream_t)stream>>>(params, init, h_tile, t_eval, atol,
                                                       mdiag, ys, info, scratch, c);
  return (int)cudaGetLastError();
}
