// Fused whole-solve BDF kernel for banded medium-n ensembles, CUDA C++ for
// sm_90a.
//
// Replaces diffsol_tpu/ops/pallas_stepper_band.py::make_pallas_band_bdf_solve
// (the Pallas kernel body at pallas_stepper_band.py:290): the adaptive
// NDF(1-5) solve of fused_bdf.cuh -- prediction, stale-Jacobian Newton, the
// WRMS error test, the PI controller, the difference update, order
// selection, the R.U rescale and dense output -- with the Jacobian as a band
// from ML+MU+1 cyclically colored dual probes of the rhs, and Newton's matrix
// M - cJ factored by the no-pivot band LU under a tile-wide element-growth
// guard (status FAIL_LU_GROWTH).  Every WRMS norm and the growth are maxima
// over the member tile, so every control decision is uniform across the
// tile.  The plain PyTorch version of the same algorithm on the same tiles is
// diffsol_tpu_torch/ops/fused_band_stepper.py::fused_band_bdf_reference.
//
// What bounds it on the H100: each member's serial chain.  A step is a
// handful of dependent phases per member -- the rhs (a straight-line body of
// some 2,400 f64 operations at heat2d's n = 400), the band solve's two
// column sweeps (2n dependent column steps), on a Jacobian refresh NB dual
// probes and the factor's n-column chain -- and the member's vectors, band
// and factors (310 KB at heat2d) cannot all stay on chip.  The f64 work of
// B = 1,024 members (0.06 ms at the card's peak) is far below the time the
// chains take, so the design spreads members over SMs and keeps each chain
// short and on chip.  The old kernel (one thread a member, one block a
// tile: 8 blocks on 132 SMs, every walk a chain of dependent loads from a
// 318 MB scratch) took 941.6 ms at heat2d.
//
// * A warp a member.  The lanes stride over the states in every walk
//   (predict, residual, update, norms, the difference update, dense output,
//   the R.U rescale); each norm is a warp sum, then a tile-wide max.  The NB
//   dual probes of a Jacobian refresh spread over the lanes (lane l takes
//   colors l, l+32, ...: one generated body, so the lanes do not diverge);
//   Newton's rhs runs on lane 0.  The rhs reads its input from and writes
//   its output to shared memory.
// * A thread block cluster a tile: `members` warps a block and `cluster`
//   blocks a tile (tile 128 = 16 blocks of 8 members, so B = 1,024 fills 128
//   SMs where one block a tile filled 8).  A tile-wide max is a warp
//   shuffle, one value a warp through shared memory, then one value a block
//   read by each lane from its peer blocks' shared memory (distributed
//   shared memory) after a cluster barrier.  Slots past the tile replicate
//   its last member, as the padded members of the last tile do, so they
//   never change a max.
// * The band LU on chip: warp_band_factor / warp_band_solve (band_lu.cuh),
//   K3's and K4's column loops for one member, with the factor's sliding
//   window and the solve's factor chunks and x in shared memory, fed by
//   cp.async from the member-major J band and factors.
// * Member-major scratch: a member's D (ND x n), J band (n x NB), factors
//   ((n + MU) x NB) and three state vectors lie contiguous in device memory,
//   so a warp's accesses are coalesced.
//
// The launch plan (members a block, blocks a cluster, the factor's and the
// solve's chunk columns -- a factor chunk of 0 keeps the factor's window in
// device memory, for a band too wide for shared memory -- and shared
// doubles a member) comes from the host in
// BandConfig, computed by fused_band_stepper.py::band_plan; the launch
// checks it against this file's own sizes and refuses a plan that does not
// fit.
//
// Measured on an H100 80GB HBM3 at 700.00 W (chip_smoke.py phases 6, 10,
// 11 and 13; B = 1,024, tile 128: a grid of 128 blocks in 8 clusters of 16,
// 256 threads and 94,976 B of shared memory a block at nb = 41, all 8
// clusters resident at once): a fused call at heat2d (n = 400, nb = 41) 23.3
// ms, K2's device time 19.8 ms (the old kernel 941.6 ms; the lockstep path
// 0.33 s); at foodweb (n = 200, nb = 41) K2 65.7 ms of a 310 ms call whose
// rest is the host-side consistent-IC solve (old K2 1.92-1.96 s); at heat1d
// (n = 128, nb = 3) 16.3 ms a call, K2 13.7 ms (old 83.8 ms).  The bound
// of the accepted steps' f64 work is 0.061, 0.101 and 0.015 ms: each
// member's chain of dependent steps sets the pace (its split between the
// rhs, the probes and the band LU's column sweeps is not measured).  ptxas keeps 128 registers at heat2d and 64 at heat1d and foodweb,
// with local-memory stores left around the ABI calls of f64 division's and
// pow's slow paths and in the probes' dual rhs (PERF.md).
//
// The translation unit that includes this header first defines BAND_ML and
// BAND_MU and includes the model header generated by eqn_codegen, which
// defines MODEL_N, MODEL_NP and diffsol_model::model_rhs<T, Y, O>.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bdf_common.cuh"
#include "dual.cuh"
#define DIFFSOL_BAND_LU_NO_ENTRY
#include "band_lu.cuh"

namespace diffsol_fused_band {

using namespace diffsol_fused;
namespace cg = cooperative_groups;

constexpr int MAX_TILE = 256;
constexpr int WARP = 32;
constexpr int MAX_MEMBERS = 16;  // warps a block: __launch_bounds__(512)
constexpr int MAX_CLUSTER = 16;  // blocks a cluster (above 8 non-portable)
// dynamic shared memory a block may take: the sm_90 limit less a reserve
// for the static part (red, slot, ru below)
constexpr size_t SMEM_DYNAMIC = 232448 - 1024;

// Every number of the solve, and the launch plan.  The host fills it as the
// ctypes.Structure fused_band_stepper.py::CBandConfig, which mirrors this
// layout field for field (the wrapper checks sizeof(BandConfig) before each
// launch).
struct BandConfig {
  double t0, rtol, nl_tol, ki, kp, min_timestep, thresh_update_jac, eta_floor;
  double max_lu_growth;
  double alpha[MAX_ORDER + 1], gamma[MAX_ORDER + 1], ec2[MAX_ORDER + 1];
  double U[ND][ND];
  double min_shrink, max_growth, dead_lo, dead_hi, eta_reset_jac, eta_reset_step;
  int max_steps, max_newton_iter, max_newton_fails, max_err_fails;
  int update_jac_after, update_rhs_jac_after;
  int neval, nbatch, tile, ntiles;
  // the plan: warps (members) a block, blocks a tile, the factor's and the
  // solve's chunk columns, shared doubles a member
  int members, cluster, fchunk, schunk, stride;
};

// shared doubles a member takes: the rhs's input and output (2n), the
// factor's window (none at fchunk = 0: the window lies in device memory) or
// the solve's x, reciprocals and chunk buffers
template <int N, int ML, int MU>
__host__ __device__ constexpr int member_doubles(int fchunk, int schunk) {
  const int f = fchunk > 0 ? diffsol_band::factor_doubles<ML, MU>(fchunk) : 0;
  const int s = diffsol_band::solve_doubles<N, ML, MU>(schunk);
  const int fs = f > s ? f : s;
  return fs > 2 * N ? fs : 2 * N;
}

// The rhs input of the dual probe of color `color`: the member's value,
// with tangent 1 on the states j with j % NB == color.
template <int NB>
struct SeedIn {
  const double* y;
  int color;
  __device__ __forceinline__ Dual<double> operator[](int i) const {
    return Dual<double>(y[i], (i % NB == color) ? 1.0 : 0.0);
  }
};

// The rhs output of that probe: row i's tangent is df_i/dy_j for the one
// column j of the probe's color in row i's band, stored as the band entry
// J[j][d], d = i - j + MU (band[j][d] = J[j+d-MU][j], jac_band :349).
template <int N, int NB, int MU>
struct BandOut {
  double* J;
  int color;
  struct Ref {
    double* J;
    int i, color;
    __device__ __forceinline__ void operator=(const Dual<double>& v) const {
      int d = (i + MU - color) % NB;
      if (d < 0) d += NB;
      const int j = i + MU - d;
      if (j >= 0 && j < N) J[(size_t)j * NB + d] = v.d;
    }
  };
  __device__ __forceinline__ Ref operator[](int i) const { return Ref{J, i, color}; }
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The max over the tile of one value a warp (NaN-propagating).  Every
// thread of the cluster calls it with the same sequence of calls.  Round r
// publishes the block's max in slot[r % 2]: a block rewrites a slot only
// after the next round's cluster barrier, which its peers pass only when
// they have read it.
struct TileMax {
  double* red;   // shared: a value a warp
  double* slot;  // shared: the block's max, two rounds
  int parity, nwarps, nblocks, warp, lane;

  __device__ __forceinline__ double operator()(double v) {
    v = warp_max(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      double r = red[0];
      for (int w = 1; w < nwarps; ++w) r = nan_max(r, red[w]);
      slot[parity] = r;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    double r = -INFINITY;
    if (lane < nblocks) r = *cluster.map_shared_rank(slot + parity, lane);
    parity ^= 1;
    return warp_max(r);
  }
};

template <int N, int NP, int ML, int MU>
__global__ void __launch_bounds__(MAX_MEMBERS * WARP)
fused_band_bdf_kernel(const double* __restrict__ params, const double* __restrict__ init,
                      const double* __restrict__ h_tile, const double* __restrict__ t_eval,
                      const double* __restrict__ atol, const double* __restrict__ mdiag,
                      double* __restrict__ ys, int* __restrict__ info,
                      double* __restrict__ scratch, const BandConfig c) {
  constexpr int NPX = NP > 0 ? NP : 1;
  constexpr int NB = ML + MU + 1;
  // a member's scratch, member-major
  constexpr int OFF_J = ND * N;                // J band, (N, NB)
  constexpr int OFF_F = OFF_J + N * NB;        // factors, (N + MU, NB)
  constexpr int OFF_YP = OFF_F + (N + MU) * NB;  // y_pred
  constexpr int OFF_PSI = OFF_YP + N;
  constexpr int OFF_XN = OFF_PSI + N;          // the Newton iterate
  constexpr int PER = OFF_XN + N;
  extern __shared__ double smem[];
  __shared__ double red[MAX_MEMBERS];
  __shared__ double slot[2];
  __shared__ double ru[ND][ND];

  const int warp = (int)threadIdx.x / WARP, lane = (int)threadIdx.x % WARP;
  const int rank = (int)cg::this_cluster().block_rank();
  const int tile_idx = (int)blockIdx.x / c.cluster;
  const int j = rank * c.members + warp;  // this warp's slot in the tile
  const int m = tile_idx * c.tile + (j < c.tile ? j : c.tile - 1);  // (padded) member
  const bool writer = j < c.tile && m < c.nbatch;
  const int mp = m < c.nbatch ? m : c.nbatch - 1;
  const size_t slots = (size_t)c.cluster * c.members;
  double* const Dm = scratch + ((size_t)tile_idx * slots + j) * PER;  // D[i][s] = Dm[i * N + s]
  double* const J = Dm + OFF_J;
  double* const F = Dm + OFF_F;
  double* const YP = Dm + OFF_YP;
  double* const PSI = Dm + OFF_PSI;
  double* const XN = Dm + OFF_XN;
  // this member's shared memory: the rhs's input and output, or the
  // factor's window, or the solve's x and factor chunks
  double* const work = smem + (size_t)warp * c.stride;
  double* const y_in = work;
  double* const f_out = work + N;
  double* const xs = work;
  TileMax tile_max{red, slot, 0, c.members, c.cluster, warp, lane};

  double p[NPX];
  Dual<double> pd[NPX];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    p[i] = params[(size_t)mp * NP + i];
    pd[i] = Dual<double>(p[i], 0.0);
  }

  // ---- the host's initial state: y0 and h y0' (pallas_stepper_band.py:509-527)
  const double* const init_m = init + (size_t)m * 2 * N;
  for (int s = lane; s < N; s += WARP) {
    Dm[s] = init_m[s];
    Dm[N + s] = init_m[N + s];
    for (int i = 2; i < ND; ++i) Dm[i * N + s] = 0.0;
  }
  // band entries outside the matrix are never written by a probe
  for (int e = lane; e < N * NB; e += WARP) J[e] = 0.0;
  double t = c.t0;
  double h = h_tile[tile_idx];

  int k = 0, steps = 0, status = OK, nxt = 0, order = 1, n_equal = 0;
  int conv_fail = 0, newton_fails = 0, err_fails = 0, h_changed = 0;
  int ssj = 0, ssrj = 0;
  double prev_err = NAN, c_last = 0.0, eta_mem = c.eta_reset_jac, growth = 1.0;
  const double mnewt = (double)c.max_newton_iter;

  // every branch below is uniform across the tile
  while (status == OK && k < c.max_steps && nxt < c.neval) {
    const double alpha_k = c.alpha[order];
    const double cval = h * alpha_k;
    const double t_pred = t + h;

    // ---- predict + psi from D
    for (int s = lane; s < N; s += WARP) {
      double a = Dm[s];
      double b = c.gamma[1] * Dm[N + s];
#pragma unroll
      for (int i = 1; i <= MAX_ORDER; ++i) {
        if (i <= order) a += Dm[i * N + s];
        if (i >= 2 && i <= order) b += c.gamma[i] * Dm[i * N + s];
      }
      YP[s] = a;
      PSI[s] = b * alpha_k;
      y_in[s] = a;
    }

    // ---- stale-Jacobian policy (pallas_stepper_band.py:610-647)
    const double rel = fabs(cval / (c_last == 0.0 ? cval : c_last) - 1.0);
    const bool refresh = k == 0 || conv_fail > 0 || ssrj >= c.update_rhs_jac_after;
    const bool refactor = refresh || rel > c.thresh_update_jac || ssj >= c.update_jac_after;
    if (refresh) {  // NB colored dual probes over the lanes (jac_band :349)
      __syncwarp();
      const Dual<double> td(t_pred, 0.0);
#pragma unroll 1
      for (int col = lane; col < NB; col += WARP)
        diffsol_model::model_rhs<Dual<double> >(td, SeedIn<NB>{y_in, col}, pd,
                                                BandOut<N, NB, MU>{J, col});
    }
    if (refactor) {  // A = M - cJ, factored (assemble_and_factor :391)
      __syncwarp();
      double amax, upd;
      if (c.fchunk > 0)
        diffsol_band::warp_band_factor<N, ML, MU, true>(J, mdiag, cval, F, work, c.fchunk, lane,
                                                         amax, upd);
      else
        diffsol_band::warp_band_factor<N, ML, MU, false>(J, mdiag, cval, F, nullptr, 0, lane,
                                                          amax, upd);
      const double a0 = nan_max(tile_max(amax), 1e-30);
      growth = nan_max(a0, tile_max(upd)) / a0;
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
    for (int s = lane; s < N; s += WARP) XN[s] = YP[s];
    double first_nrm = 0.0, eta_run = eta0;
    int niter = 0, nstat = 0;
    while (nstat == 0 && niter < c.max_newton_iter) {
      __syncwarp();
      for (int s = lane; s < N; s += WARP) y_in[s] = XN[s];
      __syncwarp();
      if (lane == 0)
        diffsol_model::model_rhs<double>(t_pred, (const double*)y_in, p, f_out);
      __syncwarp();
      for (int s = lane; s < N; s += WARP) {
        double tmp = (XN[s] - YP[s]) + PSI[s];
        if (mdiag != nullptr) tmp = mdiag[s] * tmp;
        xs[s] = tmp - cval * f_out[s];
      }
      __syncwarp();
      diffsol_band::warp_band_solve<N, ML, MU>(F, xs, c.schunk, lane);
      double acc = 0.0;
      for (int s = lane; s < N; s += WARP) {
        const double dl = xs[s];
        XN[s] = XN[s] - dl;
        const double q = dl / (fabs(YP[s]) * c.rtol + atol[s]);
        acc += q * q;
      }
      const double nrm = sqrt(tile_max(warp_sum(acc) / N));
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
    for (int s = lane; s < N; s += WARP) {
      const double q = (XN[s] - YP[s]) / (fabs(YP[s]) * c.rtol + atol[s]);
      eacc += q * q;
    }
    const double err = tile_max(warp_sum(eacc) / N) * c.ec2[order - 1];
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
      for (int s = lane; s < N; s += WARP) {
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
      // this member's sum over states of (D[row] / (|y_new| rtol + atol))^2
      auto wrms_sum = [&](int row) {
        double acc = 0.0;
        for (int s = lane; s < N; s += WARP) {
          const double q = Dm[row * N + s] / (fabs(Dm[s]) * c.rtol + atol[s]);
          acc += q * q;
        }
        return warp_sum(acc);
      };
      double em = INFINITY, ep = INFINITY;
      if (order > 1) em = tile_max(wrms_sum(order) / N) * c.ec2[order - 1];
      if (order < MAX_ORDER) ep = tile_max(wrms_sum(order + 2) / N) * c.ec2[order + 1];
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
        for (int s = lane; s < N; s += WARP) {
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
      for (int s = lane; s < N; s += WARP) {
        double v[ND];
#pragma unroll
        for (int i = 0; i < ND; ++i) v[i] = Dm[i * N + s];
#pragma unroll
        for (int jj = 0; jj < ND; ++jj) {
          double acc = ru[0][jj] * v[0];
#pragma unroll
          for (int i = 1; i < ND; ++i) acc += ru[i][jj] * v[i];
          Dm[jj * N + s] = acc;
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
  if (rank == 0 && threadIdx.x == 0) {
    int* row = info + (size_t)tile_idx * 4;
    row[0] = status;
    row[1] = steps;
    row[2] = k;
    row[3] = nxt;
  }
  // no block leaves while a peer may still read its slot
  cg::this_cluster().sync();
}

// The plan's problems for this build, or 0: every count in range, the
// tile covered, and the shared memory within the block's limit.
inline int plan_error(const BandConfig& c) {
  if (c.tile < 1 || c.tile > MAX_TILE || c.ntiles < 1 || c.nbatch < 1) return 1;
  if (c.members < 1 || c.members > MAX_MEMBERS || c.cluster < 1 || c.cluster > MAX_CLUSTER)
    return 2;
  if (c.members * c.cluster < c.tile) return 3;
  if (c.fchunk < 0 || c.schunk < 1) return 4;
  if (c.stride < member_doubles<MODEL_N, BAND_ML, BAND_MU>(c.fchunk, c.schunk)) return 5;
  if ((size_t)c.members * c.stride * sizeof(double) > SMEM_DYNAMIC) return 6;
  return 0;
}

// This build's kernel, and the launch of plan c: the kernel's shared
// memory and cluster-size attributes set, `lc` filled with the grid, the
// block, the shared memory, the stream and the cluster dimension (in
// `attr`).  Returns 0, cudaErrorInvalidValue for a plan that does not
// fit, or the CUDA error of an attribute request.
using Kernel = void (*)(const double*, const double*, const double*, const double*,
                        const double*, const double*, double*, int*, double*, const BandConfig);

inline int prepare_launch(const BandConfig& c, cudaStream_t stream, Kernel& kernel,
                          cudaLaunchConfig_t& lc, cudaLaunchAttribute* attr) {
  if (plan_error(c) != 0) return (int)cudaErrorInvalidValue;
  kernel = fused_band_bdf_kernel<MODEL_N, MODEL_NP, BAND_ML, BAND_MU>;
  const size_t bytes = (size_t)c.members * c.stride * sizeof(double);
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == cudaSuccess && c.cluster > 8)
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != cudaSuccess) return (int)rc;
  lc = cudaLaunchConfig_t{};
  lc.gridDim = dim3((unsigned)(c.ntiles * c.cluster), 1, 1);
  lc.blockDim = dim3((unsigned)(c.members * WARP), 1, 1);
  lc.dynamicSmemBytes = bytes;
  lc.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  return 0;
}

}  // namespace diffsol_fused_band

// The C entry points, bound with ctypes.  Every pointer but cfg (a host
// BandConfig) is a device pointer; mdiag is null for an identity mass.
extern "C" int fused_band_bdf_config_size() {
  return (int)sizeof(diffsol_fused_band::BandConfig);
}

// shared doubles a member needs at these chunk sizes (the plan's stride
// must be at least this)
extern "C" int fused_band_bdf_member_doubles(int fchunk, int schunk) {
  return diffsol_fused_band::member_doubles<MODEL_N, BAND_ML, BAND_MU>(fchunk, schunk);
}

// Launches every tile at once, a cluster of cfg->cluster blocks a tile, on
// `stream`; returns 0, or the CUDA error of a refused plan (InvalidValue),
// of the attribute requests, of cudaLaunchKernelEx, or cudaGetLastError().
extern "C" int fused_band_bdf_launch(const double* params, const double* init,
                                     const double* h_tile, const double* t_eval,
                                     const double* atol, const double* mdiag, double* ys,
                                     int* info, double* scratch,
                                     const diffsol_fused_band::BandConfig* cfg,
                                     void* stream) {
  using namespace diffsol_fused_band;
  Kernel kernel;
  cudaLaunchConfig_t lc;
  cudaLaunchAttribute attr[1];
  if (const int rc = prepare_launch(*cfg, (cudaStream_t)stream, kernel, lc, attr)) return rc;
  const cudaError_t rc = cudaLaunchKernelEx(&lc, kernel, params, init, h_tile, t_eval, atol,
                                            mdiag, ys, info, scratch, *cfg);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// The build and the plan as the card sees them, for the build report:
// out[0] clusters of this plan the card holds at once, out[1] registers a
// thread, out[2] local (spill and stack) bytes a thread, out[3] dynamic and
// out[4] static shared bytes a block.  Returns 0 or the CUDA error.
extern "C" int fused_band_bdf_report(const diffsol_fused_band::BandConfig* cfg, int* out) {
  using namespace diffsol_fused_band;
  Kernel kernel;
  cudaLaunchConfig_t lc;
  cudaLaunchAttribute attr[1];
  if (const int rc = prepare_launch(*cfg, nullptr, kernel, lc, attr)) return rc;
  cudaFuncAttributes fa;
  cudaError_t rc = cudaFuncGetAttributes(&fa, kernel);
  int clusters = 0;
  if (rc == cudaSuccess) rc = cudaOccupancyMaxActiveClusters(&clusters, kernel, &lc);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = clusters;
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  out[3] = (int)lc.dynamicSmemBytes;
  out[4] = (int)fa.sharedSizeBytes;
  return 0;
}
