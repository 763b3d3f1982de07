/* End-to-end C consumer of the diffsol_tpu_torch C ABI, linked against
 * libdiffsol_tpu_torch.so (role of the reference's
 * diffsol-c integration tests, crates/diffsol-c/tests/logistic_jit.rs):
 * builds DiffSL models through the embedded-Python runtime, solves, and
 * checks against analytic solutions.  Exit code 0 = all checks passed. */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "diffsol_tpu.h"

#define CHECK(cond, msg)                                                   \
    do {                                                                   \
        if (!(cond)) {                                                     \
            fprintf(stderr, "FAIL: %s (%s)\n", msg,                        \
                    diffsol_last_error_message());                         \
            return 1;                                                      \
        }                                                                  \
    } while (0)

static const char *LOGISTIC =
    "in_i { r = 1.0, k = 1.0 }\n"
    "u { 0.1 }\n"
    "F { r * u * (1.0 - u / k) }\n";

static const char *ROBERTSON =
    "in_i { k1 = 0.04, k2 = 10000, k3 = 30000000 }\n"
    "u_i { x = 1, y = 0, z = 0 }\n"
    "dudt_i { dxdt = 1, dydt = 0, dzdt = 0 }\n"
    "M_i { dxdt, dydt, 0 }\n"
    "F_i {\n"
    "    -k1 * x + k2 * y * z,\n"
    "    k1 * x - k2 * y * z - k3 * y * y,\n"
    "    1 - x - y - z,\n"
    "}\n";

int main(void) {
    CHECK(diffsol_init() == 0, "diffsol_init");

    /* ---- logistic: solve_dense vs analytic ---- */
    int64_t ode = diffsol_ode_new_jit(LOGISTIC);
    CHECK(ode > 0, "new_jit(logistic)");
    CHECK(diffsol_ode_set_rtol(ode, 1e-8) == 0, "set_rtol");
    CHECK(diffsol_ode_set_atol(ode, 1e-10) == 0, "set_atol");
    double params[2] = {1.0, 10.0};
    CHECK(diffsol_ode_set_params(ode, params, 2) == 0, "set_params");

    int64_t n = 0;
    CHECK(diffsol_ode_nstates(ode, &n) == 0 && n == 1, "nstates == 1");
    int64_t np = 0;
    CHECK(diffsol_ode_nparams(ode, &np) == 0 && np == 2, "nparams == 2");

    double y0[1];
    CHECK(diffsol_ode_y0(ode, y0, 1) == 0, "y0");
    CHECK(fabs(y0[0] - 0.1) < 1e-12, "y0 == 0.1");

    double f[1];
    CHECK(diffsol_ode_rhs(ode, 0.0, y0, 1, f) == 0, "rhs");
    CHECK(fabs(f[0] - 1.0 * 0.1 * (1.0 - 0.1 / 10.0)) < 1e-12, "rhs value");

    double t_eval[3] = {0.1, 0.25, 0.4};
    double ys[3];
    int stop = -99;
    CHECK(diffsol_ode_solve_dense(ode, t_eval, 3, 2000, ys, &stop) == 0,
          "solve_dense");
    CHECK(stop >= 0, "solve_dense stop_reason ok");
    for (int i = 0; i < 3; ++i) {
        double r = 1.0, k = 10.0, v0 = 0.1, t = t_eval[i];
        double expect = k * v0 * exp(r * t) / (k + v0 * (exp(r * t) - 1.0));
        CHECK(fabs(ys[i] - expect) < 1e-6, "logistic trajectory point");
    }

    /* clear_caches drops compiled executables; handles stay valid and
     * the next solve recompiles lazily with identical results */
    diffsol_clear_caches();
    double ys_after_clear[3];
    CHECK(diffsol_ode_solve_dense(ode, t_eval, 3, 2000, ys_after_clear,
                                  &stop) == 0,
          "solve_dense after clear_caches");
    for (int i = 0; i < 3; ++i)
        CHECK(ys_after_clear[i] == ys[i], "clear_caches preserves results");

    /* adaptive solve with every internal step recorded */
    double ts_buf[512], ys_buf[512];
    int64_t npts = 0;
    CHECK(diffsol_ode_solve(ode, 0.4, 500, ts_buf, ys_buf, 512, &npts,
                            &stop) == 0,
          "solve");
    CHECK(npts > 2 && stop >= 0, "solve points recorded");
    CHECK(fabs(ts_buf[npts - 1] - 0.4) < 1e-9, "solve final time");

    /* forward sensitivities: dy/dr and dy/dk at t_eval */
    double sens[2 * 3 * 1];
    double ys2[3];
    CHECK(diffsol_ode_solve_fwd_sens(ode, t_eval, 3, ys2, sens) == 0,
          "solve_fwd_sens");
    /* finite-difference dy/dr cross-check at t = 0.4 */
    double p_hi[2] = {1.0 + 1e-6, 10.0}, p_lo[2] = {1.0 - 1e-6, 10.0};
    double y_hi[3], y_lo[3];
    CHECK(diffsol_ode_set_params(ode, p_hi, 2) == 0, "set_params hi");
    CHECK(diffsol_ode_solve_dense(ode, t_eval, 3, 2000, y_hi, &stop) == 0,
          "solve hi");
    CHECK(diffsol_ode_set_params(ode, p_lo, 2) == 0, "set_params lo");
    CHECK(diffsol_ode_solve_dense(ode, t_eval, 3, 2000, y_lo, &stop) == 0,
          "solve lo");
    double fd = (y_hi[2] - y_lo[2]) / 2e-6;
    CHECK(fabs(sens[0 * 3 + 2] - fd) < 1e-4, "fwd sens dy/dr vs FD");

    /* adjoint gradient of G = sum_i y(t_i): dG/dp vs forward sens */
    CHECK(diffsol_ode_set_params(ode, params, 2) == 0, "set_params adj");
    double dgdu[3] = {1.0, 1.0, 1.0};
    double ys3[3], grad[2];
    CHECK(diffsol_ode_solve_adjoint(ode, t_eval, 3, dgdu, 16384, ys3,
                                    grad) == 0,
          "solve_adjoint");
    double g_fwd_r = sens[0 * 3 + 0] + sens[0 * 3 + 1] + sens[0 * 3 + 2];
    double g_fwd_k = sens[1 * 3 + 0] + sens[1 * 3 + 1] + sens[1 * 3 + 2];
    CHECK(fabs(grad[0] - g_fwd_r) < 1e-4, "adjoint dG/dr vs fwd sens");
    CHECK(fabs(grad[1] - g_fwd_k) < 1e-4, "adjoint dG/dk vs fwd sens");
    diffsol_ode_free(ode);

    /* ---- robertson DAE on BDF (mass matrix through M_i) ---- */
    int64_t dae = diffsol_ode_new_jit(ROBERTSON);
    CHECK(dae > 0, "new_jit(robertson)");
    CHECK(diffsol_ode_set_rtol(dae, 1e-6) == 0, "dae rtol");
    CHECK(diffsol_ode_set_atol(dae, 1e-8) == 0, "dae atol");
    CHECK(diffsol_ode_set_ode_solver(dae, 0) == 0, "dae bdf");
    double te[2] = {0.4, 4.0};
    double yd[6];
    CHECK(diffsol_ode_solve_dense(dae, te, 2, 5000, yd, &stop) == 0,
          "dae solve_dense");
    CHECK(stop >= 0, "dae stop ok");
    /* IDA reference values (reference test_models/robertson.rs soln) */
    CHECK(fabs(yd[0] - 0.9851721) < 1e-4, "robertson x(0.4)");
    CHECK(fabs(yd[2] - 0.0147940) < 1e-4, "robertson z(0.4)");
    /* conservation: x + y + z == 1 */
    CHECK(fabs(yd[3] + yd[4] + yd[5] - 1.0) < 1e-8, "dae conservation");
    /* klu is a CPU/SuiteSparse tier; must be rejected on a live handle */
    CHECK(diffsol_ode_set_linear_solver(dae, 2) == -1, "klu rejected");
    diffsol_clear_last_error();

    /* f32 scalar tier (reference scalar_type.rs): same solve, f32 device
     * precision -- tolerances must sit above f32 eps (the reference's JIT
     * tests use 1e-6 for F32; the stiff DAE needs a little more slack) */
    CHECK(diffsol_ode_set_rtol(dae, 1e-4) == 0, "f32 rtol");
    CHECK(diffsol_ode_set_atol(dae, 1e-6) == 0, "f32 atol");
    CHECK(diffsol_ode_set_scalar_type(dae, 0) == 0, "set f32");
    int sc = -1;
    CHECK(diffsol_ode_get_scalar_type(dae, &sc) == 0 && sc == 0, "get f32");
    double yf[6];
    CHECK(diffsol_ode_solve_dense(dae, te, 2, 5000, yf, &stop) == 0,
          "f32 dae solve");
    CHECK(stop >= 0, "f32 stop ok");
    CHECK(fabs(yf[0] - yd[0]) < 1e-3, "f32 vs f64 trajectory");
    diffsol_ode_free(dae);

    /* ---- round-3 parity surface (ode_c.rs get/setters + enums) ---- */
    int64_t ode2 = diffsol_ode_new_jit(LOGISTIC);
    CHECK(ode2 > 0, "new_jit(parity)");
    double tol = 0.0;
    /* unset tolerance groups read back NaN; set/get round-trips */
    CHECK(diffsol_ode_get_sens_rtol(ode2, &tol) == 0 && isnan(tol),
          "sens_rtol unset -> NaN");
    CHECK(diffsol_ode_set_sens_rtol(ode2, 1e-5) == 0, "set_sens_rtol");
    CHECK(diffsol_ode_set_sens_atol(ode2, 1e-7) == 0, "set_sens_atol");
    CHECK(diffsol_ode_get_sens_rtol(ode2, &tol) == 0 && fabs(tol - 1e-5) < 1e-18,
          "sens_rtol roundtrip");
    CHECK(diffsol_ode_set_out_rtol(ode2, 1e-4) == 0, "set_out_rtol");
    CHECK(diffsol_ode_set_out_atol(ode2, 1e-6) == 0, "set_out_atol");
    CHECK(diffsol_ode_get_out_atol(ode2, &tol) == 0 && fabs(tol - 1e-6) < 1e-18,
          "out_atol roundtrip");
    CHECK(diffsol_ode_set_param_rtol(ode2, 1e-3) == 0, "set_param_rtol");
    CHECK(diffsol_ode_set_param_atol(ode2, 1e-5) == 0, "set_param_atol");
    CHECK(diffsol_ode_get_param_atol(ode2, &tol) == 0 &&
              fabs(tol - 1e-5) < 1e-18,
          "param_atol roundtrip");
    /* setting NaN clears the group */
    CHECK(diffsol_ode_set_sens_rtol(ode2, NAN) == 0, "clear sens_rtol");
    CHECK(diffsol_ode_get_sens_rtol(ode2, &tol) == 0 && isnan(tol),
          "sens_rtol cleared");

    /* solver/IC options: defaults match the reference, writes take effect */
    double ov = 0.0;
    CHECK(diffsol_ode_options_get_max_nonlinear_solver_iterations(ode2, &ov)
              == 0 && ov == 10.0,
          "default max newton iters == 10");
    CHECK(diffsol_ode_options_get_update_jacobian_after_steps(ode2, &ov) == 0
              && ov == 20.0,
          "default jacobian update steps == 20");
    CHECK(diffsol_ode_options_set_min_timestep(ode2, 1e-10) == 0,
          "set min_timestep");
    CHECK(diffsol_ode_options_get_min_timestep(ode2, &ov) == 0
              && fabs(ov - 1e-10) < 1e-24,
          "min_timestep roundtrip");
    CHECK(diffsol_ic_options_get_use_linesearch(ode2, &ov) == 0 && ov == 1.0,
          "ic linesearch default on");
    CHECK(diffsol_ic_options_set_max_newton_iterations(ode2, 12) == 0,
          "set ic newton iters");
    CHECK(diffsol_ic_options_get_max_newton_iterations(ode2, &ov) == 0
              && ov == 12.0,
          "ic newton iters roundtrip");

    /* quadrature-output solve: G(t) = int_0^t u dt for the logistic */
    CHECK(diffsol_ode_set_integrate_out(ode2, 1) == 0, "set integrate_out");
    int io = 0;
    CHECK(diffsol_ode_get_integrate_out(ode2, &io) == 0 && io == 1,
          "get integrate_out");
    CHECK(diffsol_ode_set_rtol(ode2, 1e-8) == 0, "quad rtol");
    CHECK(diffsol_ode_set_atol(ode2, 1e-10) == 0, "quad atol");
    CHECK(diffsol_ode_set_params(ode2, params, 2) == 0, "quad params");
    double gs[3];
    int64_t nout = 0;
    CHECK(diffsol_ode_solve_dense_out(ode2, t_eval, 3, 2000, gs, &nout,
                                      &stop) == 0,
          "solve_dense_out");
    CHECK(nout == 1 && stop >= 0, "solve_dense_out dims");
    /* analytic integral of the logistic: (k/r) ln((k + v0(e^{rt}-1))/k) */
    {
        double r = 1.0, k = 10.0, v0 = 0.1, t = t_eval[2];
        double expect = (k / r) * log((k + v0 * (exp(r * t) - 1.0)) / k);
        CHECK(fabs(gs[2] - expect) < 1e-6, "quadrature value");
    }

    /* host-array view of a dense solve */
    CHECK(diffsol_ode_set_integrate_out(ode2, 0) == 0, "quad off");
    int64_t arr = diffsol_ode_solve_dense_array(ode2, t_eval, 3, 2000, &stop);
    CHECK(arr > 0 && stop >= 0, "solve_dense_array");
    CHECK(diffsol_host_array_ndim(arr) == 2, "host array ndim");
    CHECK(diffsol_host_array_dim(arr, 0) == 3, "host array dim 0");
    CHECK(diffsol_host_array_dim(arr, 1) == 1, "host array dim 1");
    CHECK(diffsol_host_array_stride(arr, 0) == 1, "host array stride 0");
    CHECK(diffsol_host_array_dtype(arr) == 1, "host array dtype f64");
    double *aptr = diffsol_host_array_ptr(arr);
    CHECK(aptr != NULL, "host array ptr");
    CHECK(fabs(aptr[0] - ys[0]) < 1e-9, "host array values match copy API");
    diffsol_host_array_free(arr);
    CHECK(diffsol_host_array_ptr(arr) == NULL, "host array freed");
    diffsol_ode_free(ode2);

    /* type-enumeration helpers (reference *_type_count/name/is_valid) */
    char namebuf[32];
    CHECK(diffsol_ode_solver_type_count() == 4, "ode solver type count");
    CHECK(diffsol_ode_solver_type_is_valid(0) == 1, "bdf valid");
    CHECK(diffsol_ode_solver_type_is_valid(4) == 0, "5th solver invalid");
    CHECK(diffsol_ode_solver_type_name(0, namebuf, 32) == 0 &&
              strcmp(namebuf, "bdf") == 0,
          "solver 0 is bdf");
    CHECK(diffsol_ode_solver_type_name(2, namebuf, 32) == 0 &&
              strcmp(namebuf, "tr_bdf2") == 0,
          "solver 2 is tr_bdf2");
    CHECK(diffsol_linear_solver_type_count() == 3, "linsol type count");
    CHECK(diffsol_linear_solver_type_name(2, namebuf, 32) == 0 &&
              strcmp(namebuf, "klu") == 0,
          "linsol 2 is klu");
    CHECK(diffsol_scalar_type_count() == 2, "scalar type count");
    CHECK(diffsol_scalar_type_name(1, namebuf, 32) == 0 &&
              strcmp(namebuf, "f64") == 0,
          "scalar 1 is f64");
    CHECK(diffsol_matrix_type_count() == 4, "matrix type count");
    CHECK(diffsol_matrix_type_name(3, namebuf, 32) == 0 &&
              strcmp(namebuf, "matrix_free") == 0,
          "matrix 3 is matrix_free");
    CHECK(diffsol_jit_backend_type_count() == 1, "jit backend count");
    CHECK(diffsol_jit_backend_type_name(0, namebuf, 32) == 0 &&
              strcmp(namebuf, "xla") == 0,
          "jit backend is xla");

    /* ---- time-reset model with the N built-in (reference
     * diffsol-c/tests/logistic_time_reset_jit.rs): a stop at t = 0.5
     * resets y to 0.1 + 0.5*N with N = the fired root's index (0).
     * The hidden model-index state appears as one extra state column. */
    static const char *TIME_RESET =
        "in_i { r = 1 }\n"
        "u_i { y = 0.1 }\n"
        "dudt_i { dydt = 0 }\n"
        "F_i { r * y * (1.0 - y) }\n"
        "stop_i { t - 0.5 }\n"
        "reset_i { 0.1 + 0.5 * N }\n"
        "out_i { y }\n";
    int64_t tr = diffsol_ode_new_jit(TIME_RESET);
    CHECK(tr > 0, "new_jit(time_reset)");
    CHECK(diffsol_ode_set_rtol(tr, 1e-8) == 0, "tr rtol");
    CHECK(diffsol_ode_set_atol(tr, 1e-10) == 0, "tr atol");
    int64_t ntr = 0;
    CHECK(diffsol_ode_nstates(tr, &ntr) == 0 && ntr == 2,
          "time-reset nstates (1 + hidden index)");
    double tr_eval[4] = {0.25, 0.5, 0.75, 1.0};
    double tr_ys[8];
    CHECK(diffsol_ode_solve_dense(tr, tr_eval, 4, 4000, tr_ys, &stop) == 0,
          "time-reset solve");
    CHECK(stop >= 0, "time-reset stop ok");
    {
        /* reference time_reset_state: logistic from 0.1, restarted from
         * 0.1 + 0.5*0 at t = 0.5 */
        double expect[4];
        double ts_rel[4] = {0.25, 0.5, 0.25, 0.5};
        for (int i = 0; i < 4; ++i) {
            double e = exp(1.0 * ts_rel[i]);
            expect[i] = 0.1 * e / (1.0 - 0.1 + 0.1 * e);
        }
        for (int i = 0; i < 4; ++i)
            CHECK(fabs(tr_ys[2 * i] - expect[i]) < 1e-6,
                  "time-reset trajectory point");
    }
    diffsol_ode_free(tr);

    /* ---- round-4 parity surface: alloc helpers, error file/line,
     * options handles, matrix type, external models, solution wrappers
     * (reference string_c.rs, error_c.rs:94-111, ode_c.rs:343-380,624,
     * solve.rs:324, solution_wrapper_c.rs, host_array_c.rs:13) ---- */
    {
        char *s = diffsol_alloc_string(16);
        CHECK(s != NULL && s[0] == 0, "alloc_string zeroed");
        strcpy(s, "hello");
        diffsol_free_string(s, 16);
        void *b = diffsol_alloc(100, 32);
        CHECK(b != NULL && ((uintptr_t)b % 32) == 0, "alloc aligned");
        diffsol_free(b, 100, 32);
        CHECK(diffsol_alloc(0, 8) == NULL, "alloc(0) is NULL");

        CHECK(diffsol_error() == NULL && diffsol_error_code() == 0,
              "no error pending");
        CHECK(diffsol_ode_new_jit("not a model {") == 0, "bad model");
        CHECK(diffsol_error() != NULL && diffsol_error_code() == 1,
              "error + code set");
        CHECK(diffsol_last_error_file() != NULL &&
                  strstr(diffsol_last_error_file(), "capi.cpp") != NULL,
              "error file recorded");
        CHECK(diffsol_last_error_line() > 0, "error line recorded");
        diffsol_clear_last_error();
        CHECK(diffsol_last_error_line() == 0, "error line cleared");

        /* a fresh handle: the earlier logistic handles were freed above */
        int64_t ode4 = diffsol_ode_new_jit(LOGISTIC);
        CHECK(ode4 > 0, "round-4 logistic handle");
        int64_t opts = 0, ic_opts = 0;
        CHECK(diffsol_ode_get_options(ode4, &opts) == 0 && opts == ode4,
              "options handle aliases ode");
        CHECK(diffsol_ode_get_ic_options(ode4, &ic_opts) == 0 &&
                  ic_opts == ode4,
              "ic options handle aliases ode");
        double mv = 0.0;
        CHECK(diffsol_ode_options_get_min_timestep(opts, &mv) == 0,
              "options read through aliased handle");
        diffsol_ode_options_free(opts);
        diffsol_ic_options_free(ic_opts);

        CHECK(diffsol_ode_get_matrix_type(ode4) == 0,
              "logistic routes to the dense tier");
        char mt_name[32];
        CHECK(diffsol_matrix_type_name(diffsol_ode_get_matrix_type(ode4),
                                       mt_name, sizeof mt_name) == 0 &&
                  strcmp(mt_name, "dense") == 0,
              "matrix type name");
        diffsol_ode_free(ode4);

        /* host-array alloc/list-free */
        int64_t v1 = diffsol_host_array_alloc_vector(5, 1);
        int64_t v2 = diffsol_host_array_alloc_vector(3, 1);
        CHECK(v1 > 0 && v2 > 0, "host array alloc_vector");
        CHECK(diffsol_host_array_ndim(v1) == 1 &&
                  diffsol_host_array_dim(v1, 0) == 5,
              "alloc_vector dims");
        CHECK(diffsol_host_array_ptr(v1)[4] == 0.0, "alloc_vector zeroed");
        int64_t lst[2] = {v1, v2};
        diffsol_host_array_list_free(lst, 2);
        CHECK(diffsol_host_array_ptr(v1) == NULL, "list_free freed");
        CHECK(diffsol_host_array_alloc_vector(4, 7) == 0,
              "alloc_vector rejects bad dtype");
        diffsol_clear_last_error();

        /* external dynamic model: a Python module file (the reference
         * dlopens a compiled DiffSL cdylib; solve.rs:324) */
        const char *ext_path = "diffsol_capi_ext_model.py";
        FILE *f = fopen(ext_path, "w");
        CHECK(f != NULL, "write external model file");
        fputs("import torch\n"
              "params = [0.5]\n"
              "def rhs(t, y, p):\n"
              "    return -p[0] * y\n"
              "def init(t, p):\n"
              "    return torch.ones(1, dtype=p.dtype, device=p.device)\n",
              f);
        fclose(f);
        int64_t ext = diffsol_ode_new_external_dynamic(ext_path);
        CHECK(ext > 0, "new_external_dynamic loads python model");
        CHECK(diffsol_ode_set_rtol(ext, 1e-8) == 0, "ext rtol");
        CHECK(diffsol_ode_set_atol(ext, 1e-10) == 0, "ext atol");
        int64_t next_ = 0;
        CHECK(diffsol_ode_nstates(ext, &next_) == 0 && next_ == 1,
              "ext nstates");

        /* solution wrapper with forward sensitivities:
         * y = exp(-a t), dy/da = -t exp(-a t) */
        double ext_eval[3] = {0.5, 1.0, 2.0};
        int ext_stop = -99;
        int64_t sw = diffsol_ode_solve_solution(ext, ext_eval, 3, 4000, 1,
                                                &ext_stop);
        CHECK(sw > 0 && ext_stop >= 0, "solve_solution");
        int64_t ts_arr = 0, ys_arr = 0;
        CHECK(diffsol_solution_wrapper_get_ts(sw, &ts_arr) == 0,
              "solution get_ts");
        CHECK(diffsol_host_array_dim(ts_arr, 0) == 3 &&
                  fabs(diffsol_host_array_ptr(ts_arr)[2] - 2.0) < 1e-12,
              "ts contents");
        CHECK(diffsol_solution_wrapper_get_ys(sw, &ys_arr) == 0,
              "solution get_ys");
        CHECK(diffsol_host_array_ndim(ys_arr) == 2 &&
                  diffsol_host_array_dim(ys_arr, 0) == 3 &&
                  diffsol_host_array_dim(ys_arr, 1) == 1,
              "ys dims");
        for (int i = 0; i < 3; ++i)
            CHECK(fabs(diffsol_host_array_ptr(ys_arr)[i] -
                       exp(-0.5 * ext_eval[i])) < 1e-6,
                  "external model trajectory");
        int64_t sens_handles[4];
        int64_t sens_len = 0;
        CHECK(diffsol_solution_wrapper_get_sens(sw, sens_handles, 4,
                                                &sens_len) == 0 &&
                  sens_len == 1,
              "solution get_sens");
        for (int i = 0; i < 3; ++i)
            CHECK(fabs(diffsol_host_array_ptr(sens_handles[0])[i] -
                       (-ext_eval[i] * exp(-0.5 * ext_eval[i]))) < 1e-5,
                  "external model sensitivity dy/da");
        diffsol_host_array_list_free(sens_handles, sens_len);
        diffsol_host_array_free(ts_arr);
        diffsol_host_array_free(ys_arr);
        diffsol_solution_wrapper_free(sw);
        diffsol_ode_free(ext);

        /* the statically-linked form is documented-unsupported: loud error */
        CHECK(diffsol_ode_new_external(0, 0, 0, NULL, 0, NULL, 0, NULL, 0)
                  == 0,
              "new_external fails");
        CHECK(strstr(diffsol_last_error_message(), "new_external_dynamic")
                  != NULL,
              "new_external error points at the dynamic form");
        diffsol_clear_last_error();
    }

    /* ---- error paths ---- */
    CHECK(diffsol_ode_new_jit("not a model {") == 0, "bad model rejected");
    CHECK(strlen(diffsol_last_error_message()) > 0, "error message set");
    diffsol_clear_last_error();
    CHECK(strlen(diffsol_last_error_message()) == 0, "error cleared");
    double dummy;
    CHECK(diffsol_ode_get_rtol(9999, &dummy) == -1, "bad handle rejected");

    printf("capi: ALL CHECKS PASSED\n");
    diffsol_shutdown();
    return 0;
}
