/* diffsol_tpu_torch C ABI implementation: embeds CPython and drives the
 * diffsol_tpu_torch.capi_host Python module (role of reference
 * crates/diffsol-c/src/ode_c.rs OdeWrapper FFI + error_c.rs thread-local
 * error reporting).  A copy of the JAX package's native/capi.cpp that
 * imports this package's host module; it is compiled against the same
 * header, native/diffsol_tpu.h, so one header describes both libraries.
 *
 * Build (diffsol_tpu_torch._build.load_capi does this at first use):
 *   g++ -O2 -shared -fPIC -o libdiffsol_tpu_torch.so capi.cpp \
 *       -I<repo>/native $(python3-config --includes) \
 *       -L$(python3-config --prefix)/lib -lpython3.12
 *
 * The embedding host must be able to import diffsol_tpu_torch and torch
 * (set PYTHONPATH to the repo root and the environment's site-packages).
 * DIFFSOL_PLATFORM=cpu solves on the CPU; unset, every solve runs on the
 * CUDA device.
 */
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include "diffsol_tpu.h"

static thread_local std::string g_err;
static thread_local std::string g_err_file;
static thread_local unsigned g_err_line = 0;
static PyObject *g_host = nullptr;  /* diffsol_tpu_torch.capi_host module */
static bool g_owns_interp = false;
static PyThreadState *g_main_tstate = nullptr;

/* Every error site records file:line (reference error_c.rs CError{message,
 * file, line}; surfaced by diffsol_last_error_file/line). */
static void set_err_at(const char *msg, const char *file, unsigned line) {
    g_err = msg ? msg : "unknown error";
    g_err_file = file ? file : "";
    g_err_line = line;
}
#define set_err(m) set_err_at((m), __FILE__, __LINE__)

/* Capture the current Python exception into the thread-local error slot. */
static void set_err_from_python_at(const char *file, unsigned line);
#define set_err_from_python() set_err_from_python_at(__FILE__, __LINE__)
static void set_err_from_python_at(const char *file, unsigned line) {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    if (value) {
        PyObject *s = PyObject_Str(value);
        if (s) {
            const char *c = PyUnicode_AsUTF8(s);
            set_err_at(c, file, line);
            Py_DECREF(s);
        } else {
            set_err_at("python exception (unprintable)", file, line);
        }
    } else {
        set_err_at("python exception", file, line);
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
}

extern "C" const char *diffsol_last_error_message(void) {
    return g_err.c_str();
}

extern "C" void diffsol_clear_last_error(void) {
    g_err.clear();
    g_err_file.clear();
    g_err_line = 0;
}

/* reference error_c.rs:54-111: diffsol_error returns NULL when no error is
 * set (the message-pointer form), diffsol_error_code returns 1/0, and
 * file/line report where the error was recorded. */
extern "C" const char *diffsol_error(void) {
    return g_err.empty() ? nullptr : g_err.c_str();
}

extern "C" int diffsol_error_code(void) { return g_err.empty() ? 0 : 1; }

extern "C" const char *diffsol_last_error_file(void) {
    return g_err.empty() ? nullptr : g_err_file.c_str();
}

extern "C" unsigned diffsol_last_error_line(void) {
    return g_err.empty() ? 0 : g_err_line;
}

/* reference string_c.rs: caller-side buffer helpers so a C consumer can
 * allocate/free through the library's allocator. */
extern "C" char *diffsol_alloc_string(size_t size) {
    if (size == 0) return nullptr;
    return (char *)calloc(size, 1);
}

extern "C" void diffsol_free_string(char *ptr, size_t size) {
    (void)size;
    free(ptr);
}

extern "C" void *diffsol_alloc(size_t size, size_t align) {
    if (size == 0) return nullptr;
    if (align < sizeof(void *)) align = sizeof(void *);
    /* round size up to a multiple of align (aligned_alloc requirement) */
    size_t rounded = (size + align - 1) / align * align;
    return aligned_alloc(align, rounded);
}

extern "C" void diffsol_free(void *ptr, size_t size, size_t align) {
    (void)size;
    (void)align;
    free(ptr);
}

extern "C" int diffsol_init(void) {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        g_owns_interp = true;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    int rc = 0;
    if (!g_host) {
        g_host = PyImport_ImportModule("diffsol_tpu_torch.capi_host");
        if (!g_host) {
            set_err_from_python();
            rc = -1;
        }
    }
    PyGILState_Release(gil);
    if (g_owns_interp && !g_main_tstate) {
        /* release the GIL held since Py_Initialize so any thread can
         * PyGILState_Ensure later */
        g_main_tstate = PyEval_SaveThread();
    }
    return rc;
}

extern "C" void diffsol_shutdown(void) {
    if (!Py_IsInitialized()) return;
    if (g_main_tstate) {
        PyEval_RestoreThread(g_main_tstate);
        g_main_tstate = nullptr;
    }
    Py_XDECREF(g_host);
    g_host = nullptr;
    if (g_owns_interp) {
        Py_FinalizeEx();
        g_owns_interp = false;
    }
}

/* ---- call helpers --------------------------------------------------- */

struct Gil {
    PyGILState_STATE s;
    Gil() : s(PyGILState_Ensure()) {}
    ~Gil() { PyGILState_Release(s); }
};

/* Call capi_host.<fn>(*args); returns new ref or nullptr (err set). */
static PyObject *call_host(const char *fn, PyObject *args /* stolen */) {
    if (!g_host) {
        Py_XDECREF(args);
        set_err("diffsol_init() has not been called");
        return nullptr;
    }
    PyObject *f = PyObject_GetAttrString(g_host, fn);
    if (!f) {
        Py_XDECREF(args);
        set_err_from_python();
        return nullptr;
    }
    PyObject *r = PyObject_CallObject(f, args);
    Py_DECREF(f);
    Py_XDECREF(args);
    if (!r) set_err_from_python();
    return r;
}

static PyObject *list_from_doubles(const double *p, int64_t n) {
    PyObject *l = PyList_New(n);
    for (int64_t i = 0; i < n; ++i)
        PyList_SET_ITEM(l, i, PyFloat_FromDouble(p[i]));
    return l;
}

/* Copy a Python float sequence into out (up to cap; -1 = exact len
 * unknown, copy all).  Returns copied count or -1. */
static int64_t doubles_from_seq(PyObject *seq, double *out, int64_t cap) {
    PyObject *fast = PySequence_Fast(seq, "expected a sequence");
    if (!fast) {
        set_err_from_python();
        return -1;
    }
    int64_t n = PySequence_Fast_GET_SIZE(fast);
    if (cap >= 0 && n > cap) {
        Py_DECREF(fast);
        set_err("output buffer too small");
        return -1;
    }
    for (int64_t i = 0; i < n; ++i) {
        out[i] = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(fast, i));
        if (PyErr_Occurred()) {
            Py_DECREF(fast);
            set_err_from_python();
            return -1;
        }
    }
    Py_DECREF(fast);
    return n;
}

/* ---- handle lifecycle ------------------------------------------------ */

extern "C" int64_t diffsol_ode_new_jit(const char *code) {
    Gil gil;
    PyObject *r = call_host("new_jit", Py_BuildValue("(s)", code));
    if (!r) return 0;
    int64_t h = PyLong_AsLongLong(r);
    Py_DECREF(r);
    if (PyErr_Occurred()) {
        set_err_from_python();
        return 0;
    }
    return h;
}

extern "C" void diffsol_ode_free(int64_t ode) {
    if (!Py_IsInitialized() || !g_host) return;
    Gil gil;
    PyObject *r = call_host("free", Py_BuildValue("(L)", (long long)ode));
    Py_XDECREF(r);
}

/* TPU-build extension (no ode_c.rs analog): drop jax's in-memory compiled
 * executables.  Long-lived embedding processes that build many models
 * should call this periodically -- the XLA CPU compiler crashes once the
 * live executable set grows unboundedly (tests/conftest.py documents the
 * same landmine for the test suite).  Handles stay valid; programs
 * recompile lazily. */
extern "C" void diffsol_clear_caches(void) {
    if (!Py_IsInitialized() || !g_host) return;
    Gil gil;
    PyObject *r = call_host("clear_caches", PyTuple_New(0));
    Py_XDECREF(r);
}

/* ---- scalar setters/getters ------------------------------------------ */

#define SCALAR_SET(cname, pyname)                                          \
    extern "C" int cname(int64_t ode, double v) {                          \
        Gil gil;                                                           \
        PyObject *r = call_host(pyname,                                    \
                                Py_BuildValue("(Ld)", (long long)ode, v)); \
        if (!r) return -1;                                                 \
        Py_DECREF(r);                                                      \
        return 0;                                                          \
    }

#define SCALAR_GET(cname, pyname)                                          \
    extern "C" int cname(int64_t ode, double *out) {                       \
        Gil gil;                                                           \
        PyObject *r =                                                      \
            call_host(pyname, Py_BuildValue("(L)", (long long)ode));       \
        if (!r) return -1;                                                 \
        *out = PyFloat_AsDouble(r);                                        \
        Py_DECREF(r);                                                      \
        if (PyErr_Occurred()) {                                            \
            set_err_from_python();                                         \
            return -1;                                                     \
        }                                                                  \
        return 0;                                                          \
    }

SCALAR_SET(diffsol_ode_set_rtol, "set_rtol")
SCALAR_GET(diffsol_ode_get_rtol, "get_rtol")
SCALAR_SET(diffsol_ode_set_atol, "set_atol")
SCALAR_GET(diffsol_ode_get_atol, "get_atol")
SCALAR_SET(diffsol_ode_set_t0, "set_t0")
SCALAR_GET(diffsol_ode_get_t0, "get_t0")
SCALAR_SET(diffsol_ode_set_h0, "set_h0")
SCALAR_GET(diffsol_ode_get_h0, "get_h0")

#define INT_SET(cname, pyname)                                             \
    extern "C" int cname(int64_t ode, int v) {                             \
        Gil gil;                                                           \
        PyObject *r = call_host(pyname,                                    \
                                Py_BuildValue("(Li)", (long long)ode, v)); \
        if (!r) return -1;                                                 \
        Py_DECREF(r);                                                      \
        return 0;                                                          \
    }

#define INT_GET(cname, pyname, ty)                                         \
    extern "C" int cname(int64_t ode, ty *out) {                           \
        Gil gil;                                                           \
        PyObject *r =                                                      \
            call_host(pyname, Py_BuildValue("(L)", (long long)ode));       \
        if (!r) return -1;                                                 \
        *out = (ty)PyLong_AsLongLong(r);                                   \
        Py_DECREF(r);                                                      \
        if (PyErr_Occurred()) {                                            \
            set_err_from_python();                                         \
            return -1;                                                     \
        }                                                                  \
        return 0;                                                          \
    }

INT_SET(diffsol_ode_set_ode_solver, "set_ode_solver")
INT_GET(diffsol_ode_get_ode_solver, "get_ode_solver", int)
INT_SET(diffsol_ode_set_linear_solver, "set_linear_solver")
INT_GET(diffsol_ode_get_linear_solver, "get_linear_solver", int)
INT_SET(diffsol_ode_set_scalar_type, "set_scalar_type")
INT_GET(diffsol_ode_get_scalar_type, "get_scalar_type", int)
INT_GET(diffsol_ode_nstates, "nstates", int64_t)
INT_GET(diffsol_ode_nparams, "nparams", int64_t)
INT_GET(diffsol_ode_nout, "nout", int64_t)

/* ---- params ----------------------------------------------------------- */

extern "C" int diffsol_ode_set_params(int64_t ode, const double *p,
                                      int64_t len) {
    Gil gil;
    PyObject *l = list_from_doubles(p, len);
    PyObject *r =
        call_host("set_params", Py_BuildValue("(LN)", (long long)ode, l));
    if (!r) return -1;
    Py_DECREF(r);
    return 0;
}

extern "C" int diffsol_ode_get_params(int64_t ode, double *out, int64_t cap,
                                      int64_t *len) {
    Gil gil;
    PyObject *r = call_host("get_params", Py_BuildValue("(L)", (long long)ode));
    if (!r) return -1;
    int64_t n = doubles_from_seq(r, out, cap);
    Py_DECREF(r);
    if (n < 0) return -1;
    if (len) *len = n;
    return 0;
}

/* ---- op evaluation ----------------------------------------------------- */

extern "C" int diffsol_ode_y0(int64_t ode, double *out, int64_t cap) {
    Gil gil;
    PyObject *r = call_host("y0", Py_BuildValue("(L)", (long long)ode));
    if (!r) return -1;
    int64_t n = doubles_from_seq(r, out, cap);
    Py_DECREF(r);
    return n < 0 ? -1 : 0;
}

extern "C" int diffsol_ode_rhs(int64_t ode, double t, const double *y,
                               int64_t n, double *out) {
    Gil gil;
    PyObject *l = list_from_doubles(y, n);
    PyObject *r =
        call_host("rhs", Py_BuildValue("(LdN)", (long long)ode, t, l));
    if (!r) return -1;
    int64_t m = doubles_from_seq(r, out, n);
    Py_DECREF(r);
    return m < 0 ? -1 : 0;
}

extern "C" int diffsol_ode_rhs_jac_mul(int64_t ode, double t, const double *y,
                                       const double *v, int64_t n,
                                       double *out) {
    Gil gil;
    PyObject *ly = list_from_doubles(y, n);
    PyObject *lv = list_from_doubles(v, n);
    PyObject *r = call_host(
        "rhs_jac_mul", Py_BuildValue("(LdNN)", (long long)ode, t, ly, lv));
    if (!r) return -1;
    int64_t m = doubles_from_seq(r, out, n);
    Py_DECREF(r);
    return m < 0 ? -1 : 0;
}

/* ---- solves ------------------------------------------------------------ */

extern "C" int diffsol_ode_solve_dense(int64_t ode, const double *t_eval,
                                       int64_t neval, int64_t max_steps,
                                       double *ys_out, int *stop_reason) {
    Gil gil;
    PyObject *l = list_from_doubles(t_eval, neval);
    PyObject *r = call_host(
        "solve_dense",
        Py_BuildValue("(LNL)", (long long)ode, l, (long long)max_steps));
    if (!r) return -1;
    PyObject *ys = PyTuple_GetItem(r, 0);
    PyObject *stop = PyTuple_GetItem(r, 1);
    if (!ys || !stop) {
        Py_DECREF(r);
        PyErr_Clear();
        set_err("solve_dense returned malformed tuple");
        return -1;
    }
    int64_t n = doubles_from_seq(ys, ys_out, -1);
    if (stop_reason) *stop_reason = (int)PyLong_AsLong(stop);
    Py_DECREF(r);
    return n < 0 ? -1 : 0;
}

extern "C" int diffsol_ode_solve(int64_t ode, double t_final,
                                 int64_t max_steps, double *ts_out,
                                 double *ys_out, int64_t cap_points,
                                 int64_t *npoints, int *stop_reason) {
    Gil gil;
    PyObject *r = call_host(
        "solve", Py_BuildValue("(LdL)", (long long)ode, t_final,
                               (long long)max_steps));
    if (!r) return -1;
    PyObject *ts = PyTuple_GetItem(r, 0);
    PyObject *ys = PyTuple_GetItem(r, 1);
    PyObject *np_ = PyTuple_GetItem(r, 2);
    PyObject *stop = PyTuple_GetItem(r, 3);
    if (!ts || !ys || !np_ || !stop) {
        Py_DECREF(r);
        PyErr_Clear();
        set_err("solve returned malformed tuple");
        return -1;
    }
    int64_t n = PyLong_AsLongLong(np_);
    if (n > cap_points) {
        Py_DECREF(r);
        set_err("cap_points too small for solve output");
        return -1;
    }
    if (doubles_from_seq(ts, ts_out, cap_points) < 0 ||
        doubles_from_seq(ys, ys_out, -1) < 0) {
        Py_DECREF(r);
        return -1;
    }
    if (npoints) *npoints = n;
    if (stop_reason) *stop_reason = (int)PyLong_AsLong(stop);
    Py_DECREF(r);
    return 0;
}

extern "C" int diffsol_ode_solve_adjoint(int64_t ode, const double *t_eval,
                                         int64_t neval, const double *dgdu,
                                         int64_t max_steps, double *ys_out,
                                         double *grad_out) {
    Gil gil;
    /* nstates is implied by the host side; dgdu has neval * nstates */
    int64_t n = 0;
    {
        PyObject *r =
            call_host("nstates", Py_BuildValue("(L)", (long long)ode));
        if (!r) return -1;
        n = PyLong_AsLongLong(r);
        Py_DECREF(r);
    }
    PyObject *lt = list_from_doubles(t_eval, neval);
    PyObject *lg = list_from_doubles(dgdu, neval * n);
    PyObject *r = call_host(
        "solve_adjoint", Py_BuildValue("(LNNL)", (long long)ode, lt, lg,
                                       (long long)max_steps));
    if (!r) return -1;
    PyObject *ys = PyTuple_GetItem(r, 0);
    PyObject *grad = PyTuple_GetItem(r, 1);
    if (!ys || !grad) {
        Py_DECREF(r);
        PyErr_Clear();
        set_err("solve_adjoint returned malformed tuple");
        return -1;
    }
    if ((ys_out && doubles_from_seq(ys, ys_out, -1) < 0) ||
        doubles_from_seq(grad, grad_out, -1) < 0) {
        Py_DECREF(r);
        return -1;
    }
    Py_DECREF(r);
    return 0;
}

extern "C" int diffsol_ode_solve_fwd_sens(int64_t ode, const double *t_eval,
                                          int64_t neval, double *ys_out,
                                          double *sens_out) {
    Gil gil;
    PyObject *l = list_from_doubles(t_eval, neval);
    PyObject *r = call_host("solve_fwd_sens",
                            Py_BuildValue("(LN)", (long long)ode, l));
    if (!r) return -1;
    PyObject *ys = PyTuple_GetItem(r, 0);
    PyObject *sens = PyTuple_GetItem(r, 1);
    if (!ys || !sens) {
        Py_DECREF(r);
        PyErr_Clear();
        set_err("solve_fwd_sens returned malformed tuple");
        return -1;
    }
    if (doubles_from_seq(ys, ys_out, -1) < 0 ||
        doubles_from_seq(sens, sens_out, -1) < 0) {
        Py_DECREF(r);
        return -1;
    }
    Py_DECREF(r);
    return 0;
}

/* ---- round-3 parity fill (reference ode_c.rs surface) ------------------ */

INT_SET(diffsol_ode_set_integrate_out, "set_integrate_out")
INT_GET(diffsol_ode_get_integrate_out, "get_integrate_out", int)

/* optional tolerance groups (sens/out/param): get returns NaN when unset,
 * setting NaN clears -- reference ode_c.rs sens/out/param get/setters */
SCALAR_SET(diffsol_ode_set_sens_rtol, "set_sens_rtol")
SCALAR_GET(diffsol_ode_get_sens_rtol, "get_sens_rtol")
SCALAR_SET(diffsol_ode_set_sens_atol, "set_sens_atol")
SCALAR_GET(diffsol_ode_get_sens_atol, "get_sens_atol")
SCALAR_SET(diffsol_ode_set_out_rtol, "set_out_rtol")
SCALAR_GET(diffsol_ode_get_out_rtol, "get_out_rtol")
SCALAR_SET(diffsol_ode_set_out_atol, "set_out_atol")
SCALAR_GET(diffsol_ode_get_out_atol, "get_out_atol")
SCALAR_SET(diffsol_ode_set_param_rtol, "set_param_rtol")
SCALAR_GET(diffsol_ode_get_param_rtol, "get_param_rtol")
SCALAR_SET(diffsol_ode_set_param_atol, "set_param_atol")
SCALAR_GET(diffsol_ode_get_param_atol, "get_param_atol")

/* solver options / consistent-IC options field surface
 * (reference ode_options_c.rs + initial_condition_options_c.rs: the options
 * object reads/writes through to the live solve; here the ode handle IS the
 * options handle and each field routes one call) */
#define OPTION_GETSET(cname_get, cname_set, host_get, host_set, field)     \
    extern "C" int cname_get(int64_t ode, double *out) {                   \
        Gil gil;                                                           \
        PyObject *r = call_host(                                           \
            host_get, Py_BuildValue("(Ls)", (long long)ode, field));       \
        if (!r) return -1;                                                 \
        *out = PyFloat_AsDouble(r);                                        \
        Py_DECREF(r);                                                      \
        if (PyErr_Occurred()) {                                            \
            set_err_from_python();                                         \
            return -1;                                                     \
        }                                                                  \
        return 0;                                                          \
    }                                                                      \
    extern "C" int cname_set(int64_t ode, double v) {                      \
        Gil gil;                                                           \
        PyObject *r = call_host(                                           \
            host_set, Py_BuildValue("(Lsd)", (long long)ode, field, v));   \
        if (!r) return -1;                                                 \
        Py_DECREF(r);                                                      \
        return 0;                                                          \
    }

#define ODE_OPTION(name)                                                    \
    OPTION_GETSET(diffsol_ode_options_get_##name,                           \
                  diffsol_ode_options_set_##name, "options_get",            \
                  "options_set", #name)
#define IC_OPTION(name)                                                     \
    OPTION_GETSET(diffsol_ic_options_get_##name,                            \
                  diffsol_ic_options_set_##name, "ic_options_get",          \
                  "ic_options_set", #name)

ODE_OPTION(max_nonlinear_solver_iterations)
ODE_OPTION(max_error_test_failures)
ODE_OPTION(max_nonlinear_solver_failures)
ODE_OPTION(update_jacobian_after_steps)
ODE_OPTION(update_rhs_jacobian_after_steps)
ODE_OPTION(threshold_to_update_jacobian)
ODE_OPTION(threshold_to_update_rhs_jacobian)
ODE_OPTION(min_timestep)

IC_OPTION(use_linesearch)
IC_OPTION(max_linesearch_iterations)
IC_OPTION(max_newton_iterations)
IC_OPTION(max_linear_solver_setups)
IC_OPTION(step_reduction_factor)
IC_OPTION(armijo_constant)

/* quadrature-output solve (reference integrate_out solve surface) */
extern "C" int diffsol_ode_solve_dense_out(int64_t ode, const double *t_eval,
                                           int64_t neval, int64_t max_steps,
                                           double *gs_out, int64_t *nout,
                                           int *stop_reason) {
    Gil gil;
    PyObject *l = list_from_doubles(t_eval, neval);
    PyObject *r = call_host(
        "solve_dense_out",
        Py_BuildValue("(LNL)", (long long)ode, l, (long long)max_steps));
    if (!r) return -1;
    PyObject *gs = PyTuple_GetItem(r, 0);
    PyObject *no = PyTuple_GetItem(r, 1);
    PyObject *stop = PyTuple_GetItem(r, 2);
    if (!gs || !no || !stop) {
        Py_DECREF(r);
        PyErr_Clear();
        set_err("solve_dense_out returned malformed tuple");
        return -1;
    }
    int64_t n = doubles_from_seq(gs, gs_out, -1);
    if (nout) *nout = PyLong_AsLongLong(no);
    if (stop_reason) *stop_reason = (int)PyLong_AsLong(stop);
    Py_DECREF(r);
    return n < 0 ? -1 : 0;
}

/* type-enumeration helpers (reference *_type_count/name/is_valid,
 * ode_solver_type_c.rs, linear_solver_type_c.rs, scalar_type_c.rs,
 * matrix_type_c.rs, jit_c.rs) */
#define TYPE_ENUM(prefix, kind)                                             \
    extern "C" int prefix##_count(void) {                                   \
        Gil gil;                                                            \
        PyObject *r = call_host("type_count", Py_BuildValue("(s)", kind));  \
        if (!r) return -1;                                                  \
        int n = (int)PyLong_AsLong(r);                                      \
        Py_DECREF(r);                                                       \
        return n;                                                           \
    }                                                                       \
    extern "C" int prefix##_is_valid(int value) {                           \
        Gil gil;                                                            \
        PyObject *r = call_host("type_is_valid",                            \
                                Py_BuildValue("(si)", kind, value));        \
        if (!r) return 0;                                                   \
        int n = (int)PyLong_AsLong(r);                                      \
        Py_DECREF(r);                                                       \
        return n;                                                           \
    }                                                                       \
    extern "C" int prefix##_name(int value, char *out, int64_t cap) {       \
        Gil gil;                                                            \
        PyObject *r = call_host("type_name",                                \
                                Py_BuildValue("(si)", kind, value));        \
        if (!r) return -1;                                                  \
        const char *s = PyUnicode_AsUTF8(r);                                \
        if (!s || (int64_t)strlen(s) + 1 > cap) {                           \
            Py_DECREF(r);                                                   \
            set_err("type name buffer too small");                          \
            return -1;                                                      \
        }                                                                   \
        strcpy(out, s);                                                     \
        Py_DECREF(r);                                                       \
        return 0;                                                           \
    }

TYPE_ENUM(diffsol_ode_solver_type, "ode_solver")
TYPE_ENUM(diffsol_linear_solver_type, "linear_solver")
TYPE_ENUM(diffsol_scalar_type, "scalar")
TYPE_ENUM(diffsol_matrix_type, "matrix")
TYPE_ENUM(diffsol_jit_backend_type, "jit_backend")

/* host-array views (reference host_array_c.rs: ndim/dim/stride/dtype/ptr
 * accessors over solver-owned memory; dtype 1 = f64).  Solve results can be
 * materialized as a host array handle instead of copied into caller
 * buffers. */
struct DiffsolHostArray {
    double *data;
    int64_t ndim;
    int64_t dims[4];
};

/* Unlike the solve entry points (whose Python calls serialize on the GIL),
 * these registry globals are plain C++ state: concurrent
 * diffsol_ode_solve_dense_array / diffsol_host_array_* calls from multiple
 * threads would race on the map without their own lock. */
static std::mutex g_arrays_mu;
static std::map<int64_t, DiffsolHostArray> g_arrays;
static int64_t g_next_array = 1;

extern "C" int64_t diffsol_ode_solve_dense_array(int64_t ode,
                                                 const double *t_eval,
                                                 int64_t neval,
                                                 int64_t max_steps,
                                                 int *stop_reason) {
    int64_t nst = 0;
    if (diffsol_ode_nstates(ode, &nst) != 0) return 0;
    std::vector<double> ys((size_t)(neval * nst));
    if (diffsol_ode_solve_dense(ode, t_eval, neval, max_steps, ys.data(),
                                stop_reason) != 0)
        return 0;
    DiffsolHostArray arr;
    arr.ndim = 2;
    arr.dims[0] = neval;
    arr.dims[1] = nst;
    arr.data = (double *)malloc(ys.size() * sizeof(double));
    memcpy(arr.data, ys.data(), ys.size() * sizeof(double));
    std::lock_guard<std::mutex> lock(g_arrays_mu);
    int64_t h = g_next_array++;
    g_arrays[h] = arr;
    return h;
}

extern "C" int64_t diffsol_host_array_ndim(int64_t arr) {
    std::lock_guard<std::mutex> lock(g_arrays_mu);
    auto it = g_arrays.find(arr);
    return it == g_arrays.end() ? -1 : it->second.ndim;
}

extern "C" int64_t diffsol_host_array_dim(int64_t arr, int64_t i) {
    std::lock_guard<std::mutex> lock(g_arrays_mu);
    auto it = g_arrays.find(arr);
    if (it == g_arrays.end() || i < 0 || i >= it->second.ndim) return -1;
    return it->second.dims[i];
}

extern "C" int64_t diffsol_host_array_stride(int64_t arr, int64_t i) {
    /* row-major contiguous: stride[i] = prod(dims[i+1:]) elements */
    std::lock_guard<std::mutex> lock(g_arrays_mu);
    auto it = g_arrays.find(arr);
    if (it == g_arrays.end() || i < 0 || i >= it->second.ndim) return -1;
    int64_t s = 1;
    for (int64_t j = i + 1; j < it->second.ndim; ++j) s *= it->second.dims[j];
    return s;
}

extern "C" int diffsol_host_array_dtype(int64_t arr) {
    std::lock_guard<std::mutex> lock(g_arrays_mu);
    return g_arrays.count(arr) ? 1 /* f64 */ : -1;
}

extern "C" double *diffsol_host_array_ptr(int64_t arr) {
    std::lock_guard<std::mutex> lock(g_arrays_mu);
    auto it = g_arrays.find(arr);
    return it == g_arrays.end() ? nullptr : it->second.data;
}

extern "C" void diffsol_host_array_free(int64_t arr) {
    std::lock_guard<std::mutex> lock(g_arrays_mu);
    auto it = g_arrays.find(arr);
    if (it != g_arrays.end()) {
        free(it->second.data);
        g_arrays.erase(it);
    }
}

/* ---- host-array allocation (reference host_array_c.rs:13-23
 * diffsol_host_array_alloc_vector / diffsol_host_array_list_free) -------- */

static int64_t register_host_array(double *data /* takes ownership */,
                                   int64_t ndim, const int64_t *dims) {
    DiffsolHostArray arr;
    arr.data = data;
    arr.ndim = ndim;
    for (int64_t i = 0; i < ndim; ++i) arr.dims[i] = dims[i];
    std::lock_guard<std::mutex> lock(g_arrays_mu);
    int64_t h = g_next_array++;
    g_arrays[h] = arr;
    return h;
}

extern "C" int64_t diffsol_host_array_alloc_vector(int64_t len, int dtype) {
    if (len < 0 || dtype != 1 /* f64: the C data boundary width */) {
        set_err("diffsol_host_array_alloc_vector: invalid len or dtype");
        return 0;
    }
    double *data = (double *)calloc((size_t)len, sizeof(double));
    if (!data) {
        set_err("out of memory");
        return 0;
    }
    int64_t dims[1] = {len};
    return register_host_array(data, 1, dims);
}

extern "C" void diffsol_host_array_list_free(const int64_t *handles,
                                             int64_t len) {
    if (!handles) return;
    for (int64_t i = 0; i < len; ++i) diffsol_host_array_free(handles[i]);
}

/* ---- options handles (reference ode_c.rs:343-380 get_options /
 * get_ic_options + ode_options_c.rs / initial_condition_options_c.rs free).
 * The reference returns a boxed options object whose field accessors write
 * through to the solve; here the ode handle IS the options handle (the
 * diffsol_ode_options_get/set_* and diffsol_ic_options_get/set_* families
 * already take it directly), so get returns the same handle and free is a
 * no-op. ------------------------------------------------------------------ */

extern "C" int diffsol_ode_get_options(int64_t ode, int64_t *out_options) {
    if (!out_options) {
        set_err("out_options is null");
        return -1;
    }
    *out_options = ode;
    return 0;
}

extern "C" int diffsol_ode_get_ic_options(int64_t ode, int64_t *out_options) {
    if (!out_options) {
        set_err("out_options is null");
        return -1;
    }
    *out_options = ode;
    return 0;
}

extern "C" void diffsol_ode_options_free(int64_t options) { (void)options; }
extern "C" void diffsol_ic_options_free(int64_t options) { (void)options; }

/* ---- matrix-type introspection (reference ode_c.rs:624) ----------------- */

extern "C" int diffsol_ode_get_matrix_type(int64_t ode) {
    Gil gil;
    PyObject *r = call_host("get_matrix_type",
                            Py_BuildValue("(L)", (long long)ode));
    if (!r) return -1;
    int v = (int)PyLong_AsLong(r);
    Py_DECREF(r);
    if (PyErr_Occurred()) {
        set_err_from_python();
        return -1;
    }
    return v;
}

/* ---- external model loading (reference solve.rs:324 new_external(_dynamic):
 * dlopen a precompiled DiffSL cdylib).  The embedded-CPython analog of a
 * dynamic model artifact is a Python module file defining rhs/init (and
 * optional mass/root/reset/out/params); the static-deps form has no
 * equivalent in this host (models are not linked into the process) and
 * fails loudly. ----------------------------------------------------------- */

extern "C" int64_t diffsol_ode_new_external_dynamic(const char *path) {
    Gil gil;
    PyObject *r = call_host("new_external_dynamic",
                            Py_BuildValue("(s)", path));
    if (!r) return 0;
    int64_t h = PyLong_AsLongLong(r);
    Py_DECREF(r);
    if (PyErr_Occurred()) {
        set_err_from_python();
        return 0;
    }
    return h;
}

extern "C" int64_t diffsol_ode_new_external(int matrix_type,
                                            int linear_solver, int ode_solver,
                                            const void *rhs_state_deps,
                                            size_t rhs_state_deps_len,
                                            const void *rhs_input_deps,
                                            size_t rhs_input_deps_len,
                                            const void *mass_state_deps,
                                            size_t mass_state_deps_len) {
    (void)matrix_type; (void)linear_solver; (void)ode_solver;
    (void)rhs_state_deps; (void)rhs_state_deps_len;
    (void)rhs_input_deps; (void)rhs_input_deps_len;
    (void)mass_state_deps; (void)mass_state_deps_len;
    set_err(
        "diffsol_ode_new_external (statically linked model symbols) has no "
        "equivalent in the embedded-CPython host: use "
        "diffsol_ode_new_external_dynamic(path_to_model.py) or "
        "diffsol_ode_new_jit(diffsl_text)");
    return 0;
}

/* ---- solution wrappers (reference solution_wrapper_c.rs: a solve result
 * owned by a handle; ts/ys/sens materialize as host arrays on demand) ----- */

struct DiffsolSolution {
    std::vector<double> ts;
    std::vector<double> ys;   /* neval x nstates row-major */
    std::vector<std::vector<double>> sens; /* per param, neval x nstates */
    int64_t nstates;
};

static std::mutex g_solutions_mu;
static std::map<int64_t, DiffsolSolution> g_solutions;
static int64_t g_next_solution = 1;

static int64_t vec_from_seq(PyObject *seq, std::vector<double> &out) {
    PyObject *fast = PySequence_Fast(seq, "expected a sequence");
    if (!fast) {
        set_err_from_python();
        return -1;
    }
    int64_t n = PySequence_Fast_GET_SIZE(fast);
    out.resize((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        out[(size_t)i] = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(fast, i));
        if (PyErr_Occurred()) {
            Py_DECREF(fast);
            set_err_from_python();
            return -1;
        }
    }
    Py_DECREF(fast);
    return n;
}

extern "C" int64_t diffsol_ode_solve_solution(int64_t ode,
                                              const double *t_eval,
                                              int64_t neval,
                                              int64_t max_steps,
                                              int with_sens,
                                              int *stop_reason) {
    Gil gil;
    PyObject *l = list_from_doubles(t_eval, neval);
    PyObject *r = call_host(
        "solve_solution",
        Py_BuildValue("(LNLi)", (long long)ode, l, (long long)max_steps,
                      with_sens));
    if (!r) return 0;
    PyObject *ts = PyTuple_GetItem(r, 0);
    PyObject *ys = PyTuple_GetItem(r, 1);
    PyObject *nst = PyTuple_GetItem(r, 2);
    PyObject *sens = PyTuple_GetItem(r, 3);
    PyObject *stop = PyTuple_GetItem(r, 4);
    if (!ts || !ys || !nst || !sens || !stop) {
        Py_DECREF(r);
        PyErr_Clear();
        set_err("solve_solution returned malformed tuple");
        return 0;
    }
    DiffsolSolution sol;
    sol.nstates = PyLong_AsLongLong(nst);
    if (vec_from_seq(ts, sol.ts) < 0 || vec_from_seq(ys, sol.ys) < 0) {
        Py_DECREF(r);
        return 0;
    }
    PyObject *sfast = PySequence_Fast(sens, "expected sens list");
    if (!sfast) {
        Py_DECREF(r);
        set_err_from_python();
        return 0;
    }
    int64_t nsens = PySequence_Fast_GET_SIZE(sfast);
    sol.sens.resize((size_t)nsens);
    for (int64_t i = 0; i < nsens; ++i) {
        if (vec_from_seq(PySequence_Fast_GET_ITEM(sfast, i),
                         sol.sens[(size_t)i]) < 0) {
            Py_DECREF(sfast);
            Py_DECREF(r);
            return 0;
        }
    }
    Py_DECREF(sfast);
    if (stop_reason) *stop_reason = (int)PyLong_AsLong(stop);
    Py_DECREF(r);
    std::lock_guard<std::mutex> lock(g_solutions_mu);
    int64_t h = g_next_solution++;
    g_solutions[h] = std::move(sol);
    return h;
}

static int solution_array_out(int64_t solution, int which /* 0=ts, 1=ys */,
                              int64_t *out_array) {
    if (!out_array) {
        set_err("out_array is null");
        return -1;
    }
    std::vector<double> copy;
    int64_t ndim = 1, dims[2] = {0, 0};
    {
        std::lock_guard<std::mutex> lock(g_solutions_mu);
        auto it = g_solutions.find(solution);
        if (it == g_solutions.end()) {
            set_err("invalid solution wrapper handle");
            return -1;
        }
        const std::vector<double> &src =
            which == 0 ? it->second.ts : it->second.ys;
        copy = src;
        if (which == 1) {
            ndim = 2;
            dims[1] = it->second.nstates;
            dims[0] = it->second.nstates
                          ? (int64_t)src.size() / it->second.nstates
                          : 0;
        } else {
            dims[0] = (int64_t)src.size();
        }
    }
    double *data = (double *)malloc(copy.size() * sizeof(double));
    if (!data) {
        set_err("out of memory");
        return -1;
    }
    memcpy(data, copy.data(), copy.size() * sizeof(double));
    *out_array = register_host_array(data, ndim, dims);
    return 0;
}

extern "C" int diffsol_solution_wrapper_get_ts(int64_t solution,
                                               int64_t *out_array) {
    return solution_array_out(solution, 0, out_array);
}

extern "C" int diffsol_solution_wrapper_get_ys(int64_t solution,
                                               int64_t *out_array) {
    return solution_array_out(solution, 1, out_array);
}

extern "C" int diffsol_solution_wrapper_get_sens(int64_t solution,
                                                 int64_t *out_handles,
                                                 int64_t cap,
                                                 int64_t *out_len) {
    if (!out_handles || !out_len) {
        set_err("invalid arguments to diffsol_solution_wrapper_get_sens");
        return -1;
    }
    std::vector<std::vector<double>> sens;
    int64_t nstates;
    {
        std::lock_guard<std::mutex> lock(g_solutions_mu);
        auto it = g_solutions.find(solution);
        if (it == g_solutions.end()) {
            set_err("invalid solution wrapper handle");
            return -1;
        }
        sens = it->second.sens;
        nstates = it->second.nstates;
    }
    if ((int64_t)sens.size() > cap) {
        set_err("out_handles buffer too small");
        return -1;
    }
    for (size_t i = 0; i < sens.size(); ++i) {
        double *data = (double *)malloc(sens[i].size() * sizeof(double));
        if (!data) {
            diffsol_host_array_list_free(out_handles, (int64_t)i);
            set_err("out of memory");
            return -1;
        }
        memcpy(data, sens[i].data(), sens[i].size() * sizeof(double));
        int64_t dims[2] = {
            nstates ? (int64_t)sens[i].size() / nstates : 0, nstates};
        out_handles[i] = register_host_array(data, 2, dims);
    }
    *out_len = (int64_t)sens.size();
    return 0;
}

extern "C" void diffsol_solution_wrapper_free(int64_t solution) {
    std::lock_guard<std::mutex> lock(g_solutions_mu);
    g_solutions.erase(solution);
}
