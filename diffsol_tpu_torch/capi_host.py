"""Python side of the port's C ABI (counterpart of
``diffsol_tpu.capi_host``; reference crates/diffsol-c/src/ode.rs
OdeWrapper).

The port's native library (``native/capi.cpp`` in this package, built as
``libdiffsol_tpu_torch.so`` against the repository's one header
``native/diffsol_tpu.h``) embeds CPython and drives this module: each
``diffsol_ode_*`` C function maps to one function here, keyed by an
integer handle, with the JAX host's names, arguments, enums and error
texts.  Models arrive as DiffSL text (``diffsol_ode_new_jit``) or as a
``.py`` file of torch callables (``diffsol_ode_new_external_dynamic``);
settings mutate a config that lazily rebuilds the problem; solves return
flat float lists that the C side copies out.

The device follows ``DIFFSOL_PLATFORM``, the knob the JAX host reads:
``cpu`` solves on the CPU; unset, ``cuda`` or ``gpu`` solves on the card,
and without one the first handle call fails with a message that says so
(it never falls back to the CPU).  A handle's built problem holds its
tensors on that device.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import threading

import torch

from . import errors
from .drivers import solve as _solve
from .drivers import solve_dense as _solve_dense
from .ops.linsol import DENSE
from .problem import InitialConditionOptions, OdeBuilder, OdeSolverOptions

# reference diffsol-c/src/ode_solver_type.rs:34-39 (same order)
_METHODS = ("bdf", "esdirk34", "tr_bdf2", "tsit45")
# reference diffsol-c/src/linear_solver_type.rs:15-19
_LINEAR_SOLVERS = ("default", "lu", "klu")
# reference diffsol-c/src/scalar_type.rs:11-14
_SCALARS = ("f32", "f64")

_registry: dict[int, "_OdeHandle"] = {}
_next_id = itertools.count(1)
_lock = threading.Lock()


def _device() -> torch.device:
    """The device of every solve, from ``DIFFSOL_PLATFORM``."""
    plat = os.environ.get("DIFFSOL_PLATFORM", "").strip().lower()
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise ValueError(
            f"DIFFSOL_PLATFORM={plat!r} is not a platform of this build: use "
            "'cpu', or leave it unset (or 'cuda') for the CUDA device")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: diffsol_tpu_torch solves on the card "
            "unless DIFFSOL_PLATFORM=cpu asks for the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _floats(values) -> list:
    return [float(v) for v in values]


def _tensor_list(t: torch.Tensor) -> list:
    return t.detach().reshape(-1).cpu().tolist()


class _OdeHandle:
    def __init__(self, code, model=None):
        self.code = code
        self.model = model  # compiled DiffslModel (for param-count checks)
        self.rtol = 1e-6
        self.atol = 1e-6
        self.t0 = 0.0
        self.h0 = 0.0
        self.params = None  # None => DiffSL in_i defaults
        self.method = 0  # bdf
        self.linear_solver = 0  # default
        self.scalar_type = 1  # f64 (the C data boundary is always double)
        self.integrate_out = False
        # optional tolerance groups (None = unset; reference ode_c.rs
        # sens/out/param rtol/atol get/setters)
        self.sens_rtol = None
        self.sens_atol = None
        self.out_rtol = None
        self.out_atol = None
        self.param_rtol = None
        self.param_atol = None
        # solver-wide and consistent-IC option overrides (reference
        # ode_options_c.rs / initial_condition_options_c.rs)
        self.options = {}
        self.ic_options = {}
        self._problem = None
        self._solver = None
        self._adjoint_cache = None

    def invalidate(self):
        self._problem = None
        self._solver = None
        self._adjoint_cache = None

    def _builder(self) -> OdeBuilder:
        b = (OdeBuilder().rtol(self.rtol).atol(self.atol).t0(self.t0).h0(self.h0)
             .integrate_out(self.integrate_out))
        for name in ("sens_rtol", "sens_atol", "out_rtol", "out_atol",
                     "param_rtol", "param_atol"):
            v = getattr(self, name)
            if v is not None:
                b = getattr(b, name)(v)
        if self.options:
            b = b.options(dataclasses.replace(OdeSolverOptions(), **self.options))
        if self.ic_options:
            b = b.ic_options(dataclasses.replace(InitialConditionOptions(),
                                                 **self.ic_options))
        if _LINEAR_SOLVERS[self.linear_solver] == "lu":
            b = b.linear_solver(DENSE)  # the explicit dense LU tier
        if _SCALARS[self.scalar_type] == "f32":
            b = b.dtype(torch.float32)
        if self.params is not None:
            b = b.p(self.params)
        return b

    def _build(self):
        return self._builder().build_from_diffsl(self.code)

    def problem(self):
        if self._problem is None:
            self._problem = self._build().to(_device())
        return self._problem

    def solver(self):
        if self._solver is None:
            from .factory import solver as make_solver

            self._solver = make_solver(self.problem(), _METHODS[self.method])
        return self._solver


def _get(handle: int) -> _OdeHandle:
    h = _registry.get(handle)
    if h is None:
        raise KeyError(f"invalid ode handle {handle}")
    return h


def _register(h: _OdeHandle) -> int:
    with _lock:
        hid = next(_next_id)
        _registry[hid] = h
    return hid


# ---- lifecycle -----------------------------------------------------------


def new_jit(code: str) -> int:
    """diffsol_ode_new_jit (ode_c.rs:284): build from DiffSL text.  Parse
    errors surface here, at create time, like the reference's JIT compile
    step; so does a missing device."""
    from .diffsl import compile_diffsl

    _device()
    model = compile_diffsl(code)  # validate eagerly
    return _register(_OdeHandle(code, model))


def free(handle: int) -> None:
    with _lock:
        _registry.pop(handle, None)


def clear_caches() -> None:
    """Drop the fused solves cached for live problems and the card's
    cached free memory.  Handles stay valid and later solves give the same
    results (the kernel libraries stay built)."""
    from . import ensemble

    ensemble._fused_cache.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---- settings ------------------------------------------------------------


def set_rtol(handle, v):
    h = _get(handle)
    h.rtol = float(v)
    h.invalidate()


def get_rtol(handle):
    return float(_get(handle).rtol)


def set_atol(handle, v):
    h = _get(handle)
    h.atol = float(v)
    h.invalidate()


def get_atol(handle):
    return float(_get(handle).atol)


def set_t0(handle, v):
    h = _get(handle)
    h.t0 = float(v)
    h.invalidate()


def get_t0(handle):
    return float(_get(handle).t0)


def set_h0(handle, v):
    h = _get(handle)
    h.h0 = float(v)
    h.invalidate()


def get_h0(handle):
    return float(_get(handle).h0)


def set_params(handle, values):
    h = _get(handle)
    vals = _floats(values)
    if h.model is not None and len(vals) != len(h.model.default_params):
        raise ValueError(
            f"model declares {len(h.model.default_params)} inputs (in_i) "
            f"but set_params supplied {len(vals)}"
        )
    h.params = vals
    h.invalidate()


def get_params(handle):
    h = _get(handle)
    if h.params is not None:
        return list(h.params)
    return _tensor_list(h.problem().params)


def set_ode_solver(handle, value):
    value = int(value)
    if not 0 <= value < len(_METHODS):
        raise ValueError(f"invalid ode solver type {value}")
    h = _get(handle)
    h.method = value
    h._solver = None
    h._adjoint_cache = None


def get_ode_solver(handle):
    return int(_get(handle).method)


def set_linear_solver(handle, value):
    value = int(value)
    if not 0 <= value < len(_LINEAR_SOLVERS):
        raise ValueError(f"invalid linear solver type {value}")
    if _LINEAR_SOLVERS[value] == "klu":
        raise ValueError(
            "klu is a CPU/SuiteSparse solver; the PyTorch/CUDA build provides "
            "dense/banded/block-diagonal/krylov tiers (use 'default' or 'lu')"
        )
    h = _get(handle)
    h.linear_solver = value
    h.invalidate()


def get_linear_solver(handle):
    return int(_get(handle).linear_solver)


def set_scalar_type(handle, value):
    value = int(value)
    if not 0 <= value < len(_SCALARS):
        raise ValueError(f"invalid scalar type {value}")
    h = _get(handle)
    h.scalar_type = value
    h.invalidate()


def get_scalar_type(handle):
    return int(_get(handle).scalar_type)


def set_integrate_out(handle, value):
    h = _get(handle)
    h.integrate_out = bool(value)
    h.invalidate()


def get_integrate_out(handle):
    return int(_get(handle).integrate_out)


# ---- introspection -------------------------------------------------------


def nstates(handle):
    return int(_get(handle).problem().eqn.nstates)


def nparams(handle):
    return int(_get(handle).problem().eqn.nparams)


def nout(handle):
    p = _get(handle).problem()
    return int(p.eqn.nout if p.eqn.out is not None else p.eqn.nstates)


# ---- op evaluation (ode_c.rs:389-511) -------------------------------------


def _vec(p, values):
    return torch.tensor(_floats(values), dtype=p.dtype, device=p.t0.device)


def y0(handle):
    p = _get(handle).problem()
    return _tensor_list(p.eqn.init(p.t0, p.params))


def rhs(handle, t, y):
    p = _get(handle).problem()
    return _tensor_list(p.eqn.rhs(p.t0.new_tensor(float(t)), _vec(p, y), p.params))


def rhs_jac_mul(handle, t, y, v):
    p = _get(handle).problem()
    tt = p.t0.new_tensor(float(t))
    jv = torch.func.jvp(lambda yy: p.eqn.rhs(tt, yy, p.params), (_vec(p, y),),
                        (_vec(p, v),))[1]
    return _tensor_list(jv)


# ---- solves (ode_c.rs:512-623, solve.rs) ----------------------------------


def solve(handle, t_final, max_steps=10_000):
    """Adaptive solve; returns (ts, ys_flat_row_major, npoints, stop)."""
    h = _get(handle)
    sol = _solve(h.solver(), float(t_final), max_steps=int(max_steps), device=_device())
    npts = int(sol.n_points)
    return (_tensor_list(sol.ts[:npts]), _tensor_list(sol.ys[:npts]), npts,
            int(sol.stop_reason))


def solve_dense(handle, t_eval, max_steps=10_000):
    """Dense-output solve; returns (ys_flat_row_major, stop_reason)."""
    h = _get(handle)
    sol = _solve_dense(h.solver(), _floats(t_eval), max_steps=int(max_steps),
                       device=_device())
    return _tensor_list(sol.ys), int(sol.stop_reason)


def solve_fwd_sens(handle, t_eval, max_steps=10_000):
    """Forward sensitivities; returns (ys_flat, sens_flat[np, neval, n],
    stop_reason)."""
    from .sens import solve_dense_fwd_sens

    h = _get(handle)
    ys, sens = solve_dense_fwd_sens(h.solver(), _floats(t_eval), device=_device())
    return _tensor_list(ys), _tensor_list(sens), 0


def solve_adjoint(handle, t_eval, dgdu, max_steps=16_384):
    """Adjoint gradient (reference solve.rs:123-146 solve_adjoint_fwd and
    solve_adjoint_bkwd in one call): given dG/du at the output times (flat,
    neval * nstates), returns (ys_flat, dG/dp)."""
    from .adjoint import make_differentiable_solve
    from .solvers.bdf import BdfSolver
    from .solvers.erk import ErkSolver
    from .solvers.sdirk import SdirkSolver
    from .solvers.tableau import esdirk34, tr_bdf2

    h = _get(handle)
    problem = h.problem()
    dev = _device()
    te = _floats(t_eval)
    n = int(problem.eqn.nstates)
    ct = torch.tensor(_floats(dgdu), dtype=problem.dtype, device=dev).reshape(len(te), n)
    cls = {
        0: BdfSolver,
        1: functools.partial(SdirkSolver, tableau=esdirk34()),
        2: functools.partial(SdirkSolver, tableau=tr_bdf2()),
        3: ErkSolver,
    }[h.method]
    # the cache goes with invalidate() on every settings change, so a
    # cached fn never closes over a stale problem
    key = (tuple(te), int(max_steps), h.method)
    if h._adjoint_cache is None or h._adjoint_cache[0] != key:
        fn = make_differentiable_solve(problem, te, solver_cls=cls,
                                       max_steps=int(max_steps), device=dev)
        h._adjoint_cache = (key, fn)
    fn = h._adjoint_cache[1]
    params = problem.params.detach().clone().requires_grad_(True)
    ys = fn(params)
    (grad,) = torch.autograd.grad(ys, params, ct)
    return _tensor_list(ys), _tensor_list(grad)


def stop_reason_name(code):
    return errors._MESSAGES.get(int(code), "ok")


# ---- optional tolerance groups (ode_c.rs sens/out/param get/setters) ------
# get returns NaN when unset; setting NaN clears the group (the reference
# errors on unconfigured getters; NaN-signalling keeps the C ABI one-call).


def _tol_set(name):
    def setter(handle, v):
        h = _get(handle)
        v = float(v)
        setattr(h, name, None if v != v else v)  # NaN clears
        h.invalidate()

    return setter


def _tol_get(name):
    def getter(handle):
        v = getattr(_get(handle), name)
        return float("nan") if v is None else float(v)

    return getter


set_sens_rtol = _tol_set("sens_rtol")
get_sens_rtol = _tol_get("sens_rtol")
set_sens_atol = _tol_set("sens_atol")
get_sens_atol = _tol_get("sens_atol")
set_out_rtol = _tol_set("out_rtol")
get_out_rtol = _tol_get("out_rtol")
set_out_atol = _tol_set("out_atol")
get_out_atol = _tol_get("out_atol")
set_param_rtol = _tol_set("param_rtol")
get_param_rtol = _tol_get("param_rtol")
set_param_atol = _tol_set("param_atol")
get_param_atol = _tol_get("param_atol")


# ---- solver options / IC options field surface ----------------------------
# The C side holds the ode handle and routes per-field calls; the dict
# overlays the defaults of OdeSolverOptions / InitialConditionOptions.

_OPTION_FIELDS = {
    "max_nonlinear_solver_iterations": int,
    "max_error_test_failures": int,
    "max_nonlinear_solver_failures": int,
    "update_jacobian_after_steps": int,
    "update_rhs_jacobian_after_steps": int,
    "threshold_to_update_jacobian": float,
    "threshold_to_update_rhs_jacobian": float,
    "min_timestep": float,
}
_IC_OPTION_FIELDS = {
    "use_linesearch": bool,
    "max_linesearch_iterations": int,
    "max_newton_iterations": int,
    "max_linear_solver_setups": int,
    "step_reduction_factor": float,
    "armijo_constant": float,
}


def options_set(handle, name, value):
    h = _get(handle)
    ty = _OPTION_FIELDS.get(name)
    if ty is None:
        raise ValueError(f"unknown solver option {name!r}")
    h.options[name] = ty(value)
    h.invalidate()


def options_get(handle, name):
    h = _get(handle)
    if name not in _OPTION_FIELDS:
        raise ValueError(f"unknown solver option {name!r}")
    return float(h.options.get(name, getattr(OdeSolverOptions(), name)))


def ic_options_set(handle, name, value):
    h = _get(handle)
    ty = _IC_OPTION_FIELDS.get(name)
    if ty is None:
        raise ValueError(f"unknown ic option {name!r}")
    h.ic_options[name] = ty(value)
    h.invalidate()


def ic_options_get(handle, name):
    h = _get(handle)
    if name not in _IC_OPTION_FIELDS:
        raise ValueError(f"unknown ic option {name!r}")
    return float(h.ic_options.get(name, getattr(InitialConditionOptions(), name)))


# ---- quadrature-output solve (reference integrate_out solve surface) ------


def solve_dense_out(handle, t_eval, max_steps=10_000):
    """Dense-output solve returning the integrated outputs g(t_i)
    (requires set_integrate_out(1)); (gs_flat_row_major, nout, stop)."""
    h = _get(handle)
    p = h.problem()
    if not p.integrate_out:
        raise ValueError("solve_dense_out requires integrate_out")
    sol = _solve_dense(h.solver(), _floats(t_eval), max_steps=int(max_steps),
                       device=_device())
    return _tensor_list(sol.gs), int(sol.gs.shape[-1]), int(sol.stop_reason)


# ---- type-enumeration helpers (reference *_type_count/name/is_valid) ------

# matrix tiers: the role of the reference's NalgebraDense/FaerDense/
# FaerSparse enum is played by the linear-solver tier (matrix_type_c.rs)
_MATRIX_TYPES = ("dense", "banded", "blockdiag", "matrix_free")
# the C ABI's one JIT-backend value keeps the JAX host's name, so that one
# header and one consumer serve both libraries (here DiffSL runs as torch
# callables, and as generated CUDA inside the fused kernels)
_JIT_BACKENDS = ("xla",)

_TYPE_TABLES = {
    "ode_solver": _METHODS,
    "linear_solver": _LINEAR_SOLVERS,
    "scalar": _SCALARS,
    "matrix": _MATRIX_TYPES,
    "jit_backend": _JIT_BACKENDS,
}


def type_count(kind):
    return len(_TYPE_TABLES[kind])


def type_name(kind, value):
    table = _TYPE_TABLES[kind]
    value = int(value)
    if not 0 <= value < len(table):
        raise ValueError(f"invalid {kind} type {value}")
    return table[value]


def type_is_valid(kind, value):
    return int(0 <= int(value) < len(_TYPE_TABLES[kind]))


# ---- matrix-type introspection (reference ode_c.rs:624) -------------------


def get_matrix_type(handle):
    """The tier-layout enum index of the built problem's linear solver."""
    name = _get(handle).problem().linear_solver.name
    if name.startswith("banded"):
        return _MATRIX_TYPES.index("banded")
    if name.startswith("blockdiag"):
        return _MATRIX_TYPES.index("blockdiag")
    if name.startswith("krylov"):
        return _MATRIX_TYPES.index("matrix_free")
    return _MATRIX_TYPES.index("dense")


# ---- external model loading (reference solve.rs:324 new_external /
# new_external_dynamic: dlopen a precompiled DiffSL cdylib; the
# embedded-CPython analog is a Python module file of model callables) ------


class _ExternalHandle(_OdeHandle):
    def __init__(self, mod):
        super().__init__(code=None, model=None)
        self.external = mod
        if hasattr(mod, "params"):
            self.params = _floats(mod.params)

    def _build(self):
        mod = self.external
        b = self._builder().rhs(mod.rhs).init(mod.init)
        for name in ("mass", "root", "out", "reset"):
            if hasattr(mod, name):
                b = getattr(b, name)(getattr(mod, name))
        if getattr(mod, "use_coloring", False):
            b = b.use_coloring()
        return b.build()


def new_external_dynamic(path):
    """Load a model from a Python module file defining torch callables
    rhs(t, y, p) and init(t, p), and optionally mass, root, reset, out,
    params and use_coloring."""
    import importlib.util

    _device()
    base = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"_diffsol_ext_{base}", path)
    if spec is None or spec.loader is None:
        raise ValueError(f"cannot load external model at {path!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for req in ("rhs", "init"):
        if not hasattr(mod, req):
            raise ValueError(f"external model {path!r} does not define {req}(...)")
    return _register(_ExternalHandle(mod))


# ---- solution-wrapper solves (reference solution_wrapper_c.rs) -------------


def solve_solution(handle, t_eval, max_steps=10_000, with_sens=0):
    """Dense-output solve returning (ts, ys_flat[neval*n], nstates,
    sens_flat_list[np][neval*n], stop) for the solution-wrapper surface."""
    h = _get(handle)
    te = _floats(t_eval)
    sens_list = []
    if int(with_sens):
        from .sens import solve_dense_fwd_sens

        ys, sens = solve_dense_fwd_sens(h.solver(), te, device=_device())
        sens_list = [_tensor_list(s) for s in sens]  # (np, neval, n)
        stop = 0
    else:
        sol = _solve_dense(h.solver(), te, max_steps=int(max_steps), device=_device())
        ys, stop = sol.ys, int(sol.stop_reason)
    return te, _tensor_list(ys), int(ys.shape[-1]), sens_list, stop
