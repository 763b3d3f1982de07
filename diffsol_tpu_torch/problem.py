"""Problem definition, options and the fluent builder (counterpart of
``diffsol_tpu.problem``; the defaults are the reference's and the JAX
package's).

Every tensor a problem holds has its dtype: float64 unless the builder
was given ``.dtype(torch.float32)``.  The builder keeps them on the CPU;
the solve entry points move a problem with :meth:`OdeProblem.to` to the
device they run on, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .diffsl import compile_diffsl
from .equations import OdeEquations, make_equations
from .ops.linsol import DENSE, LinearSolverSpec

F64 = torch.float64
DTYPES = (torch.float64, torch.float32)


@dataclass(frozen=True)
class OdeSolverOptions:
    """Solver-wide policies (reference problem.rs:98-152, same defaults)."""

    max_nonlinear_solver_iterations: int = 10
    max_error_test_failures: int = 40
    max_nonlinear_solver_failures: int = 50
    nonlinear_solver_tolerance: float = 0.2
    min_timestep: float = 1e-13
    max_timestep_growth: Optional[float] = None  # solver-specific default
    min_timestep_growth: Optional[float] = None
    max_timestep_shrink: Optional[float] = None
    min_timestep_shrink: Optional[float] = None
    update_jacobian_after_steps: int = 20
    update_rhs_jacobian_after_steps: int = 50
    threshold_to_update_jacobian: float = 0.3
    threshold_to_update_rhs_jacobian: float = 0.2
    pi_control_proportional: float = 0.0
    pi_control_integral: float = 0.5


@dataclass(frozen=True)
class InitialConditionOptions:
    """Consistent-IC Newton options (reference problem.rs:15-43)."""

    use_linesearch: bool = True
    max_linesearch_iterations: int = 10
    max_newton_iterations: int = 10
    max_linear_solver_setups: int = 4
    step_reduction_factor: float = 0.5
    armijo_constant: float = 1e-4


@dataclass(frozen=True)
class SolverConfig:
    """Per-solver step-size clamps (reference config.rs:22-146).

    ``from_options`` applies the solver-specific defaults: BDF/SDIRK growth
    in [2, 2] and shrink dead zone [0.5, 0.9]; ERK growth [1, 2], shrink
    [0.5, 1].
    """

    minimum_timestep: float = 1e-13
    maximum_error_test_failures: int = 40
    maximum_newton_fails: int = 50
    maximum_newton_iterations: int = 10
    maximum_timestep_growth: float = 2.0
    minimum_timestep_growth: float = 2.0
    maximum_timestep_shrink: float = 0.9
    minimum_timestep_shrink: float = 0.5

    @staticmethod
    def from_options(opts: OdeSolverOptions, kind: str) -> "SolverConfig":
        ming, maxs = (1.0, 1.0) if kind == "erk" else (2.0, 0.9)

        def pick(v, default):
            return default if v is None else v

        return SolverConfig(
            minimum_timestep=opts.min_timestep,
            maximum_error_test_failures=opts.max_error_test_failures,
            maximum_newton_fails=opts.max_nonlinear_solver_failures,
            maximum_newton_iterations=opts.max_nonlinear_solver_iterations,
            maximum_timestep_growth=pick(opts.max_timestep_growth, 2.0),
            minimum_timestep_growth=pick(opts.min_timestep_growth, ming),
            maximum_timestep_shrink=pick(opts.max_timestep_shrink, maxs),
            minimum_timestep_shrink=pick(opts.min_timestep_shrink, 0.5),
        )


@dataclass(frozen=True, eq=False)
class OdeProblem:
    """An ODE problem ready for a solver (reference `OdeSolverProblem`).

    ``params`` is (nparams,) for one instance and (B, nparams) for a
    lockstep ensemble (``lockstep_nbatch = B``), whose state is member-major
    (B, n).  ``atol`` is (n,) and broadcasts over members; so do
    ``out_atol`` (nout,), the quadrature's tolerance, and ``sens_atol``
    (n,), the forward sensitivities'.
    """

    eqn: OdeEquations
    params: torch.Tensor
    t0: torch.Tensor
    h0: torch.Tensor
    rtol: torch.Tensor
    atol: torch.Tensor
    out_rtol: Optional[torch.Tensor] = None
    out_atol: Optional[torch.Tensor] = None
    # the sensitivity rows' tolerances; both set puts the rows into the
    # error test (JAX problem.py:127-128)
    sens_rtol: Optional[torch.Tensor] = None
    sens_atol: Optional[torch.Tensor] = None
    # the adjoint's parameter-gradient rows (JAX problem.py:130-134):
    # param_atol, scaled by param_scales, is their absolute tolerance in the
    # backward solve (adjoint._adjoint_problem)
    param_rtol: Optional[torch.Tensor] = None
    param_atol: Optional[torch.Tensor] = None
    param_scales: Optional[torch.Tensor] = None
    integrate_out: bool = False
    lockstep_nbatch: int = 1
    options: OdeSolverOptions = field(default_factory=OdeSolverOptions)
    ic_options: InitialConditionOptions = field(
        default_factory=InitialConditionOptions)
    linear_solver: LinearSolverSpec = DENSE
    # the compiled DiffSL model a problem was built from (build_from_eqn)
    diffsl_model: Optional[object] = None

    def output_in_error_control(self) -> bool:
        return (self.integrate_out and self.eqn.out is not None
                and self.out_rtol is not None and self.out_atol is not None)

    def sens_in_error_control(self) -> bool:
        return self.sens_rtol is not None and self.sens_atol is not None

    @property
    def dtype(self) -> torch.dtype:
        """The solve's precision: every tensor of the problem, the state
        and the outputs carry it (``OdeBuilder.dtype``)."""
        return self.t0.dtype

    def to(self, device) -> "OdeProblem":
        """The same problem with its tensors on ``device``."""
        def moved(v):
            return None if v is None else v.to(device)

        return dataclasses.replace(
            self,
            params=self.params.to(device),
            t0=self.t0.to(device),
            h0=self.h0.to(device),
            rtol=self.rtol.to(device),
            atol=self.atol.to(device),
            out_rtol=moved(self.out_rtol),
            out_atol=moved(self.out_atol),
            sens_rtol=moved(self.sens_rtol),
            sens_atol=moved(self.sens_atol),
            param_rtol=moved(self.param_rtol),
            param_atol=moved(self.param_atol),
            param_scales=moved(self.param_scales),
        )


def _later(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to diffsol_tpu_torch yet (ROADMAP.md {item})"
    )


def _is_diagonal(m: torch.Tensor) -> bool:
    return m.ndim == 2 and bool(
        torch.count_nonzero(m - torch.diag_embed(torch.diagonal(m))) == 0
    )


class OdeBuilder:
    """Fluent problem builder (reference builder.rs:112-1933).

    Example::

        problem = (
            OdeBuilder()
            .rhs(lambda t, y, p: -p[0] * y)
            .init(lambda t, p: torch.ones(1, dtype=torch.float64))
            .p([0.1])
            .rtol(1e-6)
            .build()
        )
    """

    def __init__(self):
        self._rhs = None
        self._rhs_jac = None
        self._init = None
        self._mass = None
        self._root = None
        self._out = None
        self._reset = None
        self._reset_n = None
        self._out_rtol = None
        self._out_atol = None
        self._sens_rtol = None
        self._sens_atol = None
        self._param_rtol = None
        self._param_atol = None
        self._param_scales = None
        self._integrate_out = False
        self._ic_options = InitialConditionOptions()
        self._p = torch.zeros(0, dtype=F64)
        self._t0 = 0.0
        self._h0 = 0.0  # 0 => heuristic
        self._rtol = 1e-6
        self._atol = 1e-6
        self._options = OdeSolverOptions()
        self._linear_solver = DENSE
        self._use_coloring = False
        self._dtype = None  # float64

    # equations ---------------------------------------------------------
    def rhs(self, f: Callable):
        self._rhs = f
        return self

    def rhs_implicit(self, f: Callable, jac: Callable):
        """The rhs with the user's Jacobian ``jac(t, y, p)``, in the
        representation of the problem's linear-solver tier (dense (n, n) by
        default), in place of the forward-mode one.  It must be written in
        torch operations, so that a lockstep ensemble can ``vmap`` it."""
        self._rhs = f
        self._rhs_jac = jac
        return self

    def init(self, f: Callable):
        self._init = f
        return self

    def mass(self, m: Callable):
        self._mass = m
        return self

    def root(self, g: Callable):
        """Event function g(t, y, p) -> (nroots,): a sign change of any
        component stops the solve at the root, or applies ``reset``."""
        self._root = g
        return self

    def out(self, g: Callable):
        """Output function g(t, y, p) -> (nout,)."""
        self._out = g
        return self

    def reset(self, r: Callable):
        """Reset operator R(t, y, p) -> (n,), applied at a root."""
        self._reset = r
        return self

    # settings ----------------------------------------------------------
    def p(self, params):
        if isinstance(params, torch.Tensor):
            self._p = params.detach().to(F64).reshape(-1).clone()
        else:
            self._p = torch.tensor(np.asarray(params, np.float64)).reshape(-1)
        return self

    def t0(self, t0: float):
        self._t0 = float(t0)
        return self

    def h0(self, h0: float):
        self._h0 = float(h0)
        return self

    def rtol(self, rtol: float):
        self._rtol = float(rtol)
        return self

    def atol(self, atol):
        self._atol = atol
        return self

    def out_rtol(self, v):
        self._out_rtol = v
        return self

    def out_atol(self, v):
        self._out_atol = v
        return self

    def sens_rtol(self, v):
        """Relative tolerance of the forward-sensitivity rows."""
        self._sens_rtol = v
        return self

    def sens_atol(self, v):
        """Absolute tolerance of the forward-sensitivity rows, a scalar or
        one a state."""
        self._sens_atol = v
        return self

    def turn_off_sensitivities_error_control(self):
        """Exclude the sensitivity rows from the error test (reference
        builder.rs:1501)."""
        self._sens_rtol = None
        self._sens_atol = None
        return self

    def param_rtol(self, v):
        """Relative tolerance of the adjoint's parameter-gradient rows."""
        self._param_rtol = v
        return self

    def param_atol(self, v):
        """Absolute tolerance of the adjoint's parameter-gradient rows, a
        scalar or one a parameter."""
        self._param_atol = v
        return self

    def param_scales(self, v):
        """Absolute-tolerance scale per parameter for the adjoint's
        parameter-gradient rows (reference builder.rs param_scales)."""
        self._param_scales = v
        return self

    def turn_off_param_error_control(self):
        """Exclude the adjoint's parameter-gradient rows from the error
        test (reference builder.rs:1521)."""
        self._param_rtol = None
        self._param_atol = None
        return self

    def turn_off_output_error_control(self):
        """Exclude the quadrature output from the error test."""
        self._out_rtol = None
        self._out_atol = None
        return self

    def integrate_out(self, flag: bool = True):
        """Integrate the output (the state itself without ``out``) along
        the solve, which returns it as ``Solution.gs``."""
        self._integrate_out = bool(flag)
        return self

    def options(self, opts: OdeSolverOptions):
        self._options = opts
        return self

    def ic_options(self, opts: InitialConditionOptions):
        self._ic_options = opts
        return self

    def reset_n(self, r: Callable):
        """Index-aware reset R(t, y, p, root_idx) -> (n,): applied at a
        root in place of ``reset``, with the index of the root that fired
        (the DiffSL ``N`` protocol)."""
        self._reset_n = r
        return self

    # outside this port's slice -------------------------------------------
    def linear_solver(self, spec: LinearSolverSpec):
        """The Newton linear-solver tier: ``DENSE`` (the default),
        ``ops.banded.make_banded_solver(ml, mu)`` or
        ``ops.blockdiag.make_blockdiag_solver(perm, nb, K)``."""
        if spec == "krylov":
            _later("the matrix-free Krylov tier", "queue 1 item 14")
        if not isinstance(spec, LinearSolverSpec):
            raise TypeError(
                "linear_solver takes ops.linsol.DENSE, "
                "ops.banded.make_banded_solver(ml, mu) or "
                f"ops.blockdiag.make_blockdiag_solver(...), got {spec!r}")
        self._linear_solver = spec
        return self

    def use_coloring(self, flag: bool = True):
        """Compress the Jacobian: detect its sparsity at the initial state,
        and route a narrow band to the banded tier or else evaluate the
        dense Jacobian from one JVP probe per color of the native greedy
        coloring (reference builder.rs use_coloring)."""
        self._use_coloring = bool(flag)
        return self

    def build_from_eqn(self, model) -> OdeProblem:
        """Build from a compiled :class:`~diffsol_tpu_torch.diffsl.DiffslModel`
        (reference builder.rs ``build_from_eqn``: one compiled model,
        several problems).  ``.p(...)`` overrides the ``in_i`` defaults and
        must have as many values; a model of n >= 256 states switches
        ``use_coloring`` on unless a solver or Jacobian was chosen, as the
        reference's DiffSL bridge always colors (diffsl.rs:38-330)."""
        fns = model.make_callables()
        self._rhs = fns["rhs"]
        self._init = fns["init"]
        self._mass = fns.get("mass", self._mass)
        self._root = fns.get("root", self._root)
        self._out = fns.get("out", self._out)
        self._reset = fns.get("reset", self._reset)
        self._reset_n = fns.get("reset_n", self._reset_n)
        ndefault = len(model.default_params)
        if self._p.numel() == 0:
            self._p = torch.tensor(np.asarray(model.default_params, np.float64))
        elif self._p.shape[-1] != ndefault:
            raise ValueError(
                f"model declares {ndefault} inputs (in_i) but .p(...) "
                f"supplied {self._p.shape[-1]}")
        if (not self._use_coloring and self._rhs_jac is None
                and self._linear_solver is DENSE):
            y0 = self._init(torch.tensor(self._t0, dtype=F64), self._p)
            self._use_coloring = int(y0.shape[-1]) >= 256
        return dataclasses.replace(self.build(), diffsl_model=model)

    def build_from_diffsl(self, source: str) -> OdeProblem:
        """Build the problem from DiffSL model text (reference builder.rs
        ``build_from_diffsl``): rhs, init, mass, root, out and reset come
        from the model's F, u, M, stop, out and reset tensors
        (:mod:`diffsol_tpu_torch.diffsl`)."""
        return self.build_from_eqn(compile_diffsl(source))

    def dtype(self, d):
        """Solve precision, ``torch.float64`` (the default) or
        ``torch.float32`` (reference ScalarType{F32,F64},
        diffsol-c/src/scalar_type.rs; JAX problem.py:420-430).  The init,
        rhs, mass, root, out, reset and Jacobian callables are wrapped so
        that their outputs carry this dtype whatever the user's closures
        return, and params, t0, h0 and every tolerance carry it too.  On
        the card a float32 banded problem runs the band LU kernels' float
        build."""
        if d not in DTYPES:
            raise TypeError(f"dtype must be torch.float64 or torch.float32, got {d}")
        self._dtype = d
        return self

    # build --------------------------------------------------------------
    def build(self) -> OdeProblem:
        if self._rhs is None or self._init is None:
            raise ValueError("OdeBuilder requires at least .rhs(...) and .init(...)")
        # work on locals: build() must not change the builder, so that a
        # second build with another dtype does not stack casts (JAX
        # problem.py:434-460)
        dtype = self._dtype or F64
        rhs_f, init_f, mass_f = self._rhs, self._init, self._mass
        root_f, out_f, reset_f = self._root, self._out, self._reset
        reset_n_f, rhs_jac = self._reset_n, self._rhs_jac
        if self._dtype is not None:
            def cast(f):
                if f is None:
                    return None

                def casted(*a):
                    out = f(*a)
                    if not isinstance(out, torch.Tensor):
                        out = torch.as_tensor(out)
                    return out.to(dtype)
                return casted

            rhs_f, init_f, mass_f = cast(rhs_f), cast(init_f), cast(mass_f)
            root_f, out_f, reset_f = cast(root_f), cast(out_f), cast(reset_f)
            reset_n_f, rhs_jac = cast(reset_n_f), cast(rhs_jac)
        params = self._p.to(dtype)
        mass_diag = None
        if mass_f is not None:
            # probe at several times and perturbed params, as the JAX
            # builder does: a mass whose off-diagonals merely vanish at
            # (t0, p) must not be taken as diagonal
            probes = [
                (self._t0, params),
                (self._t0 + 1.0, params),
                (self._t0 + 0.5, params * 1.25 + 0.125),
            ]
            if all(
                _is_diagonal(mass_f(torch.tensor(t, dtype=dtype), pp))
                for t, pp in probes
            ):
                def mass_diag(t, p):
                    return torch.diagonal(mass_f(t, p), dim1=-2, dim2=-1)

        # a user Jacobian (rhs_implicit) wins over the tier's own, as in the
        # JAX OdeBuilder
        linear_solver = self._linear_solver
        if rhs_jac is None and linear_solver.name.startswith("banded"):
            # the tier's representation is the band (builder.rs
            # use_coloring's role for a banded pattern)
            from .ops.banded import make_banded_jac

            ml, mu = linear_solver.meta[:2]
            rhs_jac = make_banded_jac(rhs_f, ml, mu)
        elif rhs_jac is None and linear_solver.name.startswith("blockdiag"):
            from .ops.blockdiag import make_blockdiag_jac

            nb, K, perm = linear_solver.meta[:3]
            rhs_jac = make_blockdiag_jac(rhs_f, perm, nb, K,
                                         int((np.asarray(perm) >= 0).sum()))
        elif rhs_jac is None and self._use_coloring:
            rhs_jac, linear_solver = self._colored_tier(
                rhs_f, init_f, mass_f, params, linear_solver)
        eqn = make_equations(
            rhs_f, init_f, params, self._t0,
            mass=mass_f, mass_diag=mass_diag, rhs_jac=rhs_jac,
            root=root_f, out=out_f, reset=reset_f, reset_n=reset_n_f,
        )

        def scalar(v):
            return None if v is None else torch.tensor(float(v), dtype=dtype)

        def vec(v, nv):
            if v is None:
                return None
            v = (v.detach().to(dtype).cpu() if isinstance(v, torch.Tensor)
                 else torch.tensor(np.asarray(v, np.float64)).to(dtype)).reshape(-1)
            return v.expand(nv).clone() if v.numel() == 1 else v

        return OdeProblem(
            eqn=eqn,
            params=params.clone(),
            t0=scalar(self._t0),
            h0=scalar(self._h0),
            rtol=scalar(self._rtol),
            atol=vec(self._atol, eqn.nstates),
            out_rtol=scalar(self._out_rtol),
            out_atol=vec(self._out_atol, eqn.nout),
            sens_rtol=scalar(self._sens_rtol),
            sens_atol=vec(self._sens_atol, eqn.nstates),
            param_rtol=scalar(self._param_rtol),
            param_atol=vec(self._param_atol, eqn.nparams),
            param_scales=vec(self._param_scales, eqn.nparams),
            integrate_out=self._integrate_out,
            options=self._options,
            ic_options=self._ic_options,
            linear_solver=linear_solver,
        )

    def _colored_tier(self, rhs_f, init_f, mass_f, params, linear_solver):
        """``use_coloring``'s routing, in the JAX OdeBuilder's order
        (problem.py:473-546): independent dense blocks to the
        block-diagonal tier, a narrow band to the banded tier, else the
        colored dense Jacobian under the solver given.  Returns
        ``(rhs_jac, linear_solver)``."""
        from .ops.banded import make_banded_jac, make_banded_solver
        from .ops.blockdiag import (detect_blocks, make_blockdiag_jac,
                                    make_blockdiag_solver)
        from .ops.coloring import detect_sparsity, greedy_color, make_colored_jac

        t0 = torch.tensor(self._t0, dtype=params.dtype)
        y0 = init_f(t0, params)
        n = int(y0.shape[-1])
        rows, cols = detect_sparsity(rhs_f, t0, y0, params, n)
        ml = int(np.max(rows - cols)) if len(rows) else 0
        mu = int(np.max(cols - rows)) if len(rows) else 0
        blk_rows, blk_cols = rows, cols
        if mass_f is not None:
            # the iteration matrix is M - c J: the band must cover M too
            mi, mj = np.nonzero(mass_f(t0, params).detach().cpu().numpy())
            if len(mi):
                ml = max(ml, int(np.max(mi - mj)))
                mu = max(mu, int(np.max(mj - mi)))
            blk_rows = np.concatenate([rows, mi])
            blk_cols = np.concatenate([cols, mj])
        blocks = detect_blocks(blk_rows, blk_cols, n) if n >= 8 else None
        if blocks is not None:
            perm, nb, K = blocks
            return (make_blockdiag_jac(rhs_f, perm, nb, K, n),
                    make_blockdiag_solver(perm, nb, K))
        if n >= 8 and ml + mu + 1 <= max(n // 2, 1):
            return make_banded_jac(rhs_f, ml, mu), make_banded_solver(ml, mu)
        # (the JAX OdeBuilder's matrix-free Krylov route for n >= 256 is taken
        # on a TPU only, where a dense f64 LU cannot compile; queue 1 item 14)
        colors, ncolors = greedy_color(rows, cols, n, n)
        return make_colored_jac(rhs_f, rows, cols, colors, ncolors, n), linear_solver
