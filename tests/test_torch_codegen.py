"""Equation code generation (ops/eqn_codegen.py): the traced scalar IR
against the torch callables it came from and against torch.func.jacfwd,
the generated CUDA source (produced here, compiled only on the card), and
the scope checks.

The IR evaluator performs the callable's float64 operations in the same
order, so values and dual-number Jacobians agree to 1e-14 relative (a few
ulps where a power x**k is unrolled into k-1 products)."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch.models import robertson
from diffsol_tpu_torch.ops import eqn_codegen as cg
from diffsol_tpu_torch.ops import fused_stepper as fs
from diffsol_tpu_torch.ops.fused_stepper import make_fused_bdf_solve

torch.set_num_threads(1)

TOL = 1e-14
F64 = torch.float64


def rhs_wide(t, y, p):
    """Every operation in the codegen scope: literals, neg, powers,
    exp/log/sqrt/sin/cos/tanh, indexing, slicing, stack and cat."""
    a = 1.0 - y[0] * p[0]
    b = y[1] ** 2 / 3e7 + torch.exp(-y[2]) * 1e4 + torch.sin(t) * p[1]
    c = torch.cat([y[0:2] * 0.04, torch.tanh(y[2:3])])
    d = torch.sqrt(y[1]) + torch.log(y[0]) + torch.cos(y[2]) + y[1] ** -2
    return torch.stack([a, b, c[0] + d]) + c


def _vmapped(fn):
    return torch.func.vmap(fn, in_dims=(0, 0, 0))


def _inputs(seed, B=6):
    rng = np.random.default_rng(seed)
    t = torch.tensor(rng.uniform(0.0, 2.0, B), dtype=F64)
    y = torch.tensor(rng.uniform(0.5, 1.5, (B, 3)), dtype=F64)
    p = torch.tensor(rng.uniform(0.5, 2.0, (B, 3)), dtype=F64)
    return t, y, p


@pytest.mark.parametrize("fn", [robertson.rhs_ode, rhs_wide], ids=["robertson", "wide"])
def test_ir_matches_rhs_and_jacfwd(fn):
    t, y, p = _inputs(5)
    if fn is robertson.rhs_ode:
        p = p * torch.tensor([0.04, 1e4, 3e7], dtype=F64)
    ir = cg.trace_ir(fn, ("t", "y", "p"), (None, 3, 3))
    ref = _vmapped(fn)(t, y, p)
    got = cg.eval_rhs(ir, t, y, p)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL,
                               atol=TOL * float(ref.abs().max()))
    J_ref = _vmapped(torch.func.jacfwd(fn, argnums=1))(t, y, p)
    J = cg.jacobian(ir, t, y, p)
    np.testing.assert_allclose(J.numpy(), J_ref.numpy(), rtol=TOL,
                               atol=TOL * float(J_ref.abs().max()))


def test_init_ir_matches_init():
    model = cg.trace_model(robertson.rhs_ode, robertson.init, 3, 3)
    p = torch.tensor([[0.04, 1e4, 3e7]] * 2, dtype=F64)
    got = cg.eval_init(model.init, 0.0, p)
    np.testing.assert_array_equal(got.numpy(), [[1.0, 0.0, 0.0]] * 2)


def _constants(src):
    return {float(v) for v in re.findall(r"T\(([-+0-9.eE]+)\)", src)}


def test_generated_cuda_source():
    """The model header is produced (not compiled: there is no nvcc here)
    and lifts every literal at float64, exactly."""
    model = cg.trace_model(rhs_wide, robertson.init, 3, 3)
    src = cg.emit_cuda_header(model, "rhs_wide")
    assert "#define MODEL_N 3" in src and "#define MODEL_NP 3" in src
    # y and out are any indexable types: arrays in the small-n kernel,
    # strided accessors in the banded one
    assert "template <typename T, typename Y, typename O>" in src
    assert "void model_rhs(const T& t, Y y, const T* p, O out)" in src
    assert "void model_init(const T& t, const T* p, T* out)" in src
    for fn in ("dsol_exp", "dsol_log", "dsol_sqrt", "dsol_sin", "dsol_cos", "dsol_tanh"):
        assert fn in src
    consts = _constants(src)
    assert {1e4, 3e7, 0.04, 1.0, 0.0} <= consts
    # 0.04 is not a float32 value: lifting at f32 would have changed it
    assert float(np.float32(0.04)) not in consts
    # the Robertson model has no literals in its rhs: p carries 1e4 and 3e7
    rob = cg.emit_cuda_header(cg.trace_model(robertson.rhs_ode, robertson.init, 3, 3))
    assert "p[1]" in rob and "p[2]" in rob
    assert re.search(r"out\[2\] = v\d+;", rob)


def _unsupported(name):
    if name == "erf":
        return lambda t, y, p: torch.erf(y)
    if name == "branch":
        def f(t, y, p):
            if y[0] > 0:
                return y
            return -y
        return f
    if name == "bool_result":
        return lambda t, y, p: (y > 0.5).to(torch.float64)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["erf", "branch", "bool_result"])
def test_out_of_scope_ops_raise(name):
    with pytest.raises(cg.UnsupportedForKernel):
        cg.trace_ir(_unsupported(name), ("t", "y", "p"), (None, 3, 3))


def test_out_of_scope_problems_raise_and_auto_falls_back():
    mass_problem = (
        dtt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * y)
        .init(lambda t, p: torch.ones(2, dtype=F64))
        .mass(lambda t, p: torch.tensor([[1.0, 0.5], [0.0, 2.0]], dtype=F64))
        .p([0.5])
        .build()
    )
    with pytest.raises(cg.UnsupportedForKernel, match="non-diagonal mass"):
        make_fused_bdf_solve(mass_problem, [1.0], 4)
    big = (
        dtt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * y)
        .init(lambda t, p: torch.ones(9, dtype=F64))
        .p([0.5])
        .build()
    )
    with pytest.raises(cg.UnsupportedForKernel, match="states"):
        make_fused_bdf_solve(big, [1.0], 4)
    erf_problem = (
        dtt.OdeBuilder()
        .rhs(lambda t, y, p: -p[0] * torch.erf(y))
        .init(lambda t, p: torch.ones(2, dtype=F64))
        .p([0.5])
        .build()
    )
    params = torch.tensor([[0.5], [0.7]], dtype=F64)
    with pytest.raises(cg.UnsupportedForKernel):
        dtt.solve_dense_ensemble(dtt.BdfSolver, erf_problem, [0.5, 1.0], params,
                                 mode="fused", device="cpu")
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, erf_problem, [0.5, 1.0], params,
                                   mode="auto", device="cpu")
    assert sol.tier == "lockstep"
    assert sol.stop_reason == dtt.errors.TSTOP_REACHED


@pytest.mark.parametrize("name", ["zeros", "full", "ones_like", "zeros_like"])
def test_constant_factories_lift_to_constants(name):
    f64 = torch.float64
    fn = {
        "zeros": lambda t, p: torch.zeros(2, dtype=f64) + p,
        "full": lambda t, p: torch.full((2,), 2.5, dtype=f64) * p,
        "ones_like": lambda t, p: torch.ones_like(p) - p,
        "zeros_like": lambda t, p: torch.zeros_like(p) + 1e-3,
    }[name]
    ir = cg.trace_ir(fn, ("t", "p"), (None, 2))
    p = torch.tensor([[3.0, 4.0], [0.5, 0.25]], dtype=f64)
    ref = torch.func.vmap(fn, in_dims=(None, 0))(torch.tensor(0.0, dtype=f64), p)
    np.testing.assert_array_equal(cg.eval_init(ir, 0.0, p).numpy(), ref.numpy())


def _cuda_struct_fields(src, name):
    """(c type, field name) of each member of ``struct name`` in order."""
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for decl in body.split(";"):
        decl = re.sub(r"//[^\n]*", "", decl).strip()
        if decl:
            ctype, names = decl.split(None, 1)
            fields += [(ctype, re.match(r"\w+", v.strip()).group(0))
                       for v in names.split(",")]
    return fields


def test_kernel_config_mirrors_the_cuda_struct():
    """The wrapper's ctypes CConfig lists the kernel's Config fields in the
    same order and with the same scalar types."""
    src = (Path(fs.__file__).resolve().parent.parent / "csrc" / "fused_bdf.cuh").read_text()
    cuda = _cuda_struct_fields(src, "Config")

    def scalar(ct):
        while hasattr(ct, "_type_") and hasattr(ct, "_length_"):
            ct = ct._type_
        return {ctypes.c_double: "double", ctypes.c_int: "int"}[ct]

    assert cuda == [(scalar(ct), name) for name, ct in fs.CConfig._fields_]


def test_tile_above_the_block_limit_raises():
    with pytest.raises(ValueError, match="block limit"):
        make_fused_bdf_solve(robertson.problem_ode(), [1.0], 2048, tile=fs.MAX_TILE + 1)
    assert make_fused_bdf_solve(robertson.problem_ode(), [1.0], 2048,
                                tile=fs.MAX_TILE).tile == fs.MAX_TILE


# ---------------------------------------------------------------------------
# the rest of the primitive scope (dfinterp.py:21-29), the further device
# functions, and the transcendental rhs against the JAX kernel
# ---------------------------------------------------------------------------

_PRIMITIVES = {
    "expm1": lambda t, y, p: torch.expm1(y) * p[0],
    "log1p": lambda t, y, p: torch.log1p(y * y),
    "rsqrt": lambda t, y, p: torch.rsqrt(y + p[1]),
    "tan": lambda t, y, p: torch.tan(0.5 * y),
    "sinh": lambda t, y, p: torch.sinh(y) - t,
    "cosh": lambda t, y, p: torch.cosh(y),
    "sigmoid": lambda t, y, p: torch.sigmoid(p[0] * y),
    "pow_constant": lambda t, y, p: y ** 1.5 + y ** -0.5,
    "pow_traced": lambda t, y, p: y ** p[0] + p[1] ** y,
    "pow_scalar_base": lambda t, y, p: 2.0 ** y,
    "where_compare": lambda t, y, p: torch.where(y < 0.9, y * y, torch.exp(y)),
    "where_logic": lambda t, y, p: torch.where(
        ((y >= 0.7) & (y <= 1.1)) | ~(p[0] > y), p[0] * y, -y),
    "where_scalar_branch": lambda t, y, p: torch.where(y != y[0], 1.0, y),
}


@pytest.mark.parametrize("name", sorted(_PRIMITIVES))
def test_further_primitives_match_torch_and_jacfwd(name):
    """Each primitive added to the tracer: the IR's value against the
    callable and its dual-number Jacobian against torch.func.jacfwd, and a
    device function of that name for both scalar types in dual.cuh."""
    fn = _PRIMITIVES[name]
    ir = cg.trace_ir(fn, ("t", "y", "p"), (None, 3, 3))
    rng = np.random.default_rng(11)
    y = torch.tensor(rng.uniform(0.5, 1.5, (5, 3)))
    p = torch.tensor(rng.uniform(0.5, 1.5, (5, 3)))
    t = torch.tensor(0.3, dtype=F64)
    ref = torch.stack([fn(t, y[i], p[i]) for i in range(5)])
    torch.testing.assert_close(cg.eval_rhs(ir, t, y, p), ref, rtol=TOL, atol=TOL)
    jac = torch.stack([torch.func.jacfwd(fn, argnums=1)(t, y[i], p[i]) for i in range(5)])
    torch.testing.assert_close(cg.jacobian(ir, t, y, p), jac, rtol=1e-13, atol=1e-13)
    src = cg.emit_cuda_header(cg.ModelIR(rhs=ir, init=None, nstates=3, nparams=3))
    dual = (Path(fs.__file__).resolve().parent.parent / "csrc" / "dual.cuh").read_text()
    used = set(re.findall(r"\b(dsol_\w+)\(", src))
    assert used, src
    for device_fn in used:
        assert len(re.findall(rf"\b{device_fn}\(", dual)) >= 2, device_fn
    assert cg.op_count(ir) > 0


_MASK = torch.tensor([True, False, True, True, False, True])
_PERM = torch.tensor([2, 0, 5, 1, 1, 3])
_MAT = torch.tensor(np.random.default_rng(3).uniform(-1.0, 1.0, (6, 6)))
_COEF = torch.tensor([[-1.0, -0.5e-6], [1.0e4, -1.0]], dtype=F64)

# the operations the 2-D method-of-lines models trace to (what
# ops/dfinterp_vec.py adds for the banded Pallas kernel), on 6 states
_ARRAY_OPS = {
    "roll": lambda t, y, p: (torch.roll(y.reshape(2, 3), 1, 0)
                             + torch.roll(y.reshape(2, 3), -1, 1) * p[0]).reshape(-1),
    "roll_flat": lambda t, y, p: torch.roll(y, 2) - y,
    "flip": lambda t, y, p: torch.flip(y.reshape(3, 2), [0, 1]).reshape(-1) * y,
    "index": lambda t, y, p: y[_PERM] * y,
    "index_2d": lambda t, y, p: (y.reshape(2, 3)[:, torch.tensor([2, 0, 1])]).reshape(-1) + y,
    "index_select": lambda t, y, p: torch.index_select(y.reshape(3, 2), 0,
                                                       torch.tensor([1, 1, 0])).reshape(-1),
    "gather": lambda t, y, p: torch.gather(y, 0, _PERM) * p[1],
    "constant_pad": lambda t, y, p: torch.nn.functional.pad(y, (1, 2), value=0.5)[1:7] + (
        torch.nn.functional.pad(y.reshape(2, 3), (1, 1, 0, 1))[1:, :3].sum(0)[[0, 1, 2, 0, 1, 2]]),
    "reflect_pad_1d": lambda t, y, p: torch.nn.functional.pad(
        y[None, None], (2, 1), mode="reflect")[0, 0, 1:7] * y,
    "reflect_pad_2d": lambda t, y, p: (lambda up: (
        up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]).reshape(-1))(
            torch.nn.functional.pad(y.reshape(1, 2, 3), (1, 1, 1, 1),
                                    mode="reflect")[0]) - 4.0 * y,
    "sum_dims": lambda t, y, p: y.reshape(2, 3).sum(0)[[0, 1, 2, 0, 1, 2]] + y.reshape(2, 3).sum(
        1, keepdim=True).expand(2, 3).reshape(-1) + torch.sum(y * y),
    "mm": lambda t, y, p: (_MAT[:2, :2] @ y.reshape(2, 3)).reshape(-1),
    "mv_dot": lambda t, y, p: _MAT @ y + torch.dot(y, y) * p[0],
    "einsum": lambda t, y, p: torch.einsum(
        "ij,xyj->xyi", _COEF, y.reshape(1, 3, 2)).reshape(-1) * y,
    "bmm": lambda t, y, p: torch.bmm(y.reshape(2, 1, 3), y.reshape(2, 3, 1)).reshape(
        2, 1).expand(2, 3).reshape(-1) + y,
    "bool_mask_where": lambda t, y, p: torch.where(_MASK, y * y * p[0], y),
    "bool_mask_logic": lambda t, y, p: torch.where(_MASK & (y > 0.9), torch.exp(y), -y),
    "eye": lambda t, y, p: (torch.eye(6, dtype=F64) * 2.0) @ y,
}


@pytest.mark.parametrize("name", sorted(_ARRAY_OPS))
def test_array_operations_match_torch_and_jacfwd(name):
    """Each array operation unrolls to index plumbing plus adds and
    multiplies: the IR's value against the callable (1e-14; sums fold left
    to right, so 1e-13 where torch reduces in another order) and its
    dual-number Jacobian against torch.func.jacfwd, on inputs from a numpy
    seed; the emitted CUDA body assigns every output."""
    fn = _ARRAY_OPS[name]
    ir = cg.trace_ir(fn, ("t", "y", "p"), (None, 6, 2))
    rng = np.random.default_rng(13)
    y = torch.tensor(rng.uniform(0.5, 1.5, (4, 6)))
    p = torch.tensor(rng.uniform(0.5, 1.5, (4, 2)))
    t = torch.tensor(0.3, dtype=F64)
    ref = torch.stack([fn(t, y[i], p[i]) for i in range(4)])
    assert len(ir.outputs) == ref.shape[1]
    torch.testing.assert_close(cg.eval_rhs(ir, t, y, p), ref, rtol=1e-13, atol=1e-13)
    jac = torch.stack([torch.func.jacfwd(fn, argnums=1)(t, y[i], p[i]) for i in range(4)])
    torch.testing.assert_close(cg.jacobian(ir, t, y, p), jac, rtol=1e-13, atol=1e-13)
    src = cg.emit_cuda_header(cg.ModelIR(rhs=ir, init=None, nstates=6, nparams=2))
    assert all(f"out[{i}] = " in src for i in range(ref.shape[1]))
    assert cg.op_count(ir) >= 0


def test_boolean_constants_are_boolean_nodes():
    """A constant mask is lifted as boolean constants, not doubles: where
    it alone selects, the branch is taken at trace time; combined with a
    traced comparison it is a ``cb`` node, emitted as a C++ literal; and a
    boolean constant is still no arithmetic operand."""
    alone = cg.trace_ir(_ARRAY_OPS["bool_mask_where"], ("t", "y", "p"), (None, 6, 2))
    assert not any(n[0] == "where" for n in alone.nodes)
    logic = cg.trace_ir(_ARRAY_OPS["bool_mask_logic"], ("t", "y", "p"), (None, 6, 2))
    assert {n for n in logic.nodes if n[0] == "cb"} == {("cb", True), ("cb", False)}
    src = cg.emit_cuda_header(cg.ModelIR(rhs=logic, init=None, nstates=6, nparams=2))
    assert re.search(r"const bool v\d+ = true;", src)
    assert re.search(r"const bool v\d+ = false;", src)
    with pytest.raises(cg.UnsupportedForKernel, match="boolean"):
        cg.trace_ir(lambda t, y, p: _MASK * y, ("t", "y", "p"), (None, 6, 2))


def test_array_operations_outside_the_scope_raise():
    with pytest.raises(cg.UnsupportedForKernel, match="traced value|int64"):
        cg.trace_ir(lambda t, y, p: torch.gather(y, 0, (y > 2.0).long()),
                    ("t", "y", "p"), (None, 6, 2))
    with pytest.raises(cg.UnsupportedForKernel, match="scope|trace"):
        cg.trace_ir(lambda t, y, p: torch.cumsum(y, 0), ("t", "y", "p"), (None, 6, 2))
    with pytest.raises(cg.UnsupportedForKernel, match="negative"):
        cg.trace_ir(lambda t, y, p: torch.nn.functional.pad(y, (-1, 1)),
                    ("t", "y", "p"), (None, 6, 2))


def test_boolean_values_stay_inside_where():
    with pytest.raises(cg.UnsupportedForKernel, match="boolean"):
        cg.trace_ir(lambda t, y, p: (y > 0.5) * y, ("t", "y", "p"), (None, 3, 3))


def test_header_holds_the_further_device_functions():
    """mass, root, reset and out are traced beside rhs and init and
    emitted generic in their accessors, with the kernel's compile-time
    switches; a plain ODE gets every switch at 0."""
    from diffsol_tpu_torch.models import fused_cases as fc

    plain = cg.emit_cuda_header(cg.trace_model(robertson.rhs_ode, robertson.init, 3, 3))
    for macro in ("HAS_MASS", "NROOT", "HAS_RESET", "NQUAD", "HAS_OUT", "OUT_IN_ERR"):
        assert f"#define MODEL_{macro} 0" in plain
    assert "model_root" not in plain and "model_mass" not in plain

    ball = fc.bouncing_ball_problem().eqn
    model = cg.trace_model(ball.rhs, ball.init, 2, 2, root=ball.root, reset=ball.reset,
                           out=fc.square_out)
    src = cg.emit_cuda_header(model, "ball", nquad=1, out_in_err=True)
    for line in ("#define MODEL_NROOT 1", "#define MODEL_HAS_RESET 1",
                 "#define MODEL_NQUAD 1", "#define MODEL_HAS_OUT 1",
                 "#define MODEL_OUT_IN_ERR 1", "#define MODEL_HAS_MASS 0"):
        assert line in src
    for fn_name in ("model_rhs", "model_root", "model_reset", "model_out"):
        assert re.search(rf"template <typename T, typename Y, typename O>\n"
                         rf"__device__ __forceinline__ void {fn_name}\(", src)
    y = torch.tensor([[2.0, -3.0]], dtype=F64)
    p = torch.tensor([[9.81, 0.8]], dtype=F64)
    torch.testing.assert_close(cg.eval_rhs(model.reset, 0.0, y, p),
                               torch.tensor([[1e-9, 2.4]], dtype=F64))
    torch.testing.assert_close(cg.eval_rhs(model.root, 0.0, y, p),
                               torch.tensor([[2.0]], dtype=F64))

    # a replayed mass is a (t, p) program, a constant one literal assignments
    def mass_diag(t, p):
        return torch.diagonal(torch.diag(torch.stack([1.0 + t, p[0], 0.0 * t])))

    replayed = cg.trace_model(robertson.rhs_dae, robertson.init, 3, 3, mass_diag=mass_diag)
    torch.testing.assert_close(
        cg.eval_init(replayed.mass, 2.0, torch.tensor([[5.0, 0.0, 0.0]], dtype=F64)),
        torch.tensor([[3.0, 5.0, 0.0]], dtype=F64))
    assert "model_mass" in cg.emit_cuda_header(replayed)
    const = cg.trace_model(robertson.rhs_dae, robertson.init, 3, 3, mass_diag=mass_diag,
                           mass_const=(1.0, 1.0, 0.0))
    assert const.mass is None
    assert "out[2] = T(0.0);" in cg.emit_cuda_header(const)
    with pytest.raises(cg.UnsupportedForKernel, match="reset returns 1 values"):
        cg.trace_model(ball.rhs, ball.init, 2, 2, reset=ball.root)


def test_transcendental_rhs_matches_pallas_interpret(monkeypatch):
    """tests/test_pallas_stepper.py:372 through both packages' fused tiers
    (B = 4 in one tile).  The JAX kernel, with float32 heuristics, takes
    69 accepted steps where the float64 port takes 72 (ROADMAP.md queue 3
    logs it), so ys agree at the solver's tolerance, 1e-5 relative, the
    bound that also holds the first state to its closed form."""
    import jax.numpy as jnp

    import diffsol_tpu as dt
    from diffsol_tpu.ensemble import solve_dense_ensemble as jax_ensemble
    from diffsol_tpu_torch.models import fused_cases as fc

    def jrhs(t, y, p):
        return jnp.stack([
            -p[0] * jnp.exp(y[0]),
            -p[1] * jnp.sin(y[1]) + p[0] * jnp.tanh(y[2]),
            -p[0] * y[2] * jnp.log1p(y[0] * y[0]),
        ])

    jp = (dt.OdeBuilder().rhs(jrhs).init(lambda t, p: jnp.array([0.5, 1.0, 0.8]))
          .p([1.0, 1.0]).rtol(1e-6).atol(1e-9).build())
    a = np.linspace(0.5, 1.5, 4)
    params = np.stack([a, np.ones(4)], axis=1)
    te = fc.TRANSCENDENTAL_T_EVAL
    ref = jax_ensemble(dt.BdfSolver, jp, te, jnp.asarray(params), mode="fused",
                       interpret=True)
    sol = dtt.solve_dense_ensemble(dtt.BdfSolver, fc.transcendental_problem(), te, params,
                                   mode="fused", tile=4, device="cpu")
    assert sol.tier == "fused_small_reference" and ref.tier == "fused_small"
    assert sol.stop_reason == int(ref.stop_reason) == dtt.errors.TSTOP_REACHED
    assert abs(int(sol.tile_steps[0]) - int(ref.tile_steps[0])) <= 4
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), rtol=1e-5, atol=1e-8)
    exact = fc.transcendental_y0(np.asarray(te)[:, None], a[None, :])
    np.testing.assert_allclose(sol.ys[:, :, 0].numpy(), exact, rtol=1e-5, atol=1e-7)
    # with the rounding the Pallas kernel shows in interpret mode on the CPU
    # (fused_cases.pallas_cpu_tile_product) the port comes within one step
    from diffsol_tpu_torch.ops import fused_stepper as fs

    monkeypatch.setattr(fs, "_tile_mul", fc.pallas_cpu_tile_product)
    emulated = dtt.solve_dense_ensemble(dtt.BdfSolver, fc.transcendental_problem(), te,
                                        params, mode="fused", tile=4, device="cpu")
    assert abs(int(emulated.tile_steps[0]) - int(ref.tile_steps[0])) <= 1
