"""DiffSL in the port (``diffsol_tpu_torch.diffsl``) against the JAX
package's ``diffsol_tpu.diffsl``, on every model text of
tests/test_diffsl.py.

Each text compiles in both packages to the same layout (states, labels,
defaults, hidden model index) and the same folded constants, bit for bit
(both fold with numpy); the callables rhs, init, mass, root, out, reset
and reset_n agree on the same numpy-seeded (t, y, p) within 1e-13 relative
(of the largest entry for the near-zero ones).  The port contracts a
product term with ``torch.einsum`` where the JAX package multiplies the
chain elementwise and sums, so the two round apart by a few ulps of the
terms.

Also here: the errors and the parameter-count check, the contraction
rules, the ';' separator, serialization across the two packages,
``build_from_eqn`` reuse, the traced IR of DiffSL models (the Robertson
rhs, whose IR is the hand-written model's, and the folded heat1d
Laplacian), and the codegen's abs, maximum, minimum and sign against JAX's
``DualAlgebra`` rules, ties and x = 0 included.  No JAX kernel runs here.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsol_tpu import diffsl as jdsl
from diffsol_tpu.ops.dfinterp import DualAlgebra
from diffsol_tpu.problem import OdeBuilder as JaxBuilder

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import diffsl as tdsl
from diffsol_tpu_torch.models import diffsl_sources, robertson
from diffsol_tpu_torch.ops import eqn_codegen as cg

torch.set_num_threads(1)
F64 = torch.float64
RTOL = 1e-13

# ---------------------------------------------------------------------------
# the model texts of tests/test_diffsl.py
# ---------------------------------------------------------------------------

LOGISTIC = """
in_i { r = 1.0, k = 1.0 }
u { 0.1 }
F { r * u * (1.0 - u / k) }
"""

# reference test_models/robertson.rs:16-42
ROBERTSON = """
in_i { k1 = 0.04, k2 = 10000, k3 = 30000000 }
u_i { x = 1, y = 0, z = 0 }
dudt_i { dxdt = 1, dydt = 0, dzdt = 0 }
M_i { dxdt, dydt, 0 }
F_i {
    -k1 * x + k2 * y * z,
    k1 * x - k2 * y * z - k3 * y * y,
    1 - x - y - z,
}
out_i { x, y, z }
"""


def heat1d_text(mgrid=20):
    """tests/test_diffsl.py::test_heat1d_banded_matrix_and_contraction."""
    mgridp1 = mgrid + 1
    h = 1.0 / (mgrid + 2)
    y0 = ", ".join(
        f"({i}): {2 * (i + 1) * h if (i + 1) * h < 0.5 else 2 * (1 - (i + 1) * h)}"
        for i in range(mgridp1))
    return f"""
    D {{ 1.0 }}
    h {{ {h} }}
    A_ij {{
        (0..{mgrid}, 1..{mgridp1}): 1.0,
        (0..{mgridp1}, 0..{mgridp1}): -2.0,
        (1..{mgridp1}, 0..{mgrid}): 1.0,
    }}
    u_i {{ {y0} }}
    heat_i {{ A_ij * u_j }}
    F_i {{ D * heat_i / (h * h) }}
    out_i {{ u_i }}
    """


def coloring_heat1d_text(mgrid=12):
    """tests/test_diffsl.py::test_diffsl_use_coloring_routes_to_banded."""
    mgridp1 = mgrid + 1
    h = 1.0 / (mgrid + 2)
    y0 = ", ".join(f"({i}): {0.1 * (i + 1)}" for i in range(mgridp1))
    return f"""
    A_ij {{
        (0..{mgrid}, 1..{mgridp1}): 1.0,
        (0..{mgridp1}, 0..{mgridp1}): -2.0,
        (1..{mgridp1}, 0..{mgrid}): 1.0,
    }}
    u_i {{ {y0} }}
    F_i {{ A_ij * u_j / {h * h} }}
    """


FOODWEB_BLOCKS = """
    A { 0.5 }
    xx_i { (0): 0.0, (1): 0.3333, (2): 0.6666, (3): 1.0 }
    b_i { (1.0 + A * xx_i * xx_i) }
    u_i {
        c1 = 1.0 + xx_i,
        (4:8): c2 = 2.0,
    }
    F_i {
        -c1_i + b_i,
        -2.0 * c2_i + c1_i,
    }
    out_i {
        xx_j * c1_j,
        xx_j * c2_j,
    }
"""


def foodweb_text(nx=4):
    """tests/test_diffsl.py::test_foodweb_diffsl_full_model."""
    n = nx * nx
    dx = 1.0 / (nx - 1)
    xv = np.arange(nx) * dx
    xx, yy = np.meshgrid(xv, xv)

    def refl(j):
        return -j if j < 0 else (2 * nx - 2 - j if j >= nx else j)

    D = np.zeros((n, n))
    for jy in range(nx):
        for jx in range(nx):
            i = jy * nx + jx
            D[i, i] -= 4.0 / dx**2
            for dyy, dxx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                D[i, refl(jy + dyy) * nx + refl(jx + dxx)] += 1.0 / dx**2
    d_lit = ",\n".join(f"({i},{j}): {float(D[i, j])!r}"
                       for i in range(n) for j in range(n) if D[i, j] != 0.0)
    xx_lit = ", ".join(f"({i}): {float(v)!r}" for i, v in enumerate(xx.ravel()))
    yy_lit = ", ".join(f"({i}): {float(v)!r}" for i, v in enumerate(yy.ravel()))
    return f"""
    AA {{ 1.0 }}
    EE {{ 10000.0 }}
    GG {{ 0.5e-6 }}
    BB {{ 1.0 }}
    ALPHA {{ 50.0 }}
    BETA {{ 1000.0 }}
    PI {{ 3.141592653589793 }}
    DPREY {{ 1.0 }}
    DPRED {{ 0.05 }}
    D_ij {{ {d_lit} }}
    xx_i {{ {xx_lit} }}
    yy_i {{ {yy_lit} }}
    b_i {{
        (1.0 + ALPHA * xx_i * yy_i
         + BETA * sin(4.0 * PI * xx_i) * sin(4.0 * PI * yy_i))
    }}
    u_i {{
        c1 = 10.0 + pow(16.0 * xx_i * (1.0 - xx_i) * yy_i * (1.0 - yy_i), 2),
        ({n}:{2 * n}): c2 = 1.0e5,
    }}
    dudt_i {{
        (0:{n}): dc1dt = 0,
        ({n}:{2 * n}): dc2dt = 0,
    }}
    M_i {{
        dc1dt_i,
        ({n}:{2 * n}): 0,
    }}
    c1diff_i {{ DPREY * D_ij * c1_j }}
    c2diff_i {{ DPRED * D_ij * c2_j }}
    F_i {{
        c1diff_i + c1_i * (BB * b_i - AA * c1_i - GG * c2_i),
        c2diff_i + c2_i * (-BB * b_i + EE * c1_i - AA * c2_i),
    }}
    """


def heat2d_matrices(mg=4):
    """The D and Mass matrices of tests/test_diffsl.py::
    test_heat2d_style_matrix_mass_action, built its way."""
    n = mg * mg
    dx2 = (1.0 / (mg - 1)) ** 2
    Dm = np.zeros((n, n))
    Mass = np.zeros((n, n))
    for jy in range(mg):
        for jx in range(mg):
            i = jy * mg + jx
            if jy in (0, mg - 1) or jx in (0, mg - 1):
                Dm[i, i] = 1.0
            else:
                Mass[i, i] = 1.0
                Dm[i, i] = -4.0 / dx2
                for dyy, dxx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    Dm[i, (jy + dyy) * mg + (jx + dxx)] += 1.0 / dx2
    return Dm, Mass, dx2


def heat2d_text(mg=4):
    """tests/test_diffsl.py::test_heat2d_style_matrix_mass_action."""
    n = mg * mg
    Dm, Mass, dx2 = heat2d_matrices(mg)

    def lit(M):
        entries = [f"({i},{j}): {float(M[i, j])!r}"
                   for i in range(n) for j in range(n) if M[i, j] != 0.0]
        if M[n - 1, n - 1] == 0.0:
            entries.append(f"({n - 1},{n - 1}): 0.0")
        return ",\n".join(entries)

    y0 = np.zeros(n)
    for jy in range(1, mg - 1):
        for jx in range(1, mg - 1):
            y0[jy * mg + jx] = 1.0
    init_lit = ", ".join(f"({i}): {float(v)!r}" for i, v in enumerate(y0))
    return f"""
    D_ij {{ {lit(Dm)} }}
    Mass_ij {{ {lit(Mass)} }}
    init_i {{ {init_lit} }}
    u_i {{ y = init_i }}
    dudt_i {{ (0:{n}): dydt = 0 }}
    M_i {{ Mass_ij * dydt_j }}
    F_i {{ D_ij * y_j }}
    out_i {{ {float(dx2)!r} * y_j * y_j }}
    """


STOP_RESET = """
    in_i { r = 1.0 }
    u_i { y = 1.0 }
    F_i { -r * y }
    stop_i { y - 0.5 }
    reset_i { y + 1.0 }
    out_i { y }
"""

TIME_STOP = """
    in_i { r = 1.0 }
    u_i { y = 0.1 }
    F_i { r * y * (1.0 - y) }
    stop_i { t - 0.5 }
"""

EXP_DECAY = """
    in_i { k = 0.1, y0 = 1.0 }
    u_i { x = y0, y = y0 }
    F_i { -k * u_i }
"""

CONTRACTION = """
    A_ij { (0,0): 1.0, (0,1): 2.0, (1,0): 3.0, (1,1): 4.0 }
    u_i { a = 1.0, b = 1.0 }
    w_i { (0): 5.0, (1): 7.0 }
    F_i { A_ij * u_j * w_j }
    out { u_i ^ 2 }
"""

CONTRACTION_DIV = """
    A_ij { (0,0): 1.0, (0,1): 2.0, (1,0): 3.0, (1,1): 4.0 }
    u_i { a = 1.0, b = 1.0 }
    F_i { A_ij * u_j / 2.0 }
"""

# tests/test_diffsl.py::test_diffsl_f32_traces_f32_arithmetic's model, in
# float64 here (the port has no float32 solve yet)
SCALED_MATVEC = """
    A_ij { (0,0): 1.0, (0,1): 2.0, (1,0): 3.0, (1,1): 4.0 }
    c { 0.5 }
    u_i { a = 1.0, b = 2.0 }
    F_i { c * A_ij * u_j + 1.5 }
"""

PARAM_COUNT = """
in_i { a = 0.5, b = 2.0 }
u_i { y = 1.0 }
F_i { -a * b * y }
"""

MODEL_INDEX = """
    in_i { r = 1 }
    u_i { y = 0.1 }
    dudt_i { dydt = 0 }
    F_i { r * y * (1.0 - y) }
    stop_i { t - 0.5 }
    reset_i { 0.1 + 0.5 * N }
    out_i { y }
"""

MULTI_MODEL = """
    r_i { 1, 2, 4 }
    u_i { y = 0.1 }
    reset_i { y }
    stop_i { y - 0.5 }
    F_i { r_i[N] * y }
"""

ERRORS_N = ("in_i { r = 1 }\nu_i { y = 0.1 }\nF_i { r * y }\n"
            "stop_i { t - 0.5 }\nreset_i { 0.1 + 0.5 * N }")

FN_ARG_EXP = """
    A_ij {
        (0, 0): 1.0, (0, 1): 2.0,
        (1, 0): 0.5, (1, 1): 0.25,
    }
    u_i { x = 0.3, y = 0.7 }
    F_i { -u_i }
    out_i { exp(A_ij * u_j) }
"""

FN_ARG_MATVEC = """
    A_ij {
        (0, 0): 1.0, (0, 1): 2.0,
        (1, 0): 0.5, (1, 1): 0.25,
    }
    u_i { x = 0.3, y = 0.7 }
    F_i { -u_i }
    out_i { A_ij * exp(u_j) }
"""

SEMICOLON = """
    u_i { x = 1.0; y = 2.0; }
    F_i { -x; -2.0 * y; }
"""

SOURCES = {
    "logistic": LOGISTIC,
    "robertson": ROBERTSON,
    "heat1d": heat1d_text(),
    "foodweb_blocks": FOODWEB_BLOCKS,
    "stop_reset": STOP_RESET,
    "time_stop": TIME_STOP,
    "exp_decay": EXP_DECAY,
    "contraction": CONTRACTION,
    "contraction_div": CONTRACTION_DIV,
    "scaled_matvec": SCALED_MATVEC,
    "coloring_heat1d": coloring_heat1d_text(),
    "foodweb": foodweb_text(),
    "heat2d": heat2d_text(),
    "param_count": PARAM_COUNT,
    "model_index": MODEL_INDEX,
    "multi_model": MULTI_MODEL,
    "errors_n": ERRORS_N,
    "fn_arg_exp": FN_ARG_EXP,
    "fn_arg_matvec": FN_ARG_MATVEC,
    "semicolon": SEMICOLON,
}


# ---------------------------------------------------------------------------
# front end and callables against the JAX package
# ---------------------------------------------------------------------------

def _close(got, ref, what):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale, err_msg=what)


def _point(model, fns, seed):
    """A numpy-seeded (t, y, p): parameters within +-10 % of the defaults,
    the state the initial one perturbed by +-10 % and shifted off zero, the
    hidden model index 1."""
    rng = np.random.default_rng(seed)
    t = float(rng.uniform(0.1, 0.9))
    p = model.default_params * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, model.default_params.shape))
    y0 = np.asarray(fns["init"](jnp.asarray(t), jnp.asarray(p)))
    y = (y0 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, y0.shape))
         + 0.05 * rng.uniform(0.5, 1.0, y0.shape))
    if model.uses_n:
        y[-1] = 1.0
    return t, y, p


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_compile_matches_jax(name):
    """Layout, labels, defaults, the hidden index and every folded constant
    equal the JAX package's."""
    j, t = jdsl.compile_diffsl(SOURCES[name]), tdsl.compile_diffsl(SOURCES[name])
    for attr in ("order", "param_labels", "state_segments", "dudt_segments", "nstates",
                 "has_mass", "has_root", "has_out", "has_reset", "state_dep", "uses_n"):
        assert getattr(t, attr) == getattr(j, attr), attr
    np.testing.assert_array_equal(t.default_params, j.default_params)
    assert t.constants.keys() == j.constants.keys()
    for k, (arr, rank) in j.constants.items():
        assert t.constants[k][1] == rank
        np.testing.assert_array_equal(t.constants[k][0], arr)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_callables_match_jax(name):
    """rhs, init, mass, root, out, reset and reset_n (at k = 0 and 1) on the
    same (t, y, p), at two seeded points."""
    jm, tm = jdsl.compile_diffsl(SOURCES[name]), tdsl.compile_diffsl(SOURCES[name])
    jf, tf = jm.make_callables(), tm.make_callables()
    assert sorted(jf) == sorted(tf)
    for seed in (0, 1):
        t, y, p = _point(jm, jf, seed)
        jt, jy, jp = jnp.asarray(t), jnp.asarray(y), jnp.asarray(p)
        tt, ty, tp = torch.tensor(t, dtype=F64), torch.tensor(y), torch.tensor(p)
        _close(tf["init"](tt, tp), jf["init"](jt, jp), "init")
        _close(tf["rhs"](tt, ty, tp), jf["rhs"](jt, jy, jp), "rhs")
        if "mass" in jf:
            _close(tf["mass"](tt, tp), jf["mass"](jt, jp), "mass")
        for key in ("root", "out", "reset"):
            if key in jf:
                _close(tf[key](tt, ty, tp), jf[key](jt, jy, jp), key)
        if "reset_n" in jf:
            for k in (0, 1):
                _close(tf["reset_n"](tt, ty, tp, k), jf["reset_n"](jt, jy, jp, k),
                       f"reset_n k={k}")


def test_callables_compose_with_vmap_and_jacfwd():
    """The port's callables act on a member batch through vmap (the lockstep
    ensemble) and differentiate through jacfwd, the hidden index and the
    dynamic index r_i[N] included."""
    for name in ("robertson", "foodweb", "multi_model"):
        tm = tdsl.compile_diffsl(SOURCES[name])
        fns = tm.make_callables()
        p = torch.tensor(tm.default_params)
        y = fns["init"](torch.tensor(0.0, dtype=F64), p) + 0.25
        if tm.uses_n:
            y[-1] = 2.0
        ys = torch.stack([y, 1.5 * y])
        ps = torch.stack([p, p])
        t = torch.tensor(0.3, dtype=F64)
        batched = torch.func.vmap(fns["rhs"], in_dims=(None, 0, 0))(t, ys, ps)
        for b in range(2):
            torch.testing.assert_close(batched[b], fns["rhs"](t, ys[b], ps[b]), rtol=1e-14,
                                       atol=0.0)
        J = torch.func.jacfwd(fns["rhs"], argnums=1)(t, y, p)
        eps = 1e-7
        for c in range(y.shape[0] - int(tm.uses_n)):
            e = torch.zeros_like(y)
            e[c] = eps
            fd = (fns["rhs"](t, y + e, p) - fns["rhs"](t, y - e, p)) / (2 * eps)
            torch.testing.assert_close(J[:, c], fd, rtol=1e-5, atol=1e-6 * float(J.abs().max()))
    # r_i[N] picks the sub-model N (reference diffsl.rs:2030-2080)
    fns = tdsl.compile_diffsl(MULTI_MODEL).make_callables()
    for m, rate in ((0, 1.0), (1, 2.0), (2, 4.0), (7, 4.0), (-1, 1.0)):
        f = fns["rhs"](torch.tensor(0.0, dtype=F64), torch.tensor([0.1, float(m)], dtype=F64),
                       torch.zeros(0, dtype=F64))
        assert float(f[0]) == pytest.approx(rate * 0.1, rel=1e-12)
        assert float(f[1]) == 0.0


# ---------------------------------------------------------------------------
# the builder, errors, contraction rules, serialization
# ---------------------------------------------------------------------------

def test_errors():
    """tests/test_diffsl.py::test_errors and ::test_wrong_param_count_rejected
    in the port."""
    with pytest.raises(tdsl.DiffslError, match="needs `u`"):
        tdsl.compile_diffsl("F { 1.0 }")
    with pytest.raises(tdsl.DiffslError, match="undefined"):
        p = dtt.OdeBuilder().build_from_diffsl("u { 1.0 }\nF { -q * u }")
        p.eqn.rhs(torch.tensor(0.0, dtype=F64), torch.ones(1, dtype=F64), p.params)
    assert tdsl.compile_diffsl(ERRORS_N).uses_n
    with pytest.raises(tdsl.DiffslError, match="unexpected character"):
        tdsl.compile_diffsl("u { 1.0 }\nF { u @ 2 }")
    with pytest.raises(tdsl.DiffslError, match="unknown function"):
        p = dtt.OdeBuilder().build_from_diffsl("u { 1.0 }\nF { erf(u) }")
        p.eqn.rhs(torch.tensor(0.0, dtype=F64), torch.ones(1, dtype=F64), p.params)
    with pytest.raises(ValueError, match="2 inputs"):
        dtt.OdeBuilder().p([5.0]).build_from_diffsl(PARAM_COUNT)
    with pytest.raises(ValueError, match="2 inputs"):
        dtt.OdeBuilder().p([5.0, 1.0, 2.0]).build_from_diffsl(PARAM_COUNT)
    problem = dtt.OdeBuilder().p([5.0, 1.0]).build_from_diffsl(PARAM_COUNT)
    np.testing.assert_array_equal(problem.params.numpy(), [5.0, 1.0])
    np.testing.assert_array_equal(dtt.OdeBuilder().build_from_diffsl(LOGISTIC).params.numpy(),
                                  [1.0, 1.0])


def test_contraction_rules():
    """Per product term (tests/test_diffsl.py::test_contraction_per_product_term),
    elementwise inside function arguments (::test_contraction_inside_function_
    argument) and the ';' separator (::test_semicolon_element_separator)."""
    t0, none = torch.tensor(0.0, dtype=F64), torch.zeros(0, dtype=F64)
    p = dtt.OdeBuilder().build_from_diffsl(CONTRACTION)
    y0 = p.eqn.init(t0, p.params)
    np.testing.assert_array_equal(p.eqn.rhs(t0, y0, p.params).numpy(), [19.0, 43.0])
    np.testing.assert_array_equal(p.eqn.out(t0, y0, p.params).numpy(), [2.0])
    p2 = dtt.OdeBuilder().build_from_diffsl(CONTRACTION_DIV)
    np.testing.assert_array_equal(
        p2.eqn.rhs(t0, p2.eqn.init(t0, p2.params), p2.params).numpy(), [1.5, 3.5])
    A = np.array([[1.0, 2.0], [0.5, 0.25]])
    y = torch.tensor([0.3, 0.7], dtype=F64)
    out = tdsl.compile_diffsl(FN_ARG_EXP).make_callables()["out"](t0, y, none)
    np.testing.assert_allclose(out.numpy(), np.exp(A * y.numpy()[None, :]).sum(axis=1),
                               rtol=1e-12)
    out2 = tdsl.compile_diffsl(FN_ARG_MATVEC).make_callables()["out"](t0, y, none)
    np.testing.assert_allclose(out2.numpy(), A @ np.exp(y.numpy()), rtol=1e-12)
    fns = tdsl.compile_diffsl(SEMICOLON).make_callables()
    np.testing.assert_array_equal(fns["init"](t0, none).numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(
        fns["rhs"](t0, torch.tensor([1.0, 2.0], dtype=F64), none).numpy(), [-1.0, -4.0])


def test_serialization_across_packages():
    """JSON that the JAX package's serialize() wrote loads in the port, and
    the reverse; the format string is the JAX package's."""
    for src in (ROBERTSON, MODEL_INDEX):
        jm, tm = jdsl.compile_diffsl(src), tdsl.compile_diffsl(src)
        assert json.loads(tm.serialize()) == json.loads(jm.serialize())
        assert json.loads(tm.serialize())["format"] == "diffsol_tpu.diffsl.v1"
        from_jax = tdsl.DiffslModel.deserialize(jm.serialize())
        from_port = jdsl.DiffslModel.deserialize(tm.serialize())
        np.testing.assert_array_equal(from_jax.default_params, jm.default_params)
        assert from_jax.nstates == jm.nstates and from_port.nstates == tm.nstates
        p = torch.tensor(from_jax.default_params)
        y0 = from_jax.make_callables()["init"](torch.tensor(0.0, dtype=F64), p)
        np.testing.assert_array_equal(
            y0.numpy(), np.asarray(from_port.make_callables()["init"](
                jnp.asarray(0.0), jnp.asarray(from_port.default_params))))
    with pytest.raises(tdsl.DiffslError, match="unknown serialization"):
        tdsl.DiffslModel.deserialize(json.dumps({"format": "other", "source": LOGISTIC}))


def test_build_from_eqn_reuses_the_compiled_model():
    """One compiled model, several problems with their own settings
    (reference builder.rs build_from_eqn); the problem keeps its model."""
    m = tdsl.compile_diffsl(LOGISTIC)
    p1 = dtt.OdeBuilder().rtol(1e-6).p([1.0, 10.0]).build_from_eqn(m)
    p2 = dtt.OdeBuilder().rtol(1e-9).atol(1e-11).build_from_eqn(m)
    assert float(p1.rtol) == 1e-6 and float(p2.rtol) == 1e-9
    np.testing.assert_array_equal(p2.params.numpy(), [1.0, 1.0])
    assert p1.diffsl_model is m and p2.diffsl_model is m
    assert p1.to("cpu").diffsl_model is m
    s1 = dtt.solve_dense(dtt.BdfSolver(p1), [0.4], max_steps=1000, device="cpu")
    r, k, y0 = 1.0, 10.0, 0.1
    expect = k * y0 * np.exp(r * 0.4) / (k + y0 * (np.exp(r * 0.4) - 1.0))
    assert s1.stop_reason >= 0
    np.testing.assert_allclose(float(s1.ys[0, 0]), expect, rtol=1e-5)
    jp = JaxBuilder().rtol(1e-6).p([1.0, 10.0]).build_from_eqn(jdsl.compile_diffsl(LOGISTIC))
    np.testing.assert_array_equal(p1.params.numpy(), np.asarray(jp.params))


def test_index_aware_reset_on_the_builder():
    """The N model's problem carries reset_n and the hidden state; the
    builder's own .reset_n(...) sets one for closure-built problems."""
    problem = dtt.OdeBuilder().build_from_diffsl(MODEL_INDEX)
    assert problem.eqn.reset_n is not None and problem.eqn.nstates == 2
    t = torch.tensor(0.5, dtype=F64)
    y = torch.tensor([0.7, 0.0], dtype=F64)
    np.testing.assert_allclose(problem.eqn.reset_n(t, y, problem.params, 1).numpy(),
                               [0.6, 1.0], rtol=1e-15)
    np.testing.assert_array_equal(problem.eqn.reset(t, y, problem.params).numpy(),
                                  [0.1, 0.0])
    closure = (dtt.OdeBuilder().rhs(lambda t, y, p: -y)
               .init(lambda t, p: torch.ones(1, dtype=F64))
               .root(lambda t, y, p: y - 0.5).reset(lambda t, y, p: y + 1.0)
               .reset_n(lambda t, y, p, k: y + 1.0 + k).build())
    assert closure.eqn.reset_n is not None


# ---------------------------------------------------------------------------
# the kernels' view: traced IR of DiffSL models
# ---------------------------------------------------------------------------

def _points(n, np_, seed, B=5):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(0.0, 1.0, B), dtype=F64),
            torch.tensor(rng.uniform(0.2, 1.2, (B, n))),
            torch.tensor(rng.uniform(0.5, 1.5, (B, np_))))


def test_robertson_ir_is_the_hand_written_models():
    """The DiffSL Robertson ODE rhs traces to the hand-written model's IR
    node for node (the same op_count, 10); the DAE's to 13 operations; both
    evaluate like their callables, and the IR's dual-number Jacobian equals
    torch.func.jacfwd."""
    fns = tdsl.compile_diffsl(diffsl_sources.robertson_ode()).make_callables()
    ir = cg.trace_ir(fns["rhs"], ("t", "y", "p"), (None, 3, 3))
    hand = cg.trace_ir(robertson.rhs_ode, ("t", "y", "p"), (None, 3, 3))
    assert ir == hand and cg.op_count(ir) == 10
    dae = tdsl.compile_diffsl(ROBERTSON).make_callables()["rhs"]
    dae_ir = cg.trace_ir(dae, ("t", "y", "p"), (None, 3, 3))
    assert cg.op_count(dae_ir) == 13
    t, y, p = _points(3, 3, 7)
    p = p * torch.tensor([0.04, 1e4, 3e7], dtype=F64)
    for fn, model_ir in ((fns["rhs"], ir), (dae, dae_ir)):
        want = torch.func.vmap(fn)(t, y, p)
        torch.testing.assert_close(cg.eval_rhs(model_ir, t, y, p), want, rtol=1e-14,
                                   atol=1e-14 * float(want.abs().max()))
        jac = torch.func.vmap(torch.func.jacfwd(fn, argnums=1))(t, y, p)
        torch.testing.assert_close(cg.jacobian(model_ir, t, y, p), jac, rtol=1e-14,
                                   atol=1e-14 * float(jac.abs().max()))


@pytest.mark.parametrize("mgrid", [12, 127])
def test_heat1d_ir_folds_to_the_band(mgrid):
    """The DiffSL heat1d rhs D * A_ij * u_j / (h * h) traces through an
    (n, n) contraction whose products by a literal 0 fold away: 3n - 2
    operations of the tridiagonal mat-vec, 2 of the scale D / h / h and n
    of scaling the rows, 4n in all (n^2 products unfolded), and the IR
    evaluates like the callable with the callable's Jacobian."""
    n = mgrid + 1
    fn = tdsl.compile_diffsl(diffsl_sources.heat1d(mgrid)).make_callables()["rhs"]
    ir = cg.trace_ir(fn, ("t", "y", "p"), (None, n, 1))
    assert cg.op_count(ir) == 4 * n
    t, y, p = _points(n, 1, 3)
    want = torch.func.vmap(fn)(t, y, p)
    torch.testing.assert_close(cg.eval_rhs(ir, t, y, p), want, rtol=1e-13,
                               atol=1e-13 * float(want.abs().max()))
    if mgrid == 12:
        jac = torch.func.vmap(torch.func.jacfwd(fn, argnums=1))(t, y, p)
        torch.testing.assert_close(cg.jacobian(ir, t, y, p), jac, rtol=1e-13,
                                   atol=1e-13 * float(jac.abs().max()))


def test_heat2d_source_matches_the_reference_matrices():
    """diffsl_sources.heat2d at mgrid = 4 folds to the D and Mass matrices
    of tests/test_diffsl.py::test_heat2d_style_matrix_mass_action; its mass
    is that matrix, and its state the hand-written heat2d's."""
    from diffsol_tpu_torch.models import heat2d

    m = tdsl.compile_diffsl(diffsl_sources.heat2d(4))
    Dm, Mass, _dx2 = heat2d_matrices(4)
    np.testing.assert_array_equal(m.constants["D"][0], Dm)
    np.testing.assert_array_equal(m.constants["Mass"][0], Mass)
    fns = m.make_callables()
    none = torch.zeros(0, dtype=F64)
    t0 = torch.tensor(0.0, dtype=F64)
    np.testing.assert_array_equal(fns["mass"](t0, none).numpy(), Mass)
    hand = heat2d.callables(4)
    np.testing.assert_array_equal(fns["init"](t0, none).numpy(),
                                  hand["init"](t0, torch.ones(1, dtype=F64)).numpy())


# ---------------------------------------------------------------------------
# the codegen's abs, maximum, minimum and sign against DualAlgebra
# ---------------------------------------------------------------------------

class _F64:
    """A float64 numpy base algebra for JAX's DualAlgebra."""

    def const(self, v, like=None):
        return np.full_like(like, v) if like is not None else np.float64(v)

    def hi(self, x):
        return x

    def neg(self, x):
        return -x

    def lt(self, x, y):
        return x < y

    def le(self, x, y):
        return x <= y

    def ge(self, x, y):
        return x >= y

    def where(self, m, x, y):
        return np.where(m, x, y)

    def sign(self, x):
        return np.sign(x)

    def zeros_like(self, x):
        return np.zeros_like(x)


_MINMAX_FNS = {
    "abs": lambda t, y, p: torch.abs(y),
    "sign": lambda t, y, p: torch.sign(y),
    "maximum": lambda t, y, p: torch.maximum(y, y.flip(0)),
    "minimum": lambda t, y, p: torch.minimum(y, y.flip(0)),
}


def _dual_rule(name, x, dx):
    """DualAlgebra's value and tangent of the case ``name`` at x with
    tangent dx, as (B, 3) numpy arrays."""
    alg = DualAlgebra(_F64())
    a = (x, dx)
    if name == "abs":
        return alg.abs_(a)
    if name == "sign":
        return alg.sign(a)
    b = (x[:, ::-1], dx[:, ::-1])
    return alg.maximum(a, b) if name == "maximum" else alg.minimum(a, b)


@pytest.mark.parametrize("name", sorted(_MINMAX_FNS))
def test_abs_sign_max_min_follow_dual_algebra(name):
    """Each traced op's IR against the callable (values) and against JAX's
    DualAlgebra rule (values and every Jacobian column) on numpy-seeded
    points with zeros and ties: abs's tangent at x = 0 is +dx (torch's
    derivative gives 0 there), maximum and minimum take the first
    operand's tangent on a tie, sign has none."""
    rng = np.random.default_rng(5)
    y = rng.uniform(-1.0, 1.0, (6, 3))
    y[0] = [0.0, -0.5, 0.0]  # zeros; max/min tie between y0 and y2
    y[1] = [0.25, 0.0, 0.25]  # a tie at a positive value
    y[2] = [-0.0, 0.3, 0.7]
    yt = torch.tensor(y)
    p = torch.ones(6, 1, dtype=F64)
    t = torch.zeros(6, dtype=F64)
    fn = _MINMAX_FNS[name]
    ir = cg.trace_ir(fn, ("t", "y", "p"), (None, 3, 1))
    assert {node[0] for node in ir.nodes} & {"abs", "sign", "maximum", "minimum"}
    want = torch.func.vmap(fn)(t, yt, p)
    torch.testing.assert_close(cg.eval_rhs(ir, t, yt, p), want, rtol=0.0, atol=0.0)
    jac = cg.jacobian(ir, t, yt, p).numpy()
    for c in range(3):
        seed = np.zeros_like(y)
        seed[:, c] = 1.0
        v, d = _dual_rule(name, y, seed)
        np.testing.assert_array_equal(want.numpy(), v)
        np.testing.assert_array_equal(jac[:, :, c], d)
    if name == "abs":
        assert jac[0, 0, 0] == 1.0  # +dx at x = 0
    src = cg.emit_cuda_header(cg.ModelIR(rhs=ir, init=None, nstates=3, nparams=1))
    assert f"dsol_{name}(" in src


def test_literal_zero_and_one_fold():
    """x*0 -> 0, 0/x -> 0, 0+x -> x, x*1 -> x, x/1 -> x, x-0 -> x; a
    subtraction from 0 and a division by 0 stay."""
    def fn(t, y, p):
        z = torch.zeros_like(y)
        one = torch.ones_like(y)
        return torch.stack([y[0] * z[0] + y[1] * one[1], z[1] / y[2] + y[2] / one[0],
                            (y[0] - z[0]) + (z[2] - y[1]), y[1] / z[0]])

    ir = cg.trace_ir(fn, ("t", "y", "p"), (None, 3, 1))
    ops = [node[0] for node in ir.nodes if node[0] not in ("t", "y", "p", "c")]
    assert sorted(ops) == ["add", "div", "sub"]
    t, y, p = _points(3, 1, 9)
    with np.errstate(divide="ignore"):
        torch.testing.assert_close(cg.eval_rhs(ir, t, y, p), torch.func.vmap(fn)(t, y, p))
