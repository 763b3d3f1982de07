"""The port's examples against the JAX package's, on the CPU.

Each JAX example's ``main()`` runs in-process (JAX on the CPU, as
tests/conftest.py sets it) with its output captured; the numbers it
prints are held to the numbers the port's example returns.  The tolerance
is half a unit in the last printed digit (a float printed as ``0.8410``
is matched within 5e-5, ``1.20e-05`` within 5e-8).  Step, point and rhs
counts are equal, except after reset events, where the float32 root and
controller arithmetic of the JAX side and the port's float64 part by up
to 3 steps (tests/test_torch_events.py, ROADMAP queue 3 "Not faults").

``lorenz_attractor`` is not compared: the system is chaotic, and two
correct solvers part after a few Lyapunov times, so only its own checks
(both wings visited, bounded) hold, in tests/test_torch_examples.py.

Also: ``torch.optim.Adam`` takes the steps of ``optax.adam`` on the same
gradients (the port's fitting examples use the one where the JAX
examples use the other).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NUM = r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?"
RESET_STEP_SLACK = 3


def _jax_main(name, capsys):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _torch_main(name):
    mod = importlib.import_module(f"diffsol_tpu_torch.examples.{name}")
    return mod.main(device="cpu")


def _half_unit(text: str) -> float:
    """Half a unit in the last digit of a printed number."""
    mant, _, exp = text.lower().partition("e")
    decimals = len(mant.partition(".")[2])
    return 0.5 * 10.0 ** (-decimals) * 10.0 ** (int(exp) if exp else 0)


def _close(got, text, what):
    """``got`` within half a unit of the last digit of ``text`` (and a
    relative 1e-12 for the rounding of the bound itself)."""
    want = float(text)
    assert abs(float(got) - want) <= _half_unit(text) * (1 + 1e-9) + 1e-12 * abs(want), (
        what, got, text)


def _find(pattern, out):
    m = re.search(pattern, out)
    assert m, (pattern, out)
    return m.groups()



def test_bouncing_ball(capsys):
    out = _jax_main("bouncing_ball", capsys)
    t, n, bounces, height = _find(rf"t=({NUM}) with (\d+) points, (\d+) bounces, "
                                  rf"final height ({NUM})", out)
    got = _torch_main("bouncing_ball")
    _close(got["t_final"], t, "t_final")
    assert abs(got["n_points"] - int(n)) <= RESET_STEP_SLACK  # three resets
    assert got["bounces"] == int(bounces)
    _close(got["final_height"], height, "final height")


def test_spring_mass(capsys):
    out = _jax_main("spring_mass", capsys)
    t, exact, x = _find(rf"at t=({NUM}) \(exact ({NUM})\), x=({NUM})", out)
    got = _torch_main("spring_mass")
    _close(got["t_extremum"], t, "t")
    _close(got["t_exact"], exact, "exact")
    _close(got["x_extremum"], x, "x")


def test_electrical_circuit(capsys):
    out = _jax_main("electrical_circuit", capsys)
    (v,) = _find(rf"charges to ({NUM}) V", out)
    _close(_torch_main("electrical_circuit")["v_final"], v, "v_c")


def test_custom_ode_equations(capsys):
    out = _jax_main("custom_ode_equations", capsys)
    t, analytic = _find(rf"found at t=({NUM}) \(analytic ({NUM})\)", out)
    got = _torch_main("custom_ode_equations")
    _close(got["t_root"], t, "root time")
    _close(got["t_expect"], analytic, "analytic")


def test_sir_policy_switching(capsys):
    out = _jax_main("sir_policy_switching", capsys)
    peak, switches, rec = _find(rf"peak infections ({NUM}) .*?, (\d+) policy switches, "
                                rf"final recovered ({NUM})", out)
    got = _torch_main("sir_policy_switching")
    _close(got["peak"], peak, "peak")
    assert got["switches"] == int(switches)
    _close(got["recovered"], rec, "recovered")


def test_pde_heat(capsys):
    out = _jax_main("pde_heat", capsys)
    n, steps, err = _find(rf"(\d+)-point MOL heat solve on the banded tier: (\d+) steps, "
                          rf"max error ({NUM})", out)
    got = _torch_main("pde_heat")
    assert got["n"] == int(n) and got["steps"] == int(steps)
    _close(got["max_error"], err, "max error")


def test_population_dynamics(capsys):
    out = _jax_main("population_dynamics", capsys)
    n1, a1, b1 = _find(rf"DiffSL build: (\d+) steps to t=40, final \(prey, predator\) = "
                       rf"\[\s*({NUM})\s+({NUM})\s*\]", out)
    n2, a2, b2 = _find(rf"closure build \(tsit45\): (\d+) steps, final = "
                       rf"\[\s*({NUM})\s+({NUM})\s*\]", out)
    orbits, lo, hi = _find(rf"ensemble: (\d+) orbits, prey range \[({NUM}), ({NUM})\]", out)
    got = _torch_main("population_dynamics")
    assert got["diffsl_steps"] == int(n1) and got["closure_steps"] == int(n2)
    for v, text in zip(got["diffsl_final"] + got["closure_final"], (a1, b1, a2, b2)):
        _close(v, text, "final populations")
    assert got["orbits"] == int(orbits)
    _close(got["prey_min"], lo, "prey min")
    _close(got["prey_max"], hi, "prey max")


def test_solver_comparison(capsys):
    out = _jax_main("solver_comparison", capsys)
    rows = re.findall(rf"(\w+)\s+(\w+)\s+{NUM} ms\s+steps=\s*(\d+)\s+etf=\s*(\d+)\s+"
                      rf"rhs=\s*(\d+)\s+y\(T\)=({NUM})", out)
    assert len(rows) == 7, out
    got = _torch_main("solver_comparison")["rows"]
    for (problem, method, steps, etf, rhs, y), g in zip(rows, got):
        assert (g["problem"], g["method"]) == (problem, method)
        assert (g["steps"], g["error_test_failures"], g["rhs_evals"]) == (
            int(steps), int(etf), int(rhs)), (problem, method)
        _close(g["y_end"], y, f"{problem} {method} y(T)")


def test_torch_adam_takes_optax_adams_steps():
    """torch.optim.Adam(lr) and optax.adam(lr) on one gradient sequence:
    bias-corrected moments, eps outside the square root, equal steps."""
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    grads = rng.normal(size=(50, 2, 3)) * np.logspace(-3, 1, 50)[:, None, None]
    p0 = rng.normal(size=(2, 3))
    for lr in (0.1, 5e-2):
        opt = optax.adam(lr)
        pj = jnp.asarray(p0)
        state = opt.init(pj)
        pt = torch.tensor(p0, requires_grad=True)
        topt = torch.optim.Adam([pt], lr=lr)
        for g in grads:
            upd, state = opt.update(jnp.asarray(g), state)
            pj = optax.apply_updates(pj, upd)
            pt.grad = torch.tensor(g)
            topt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-12,
                                   atol=1e-14)
