"""The port's examples (``diffsol_tpu_torch/examples/``) on the CPU, and
``drivers.init_state``.

Every example runs through its ``main(device="cpu", ...)`` and its own
assertions, at its default size where that is cheap here and else at a
small one (the kernel examples at a few members, the fitting examples at
one or two iterations, the staged solves at a few events); the full sizes
run on the card (``scripts/torch_examples_card.py``, ``chip_smoke.py``
phase 29).  Without ``device`` an example runs on the card and raises
where there is none.  No module of the port, the examples included,
imports JAX or the JAX package.
"""

import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import diffsol_tpu_torch as dtt
from diffsol_tpu_torch import drivers, examples
from diffsol_tpu_torch.models import robertson

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# (example, keyword arguments of its CPU run): its default size unless
# named here
CPU_RUNS = {
    "robertson_ensemble": dict(nbatch=4),
    "heat1d_band_ensemble": dict(nbatch=4),
    "pde_heat": {},
    "electrical_circuit": {},
    "custom_ode_equations": {},
    "bouncing_ball": {},
    "spring_mass": {},
    "sir_policy_switching": {},
    "lorenz_attractor": {},
    "population_dynamics": {},
    "drug_delivery": {},
    "solver_comparison": {},
    "solver_events_performance": dict(num_events=6),
    "lid_driven_cavity_stokes": {},
    "predator_prey_fitting": dict(iterations=1),
    "mass_spring_fitting_adjoint": dict(iterations=1),
    "neural_ode": dict(iterations=2),
    "diffsl_logistic_fit": dict(iterations=1),
    "mass_spring_fitting_ensemble": dict(nbatch=8, iterations=1),
}


def _example(name):
    return importlib.import_module(f"diffsol_tpu_torch.examples.{name}")


def test_every_jax_example_but_battery_spm_has_its_port():
    jax_names = {p.stem for p in (ROOT / "examples").glob("*.py")}
    ported = {"robertson_ensemble_tpu" if n == "robertson_ensemble" else n
              for n in examples.NAMES}
    assert jax_names - ported == {"battery_spm"}
    assert set(CPU_RUNS) == set(examples.NAMES)
    for name in examples.NAMES:
        assert (ROOT / "diffsol_tpu_torch" / "examples" / f"{name}.py").is_file()


@pytest.mark.parametrize("name", examples.NAMES)
def test_example_runs_on_the_cpu(name):
    out = _example(name).main(device="cpu", **CPU_RUNS[name])
    assert isinstance(out, dict) and out
    losses = out.get("losses", out.get("residuals"))
    if losses is not None:
        # every fitting example's loss falls from its first iteration to
        # its fitted parameters'
        assert losses[-1] < losses[0], losses
    if "tier" in out:
        assert out["tier"].endswith("_reference")  # the kernel's plain version


def test_examples_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for name in ("bouncing_ball", "pde_heat", "robertson_ensemble"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _example(name).main()


def test_examples_import_neither_jax_nor_the_jax_package():
    """Every module of the port, the examples included, in a fresh
    interpreter: neither ``jax`` nor ``diffsol_tpu`` is loaded after."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffsol_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'diffsol_tpu' or m.startswith('diffsol_tpu.'))\n"
        "assert any(n.endswith('examples.neural_ode') for n in names), names\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) > 60


def test_init_state_lies_on_the_requested_device():
    solver = dtt.BdfSolver(robertson.problem_ode())
    state = drivers.init_state(solver, device="cpu")
    assert state.y.device.type == "cpu" and state.t == 0.0
    torch.testing.assert_close(state.y, torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64))
    # other params: the state starts from them
    p = torch.tensor([0.05, 1e4, 3e7], dtype=torch.float64)
    other = drivers.init_state(solver, params=p, device="cpu")
    assert other.h != state.h
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            drivers.init_state(solver)


@pytest.mark.parametrize("method", ["bdf", "tr_bdf2", "tsit45"])
def test_staged_solve_from_init_state_equals_a_plain_solve(method):
    solver = dtt.solver(robertson.problem_ode(), method)
    plain = dtt.solve(solver, 0.4, device="cpu")
    staged = dtt.solve(solver, 0.4, state=drivers.init_state(solver, device="cpu"),
                       device="cpu")
    assert staged.n_points == plain.n_points
    assert torch.equal(staged.ys, plain.ys)
    assert dataclasses.asdict(staged.state.stats) == dataclasses.asdict(plain.state.stats)
    # two stages: the state handed on, then the rest
    first = dtt.solve(solver, 0.2, state=drivers.init_state(solver, device="cpu"),
                      device="cpu")
    second = dtt.solve(solver, 0.4, state=first.state, device="cpu")
    np.testing.assert_allclose(second.state.y.numpy(), plain.state.y.numpy(),
                               rtol=1e-3, atol=1e-6)


def test_a_modified_state_restarts_the_solve():
    """The staged protocol of drug_delivery: a dose added to a state from
    init_state gives the solve from the dosed initial condition."""
    from diffsol_tpu_torch.examples import drug_delivery

    problem = dtt.OdeBuilder().rtol(1e-8).atol(1e-10).build_from_diffsl(drug_delivery.DIFFSL)
    solver = dtt.BdfSolver(problem)
    state = drug_delivery.dosed(drivers.init_state(solver, device="cpu"), 1000.0)
    assert state.state_modified and float(state.y[0]) == 1000.0
    got = dtt.solve(solver, 6.0, state=state, device="cpu")
    # the same model started at the dose: y(6) of the linear system
    CL, Qp1, V = 100.0, 50.0, 1000.0
    A = np.array([[-(CL + Qp1) / V, Qp1 / V], [Qp1 / V, -Qp1 / V]])
    from scipy.linalg import expm

    want = expm(A * 6.0) @ np.array([1000.0, 0.0])
    np.testing.assert_allclose(got.state.y.numpy(), want, rtol=1e-6)
