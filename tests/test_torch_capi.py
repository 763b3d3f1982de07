"""The port's C ABI: ``libdiffsol_tpu_torch.so`` (diffsol_tpu_torch/
native/capi.cpp, embedded CPython driving diffsol_tpu_torch.capi_host)
and the port's copy of the pure-C consumer, built with g++/gcc and run
on the CPU; the host functions against the JAX package's host on the
same DiffSL text; the device rule of ``DIFFSOL_PLATFORM``; and the
consumer's difference from native/test_capi.c.
"""

import difflib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from diffsol_tpu import capi_host as jhost

from diffsol_tpu_torch import _build
from diffsol_tpu_torch import capi_host as thost

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# native/test_capi.c's logistic model
LOGISTIC = (
    "in_i { r = 1.0, k = 1.0 }\n"
    "u { 0.1 }\n"
    "F { r * u * (1.0 - u / k) }\n"
)
NO_COMPILER = shutil.which("g++") is None or shutil.which("gcc") is None


def _run_consumer(platform, **extra_env):
    built = _build.build_capi()
    env = _build.capi_env(platform)
    env.update(extra_env)
    return subprocess.run([str(built["consumer"])], env=env, cwd=built["dir"],
                          capture_output=True, text=True, timeout=600)


@pytest.mark.skipif(NO_COMPILER, reason="no g++/gcc")
def test_c_abi_end_to_end_cpu():
    """The port's C consumer, every check of native/test_capi.c, against
    libdiffsol_tpu_torch.so on the CPU."""
    res = _run_consumer("cpu")
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr}"
    assert "ALL CHECKS PASSED" in res.stdout


@pytest.mark.skipif(NO_COMPILER, reason="no g++/gcc")
def test_c_abi_without_a_card_fails_loudly():
    """Without DIFFSOL_PLATFORM the library solves on the card; with none
    visible the first handle call fails with a last-error message that
    says so, and nothing is solved on the CPU.  In-process too."""
    res = _run_consumer(None, CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "FAIL: new_jit(logistic)" in res.stderr
    assert "no CUDA device is available" in res.stderr
    assert "ALL CHECKS PASSED" not in res.stdout


def test_host_device_rule(monkeypatch):
    monkeypatch.delenv("DIFFSOL_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="DIFFSOL_PLATFORM=cpu"):
        thost.new_jit(LOGISTIC)
    monkeypatch.setenv("DIFFSOL_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="not a platform of this build"):
        thost.new_jit(LOGISTIC)
    monkeypatch.setenv("DIFFSOL_PLATFORM", "cpu")
    h = thost.new_jit(LOGISTIC)
    assert thost._get(h).problem().params.device.type == "cpu"
    thost.free(h)


def test_host_matches_jax_host(monkeypatch):
    """solve_dense, solve_fwd_sens and get_matrix_type of the port's host
    against the JAX host on native/test_capi.c's logistic text (its
    settings); a krylov problem reports matrix_free on both."""
    monkeypatch.setenv("DIFFSOL_PLATFORM", "cpu")
    te = [0.1, 0.25, 0.4]
    out = {}
    for name, host in (("jax", jhost), ("port", thost)):
        h = host.new_jit(LOGISTIC)
        host.set_rtol(h, 1e-8)
        host.set_atol(h, 1e-10)
        host.set_params(h, [1.0, 10.0])
        ys, stop = host.solve_dense(h, te, 2000)
        ys2, sens, stop2 = host.solve_fwd_sens(h, te)
        assert stop >= 0 and stop2 == 0
        assert host.get_matrix_type(h) == 0
        assert host.type_name("matrix", 3) == "matrix_free"
        with pytest.raises(ValueError, match="klu is a CPU/SuiteSparse solver"):
            host.set_linear_solver(h, 2)
        out[name] = (np.asarray(ys), np.asarray(ys2), np.asarray(sens))
        host.free(h)
    r, k, v0 = 1.0, 10.0, 0.1
    t = np.asarray(te)
    exact = k * v0 * np.exp(r * t) / (k + v0 * (np.exp(r * t) - 1.0))
    np.testing.assert_allclose(out["port"][0], exact, atol=1e-6)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-8)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=1e-8)
    # forward mode along the port's frozen step sequence against JAX's
    # jacfwd, which also carries dh/dp (ROADMAP queue 3, not a fault):
    # 2.2e-9 apart here
    np.testing.assert_allclose(out["port"][2], out["jax"][2], rtol=1e-7, atol=1e-12)
    # a matrix-free problem on either host
    import jax.numpy as jnp

    import diffsol_tpu as dt
    import diffsol_tpu_torch as dtt

    for host, problem in (
        (jhost, dt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y)
         .init(lambda t, p: jnp.ones(3)).p([0.5]).linear_solver("krylov").build()),
        (thost, dtt.OdeBuilder().rhs(lambda t, y, p: -p[0] * y)
         .init(lambda t, p: torch.ones(3, dtype=torch.float64)).p([0.5])
         .linear_solver("krylov").build()),
    ):
        h = host.new_jit(LOGISTIC)
        host._get(h)._problem = problem
        assert host.get_matrix_type(h) == 3
        host.free(h)


def test_consumer_differs_from_the_jax_consumer_only_where_it_must():
    """The port's native/test_capi.c is native/test_capi.c with every check
    kept: it differs in the comment naming the library it links and in
    the external model it writes (torch in place of jax.numpy, in the
    working directory)."""
    with open(os.path.join(REPO, "native", "test_capi.c")) as f:
        jax_c = f.read().splitlines()
    with open(os.path.join(REPO, "diffsol_tpu_torch", "native", "test_capi.c")) as f:
        port_c = f.read().splitlines()
    removed = [ln for ln in difflib.ndiff(jax_c, port_c) if ln.startswith("- ")]
    added = [ln for ln in difflib.ndiff(jax_c, port_c) if ln.startswith("+ ")]
    assert [ln[2:] for ln in removed] == [
        "/* End-to-end C consumer of the diffsol_tpu C ABI (role of the reference's",
        '        const char *ext_path = "/tmp/diffsol_capi_ext_model.py";',
        '        fputs("import jax.numpy as jnp\\n"',
        '              "    return jnp.ones(1)\\n",',
    ]
    assert [ln[2:] for ln in added] == [
        "/* End-to-end C consumer of the diffsol_tpu_torch C ABI, linked against",
        " * libdiffsol_tpu_torch.so (role of the reference's",
        '        const char *ext_path = "diffsol_capi_ext_model.py";',
        '        fputs("import torch\\n"',
        '              "    return torch.ones(1, dtype=p.dtype, device=p.device)\\n",',
    ]
    assert sum("CHECK(" in ln for ln in port_c) == sum("CHECK(" in ln for ln in jax_c)
