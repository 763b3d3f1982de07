"""Build the CUDA kernels with ``nvcc`` at first use and load them with
``ctypes``.

Each kernel library is a shared library with plain C entry points (no
PyTorch headers, so a build takes seconds).  Its sources are the
repository's ``csrc/`` files plus, for the fused steppers, the model
header generated for the problem's equations; the library lands in
``build/diffsol_tpu_torch/`` beside the package, named by a hash of
everything that went into it, so a second process or a second solve of the
same model reuses it.  ``nvcc -Xptxas -v`` reports each kernel's registers
and spill bytes; :data:`BUILDS` records them with the build time.

The libraries:

* ``fused_bdf`` (K1): ``fused_bdf.cuh`` with a model header;
* ``band_lu`` (K3, K4): ``band_lu.cuh``, no model header, the double and
  the float build of each kernel in one library;
* ``fused_band_bdf`` (K2): ``fused_band_bdf.cuh`` with a model header and
  the band widths.

* ``coloring``: ``coloring.cpp``, host code built with ``g++`` (the greedy
  colorer of :mod:`.ops.coloring`).

The loaders may run in several threads at once, one compiler each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "diffsol_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_COMMON = ("bdf_common.cuh", "dual.cuh")
_SOURCES = {
    "fused_bdf": _COMMON + ("fused_bdf.cuh",),
    "band_lu": ("bdf_common.cuh", "band_lu.cuh"),
    "fused_band_bdf": _COMMON + ("band_lu.cuh", "fused_band_bdf.cuh"),
}
_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> (argtypes, restype); every pointer and the stream are
# c_void_p so they stay 64-bit
_SIGNATURES = {
    "fused_bdf": {
        # params, t_eval, ys, gs, info, root_t, &config, stream
        "fused_bdf_launch": ([_P] * 8, _I),
        "fused_bdf_config_size": ([], _I),
    },
    "band_lu": {
        # band, F, n, ml, mu, B, stream
        "band_lu_factor_launch": ([_P, _P, _I, _I, _I, _I, _P], _I),
        # F, its members (1 or B), b, x, n, ml, mu, B, stream
        "band_lu_solve_launch": ([_P, _I, _P, _P, _I, _I, _I, _I, _P], _I),
        # the float builds, the same arguments
        "band_lu_factor_launch_f32": ([_P, _P, _I, _I, _I, _I, _P], _I),
        "band_lu_solve_launch_f32": ([_P, _I, _P, _P, _I, _I, _I, _I, _P], _I),
        # n, ml, mu, solve (0: the factor), the scalar's bytes (8 or 4)
        # -> bytes a block
        "band_lu_shared_bytes": ([_I, _I, _I, _I, _I], _I),
    },
    "fused_band_bdf": {
        # params, init, h_tile, t_eval, atol, mass diag, ys, info, scratch,
        # &config, stream
        "fused_band_bdf_launch": ([_P] * 11, _I),
        "fused_band_bdf_config_size": ([], _I),
        # factor chunk, solve chunk -> shared doubles a member
        "fused_band_bdf_member_doubles": ([_I, _I], _I),
        # &config, int out[5] -> clusters held at once, registers, local,
        # dynamic and static shared bytes
        "fused_band_bdf_report": ([_P, _P], _I),
    },
}

# every build of this process: name, library, seconds, ptxas lines
BUILDS: list = []
# (name, entry source) -> loaded library (the csrc files do not change in
# a process)
_loaded: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _compile(name: str, key: str, entry: str, model_header, out: Path) -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f"{name}_{key}_", dir=BUILD_DIR))
    try:
        if model_header is not None:
            (tmp / "model.cuh").write_text(model_header)
        src = tmp / f"{name}_entry.cu"
        src.write_text(entry)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-I", str(tmp),
               "-o", str(tmp / out.name), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name} ({proc.returncode}):\n{proc.stdout}\n"
                f"{proc.stderr}")
        os.replace(tmp / out.name, out)  # atomic: no half-written library
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # "Function properties for <kernel>", then "... bytes spill stores, ..."
    # and "ptxas info : Used R registers, ..."
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Function properties" in ln]
    build = dict(name=name, library=out.name, seconds=secs, ptxas=ptxas)
    print(f"built {out.name} in {secs:.1f} s", file=sys.stderr)
    for ln in ptxas:
        print(ln, file=sys.stderr)
    return build


def _load(name: str, entry: str, model_header=None) -> ctypes.CDLL:
    """The library ``name`` built from ``entry`` (a translation unit that
    includes csrc headers and, if given, ``model.cuh``)."""
    cache_key = (name, entry, model_header)
    lib = _loaded.get(cache_key)
    if lib is not None:
        return lib
    parts = [" ".join(NVCC_FLAGS), entry, model_header or ""]
    parts += [(CSRC / f).read_text() for f in _SOURCES[name]]
    key = hashlib.sha256("\0".join(parts).encode()).hexdigest()[:20]
    out = BUILD_DIR / f"{name}_{key}.so"
    if not out.exists():
        BUILDS.append(_compile(name, key, entry, model_header, out))
    lib = ctypes.CDLL(str(out))
    for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    _loaded[cache_key] = lib
    return lib


def load_fused_bdf(model_header: str) -> ctypes.CDLL:
    """K1, the fused small-n BDF kernel, for one generated model header."""
    return _load("fused_bdf", '#include "model.cuh"\n#include "fused_bdf.cuh"\n',
                 model_header)


def load_band_lu() -> ctypes.CDLL:
    """K3 and K4, the band LU factor and solve."""
    return _load("band_lu", '#include "band_lu.cuh"\n')


def load_fused_band_bdf(model_header: str, ml: int, mu: int) -> ctypes.CDLL:
    """K2, the fused banded BDF kernel, for one model header and band."""
    entry = (f"#define BAND_ML {int(ml)}\n#define BAND_MU {int(mu)}\n"
             '#include "model.cuh"\n#include "fused_band_bdf.cuh"\n')
    return _load("fused_band_bdf", entry, model_header)


def load_coloring() -> ctypes.CDLL:
    """The native greedy colorer (host C++, ``g++``); raises if it does not
    build."""
    lib = _loaded.get("coloring")
    if lib is not None:
        return lib
    src = CSRC / "coloring.cpp"
    flags = ("-O2", "-shared", "-fPIC")
    key = hashlib.sha256((" ".join(flags) + "\0" + src.read_text()).encode()).hexdigest()[:20]
    out = BUILD_DIR / f"coloring_{key}.so"
    if not out.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native colorer cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix=f"coloring_{key}_", dir=BUILD_DIR))
        try:
            t0 = time.perf_counter()
            proc = subprocess.run([gxx, *flags, "-o", str(tmp / out.name), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed for coloring ({proc.returncode}):\n{proc.stdout}\n"
                    f"{proc.stderr}")
            os.replace(tmp / out.name, out)
            BUILDS.append(dict(name="coloring", library=out.name,
                               seconds=time.perf_counter() - t0, ptxas=[]))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(str(out))
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.diffsol_greedy_color.restype = ctypes.c_int64
    lib.diffsol_greedy_color.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, i64p]
    _loaded["coloring"] = lib
    return lib
