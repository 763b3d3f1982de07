"""Build the CUDA kernels with ``nvcc`` at first use and load them with
``ctypes``.

Each kernel is a shared library with a plain C entry point (no PyTorch
headers, so a build takes seconds).  Its sources are the repository's
``csrc/`` files plus the model header generated for the problem's
equations; the library lands in ``build/diffsol_tpu_torch/`` beside the
package, named by a hash of everything that went into it, so a second
process or a second solve of the same model reuses it.  ``nvcc -Xptxas -v``
reports each kernel's registers and spill bytes, which are printed with
the build time.
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
_FUSED_SOURCES = ("fused_bdf.cuh", "dual.cuh")
_ENTRY = '#include "model.cuh"\n#include "fused_bdf.cuh"\n'

# model header -> loaded library (the csrc files do not change in a process)
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


def _compile(key: str, model_header: str, out: Path) -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f"fused_bdf_{key}_", dir=BUILD_DIR))
    try:
        (tmp / "model.cuh").write_text(model_header)
        src = tmp / "fused_bdf_model.cu"
        src.write_text(_ENTRY)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-I", str(tmp),
               "-o", str(tmp / out.name), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp / out.name, out)  # atomic: no half-written library
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # "ptxas info : Used R registers, ..." and "... bytes spill stores, ..."
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    build = dict(library=out.name, seconds=secs, ptxas=ptxas)
    print(f"built {out.name} in {secs:.1f} s", file=sys.stderr)
    for ln in ptxas:
        print(ln, file=sys.stderr)
    return build


def load_fused_bdf(model_header: str) -> ctypes.CDLL:
    """The fused BDF kernel for one generated model header, built at first
    use.  ``load_fused_bdf.builds`` records each build of this process
    (library, seconds, ptxas register and spill lines)."""
    lib = _loaded.get(model_header)
    if lib is not None:
        return lib
    parts = [" ".join(NVCC_FLAGS), _ENTRY, model_header]
    parts += [(CSRC / name).read_text() for name in _FUSED_SOURCES]
    key = hashlib.sha256("\0".join(parts).encode()).hexdigest()[:20]
    out = BUILD_DIR / f"fused_bdf_{key}.so"
    if not out.exists():
        load_fused_bdf.builds.append(_compile(key, model_header, out))
    lib = ctypes.CDLL(str(out))
    fn = lib.fused_bdf_launch
    # params, t_eval, ys, info, &config, stream: all 64-bit pointers
    fn.argtypes = [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    lib.fused_bdf_config_size.argtypes = []
    lib.fused_bdf_config_size.restype = ctypes.c_int
    _loaded[model_header] = lib
    return lib


load_fused_bdf.builds = []
