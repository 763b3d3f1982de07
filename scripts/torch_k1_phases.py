#!/usr/bin/env python3
"""K1's time by step phase on the card: a throw-away instrumented build of
the fused small-n BDF kernel (diffsol_tpu_torch/csrc/fused_bdf.cuh).

    python scripts/torch_k1_phases.py [--root CHECKOUT] [--out FILE.json]

(the JSON report goes to ``build/k1_phases/k1_phases.json`` without --out)

The kernel source carries no instrumentation.  This script copies it into
``build/k1_phases/`` and inserts a phase mark before each of its section
comments (``// ---- predict``, ``// ---- error test``, ...) and before the
Newton iteration's rhs, solve, norm and rate statements; a mark reads
``clock64()`` on thread 0 of each block and adds the cycles since the last
mark to the phase that mark opened.  It builds that copy with the same
nvcc flags as the package, launches it through the package's own wrapper
on four paths (Robertson ODE and DAE at B = 10,000 to t = 4e10, the n = 8
chain of tests/test_torch_cuda.py at B = 10,000, the bouncing ball at
B = 10,000) and prints, per path, each phase's cycles a step attempt and
share and the mark count; the solve_dense_ensemble call's time, the
uninstrumented kernel's alone (CUDA events around the bare launch) and
their difference, the call's host work; and the instrumented kernel's
time (the marks cost the difference to the uninstrumented one).

``--root`` runs another checkout's package and kernel (for example an
unpacked parent commit), so two versions compare in one run.  Needs a
CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

# phase name, and the stripped source lines (prefixes) before which its mark
# goes; marks are placed inside the step kernel only
PHASES = [
    ("predict", ("// ---- predict",)),
    ("jac_policy", ("// ---- stale-Jacobian policy",)),
    ("jacobian", ("if (refresh) jacobian<", "jacobian<N, NP, MT>(")),
    ("factor", ("if (refactor) factor_newton<", "factor_newton<N>(")),
    ("newton_setup", ("// ---- Newton on",)),
    ("newton_rhs", ("diffsol_model::model_rhs<double>(t_pred, x, p, fx);",)),
    ("newton_solve", ("solve_newton<N>(",)),
    ("newton_norm", ("const double nrm",)),
    ("newton_rate", ("niter += 1;",)),
    ("after_newton", ("const bool solve_ok",)),
    ("quadrature", ("// ---- quadrature delta",)),
    ("error_test", ("// ---- error test",)),
    ("diff_update", ("// ---- accepted-step difference update",)),
    ("order_select", ("// ---- order selection",)),
    ("root", ("// ---- root check",)),
    ("dense_output", ("// ---- dense output",)),
    ("rescale", ("// ---- one shared D rescale",)),
    ("bookkeeping", ("// ---- bookkeeping",)),
    ("end", ("if (status == OK && nxt < c.neval) status = FAIL_MAX_STEPS;",)),
]
NPH = len(PHASES) + 1  # phase 0: the set-up before the first mark
MAXB = 256

PRELUDE = f"""
#define K1P_N {NPH}
#define K1P_MAXB {MAXB}
__device__ long long k1p_out[K1P_MAXB * K1P_N * 2 + K1P_MAXB];
__device__ __forceinline__ long long k1p_gtime() {{
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define K1P(id) do {{ if (threadIdx.x == 0) {{ const long long n_ = clock64(); \\
  k1p_cyc[k1p_cur] += n_ - k1p_last; k1p_cnt[id] += 1; k1p_last = n_; \\
  k1p_cur = (id); }} }} while (0)
"""
OPEN = """
  __shared__ long long k1p_cyc[K1P_N];
  __shared__ int k1p_cnt[K1P_N];
  long long k1p_last = clock64(), k1p_g0 = k1p_gtime();
  int k1p_cur = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < K1P_N; ++i) { k1p_cyc[i] = 0; k1p_cnt[i] = 0; }
"""
CLOSE = """
    if (threadIdx.x == 0 && blockIdx.x < K1P_MAXB) {
      for (int i = 0; i < K1P_N; ++i) {
        k1p_out[(blockIdx.x * K1P_N + i) * 2] = k1p_cyc[i];
        k1p_out[(blockIdx.x * K1P_N + i) * 2 + 1] = k1p_cnt[i];
      }
      k1p_out[K1P_MAXB * K1P_N * 2 + blockIdx.x] = k1p_gtime() - k1p_g0;
    }
"""
READ = """
extern "C" int k1p_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, k1p_out, sizeof(k1p_out));
}
"""


def instrument(src: str) -> str:
    """The kernel source with the phase marks; raises if a phase has no
    anchor in the step kernel."""
    head, sep, body = src.partition("fused_bdf_kernel(")
    if not sep:
        raise RuntimeError("no fused_bdf_kernel in the source")
    brace = body.index("{\n") + 2
    body = body[:brace] + OPEN + body[brace:]
    lines, out, seen = body.split("\n"), [], set()
    for ln in lines:
        s = ln.strip()
        for pid, (name, anchors) in enumerate(PHASES, start=1):
            if any(s.startswith(a) for a in anchors):
                indent = ln[: len(ln) - len(ln.lstrip())]
                out.append(f"{indent}K1P({pid});")
                if name == "end":
                    out.append(CLOSE)
                seen.add(name)
                break
        out.append(ln)
    missing = [name for name, _ in PHASES if name not in seen]
    # a build without quadrature or roots keeps those anchors all the same
    if missing:
        raise RuntimeError(f"no anchor for phases {missing}")
    return head.replace("namespace diffsol_fused {", PRELUDE + "namespace diffsol_fused {", 1) \
        + sep + "\n".join(out) + READ


def chain8(t, y, p):
    import torch

    rows = [-p[0] * y[0] + p[1] * y[7] * y[1]]
    for i in range(1, 8):
        rows.append(p[0] * y[i - 1] - (1.0 + i) * y[i] - p[1] * y[i] * y[(i + 1) % 8])
    return torch.stack(rows)


def paths(dtt, torch, dev):
    from diffsol_tpu_torch.models import fused_cases as fc
    from diffsol_tpu_torch.models import robertson

    B = 10_000
    rng = np.random.default_rng(0)
    u = rng.uniform(-1.0, 1.0, B)
    u[0] = 0.0
    rob = np.stack([0.04 * (1.0 + 0.1 * u), np.full(B, 1e4), np.full(B, 3e7)], 1)
    chain = (dtt.OdeBuilder().rhs(chain8)
             .init(lambda t, p: torch.ones(8, dtype=torch.float64, device=p.device))
             .p([50.0, 1e3]).rtol(1e-6).atol(1e-9).build())
    c8 = np.stack([rng.uniform(40, 60, B), np.full(B, 1e3)], 1)
    return {
        "robertson_ode": (robertson.problem_ode(), robertson.T_EVAL_4E10, rob),
        "robertson_dae": (robertson.problem_dae(), robertson.T_EVAL_4E10, rob),
        "chain8": (chain, [0.1, 1.0, 10.0], c8),
        "root_reset": (fc.bouncing_ball_problem(), fc.BALL_T_EVAL,
                       np.tile(fc.BALL_P, (B, 1))),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import ctypes

    import torch

    import diffsol_tpu_torch as dtt
    from diffsol_tpu_torch import _build
    from diffsol_tpu_torch.ops import fused_stepper as fs

    if not torch.cuda.is_available():
        print("torch_k1_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    work = root / "build" / "k1_phases"
    work.mkdir(parents=True, exist_ok=True)
    for f in ("bdf_common.cuh", "dual.cuh"):
        (work / f).write_text((_build.CSRC / f).read_text())
    (work / "fused_bdf.cuh").write_text(instrument((_build.CSRC / "fused_bdf.cuh").read_text()))
    libs = {}

    def load_instrumented(header):
        key = hash(header)
        if key not in libs:
            d = work / f"m{len(libs)}"
            d.mkdir(exist_ok=True)
            (d / "model.cuh").write_text(header)
            (d / "entry.cu").write_text('#include "model.cuh"\n#include "fused_bdf.cuh"\n')
            so = d / "libk1p.so"
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(work),
                                   "-I", str(d), "-o", str(so), str(d / "entry.cu")],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(proc.stdout + proc.stderr)
            for ln in (proc.stdout + proc.stderr).splitlines():
                if "stack frame" in ln or "registers" in ln:
                    print(f"  instrumented build: {ln.strip()}", flush=True)
            lib = ctypes.CDLL(str(so))
            for fn, (at, rt) in _build._SIGNATURES["fused_bdf"].items():
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = at, rt
            lib.k1p_read.argtypes, lib.k1p_read.restype = [ctypes.c_void_p], ctypes.c_int
            libs[key] = lib
        return libs[key]

    def events_ms(fn, reps=21):
        """Median of ``reps`` timings of fn() between CUDA events, after a
        warm-up call."""
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    names = ["setup"] + [n for n, _ in PHASES]
    report = {"card": card, "root": str(root), "paths": {}}
    print(f"card: {card}; checkout {root}", flush=True)
    for label, (problem, te, p_np) in paths(dtt, torch, dev).items():
        params = torch.tensor(p_np, dtype=torch.float64, device=dev)
        solve = fs.make_fused_bdf_solve(problem, te, params.shape[0])
        te_dev = torch.tensor(te, dtype=torch.float64, device=dev)

        def launch():
            return fs.launch_fused_bdf(solve.cfg, solve.header, params, te_dev)

        # the user's call, and the kernel alone (events around the bare
        # launch): the difference is the call's host work
        call_ms = events_ms(lambda: dtt.solve_dense_ensemble(
            dtt.BdfSolver, problem, te, params, mode="fused"))
        alone_ms = events_ms(launch)
        real = _build.load_fused_bdf
        _build.load_fused_bdf = load_instrumented
        try:
            instr_ms = events_ms(launch)
            raw = solve(params)
            torch.cuda.synchronize()
            lib = load_instrumented(solve.header)
            buf = np.zeros(MAXB * NPH * 2 + MAXB, dtype=np.int64)
            rc = lib.k1p_read(buf.ctypes.data)
            if rc != 0:
                raise RuntimeError(f"k1p_read: CUDA error {rc}")
        finally:
            _build.load_fused_bdf = real
        for b in _build.BUILDS:
            if b["name"] == "fused_bdf" and not b.get("shown"):
                b["shown"] = True
                for ln in b["ptxas"]:
                    print(f"  uninstrumented build: {ln}", flush=True)
        res = raw if isinstance(raw, dict) else dict(zip(("ys", "status", "steps"), raw))
        ntiles = min(solve.ntiles, MAXB)
        per = buf[: MAXB * NPH * 2].reshape(MAXB, NPH, 2)[:ntiles]
        cyc, cnt = per[..., 0].astype(np.float64), per[..., 1].astype(np.float64)
        ns = buf[MAXB * NPH * 2: MAXB * NPH * 2 + ntiles].astype(np.float64)
        attempts = cnt[:, 1].sum()  # one predict mark an attempt
        steps = float(res["steps"][:ntiles].sum().item())
        total = cyc[:, :-1].sum()  # the last phase ("end") holds nothing
        ghz = total / ns.sum()
        rows = []
        for i, name in enumerate(names[:-1]):
            c = cyc[:, i].sum()
            rows.append(dict(phase=name, cycles_per_attempt=c / attempts,
                             share=c / total, marks_per_attempt=cnt[:, i].sum() / attempts))
        report["paths"][label] = dict(
            ntiles=int(solve.ntiles), tile=int(solve.tile), attempts_per_tile=attempts / ntiles,
            steps_per_tile=steps / ntiles, cycles_per_attempt=total / attempts,
            clock_ghz=ghz, call_ms=call_ms, kernel_ms=alone_ms, host_ms=call_ms - alone_ms,
            instrumented_kernel_ms=instr_ms, phases=rows)
        print(f"\n[{label}] {ntiles} tiles of {solve.tile}: {attempts / ntiles:.1f} attempts, "
              f"{steps / ntiles:.1f} accepted steps a tile; {total / attempts:.0f} cycles an "
              f"attempt (thread 0 of each tile, clock {ghz:.3f} GHz from %globaltimer); "
              f"solve_dense_ensemble call {call_ms:.3f} ms, the kernel alone {alone_ms:.3f} "
              f"ms (so {call_ms - alone_ms:.3f} ms host work), instrumented kernel "
              f"{instr_ms:.3f} ms (CUDA events, medians of 21); card {card}", flush=True)
        print("| phase | cycles an attempt | share | marks an attempt |")
        print("|---|---|---|---|")
        for r in rows:
            if r["marks_per_attempt"] > 0 or r["cycles_per_attempt"] > 0.5:
                print(f"| {r['phase']} | {r['cycles_per_attempt']:.0f} | {r['share']:.1%} | "
                      f"{r['marks_per_attempt']:.2f} |")
    out = Path(args.out) if args.out else work / "k1_phases.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"\nwritten {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
