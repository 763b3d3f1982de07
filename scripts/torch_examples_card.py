"""Run every example of ``diffsol_tpu_torch/examples`` at its full default
size and iteration count on the card, each through its ``main()``, and
print each one's wall time (host clock, the card's queue drained) and
the numbers it returns; an example whose own checks fail is reported and
the script exits non-zero after the rest have run.

    python scripts/torch_examples_card.py [name ...] [--out FILE]

The first example that reaches a kernel builds it with nvcc inside its
time (``build/diffsol_tpu_torch/`` keeps the libraries for later runs).
The record goes to ``--out`` (default
``build/torch_examples_card.json``) with the card's name and power
limit.
"""

import argparse
import importlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diffsol_tpu_torch import examples  # noqa: E402


def scalars(out: dict) -> dict:
    """The returned numbers that print on a line: no tensors, no lists of
    more than eight entries."""
    keep = {}
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            continue
        if isinstance(v, (list, tuple)) and len(v) > 8:
            v = {"first": v[0], "last": v[-1], "len": len(v)}
        keep[k] = v
    return keep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(examples.NAMES))
    ap.add_argument("--out", default="build/torch_examples_card.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_examples_card: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    rows, failed = [], []
    t_all = time.perf_counter()
    for name in args.names:
        mod = importlib.import_module(f"diffsol_tpu_torch.examples.{name}")
        print(f"==== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = mod.main()
            torch.cuda.synchronize()
            ok, error = True, None
        except Exception:  # the example's own checks; reported, then the rest
            torch.cuda.synchronize()
            out, ok, error = {}, False, traceback.format_exc()
            failed.append(name)
            print(error, flush=True)
        seconds = time.perf_counter() - t0
        row = {"name": name, "seconds": seconds, "ok": ok, "numbers": scalars(out)}
        if error:
            row["error"] = error.strip().splitlines()[-1]
        rows.append(row)
        print(f"[{name}] {'checks passed' if ok else 'FAILED'}, {seconds:.1f} s (host clock); "
              f"{json.dumps(row['numbers'], default=str)}", flush=True)
    total = time.perf_counter() - t_all
    print("\n" + "\n".join(f"{r['name']:30s} {r['seconds']:9.1f} s  "
                           f"{'ok' if r['ok'] else 'FAILED'}" for r in rows))
    print(f"all {len(rows)} examples: {total:.1f} s; card {card}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "seconds": total, "examples": rows},
                                         indent=1, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
