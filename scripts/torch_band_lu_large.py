#!/usr/bin/env python3
"""K3 and K4 (csrc/band_lu.cuh) at a few members of very many columns, and
chip_smoke.py phase 30 (j)'s unsharded cell, on one card.

Run from the root of a checkout (or of a copy of one) with a CUDA card:

    python3 scripts/torch_band_lu_large.py

Prints the card, the band LU's build time, one K3 and one K4 call at B = 2,
n = 2^20, nb = 3 (a diagonally dominant tridiagonal band; medians of 3
after a warm-up, CUDA events), the plain factor on the leading 2^14
columns (one run), and the unsharded (j) cell: each solver's time from
init_state (CUDA events), its K3/K4 launches and its Stats.  This is the
shape at which phase 30 (j) chooses its step counts (IMPLICIT_SHARD_STEPS).
"""
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    from diffsol_tpu_torch import _build
    from diffsol_tpu_torch.ops import band_lu

    dev = torch.device("cuda", 0)
    print(cs.card(), flush=True)
    t0 = time.time()
    _build.load_band_lu()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    n, B = 2**20, 2
    band = torch.zeros(B, 3, n, dtype=torch.float64, device=dev)
    band[:, 1] = 3.0
    band[:, 0, 1:] = -1.0
    band[:, 2, :-1] = -1.0
    b = torch.randn(B, n, dtype=torch.float64, device=dev)
    F = band_lu.launch_band_lu_factor(band, 1, 1)
    band_lu.launch_band_lu_solve(F, b, 1, 1)
    torch.cuda.synchronize()
    print(f"K3 {cs.time_ms(lambda: band_lu.launch_band_lu_factor(band, 1, 1), 3):.1f} ms, "
          f"K4 {cs.time_ms(lambda: band_lu.launch_band_lu_solve(F, b, 1, 1), 3):.1f} ms "
          f"(B = {B}, n = {n}, nb = 3)", flush=True)
    sub = band[..., :2**14].contiguous()
    plain = cs.events_ms(lambda: band_lu.band_lu_factor_reference(sub, 1, 1))[1]
    print(f"plain K3 on {2**14} columns {plain:.1f} ms", flush=True)
    cell = cs.implicit_state_cell(None, dev)
    for name in ("bdf", "sdirk"):
        c = cell[name]
        print(f"{name}: {cs.IMPLICIT_SHARD_STEPS[name]} steps {c['ms']:.1f} ms, K3/K4 "
              f"launches {c['launches']}, {c['state'].stats}", flush=True)
