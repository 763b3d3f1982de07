#!/usr/bin/env python3
"""chip_smoke.py's phase 30 (the sharded paths) alone, on one card.

Run from the root of a checkout (or of a copy of one) with a CUDA card:

    python3 scripts/torch_smoke_phase30.py

Phase 30 spawns its two gloo ranks on the card and holds every sharded
path to its reference; run alone, it computes the unsharded references
that the whole script takes from phase 28 d (PHASE_REFS).  Any
failed gate raises, so the exit code is non-zero.  It prints the phase's
lines, its host-clock time and the names of its kernel records.
"""
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    from diffsol_tpu_torch.models import heat1d

    dev = torch.device("cuda", 0)
    card_line = cs.card()
    print(card_line, flush=True)
    _, soln = heat1d.make(cs.HEAT_MGRID, rtol=1e-6, atol=1e-8, banded=True)
    t0 = time.perf_counter()
    recs = cs.sharding_phase(dev, card_line, soln)
    print(f"phase 30 alone {time.perf_counter() - t0:.1f} s; records "
          f"{[r['name'] for r in recs]}", flush=True)
