#!/usr/bin/env python3
"""The sharded ensemble across cards: chip_smoke.py phase 30's cells at a
wider global batch, unsharded on one card and then sharded over meshes of
2 and 4 ranks, one card a rank (NCCL), every call timed between CUDA
events and every sharded result held to the unsharded one.  The cells:
Robertson and heat1d fused, heat2d lockstep on the banded tier and on the
Krylov tier (one GMRES over the ranks' members), Robertson independent,
the lockstep gradient, heat1d's independent gradient, and heat1d ERK with
every member's 2^20 states sharded over the ranks (a (1, k) mesh).

    python scripts/torch_sharding_scaling.py [--out FILE.json]  # 4 cards
    python scripts/torch_sharding_scaling.py --cpu      # rehearsal: gloo on
                                                        # the CPU, tiny sizes

Each rank calls with the global batch and solves its block (sharding.py);
the lockstep cells reduce over the mesh every step (the Krylov tier every
Arnoldi iteration, the state-sharded ERK every stage), the fused and
independent ones gather at the end.  Per cell and mesh size it prints the
call's time on rank 0 (the whole call, from a barrier of all ranks; its
first and its second call), the all-gathers a
rank made and the speed-up over the unsharded call (second calls on both
sides), and writes all of it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# global batch of each cell (chip_smoke's B_MAIN, B_BAND, B_SHARD; the
# Krylov cell keeps B_KRYLOV_CUT = 256, the ERK cell B = 2 at 2^20 states)
CARD_SIZES = (40_000, 4096, 4096)
CPU_SIZES = (8, 8, 8)
TIMEOUT_S = 900
CELLS = ("robertson_fused", "heat1d_fused", "heat2d_lockstep", "robertson_independent",
         "robertson_grad", "heat2d_krylov_lockstep", "heat1d_ind_grad")


def configure(cpu):
    """chip_smoke's batch sizes for this run; on the CPU its timer on the
    host clock (no CUDA events there)."""
    cs.B_MAIN, cs.B_BAND, cs.B_SHARD = CPU_SIZES if cpu else CARD_SIZES
    if cpu:
        cs.B_KRYLOV_CUT, cs.KRYLOV_MGRID, cs.ERK_SHARD_MGRID = 4, 4, 255
        def host_ms(fn):
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3

        cs.events_ms = host_ms


def rank(r, world, cpu):
    """One rank: the cells sharded over a ``world``-rank mesh, one card a
    rank."""
    from torch.distributed.device_mesh import init_device_mesh

    configure(cpu)
    dev = torch.device("cpu") if cpu else torch.device("cuda", r)
    if not cpu:
        torch.cuda.set_device(r)
    mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("dp",))
    out = cs.run_shard_cells(mesh, dev, again=CELLS)
    out["erk_state"] = cs.erk_state_rank(dev.type, world, dev)
    out["erk_state_warm"] = cs.erk_state_rank(dev.type, world, dev)
    return out


def spawn(world, out_dir, cpu):
    sub = os.path.join(out_dir, f"w{world}")
    os.makedirs(sub)
    return cs.spawn_ranks(rank, world, sub, args=(cpu,), backend="gloo" if cpu else "nccl",
                          timeout=TIMEOUT_S)


def check(cell, label, got, ref):
    """The sharded result against the unsharded one: lockstep and
    independent equal Stats and ys within 1e-12 + 1e-9 |ref|; the gradient
    within 1e-10 of its largest entry; fused the stop and the member-0
    checks of phase 30 (its blocks are the shards' own tiles)."""
    if cell in ("robertson_grad", "heat1d_ind_grad"):
        cs.same_stats(label, got["forward"], ref["forward"])
        cs.same_stats(label, got["backward"], ref["backward"])
        if cell == "heat1d_ind_grad":  # independent members: bit for bit
            for key in ("ys", "grad", "status", "backward_status"):
                if not torch.equal(got[key], ref[key]):
                    raise AssertionError(f"{label}: {key} differs from the unsharded call's")
        rel = float((got["grad"] - ref["grad"]).abs().max() / ref["grad"].abs().max())
        if not rel <= cs.SHARD_GRAD_RTOL:
            raise AssertionError(f"{label}: gradient {rel:.3e} from the unsharded one")
        return rel
    if cell == "heat2d_krylov_lockstep":  # one GMRES over the ranks: sums reorder
        if got["gmres"] != ref["gmres"]:
            raise AssertionError(f"{label}: GMRES counts {got['gmres']}, {ref['gmres']}")
        got, ref = got["sol"], ref["sol"]
        cs.same_stats(label, got["stats"], ref["stats"])
        rel = float((got["ys"] - ref["ys"]).abs().max() / ref["ys"].abs().max())
        if not rel <= cs.SHARD_KRYLOV_RTOL:
            raise AssertionError(f"{label}: ys {rel:.3e} of the largest from the unsharded")
        return rel
    if not torch.equal(torch.as_tensor(got["stop"]), torch.as_tensor(ref["stop"])):
        raise AssertionError(f"{label}: stop {got['stop']} against {ref['stop']}")
    if got["stats"] is not None:
        cs.same_stats(label, got["stats"], ref["stats"])
        return cs.shard_close(label, got["ys"], ref["ys"])
    if not bool(torch.isfinite(got["ys"]).all()):
        raise AssertionError(f"{label}: non-finite ys")
    return float((got["ys"] - ref["ys"]).abs().max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU, tiny sizes")
    ap.add_argument("--out", help="a JSON file for the whole record")
    args = ap.parse_args()
    if not args.cpu and torch.cuda.device_count() < 4:
        print("torch_sharding_scaling: needs 4 CUDA devices (or --cpu)", file=sys.stderr)
        return 1
    sizes = CPU_SIZES if args.cpu else CARD_SIZES
    configure(args.cpu)
    card = "the CPU (rehearsal)" if args.cpu else cs.card()
    out_dir = os.path.join(ROOT, "build", "sharding_scaling")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    cells, _ = cs.shard_cells(dev)
    ref, ref_ms, ref_warm = {}, {}, {}
    for name, run in cells.items():  # the first calls build the kernels
        res, ref_ms[name] = cs.events_ms(lambda: run(None))
        ref[name] = cs._host(res)
        ref_warm[name] = cs.events_ms(lambda: run(None))[1]
        print(f"[scaling] {name} unsharded on one card: {ref_ms[name]:.1f} ms (first call), "
              f"{ref_warm[name]:.1f} ms again; card {card}", flush=True)
    ref_erk, ref_ms["erk_state"] = cs.events_ms(lambda: cs.erk_state_cell(None, dev)["state"])
    ref_warm["erk_state"] = cs.events_ms(lambda: cs.erk_state_cell(None, dev))[1]
    print(f"[scaling] erk_state unsharded on one card: {ref_ms['erk_state']:.1f} ms (first "
          f"call), {ref_warm['erk_state']:.1f} ms again; card {card}", flush=True)
    record = {"card": card, "sizes": dict(zip(("B_MAIN", "B_BAND", "B_SHARD"), sizes)),
              "unsharded_ms": ref_ms, "unsharded_warm_ms": ref_warm, "meshes": {}}
    for world in (2, 4):
        t0 = time.perf_counter()
        ranks = spawn(world, out_dir, args.cpu)
        wall = time.perf_counter() - t0
        rows = {}
        for name in cells:
            r0 = ranks[0][name]
            err = check(name, f"{name} over {world}", r0["result"], ref[name])
            warm = r0["ms_warm"]
            rows[name] = dict(ms=r0["ms"], ms_warm=warm, all_gathers=r0["all_gathers"],
                              launches=[res[name]["launches"] for res in ranks],
                              speedup=ref_warm[name] / warm, max_abs_diff=err)
            print(f"[scaling] {name} over {world} ranks: {r0['ms']:.1f} ms (first call), "
                  f"{warm:.1f} ms again, {ref_warm[name] / warm:.2f}x the unsharded call "
                  f"(second calls); {r0['all_gathers']} all-gathers "
                  f"a rank; launches K1, K2, K3, K4 of rank 0 {r0['launches']}; max abs "
                  f"{err:.3e} from the unsharded result; card {card}", flush=True)
        er = [res["erk_state"] for res in ranks]
        cs.check_erk_state(f"erk_state over {world}", er, ref_erk)
        warm = ranks[0]["erk_state_warm"]["ms"]
        rows["erk_state"] = dict(ms=er[0]["ms"], ms_warm=warm,
                                 all_gathers=er[0]["all_gathers"],
                                 speedup=ref_warm["erk_state"] / warm, max_abs_diff=0.0)
        print(f"[scaling] erk_state over {world} ranks ({cs.ERK_SHARD_MGRID + 1} states a "
              f"member, B = {len(cs.ERK_SHARD_D)}, {cs.ERK_SHARD_STEPS} steps, the states over "
              f"all ranks): {er[0]['ms']:.1f} ms "
              f"(first call), {warm:.1f} ms again, {ref_warm['erk_state'] / warm:.2f}x the "
              f"unsharded steps; {er[0]['all_gathers']} all-gathers a rank; every block "
              f"equal bit for bit; card {card}", flush=True)
        record["meshes"][world] = dict(spawn_to_join_s=wall, cells=rows)
        print(f"[scaling] {world} ranks: {wall:.1f} s from spawn to join", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1, default=float)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
