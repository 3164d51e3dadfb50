#!/usr/bin/env python3
"""BASELINE config 6 through the port's scheduler loop, repeated on one GPU.

Runs ``chip_smoke.py``'s ``drive_framework_e2e`` (config 6 as
``benchmarks/ladder.py:469`` builds it, through
``SimCluster(scorer="oracle", device="cuda")``) in one process, after the
kernels' build and the north-star phase (so the process is as warm as the
whole smoke leaves it): ``--runs`` rounds of the serial kernel and the
wave kernel at W=8, in turns. Prints one JSON line a run (wall clock,
pods a second, standing batch, batches in the window, cycles, permit
waits, fold outcomes, the profiled second flood's device idle share and
the host's running share by thread), then the card's name and power
limit and a summary line with each side's walls. Every run holds the
smoke phase's own checks; a run that fails one prints its error and the
next run goes on (exit 1 at the end). Card only:

    python3 scripts/framework_e2e.py [--runs 2]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    if not torch.cuda.is_available():
        print("framework_e2e: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    if cs.build() is None:
        return 1
    results = {k: {"launches_by_path": {}} for k in cs.KERNELS}
    cs.north_star(results)
    walls = {"serial": [], "wave8": []}
    failed = 0
    for r in range(args.runs):
        for wave, side in ((None, "serial"), (8, "wave8")):
            try:
                launches, rep = cs.drive_framework_e2e(wave, cs.FRAMEWORK_SHAPE)
            except Exception as e:  # noqa: BLE001 — reported, the next run goes on
                failed += 1
                print(json.dumps({"framework_e2e_run": r, "side": side,
                                  "error": repr(e)[:1500]}), flush=True)
                continue
            walls[side].append(rep["wall_clock_s"])
            flood = rep["profiled_flood"]
            print(json.dumps({
                "framework_e2e_run": r, "side": side, "wall_clock_s": rep["wall_clock_s"],
                "pods_per_sec": rep["pods_per_sec"], "standing_batch_s": rep["standing_batch_s"],
                "oracle_batches_in_window": rep["oracle_batches_in_window"],
                "cycle_breakdown": rep["cycle_breakdown"], "permit_waits": rep["permit_waits"],
                "fold_outcomes": rep["fold_outcomes"], "launches": launches,
                "pack_ms": rep["oracle_stats"]["pack_ms"],
                "batch_ms": rep["oracle_stats"]["batch_ms"],
                "flood_ms": flood.get("profiled_flood_ms"),
                "flood_device_busy_ms": flood.get("device_busy_ms"),
                "flood_device_idle_share": flood.get("device_idle_share"),
                "flood_host_running_share": {
                    g: v["share"] for g, v in
                    flood["host_stacks"]["running_share_by_thread"].items() if v["running"]},
                "flood_top_running_functions": flood["host_stacks"]["top_running_functions"],
                "settled_refresh": rep["settled_refresh"],
            }), flush=True)
    print(cs.card_line(), flush=True)
    print(json.dumps({"framework_e2e_summary": {
        side: {"walls_s": w, "median_s": statistics.median(w) if w else None}
        for side, w in walls.items()}, "failed_runs": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
