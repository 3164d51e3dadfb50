#!/usr/bin/env python3
"""The churn refresh of two checkouts, in alternating processes on one GPU.

Runs ``chip_smoke.py``'s north_star_churn driver (``drive_north_star_churn``:
the north-star deployment in a ClusterState, 16 node and 4 gang rows
churned before each refresh, the refresh median of the timed rounds) in a
fresh process per run, checkout A then B or B then A, the order
alternating by pair. The one profiled refresh of drive_north_star_churn is
taken by this script's own profiler in both checkouts (``_PROFILE``, which
replaces ``chip_smoke.profile_window`` there): an older checkout's
profile_window reports neither the device operations' count nor every
operation by name, so both sides report through this copy, whose rows are
profile_window's (the card's kernels, copies and memsets, their self
times). Prints one
JSON line a run, then a summary line: each side's per-run medians, their
median and quartiles, the pairs each side won, and the profiled refreshes'
device busy ms, idle share against the run's median and device
operations. Each checkout builds its kernels into its own ``build/`` on
its first run. Run from anywhere, on a machine with the card:

    python3 scripts/churn_pairs.py --a DIR --b DIR [--pairs 10] [--wave 8]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_PROFILE = """
def _profile_window(fn, wall_key, host_ops=True):
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile

    # the rows as chip_smoke.profile_window takes them; all of them kept
    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, ev.key[:80], ev.count))
    rows.sort(reverse=True)
    PROFILED.update(wall_ms=wall_ms, device_busy_ms=sum(r[0] for r in rows),
                    device_ops=sum(r[2] for r in rows),
                    ops=[{{"op": k, "ms": ms, "calls": n}} for ms, k, n in rows])
    return {{wall_key: wall_ms}}
"""

_RUN = """
import json, chip_smoke as cs
PROFILED = {{}}
""" + _PROFILE + """
cs.profile_window = _profile_window
cs.build()
launches, report = cs.drive_north_star_churn({wave})
if PROFILED:
    PROFILED["device_idle_share_vs_median"] = 1 - PROFILED["device_busy_ms"] / report["refresh_ms_median"]
print(json.dumps({{"churn_pairs_run": True, "refresh_ms_median": report["refresh_ms_median"],
                  "refresh_ms": report["refresh_ms"], "launches": launches,
                  "profiled": PROFILED}}))
"""


def run_once(checkout: str, wave) -> dict:
    """One process in ``checkout``: its churn refresh report."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN.format(wave=wave)], cwd=checkout,
        capture_output=True, text=True, timeout=900,
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"churn_pairs_run"')]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return [q[0], q[2]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (its root holds chip_smoke.py)")
    ap.add_argument("--b", required=True, help="checkout B")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--wave", type=int, default=None, help="BST_SCAN_WAVE (unset: serial)")
    args = ap.parse_args()
    sides = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    medians = {"a": [], "b": []}
    profiled = {"a": [], "b": []}
    wins = {"a": 0, "b": 0}
    for pair in range(args.pairs):
        got = {}
        for side in (("a", "b") if pair % 2 == 0 else ("b", "a")):
            run = run_once(sides[side], args.wave)
            got[side] = run["refresh_ms_median"]
            medians[side].append(got[side])
            prof = run.get("profiled") or {}
            profiled[side].append({k: prof.get(k) for k in (
                "device_busy_ms", "device_idle_share_vs_median", "device_ops")})
            print(json.dumps({"pair": pair, "side": side, "refresh_ms_median": got[side],
                              "profiled": prof}), flush=True)
        if got["a"] != got["b"]:
            wins["a" if got["a"] < got["b"] else "b"] += 1
    print(json.dumps({
        "churn_pairs": True, "wave": args.wave, "pairs": args.pairs, "checkouts": sides,
        "median_ms": {s: statistics.median(m) for s, m in medians.items()},
        "quartiles_ms": {s: quartiles(m) for s, m in medians.items()},
        "wins": wins, "medians_ms": medians, "profiled": profiled,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
