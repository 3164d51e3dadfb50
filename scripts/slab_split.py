"""Time each scan kernel's slab variant against the variant the build runs
on global-scratch plans of at most 64 nodes a thread.

Both kernels keep the leftover in global scratch from the 262144-node
bucket (R=5). Up to 64 nodes a thread they run an instantiation that keeps
a thread's capacities across the phases of a step (the serial kernel's
``assign_scan_kernel<kPer, false>``, the wave kernel's runtime-loop
``assign_wave_kernel<0, false>``); past 64 they run the slab variant, which
recomputes them in each pass. This script builds the sources as they are
and a copy under ``batch_scheduler_tpu_torch/build/slab_split/`` whose
``kernel_for`` sends every global-scratch plan to the slab variant, then
runs both builds on ``chip_smoke.py``'s 262144-node inputs (150,000 nodes x
64 gangs, both mask modes; the wave kernel at W=8 and 32), in turns (as
built, slabs, slabs, as built), each a mean of 20 launches under CUDA
events, and checks every output bit for bit against the plain scans.

Run on a machine with one CUDA card, from the repository root::

    python3 scripts/slab_split.py

It prints the card's name and power limit, then one JSON object, and exits
non-zero if a build or a comparison fails.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402

# the one line of each kernel_for that routes plans past 64 nodes a thread
# to the slab variant, and the same line routing every global-scratch plan
PATCHES = {
    "assign_scan": ("if (per > 64) return shared ? nullptr",
                    "if (per > 64 || !shared) return shared ? nullptr"),
    "assign_wave": ("if (per > kMaxPer) return shared ? nullptr",
                    "if (per > kMaxPer || !shared) return shared ? nullptr"),
}
REPS = 20
WAVES = (8, 32)


def build_both():
    """{name: (library as built, library with every global plan on slabs)}."""
    from batch_scheduler_tpu_torch.ops import _build

    copy = _build.BUILD_DIR / "slab_split" / "csrc"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, copy)
    for name, (old, new) in PATCHES.items():
        src = copy / f"{name}.cu"
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{src.name}: kernel_for line {old!r} not found once")
        src.write_text(text.replace(old, new))
    # all four nvcc runs at once
    procs = {}
    for name in PATCHES:
        out = copy.parent / f"lib{name}_slabs.so"
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(copy / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    with ThreadPoolExecutor(len(PATCHES)) as pool:
        built = dict(zip(PATCHES, pool.map(_build.library, PATCHES)))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the slab copy of {name}.cu:\n{log}")
        libs[name] = (built[name], ctypes.CDLL(str(out)))
    return libs


def use(libs, which):
    """Point the wrappers' entry points at build ``which`` (0 as built, 1
    slabs)."""
    from batch_scheduler_tpu_torch.ops import _build, assign_scan

    with _build._lock:
        for name, pair in libs.items():
            _build._libs[name] = pair[which]
    assign_scan._entry_points.cache_clear()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("slab_split: no CUDA device", file=sys.stderr)
        return 2
    from batch_scheduler_tpu_torch.ops.assign_scan import (
        _launch_scan, _launch_wave, assign_gangs_plain, scan_plan, wave_scan_plan)
    from batch_scheduler_tpu_torch.ops.oracle import assign_gangs_wavefront

    libs = build_both()
    use(libs, 0)
    runs = []
    ok = True
    for mode, per_group in (("per_group", True), ("broadcast", False)):
        batch_args, _ = smoke.mixed_batch(*smoke.SERIAL_GLOBAL, per_group)
        args = smoke.scan_inputs(batch_args)
        n, r = batch_args[0].shape
        serial = assign_gangs_plain(*args)
        cases = [("assign_scan", 0, scan_plan(n, r, 0), serial,
                  lambda plan, w: _launch_scan(plan, *args))]
        for wave in WAVES:
            plain = assign_gangs_wavefront(*args, wave=wave, with_stats=True)
            want = list(plain[:3]) + list(plain[3])
            cases.append(("assign_wave", wave, wave_scan_plan(n, r, 0), want,
                          lambda plan, w: _launch_wave(plan, *args, w)))
        for name, wave, plan, want, launch in cases:
            if plan.leftover != "global" or plan.per_thread > 64:
                raise AssertionError(f"{name} plan {plan}: not a global plan of <= 64 "
                                     f"nodes a thread")
            ms = {0: [], 1: []}
            equal = {}
            for which in (0, 1, 1, 0):
                use(libs, which)
                got = launch(plan, wave)
                got = list(got[:3]) + (list(got[3]) if len(got) > 3 else [])
                torch.cuda.synchronize()
                err, eq = smoke.max_err(got, want)
                equal[which] = equal.get(which, True) and eq
                ms[which].append(smoke.cuda_ms(lambda: launch(plan, wave), REPS))
            ok &= all(equal.values())
            runs.append({"input": f"global_leftover_262144/{mode}", "kernel": name,
                         "wave": wave or None, "plan": plan._asdict(),
                         "as_built_ms": ms[0], "slabs_ms": ms[1],
                         "as_built_equal": equal[0], "slabs_equal": equal[1]})
    use(libs, 0)
    print(smoke.card_line(), flush=True)
    smoke.emit({"slab_split": runs, "ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
