"""Time one rank's step of the two node-sharded wave kernels (shard_wave,
shard_topk) on the card alone, and their whole sharded batches on one NCCL
rank, for the package of a source tree.

    python3 scripts/shard_steps.py [--tree DIR] [--repeat N] [--out FILE] [--only a,b]

A step is one rank's summary and apply (rank 0's block, the merged buffer
given) through the wrappers, on buffers allocated once: chip_smoke.py's
``shard_wave_step`` / ``shard_topk_step`` timed by ``graph_ms`` (the calls
captured in a CUDA graph, so none of the host's work is timed), and each
of its two launches alone (``summary_ms``, ``apply_ms``). Every
step is first held bit for bit against the plain versions
(``shard_wave_pair`` / ``shard_topk_pair``). The inputs are the smoke's:
the north star's first wave (uniform: the mega mode) at S = 2 and 4,
mixed's first per-group wave (speculative) and one gang of it (replay),
the tight fit's first gang (shard_topk's dense-column replay); and the XL
input's node block (``XLClusterSpec()`` padded to 131,072 nodes: 65,536 a
rank at S = 2, 131,072 at S = 1) in every mode. The batches are
``sharded_schedule_batch`` on a one-rank NCCL mesh, the dense rung (W=8)
and the top-K rung (K=16) at the north star and on the XL input (K=128 on
the top-K rung), each held against the single-device batch once.

``--tree`` is the root of a checkout whose package and ``csrc/`` are timed
(default: this repository); the timing code is this repository's, so a
parent commit unpacked with ``git archive`` and the change are timed alike
when the script runs once a tree, in turns. Prints one JSON line a step or
batch, then one line with all of them; ``--out`` also writes that line to
a file."""

import argparse
import functools
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVE = 8
K = 16  # the smoke's SHARD_TOPK_K
XL_BATCH_K = 128  # the smoke's SHARD_TOPK_XL_K
BATCH_REPS = 3


def load_smoke():
    """This repository's chip_smoke.py as a module (its functions import the
    package lazily, so they use whichever package ``sys.path`` finds)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def build():
    """Both libraries from the tree's csrc/, their nvcc in parallel."""
    from batch_scheduler_tpu_torch.ops import _build

    errors = []

    def one(name):
        try:
            _build.library(name)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {e}")

    threads = [threading.Thread(target=one, args=(n,)) for n in ("shard_wave", "shard_topk")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("; ".join(errors))


def step_cases(cs):
    """(kernel, label, mode, scan inputs, wave, ranks) of every timed step."""
    from batch_scheduler_tpu_torch.ops import oracle
    from batch_scheduler_tpu_torch.sim.scenarios import XLClusterSpec

    ns, _ = cs.shard_north_star_args()
    ns = cs.scan_inputs(ns)
    per_group, _ = cs.mixed_batch(*cs.MIXED[:2], cs.MIXED[2], per_group=True)
    mixed = cs.scan_inputs(per_group)
    tight = cs.scan_inputs(cs.tight_batch())
    xl = cs.xl_operands(XLClusterSpec(), cs.XL_PAD)
    out = []
    for s in (2, 4):
        out += [("shard_wave", f"mega_s{s}", oracle.SHARD_MEGA, ns, WAVE, s),
                ("shard_wave", f"speculative_s{s}", oracle.SHARD_SPECULATIVE, mixed, WAVE, s),
                ("shard_wave", f"replay_s{s}", oracle.SHARD_REPLAY, mixed, 1, s)]
    out += [("shard_topk", "mega_s2", oracle.TOPK_MEGA, ns, WAVE, 2),
            ("shard_topk", "speculative_s2", oracle.TOPK_SPECULATIVE, mixed, WAVE, 2),
            ("shard_topk", "replay_restricted_s2", oracle.TOPK_REPLAY, mixed, 1, 2),
            ("shard_topk", "replay_dense_s2", oracle.TOPK_REPLAY, tight, 1, 2)]
    for s in (2, 1):
        out += [("shard_wave", f"xl_mega_s{s}", oracle.SHARD_MEGA, xl, WAVE, s),
                ("shard_wave", f"xl_speculative_s{s}", oracle.SHARD_SPECULATIVE, xl, WAVE, s),
                ("shard_wave", f"xl_replay_s{s}", oracle.SHARD_REPLAY, xl, 1, s),
                ("shard_topk", f"xl_mega_s{s}", oracle.TOPK_MEGA, xl, WAVE, s),
                ("shard_topk", f"xl_speculative_s{s}", oracle.TOPK_SPECULATIVE, xl, WAVE, s),
                ("shard_topk", f"xl_replay_s{s}", oracle.TOPK_REPLAY, xl, 1, s)]
    return out


def time_step(cs, kernel, mode, scan_args, w, s):
    """The step of ``kernel`` on rank 0's block: checked against the plain
    versions on every rank, then timed alone. Returns its record."""
    from batch_scheduler_tpu_torch.ops import oracle
    from batch_scheduler_tpu_torch.ops.assign_scan import shard_apply_cuda, shard_summary_cuda

    blocks, req_c, need_c = cs.shard_wave_blocks(scan_args, s, 0, w)
    rec = {"nodes_a_rank": blocks[0][0].shape[0], "wave": w, "ranks": s}
    if kernel == "shard_wave":
        def plain_apply(*a):
            return oracle.shard_wave_apply(*a[:-1])

        for rank in range(s):
            got = cs.shard_wave_pair(shard_summary_cuda, shard_apply_cuda, mode, blocks, req_c,
                                     need_c, rank)
            want = cs.shard_wave_pair(oracle.shard_wave_summary, plain_apply, mode, blocks, req_c,
                                      need_c, rank)
            err, equal = cs.max_err(got, want)
            if not equal:
                raise AssertionError(f"shard_wave mode {mode} S={s} rank {rank}: kernel differs "
                                     f"from plain (max abs err {err})")
        merged = want[2 * s]
        step = functools.partial(cs.shard_wave_step, mode, blocks[0], req_c, need_c, 0, merged)
    else:
        rows = w if mode == oracle.TOPK_SPECULATIVE else 1
        for rank in range(s):
            got = cs.shard_topk_pair(mode, blocks, req_c[:rows], need_c, rank, True)
            want = cs.shard_topk_pair(mode, blocks, req_c[:rows], need_c, rank, False)
            err, equal = cs.max_err(got, want)
            if not equal:
                raise AssertionError(f"shard_topk mode {mode} S={s} rank {rank}: kernel differs "
                                     f"from plain (max abs err {err})")
        merged = want[2 * s]
        rec["dense_demotions"] = int(want[2 * s + 4].item())
        step = functools.partial(cs.shard_topk_step, mode, blocks[0], req_c[:rows], need_c, 0,
                                 merged)
    rec["ms"] = cs.graph_ms(step())
    rec["summary_ms"] = cs.graph_ms(step(parts=("summary",)))
    rec["apply_ms"] = cs.graph_ms(step(parts=("apply",)))
    return rec


def batch_times(cs):
    """The whole sharded batches on a one-rank NCCL mesh: median wall ms of
    BATCH_REPS batches (each ends in a synchronise), held against the
    single-device batch once."""
    import socket

    import torch

    from batch_scheduler_tpu_torch.ops.convert import args_from_numpy
    from batch_scheduler_tpu_torch.ops.oracle import schedule_batch
    from batch_scheduler_tpu_torch.parallel import (
        init_distributed, make_mesh, sharded_schedule_batch)
    from batch_scheduler_tpu_torch.sim.scenarios import XLClusterSpec

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(BST_COORDINATOR=f"127.0.0.1:{port}", BST_NUM_PROCESSES="1",
                      BST_PROCESS_ID="0")
    if not init_distributed(backend="nccl", device="cuda"):
        raise AssertionError("BST_COORDINATOR not picked up")
    mesh = make_mesh("cuda")
    ns, _ = cs.shard_north_star_args()
    xl, _ = cs.xl_batch_args(cs.xl_operands(XLClusterSpec(), cs.XL_PAD))
    out = {}
    for label, args, topk in (("north_star_dense", ns, 0), ("north_star_topk", ns, K),
                              ("xl_dense", xl, 0), ("xl_topk", xl, XL_BATCH_K)):
        want = schedule_batch(*args_from_numpy(args, "cuda"))
        walls = []
        for _ in range(BATCH_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = sharded_schedule_batch(mesh, args, sharded_scan=True, scan_wave=WAVE,
                                         scan_topk=topk)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        diff = cs.shard_diff(got, want)
        if diff:
            raise AssertionError(f"{label}: the sharded batch differs from the single-device "
                                 f"one in {diff}")
        out[label] = {"wall_ms": walls, "wall_ms_median": statistics.median(walls),
                      "waves": int(got["wave_conflicts"].numel()),
                      "replayed": int(got["wave_conflicts"].sum().item()),
                      "uniform": int(got["wave_megas"].sum().item())}
        print(json.dumps({"batch": label, **out[label]}), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default="",
                    help="time only the steps whose names hold one of these comma-separated "
                         "strings, and no batches")
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("shard_steps: no CUDA device", file=sys.stderr)
        return 2
    cs = load_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    build()
    report = {"tree": root, "card": card.strip(), "build_s": time.perf_counter() - t0,
              "steps": {}}
    only = [x for x in args.only.split(",") if x]
    for kernel, label, mode, scan_args, w, s in step_cases(cs):
        if only and not any(x in f"{kernel}/{label}" for x in only):
            continue
        times = {"ms": [], "summary_ms": [], "apply_ms": []}
        for _ in range(args.repeat):
            rec = time_step(cs, kernel, mode, scan_args, w, s)
            for key, v in times.items():
                v.append(rec.pop(key))
        rec.update(times, ms_min=min(times["ms"]))
        report["steps"][f"{kernel}/{label}"] = rec
        print(json.dumps({"step": f"{kernel}/{label}", **rec}), flush=True)
    if not only:
        report["batches"] = batch_times(cs)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
