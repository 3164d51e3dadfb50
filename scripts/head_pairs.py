"""Time the batch head kernel (csrc/batch_head.cu) alone on the card, in
each of its modes at the smoke's shapes, for the package of a source tree.

    python3 scripts/head_pairs.py [--tree DIR] [--repeat N] [--out FILE] [--check]

Cases: the north star's packed batch ([1024, 8192, 5], a broadcast mask,
every gang asking the same), a seeded batch of its shape whose gangs ask
different rows, the north star with the policy's anti-affinity fold
(seeded labels, 4 hash lanes), mixed's per-group input (R = 5), a seeded
batch of 12 lanes at the north star's width (the leftover in shared
memory), the XL input (``XLClusterSpec()`` padded to 131,072 nodes: [4096,
131072, 6], one request profile) and its three-profile form, the CLI's
quarter width ([256, 2048, 5], seeded), the replicated rung's two
blocks of mixed's per-group input cut to N = 5,003 (1 x 2 ranks: nb =
2,502, the second block's mask pointer at node 2,502), the finish on the
north star's matrix and the leftover alone at XL. Every case is first held
bit for bit against the plain version, then timed by chip_smoke.py's
``graph_ms`` (the calls captured in a CUDA graph, so none of the wrapper's
host work is timed) and with each call's host work (``cuda_ms``); the
whole-batch cases carry their bound (``ops.bounds.head_bound``). Last,
the card's write floor on the same bytes: PyTorch's ``fill_`` of two int32
[G, N] tensors at the north star's and XL's shapes, timed alike.

``--tree`` is the root of a checkout whose package and ``csrc/`` are timed
(default: this repository); the timing code is this repository's, so a
parent commit unpacked with ``git archive`` and the change are timed alike
when the script runs once a tree, in turns (parent, change, change,
parent). ``--check`` builds the source once more with ``-Xptxas -v`` (each
kernel's registers, shared memory and spills, printed), holds every case
against the plain version and stops without timing. Prints one JSON line a
case, then one line with all of them; ``--out`` also writes that line to a
file."""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_QUARTER = (256, 2048, 5)
HASH_LANES = 4
WIDE_LANES = 12  # past the 6 a thread keeps in registers
BIG_ENTRIES = 2**28  # [G, N] entries past which a graph holds 2 calls, not 20


def load_smoke():
    """This repository's chip_smoke.py as a module (its functions import the
    package lazily, so they use whichever package ``sys.path`` finds)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def ptxas_report():
    """nvcc of the tree's csrc/batch_head.cu with -Xptxas -v into its build
    directory: the compiler's lines about registers, shared memory and
    spills."""
    from batch_scheduler_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "ptxas" / "libbatch_head_ptxas.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                           str(_build.CSRC_DIR / "batch_head.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{proc.stdout}")
    return [line.strip() for line in proc.stdout.splitlines()
            if any(k in line for k in ("Compiling entry", "registers", "spill", "smem"))]


def seeded_batch(g, n, r, seed):
    """A packed batch of [g, n, r] from a seed, numpy: leftover, requests,
    needs, a broadcast mask (10% of nodes off) and every gang valid."""
    import numpy as np

    rng = np.random.default_rng(seed)
    requested = rng.integers(0, 40, size=(n, r)).astype(np.int32)
    alloc = rng.integers(0, 3000, size=(n, r)).astype(np.int32) + requested
    req = rng.integers(0, 40, size=(g, r)).astype(np.int32)
    req[:, 0] = np.maximum(req[:, 0], 1)
    rem = rng.integers(1, 20, size=g).astype(np.int32)
    mask = (rng.random((1, n)) >= 0.1)
    return alloc, requested, req, rem, mask, np.ones(g, bool)


def fold_columns(g, n, seed):
    """(anti [g], node_hash [n, HASH_LANES]) int32 from a seed over a small
    label vocabulary, so the fold hits and misses."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = np.array([0, 101, 202, 303, 404], np.int32)
    node_hash = vocab[rng.integers(0, len(vocab), size=(n, HASH_LANES))]
    anti = np.where(rng.random(g) < 0.5, vocab[rng.integers(1, len(vocab), size=g)], 0)
    return anti.astype(np.int32), np.ascontiguousarray(node_hash)


def cases(cs):
    """(label, kind, numpy inputs, extra) of every timed case."""
    from batch_scheduler_tpu_torch.sim.scenarios import XLClusterSpec

    ns, _ = cs.shard_north_star_args()
    ns = tuple(ns[:6])
    per_group, _ = cs.mixed_batch(*cs.MIXED, per_group=True)
    k = cs.SHARD_UNEVEN_N
    cut = (per_group[0][:k], per_group[1][:k], per_group[2], per_group[3], per_group[4][:, :k],
           per_group[5])
    xl, _ = cs.xl_batch_args(cs.xl_operands(XLClusterSpec(), cs.XL_PAD))
    xl = tuple(xl[:6])
    xl3, _ = cs.xl_batch_args(cs.xl_operands(XLClusterSpec(request_profiles=3), cs.XL_PAD))
    g, n = ns[2].shape[0], ns[0].shape[0]
    out = [("north_star", "whole", ns, None),
           ("north_star_rows", "whole", seeded_batch(g, n, ns[0].shape[1], seed=5), None),
           ("north_star_fold", "whole", ns, fold_columns(g, n, 7)),
           ("mixed_per_group", "whole", tuple(per_group[:6]), None),
           ("wide_lanes_r12", "whole", seeded_batch(g, n, WIDE_LANES, seed=12), None),
           ("xl", "whole", xl, None),
           ("xl_3_profiles", "whole", tuple(xl3[:6]), None),
           ("cli_quarter", "whole", seeded_batch(*CLI_QUARTER, seed=16), None)]
    nb = -(-k // 2)
    for rank in (0, 1):
        nodes = (min(rank * nb, k), min((rank + 1) * nb, k))
        out.append((f"block_n{k}_1x2_r{rank}", "block", cut,
                    ((0, cut[2].shape[0]), nodes, (cut[2].shape[0], nb), rank == 0)))
    out += [("finish_north_star", "finish", ns, None), ("left_xl", "left", xl, None)]
    return out


def prepare(kind, arrays, extra):
    """(kernel call, plain outputs, bound or None) of a case on the card."""
    import torch

    from batch_scheduler_tpu_torch.ops import batch_kernels as bk
    from batch_scheduler_tpu_torch.ops.bounds import head_bound

    cpu = [torch.from_numpy(a) for a in arrays]
    cuda = [t.cuda() for t in cpu]
    if kind == "whole":  # the plain version on the card (XL's [G, N] matrices are 2 GB each)
        fold = [torch.from_numpy(a).cuda() for a in extra] if extra is not None else [None, None]
        args = cuda + fold
        return (lambda: bk.batch_head_cuda(*args)), bk.batch_head_plain(*args), head_bound(*args)
    if kind == "block":
        groups, nodes, shape, with_left = extra
        plain_left, block = bk.head_block_cuda(cpu[0], cpu[1], cpu[2], cpu[4], groups, nodes,
                                               shape, with_left=with_left)
        want = (plain_left, block) if with_left else (block,)

        def call():
            left, got = bk.head_block_cuda(cuda[0], cuda[1], cuda[2], cuda[4], groups, nodes,
                                           shape, with_left=with_left)
            return (left, got) if with_left else (got,)
        return call, want, None
    if kind == "finish":
        cap = bk.batch_head_plain(*cpu)[1]
        want = bk.head_finish_cuda(cap, cpu[3], cpu[5])
        cap_cuda = cap.cuda()
        return (lambda: bk.head_finish_cuda(cap_cuda, cuda[3], cuda[5])), want, None
    want = (cpu[0] - cpu[1],)
    return (lambda: (bk.head_left_cuda(cuda[0], cuda[1]),)), want, None


def run_case(cs, label, kind, arrays, extra, timed):
    """A case held against its plain version, then (``timed``) timed alone."""
    import torch

    call, want, bound = prepare(kind, arrays, extra)
    got = call()
    torch.cuda.synchronize()
    err, equal = cs.max_err(tuple(got), tuple(w.to(t.device) for t, w in zip(got, want)))
    if not equal:
        raise AssertionError(f"{label}: the head kernel differs from the plain version "
                             f"(max abs err {err})")
    rec = {"kind": kind, "shape": [int(arrays[2].shape[0]), int(arrays[0].shape[0]),
                                   int(arrays[0].shape[1])],
           "mask_rows": int(arrays[4].shape[0]), "matched": True}
    if kind == "block":
        rec["block"] = {"groups": list(extra[0]), "nodes": list(extra[1]),
                        "shape": list(extra[2]), "with_left": extra[3]}
    if bound is not None:
        rec.update(bound_ms=bound[0], bound_by=bound[1], bytes=bound[2], int_ops=bound[3])
    if timed:
        # XL's outputs are 4 GB a call: 2 calls a graph (20 replays, 40 calls);
        # else 20 calls replayed 50 times: a mean over tens of milliseconds
        big = arrays[0].shape[0] * arrays[2].shape[0] > BIG_ENTRIES
        calls = 2 if big else 20
        rec["ms"] = cs.graph_ms(call, calls=calls, replays=20 if big else 50)
        rec["with_host_ms"] = cs.cuda_ms(call, calls)
    return rec


def write_floor(cs, g, n):
    """The card's write floor on the head's output bytes: ``fill_`` of two
    int32 [g, n] tensors (the capacity and the scores), timed as the cases
    are. PyTorch's fill is the yardstick, not a part of the port."""
    import torch

    a = torch.empty((g, n), dtype=torch.int32, device="cuda")
    b = torch.empty_like(a)

    def fill():
        a.fill_(7)
        b.fill_(9)

    big = g * n > BIG_ENTRIES
    return cs.graph_ms(fill, calls=2 if big else 20, replays=20 if big else 50)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", action="store_true",
                    help="print -Xptxas -v, hold every case against the plain version, no timing")
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("head_pairs: no CUDA device", file=sys.stderr)
        return 2
    cs = load_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    from batch_scheduler_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library("batch_head")
    report = {"tree": root, "card": card.strip(), "build_s": time.perf_counter() - t0,
              "cases": {}}
    if args.check:
        report["ptxas"] = ptxas_report()
        for line in report["ptxas"]:
            print(line, flush=True)
    for label, kind, arrays, extra in cases(cs):
        rows = [run_case(cs, label, kind, arrays, extra, not args.check)
                for _ in range(1 if args.check else args.repeat)]
        rec = rows[0]
        if not args.check:
            rec["ms"] = [row["ms"] for row in rows]
            rec["with_host_ms"] = [row["with_host_ms"] for row in rows]
            rec["ms_min"] = min(rec["ms"])
        report["cases"][label] = rec
        print(json.dumps({"case": label, **rec}), flush=True)
    if not args.check:
        for label, (g, n) in (("north_star", (1024, 8192)), ("xl", (4096, cs.XL_PAD))):
            ms = [write_floor(cs, g, n) for _ in range(args.repeat)]
            report["write_floor"] = {**report.get("write_floor", {}), label: ms}
            print(json.dumps({"write_floor": label, "shape": [g, n], "ms": ms}), flush=True)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
