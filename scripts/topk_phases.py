"""Run chip_smoke.py's build and a few of its phases from a source tree, on
the card: the top-K kernel's phases (north_star_topk, xl_topk) or
coalesce_drf, each printed as chip_smoke prints it (one JSON line a phase,
its timings included).

    python3 scripts/topk_phases.py [--tree DIR] [--phases a,b] [--repeat N]

``--tree`` is the root of a checkout (default: this repository), so two
trees can be timed in one process's turn on one card, e.g. a parent commit
unpacked with ``git archive`` beside the change: run the script once a
tree, in turns. ``--repeat`` runs the phases that many times (the
coalesce_drf check's spread)."""

import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--phases", default="north_star_topk,xl_topk")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("topk_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    if chip_smoke.build() is None:
        return 1
    results = {}
    for _ in range(args.repeat):
        for name in args.phases.split(","):
            getattr(chip_smoke, name)(results)
    return 0 if all(ok for _, ok in chip_smoke.PHASES) else 1


if __name__ == "__main__":
    sys.exit(main())
