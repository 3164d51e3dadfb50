"""``python -m batch_scheduler_tpu_torch.analysis``: the port's analyzer gate.

The JAX package's analyzer suite (``batch_scheduler_tpu/analysis/``)
walks only its own package; this is the port's own copy, run over the
port's tree. Four checkers, all pure stdlib AST/tokenize: no imports of
the checked modules, no torch, so the sweep takes seconds:

  guarded-by   static lock discipline over annotated shared attributes
  knobs        BST_* parse-guard discipline + README knob-table coverage
  wire         MsgType exhaustiveness on both peer dispatch paths
  metrics      bst_ namespace, single-kind, documented in the catalog

The JAX package's ``jit-purity`` (the port traces no function) and
``coupling`` (its groups name JAX sources) have no counterpart here.

Exit 0 with no findings; exit 1 with findings rendered one per line
(file:line: [checker] message). Every ``allow()`` suppression is
inventoried on stderr, and one without a reason is a finding. The
BST_LOCKCHECK runtime mode lives in lockcheck.py, armed by env var, not
by this runner.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Iterable, List, Optional, Tuple

from . import annotations as ann
from . import guards, knobs, wire
from .findings import Finding, render_all

PACKAGE = "batch_scheduler_tpu_torch"

# everything the knobs checker and the suppression inventory read: the
# package, the card smoke and the port's scripts
_KNOB_SCOPE = [
    PACKAGE,
    "chip_smoke.py",
    os.path.join("scripts", "executor_split.py"),
    os.path.join("scripts", "slab_split.py"),
]

# directories never scanned: bytecode caches and the kernels' build outputs
_EXCLUDE_PARTS = ("__pycache__", "build")

# the README section whose table lists the port-only metric series
_PORT_SECTION = "## The PyTorch/CUDA port"

METRICS_CATALOG = "docs/observability.md or README.md's port metrics table"


def package_root() -> str:
    """The repo root: analysis/ -> batch_scheduler_tpu_torch/ -> root."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def _iter_py(root: str, subdirs: Iterable[str]) -> Iterable[str]:
    for sub in subdirs:
        base = os.path.join(root, sub)
        if os.path.isfile(base):
            yield base
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d not in _EXCLUDE_PARTS]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def _read(path: str) -> str:
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def _rel(root: str, path: str) -> str:
    return os.path.relpath(path, root)


def annotated_sources(
    root: str, modules: Optional[List[str]] = None
) -> List[Tuple[str, str]]:
    """(path, source) for every package file (lockcheck.install reuses this)."""
    if modules:
        paths = [os.path.join(root, m) for m in modules]
    else:
        paths = list(_iter_py(root, [PACKAGE]))
    return [(p, _read(p)) for p in paths]


def port_metrics_table(readme: str) -> str:
    """The table rows of README.md's port section: the port-only series
    (those the JAX package does not register) are documented there, as
    ``docs/observability.md`` belongs to the JAX package."""
    start = readme.find(_PORT_SECTION)
    if start < 0:
        return ""
    end = readme.find("\n## ", start + len(_PORT_SECTION))
    section = readme[start:] if end < 0 else readme[start:end]
    return "\n".join(
        line for line in section.splitlines() if line.lstrip().startswith("|")
    )


def run_guards(root: str) -> List[Finding]:
    findings: List[Finding] = []
    for path, source in annotated_sources(root):
        mod = ann.scan_module(path, source)
        if mod.classes or mod.guarded_globals:
            for f in guards.check_module(mod, source):
                f.path = _rel(root, f.path)
                findings.append(f)
    return findings


def run_knobs(root: str) -> List[Finding]:
    readme = _read(os.path.join(root, "README.md"))
    findings: List[Finding] = []
    for path in _iter_py(root, _KNOB_SCOPE):
        for f in knobs.check_source(path, _read(path), readme):
            f.path = _rel(root, f.path)
            findings.append(f)
    return findings


def run_wire(root: str) -> List[Finding]:
    svc = os.path.join(root, PACKAGE, "service")
    protocol_path = os.path.join(svc, "protocol.py")
    peers = [
        ("server dispatch", os.path.join(svc, "server.py")),
        ("client annotation", os.path.join(svc, "client.py")),
    ]
    return wire.check_wire(
        _rel(root, protocol_path),
        _read(protocol_path),
        [(role, _rel(root, p), _read(p)) for role, p in peers],
    )


def run_metrics(root: str) -> List[Finding]:
    catalog = _read(os.path.join(root, "docs", "observability.md"))
    catalog += "\n" + port_metrics_table(_read(os.path.join(root, "README.md")))
    files = [
        (_rel(root, p), _read(p))
        for p in _iter_py(root, [PACKAGE])
        # the metrics module itself is the registry implementation: its
        # counter()/gauge()/histogram() defs and internal calls are plumbing
        if os.path.basename(p) != "metrics.py"
    ]
    return wire.check_metrics(files, catalog, METRICS_CATALOG)


CHECKS = {
    "guarded-by": run_guards,
    "knobs": run_knobs,
    "wire": run_wire,
    "metrics": run_metrics,
}


def suppression_inventory(root: str) -> Tuple[List[ann.Suppression], List[Finding]]:
    """Every allow() suppression in the scanned tree; reasonless ones are
    findings, so the gate holds zero unreviewed escapes."""
    supps: List[ann.Suppression] = []
    findings: List[Finding] = []
    for path in _iter_py(root, _KNOB_SCOPE):
        source = _read(path)
        mod_supps = ann.suppressions_at(ann.comment_map(source), path)
        for s in mod_supps.values():
            s.path = _rel(root, s.path)
            supps.append(s)
            if not s.reason:
                findings.append(
                    Finding(
                        "suppressions",
                        s.path,
                        s.line,
                        f"allow({s.checker}) without a reason — every "
                        "suppression must say why (docs/static_analysis.md)",
                    )
                )
    return supps, findings


def run_all(
    root: Optional[str] = None, checks: Optional[List[str]] = None
) -> Tuple[List[Finding], List[ann.Suppression]]:
    root = root or package_root()
    findings: List[Finding] = []
    for name, fn in CHECKS.items():
        if checks and name not in checks:
            continue
        findings.extend(fn(root))
    supps, supp_findings = suppression_inventory(root)
    findings.extend(supp_findings)
    return findings, supps


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m batch_scheduler_tpu_torch.analysis",
        description="the port's invariant analyzer suite",
    )
    parser.add_argument("--root", default=None, help="repo root to scan")
    parser.add_argument(
        "--check",
        action="append",
        choices=sorted(CHECKS),
        help="run only the named checker(s)",
    )
    args = parser.parse_args(argv)
    root = args.root or package_root()

    t0 = time.monotonic()
    findings, supps = run_all(root, args.check)
    dt = time.monotonic() - t0
    if supps:
        print(f"# {len(supps)} reviewed suppression(s):", file=sys.stderr)
        for s in supps:
            print(
                f"#   {s.path}:{s.line}: allow({s.checker}) {s.reason}",
                file=sys.stderr,
            )
    if findings:
        print(render_all(findings))
        print(
            f"analyze: {len(findings)} finding(s) in {dt:.2f}s",
            file=sys.stderr,
        )
        return 1
    print(f"analyze: clean ({dt:.2f}s)", file=sys.stderr)
    return 0
