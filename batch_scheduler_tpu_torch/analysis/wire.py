"""Checkers ``wire`` + ``metrics``: protocol and telemetry exhaustiveness.

**wire**: every ``MsgType`` member declared in service/protocol.py must be
either referenced (handled) in the server dispatch file AND the client
annotation-path file, or explicitly waived in that file with a

    # msgtype-ignored: <NAME> <reason>

comment, so a new frame type fails the gate until both peers say
something about it.

**metrics**: every metric registered anywhere in the package must be
``bst_``-prefixed, documented in the metrics catalog, and registered
under a single metric kind (counter/gauge/histogram): the Registry
raises TypeError on kind conflicts only at runtime, on whichever path
loses the race. Registration sites with a non-constant name must carry
``# analysis: allow(metrics) <reason>``. The port's catalog is
``docs/observability.md`` plus README.md's table of port-only series
(runner.run_metrics); the messages are the JAX package's checker's.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from .annotations import comment_map, is_suppressed, suppressions_at
from .findings import Finding

WIRE = "wire"
METRICS = "metrics"

MSG_IGNORED_RE = re.compile(r"#\s*msgtype-ignored:\s*([A-Z_0-9]+)\s+(\S.*)")

_METRIC_METHODS = ("counter", "gauge", "histogram")


def msgtype_members(protocol_source: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    tree = ast.parse(protocol_source)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "MsgType":
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and isinstance(
                    stmt.value, ast.Constant
                ):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            out[t.id] = stmt.lineno
    return out


def _referenced_msgtypes(source: str) -> Set[str]:
    refs: Set[str] = set()
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return refs
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            v = node.value
            if (isinstance(v, ast.Name) and v.id == "MsgType") or (
                isinstance(v, ast.Attribute) and v.attr == "MsgType"
            ):
                refs.add(node.attr)
    return refs


def _ignored_msgtypes(source: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for text in comment_map(source).values():
        m = MSG_IGNORED_RE.search(text)
        if m:
            out[m.group(1)] = m.group(2).strip()
    return out


def check_wire(
    protocol_path: str,
    protocol_source: str,
    peers: List[Tuple[str, str, str]],
) -> List[Finding]:
    """peers: (role, path, source) for the server and client files."""
    findings: List[Finding] = []
    members = msgtype_members(protocol_source)
    if not members:
        findings.append(
            Finding(WIRE, protocol_path, 0, "no MsgType class found in protocol")
        )
        return findings
    for role, path, source in peers:
        refs = _referenced_msgtypes(source)
        ignored = _ignored_msgtypes(source)
        for name, line in sorted(members.items()):
            if name in refs or name in ignored:
                continue
            findings.append(
                Finding(
                    WIRE,
                    path,
                    0,
                    f"MsgType.{name} (protocol.py:{line}) is neither handled "
                    f"nor explicitly waived on the {role} path — handle it or "
                    f"add '# msgtype-ignored: {name} <reason>' (both peers "
                    "must stay exhaustive; the POLICY_INFO lesson)",
                )
            )
    return findings


def collect_metric_registrations(
    path: str, source: str
) -> Tuple[List[Tuple[str, str, int, int]], List[Tuple[int, int]]]:
    """([(name, kind, line, end_line)], [(line, end_line) non-constant])."""
    out: List[Tuple[str, str, int, int]] = []
    dynamic: List[Tuple[int, int]] = []
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return out, dynamic
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _METRIC_METHODS
            and node.args
        ):
            end = getattr(node, "end_lineno", node.lineno) or node.lineno
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                out.append((first.value, node.func.attr, node.lineno, end))
            else:
                dynamic.append((node.lineno, end))
    return out, dynamic


def check_metrics(
    files: List[Tuple[str, str]],
    observability_text: str,
    catalog: str = "docs/observability.md",
) -> List[Finding]:
    """``catalog`` names, in the undocumented-metric message, where the
    ``observability_text`` comes from."""
    findings: List[Finding] = []
    kinds: Dict[str, Set[str]] = {}
    sites: Dict[str, List[Tuple[str, int, str]]] = {}
    for path, source in files:
        supp = suppressions_at(comment_map(source), path)
        regs, dynamic = collect_metric_registrations(path, source)

        def _span_suppressed(line: int, end: int) -> bool:
            # trailing allow() comments may sit on any line the call spans
            return any(
                is_suppressed(supp, l, METRICS) for l in range(line, end + 1)
            )

        for line, end in dynamic:
            if not _span_suppressed(line, end):
                findings.append(
                    Finding(
                        METRICS,
                        path,
                        line,
                        "metric registered under a non-constant name — the "
                        "registry can't be audited statically; add "
                        "'# analysis: allow(metrics) <reason>' naming where "
                        "the names are enumerated",
                    )
                )
        for name, kind, line, end in regs:
            if _span_suppressed(line, end):
                continue
            kinds.setdefault(name, set()).add(kind)
            sites.setdefault(name, []).append((path, line, kind))
            if not name.startswith("bst_"):
                findings.append(
                    Finding(
                        METRICS,
                        path,
                        line,
                        f"metric '{name}' is not bst_-prefixed — every metric "
                        "this codebase exports shares the bst_ namespace",
                    )
                )
            if name not in observability_text:
                findings.append(
                    Finding(
                        METRICS,
                        path,
                        line,
                        f"metric '{name}' is not documented in "
                        f"{catalog} — add it to the metrics "
                        "catalog (name, kind, meaning)",
                    )
                )
    for name, ks in sorted(kinds.items()):
        if len(ks) > 1:
            path, line, _ = sites[name][0]
            findings.append(
                Finding(
                    METRICS,
                    path,
                    line,
                    f"metric '{name}' is registered as multiple kinds "
                    f"({', '.join(sorted(ks))}) — the Registry raises "
                    "TypeError at runtime on whichever path registers second",
                )
            )
    return findings
