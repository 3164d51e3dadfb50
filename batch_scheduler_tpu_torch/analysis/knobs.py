"""Checker ``knobs``: the BST_* env-knob registry, kept mechanical.

Two invariants:

1. **Parse-guard discipline** (the BST_SCAN_WAVE idiom, ops/oracle.py): a
   typo'd knob must degrade to the working default, never crash a batch.
   Mechanized as: any ``int(...)``/``float(...)`` conversion of a
   ``BST_*`` env read (direct, or through one local name) must sit inside
   a ``try`` whose handlers catch ``ValueError`` (or ``TypeError`` /
   ``Exception`` / bare).  Flag-style string comparisons need no guard.

2. **Documentation**: every knob read anywhere in the scanned tree (the
   port's package, ``chip_smoke.py`` and the port's scripts) must appear
   in README.md's env-knob tables. Dynamically-built names (f-strings
   like ``BST_SLO_{sig}_P95_S``) are checked as a family by their literal
   prefix, which the README documents with the ``BST_SLO_<SIGNAL>``
   spelling.

Writes (``os.environ["BST_X"] = ...``) configure child code and are
exempt. Suppress one line with ``# analysis: allow(knobs) <reason>``.
The messages are the JAX package's checker's, word for word.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .annotations import comment_map, is_suppressed, suppressions_at
from .findings import Finding

CHECKER = "knobs"

_CATCH_OK = {"ValueError", "TypeError", "Exception", None}  # None = bare except


def _env_read_key(node: ast.AST) -> Optional[ast.AST]:
    """The key expression of an env read, or None.

    Matches ``os.environ.get(K, ...)``, ``os.getenv(K, ...)``,
    ``os.environ[K]`` (Load ctx only — subscript stores are writes).
    """
    if isinstance(node, ast.Call):
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr == "get"
            and isinstance(f.value, ast.Attribute)
            and f.value.attr == "environ"
        ) or (isinstance(f, ast.Attribute) and f.attr == "getenv") or (
            isinstance(f, ast.Name) and f.id == "getenv"
        ):
            return node.args[0] if node.args else None
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        v = node.value
        if isinstance(v, ast.Attribute) and v.attr == "environ":
            key = node.slice
            if isinstance(key, ast.Index):  # py<3.9 compat
                key = key.value
            return key
    return None


def _knob_name(key: ast.AST) -> Optional[Tuple[str, bool]]:
    """(name-or-prefix, is_family) if the key is a BST_* knob."""
    if isinstance(key, ast.Constant) and isinstance(key.value, str):
        if key.value.startswith("BST_"):
            return key.value, False
        return None
    if isinstance(key, ast.JoinedStr) and key.values:
        head = key.values[0]
        if (
            isinstance(head, ast.Constant)
            and isinstance(head.value, str)
            and head.value.startswith("BST_")
        ):
            return head.value, True
    if isinstance(key, ast.Name):
        # module-level constant like _WAVE_ENV = "BST_SCAN_WAVE" — resolved
        # by the caller against the file's constant bindings
        return key.id, None  # type: ignore[return-value]
    return None


def _module_str_constants(tree: ast.AST) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            if isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = node.value.value
    return out


def _parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _guarded_by_try(node: ast.AST, parents: Dict[ast.AST, ast.AST]) -> bool:
    prev = node
    cur = node
    while cur in parents:
        prev, cur = cur, parents[cur]
        if isinstance(cur, ast.Try):
            # only the try BODY is guarded — a parse inside an except
            # handler / else / finally raises past this Try
            if not any(prev is stmt for stmt in cur.body):
                continue
            for h in cur.handlers:
                names: Set[Optional[str]] = set()
                t = h.type
                if t is None:
                    names.add(None)
                elif isinstance(t, ast.Tuple):
                    names |= {
                        e.id if isinstance(e, ast.Name) else getattr(e, "attr", "")
                        for e in t.elts
                    }
                elif isinstance(t, ast.Name):
                    names.add(t.id)
                elif isinstance(t, ast.Attribute):
                    names.add(t.attr)
                if names & _CATCH_OK:
                    return True
    return False


class _KnobScan(ast.NodeVisitor):
    """One file: collect (knob, line, node) reads and parse sites."""

    def __init__(self, consts: Dict[str, str]):
        self.consts = consts
        self.reads: List[Tuple[str, bool, ast.AST]] = []

    def visit_Call(self, node: ast.Call) -> None:
        self._note(node)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        self._note(node)
        self.generic_visit(node)

    def _note(self, node: ast.AST) -> None:
        key = _env_read_key(node)
        if key is None:
            return
        got = _knob_name(key)
        if got is None:
            return
        name, family = got
        if family is None:  # Name indirection — resolve via constants
            resolved = self.consts.get(name, "")
            if not resolved.startswith("BST_"):
                return
            name, family = resolved, False
        self.reads.append((name, bool(family), node))


def check_source(path: str, source: str, readme_text: str) -> List[Finding]:
    findings: List[Finding] = []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return findings
    supp = suppressions_at(comment_map(source), path)
    consts = _module_str_constants(tree)
    scan = _KnobScan(consts)
    scan.visit(tree)
    if not scan.reads:
        return findings
    parents = _parent_map(tree)

    def _enclosing_fn(n: ast.AST) -> Optional[ast.AST]:
        cur = n
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
        return None

    # map: (enclosing function, name assigned from an env read) -> read
    # node. Scoped per function: a parameter named `raw` in one function
    # must not be tainted by an env-read local of the same name elsewhere
    env_named: Dict[Tuple[Optional[ast.AST], str], ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                for _, _, read in scan.reads:
                    # the read (or a strip()/or-chain around it) is the value
                    if _contains(node.value, read):
                        env_named[(_enclosing_fn(node), t.id)] = read

    for name, family, read in scan.reads:
        line = getattr(read, "lineno", 0)
        if is_suppressed(supp, line, CHECKER):
            continue
        # 1) documentation
        if name not in readme_text:
            label = f"{name}* (family)" if family else name
            findings.append(
                Finding(
                    CHECKER,
                    path,
                    line,
                    f"knob {label} is read here but missing from README.md's "
                    "env-knob table — document it (value grammar + default) "
                    "or the knob is invisible to operators",
                )
            )
        # 2) parse-guard: direct int()/float() around the read, including
        # the map(int, env.split(",")) spelling
        cur = read
        while cur in parents:
            parent = parents[cur]
            if isinstance(parent, ast.Call) and isinstance(parent.func, ast.Name):
                is_parse = parent.func.id in ("int", "float") or (
                    parent.func.id == "map"
                    and parent.args
                    and isinstance(parent.args[0], ast.Name)
                    and parent.args[0].id in ("int", "float")
                )
                if is_parse and not _guarded_by_try(parent, parents):
                    findings.append(_parse_finding(path, parent, name))
                    break
            cur = parent

    # 2b) parse-guard through one local name, same function only:
    # raw = os.environ.get(...); int(raw) outside try
    if env_named:
        knob_of_read = {id(read): name for name, _, read in scan.reads}
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("int", "float")
                and node.args
                and isinstance(node.args[0], ast.Name)
            ):
                key = (_enclosing_fn(node), node.args[0].id)
                if key not in env_named:
                    continue
                line = getattr(node, "lineno", 0)
                if is_suppressed(supp, line, CHECKER):
                    continue
                if not _guarded_by_try(node, parents):
                    knob = knob_of_read.get(id(env_named[key]), "BST_*")
                    findings.append(_parse_finding(path, node, knob))
    return findings


def _parse_finding(path: str, node: ast.AST, knob: str) -> Finding:
    return Finding(
        CHECKER,
        path,
        getattr(node, "lineno", 0),
        f"unguarded {getattr(node.func, 'id', 'parse')}() of knob {knob} — a "
        "typo'd value raises ValueError in the serving path; wrap in "
        "try/except and degrade to the default (the BST_SCAN_WAVE "
        "parse-guard idiom, ops/oracle.py)",
    )


def _contains(haystack: ast.AST, needle: ast.AST) -> bool:
    return any(n is needle for n in ast.walk(haystack))
