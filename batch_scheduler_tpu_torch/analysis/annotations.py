"""Machine-readable invariant annotations: the grammar every checker shares.

A tokenize + AST scanner that turns trailing comments into a structured
registry the static checkers (and the ``BST_LOCKCHECK`` runtime mode)
consume. The grammar is the JAX package's (``docs/static_analysis.md``),
kept identical so one annotation means the same in both packages.

``# guarded-by: <lock>``
    Trailing comment on a ``self.<attr> = ...`` assignment (class scope) or
    a module-level ``NAME = ...`` assignment. Declares that every read or
    write of the attribute/global must happen while ``self.<lock>`` (or the
    module-level ``<lock>``) is held: lexically inside ``with <lock>:`` for
    the static checker, dynamically owned for the runtime checker.

``# lock-held: <lock>[, <lock2>]``
    Trailing comment on a ``def`` line. The method documents that its
    CALLERS hold the named lock(s); its body is checked as if the locks
    were held. The runtime checker verifies the claim by walking the call
    stack.

``# analysis: allow(<checker>) <reason>``
    Suppression, trailing on the flagged line (or alone on the line
    above). A reason is mandatory: the runner inventories every
    suppression and counts a reasonless one as a finding.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

# the marker may open the comment or follow prose ("# heap; guarded-by: x")
GUARDED_BY_RE = re.compile(r"guarded-by:\s*([A-Za-z_][A-Za-z_0-9]*)")
LOCK_HELD_RE = re.compile(
    r"lock-held:\s*([A-Za-z_][A-Za-z_0-9]*(?:\s*,\s*[A-Za-z_][A-Za-z_0-9]*)*)"
)
ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\(([a-z0-9_-]+)\)\s*(.*)")


@dataclass
class Suppression:
    path: str
    line: int
    checker: str
    reason: str


@dataclass
class ClassAnnotations:
    """Annotations for one class: attr name -> guard lock attr name."""

    module: str
    name: str
    guarded: Dict[str, str] = field(default_factory=dict)
    # method name -> set of lock attr names the caller holds
    lock_held: Dict[str, Set[str]] = field(default_factory=dict)
    lines: Dict[str, int] = field(default_factory=dict)  # attr -> decl line


@dataclass
class ModuleAnnotations:
    """One scanned file: class annotations plus module-global guards."""

    path: str
    classes: Dict[str, ClassAnnotations] = field(default_factory=dict)
    # module-level global name -> module-level lock global name
    guarded_globals: Dict[str, str] = field(default_factory=dict)
    global_lines: Dict[str, int] = field(default_factory=dict)
    # module-level function name -> lock globals the caller holds
    lock_held_funcs: Dict[str, Set[str]] = field(default_factory=dict)
    suppressions: List[Suppression] = field(default_factory=list)
    tree: Optional[ast.AST] = None


def comment_map(source: str) -> Dict[int, str]:
    """line number -> comment text for every comment token in the file."""
    out: Dict[int, str] = {}
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except tokenize.TokenError:
        pass
    return out


def suppressions_at(comments: Dict[int, str], path: str) -> Dict[Tuple[int, str], Suppression]:
    """(line, checker) -> Suppression for every allow() comment."""
    out: Dict[Tuple[int, str], Suppression] = {}
    for line, text in comments.items():
        m = ALLOW_RE.search(text)
        if m:
            out[(line, m.group(1))] = Suppression(
                path=path, line=line, checker=m.group(1), reason=m.group(2).strip()
            )
    return out


def is_suppressed(
    supp: Dict[Tuple[int, str], Suppression], line: int, checker: str
) -> bool:
    # trailing on the flagged line, or standalone on the line above
    return (line, checker) in supp or (line - 1, checker) in supp


def _assign_target_lines(node: ast.stmt):
    """Yield (kind, name, line) for annotatable assignment targets.

    kind is "self" for ``self.X = ...`` targets, "global" for module-level
    ``NAME = ...`` targets.
    """
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        targets = [node.target]
    for t in targets:
        if (
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
        ):
            yield "self", t.attr, node.lineno
        elif isinstance(t, ast.Name):
            yield "global", t.id, node.lineno


def scan_module(path: str, source: Optional[str] = None) -> ModuleAnnotations:
    """Parse one file's annotations into a ModuleAnnotations registry."""
    if source is None:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    mod = ModuleAnnotations(path=path)
    comments = comment_map(source)
    mod.suppressions = list(suppressions_at(comments, path).values())
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return mod
    mod.tree = tree

    def matching_comment(node: ast.stmt, regex) -> Optional[re.Match]:
        # trailing annotations attach to any line the statement spans — a
        # multi-line call keeps its annotation next to the closing paren.
        # EVERY comment in the span is searched: an unrelated inline
        # comment on an earlier line must not shadow the marker
        end = getattr(node, "end_lineno", node.lineno) or node.lineno
        for line in range(node.lineno, end + 1):
            text = comments.get(line)
            if text:
                m = regex.search(text)
                if m:
                    return m
        return None

    # module-level guarded globals + lock-held functions
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            m = matching_comment(node, GUARDED_BY_RE)
            if m:
                for kind, name, line in _assign_target_lines(node):
                    if kind == "global":
                        mod.guarded_globals[name] = m.group(1)
                        mod.global_lines[name] = line
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            text = comments.get(node.lineno)
            if text:
                m = LOCK_HELD_RE.search(text)
                if m:
                    mod.lock_held_funcs[node.name] = {
                        s.strip() for s in m.group(1).split(",")
                    }

    # class-scope annotations: guarded attrs declared anywhere inside the
    # class body (typically __init__), lock-held methods on def lines
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        ca = ClassAnnotations(module=path, name=node.name)
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                m = matching_comment(sub, GUARDED_BY_RE)
                if m:
                    for kind, name, line in _assign_target_lines(sub):
                        if kind == "self":
                            ca.guarded[name] = m.group(1)
                            ca.lines[name] = line
            elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                text = comments.get(sub.lineno)
                if text:
                    m = LOCK_HELD_RE.search(text)
                    if m:
                        ca.lock_held[sub.name] = {
                            s.strip() for s in m.group(1).split(",")
                        }
        if ca.guarded or ca.lock_held:
            mod.classes[node.name] = ca
    return mod
