"""Checker ``guarded-by`` — static lock-discipline verification.

For every attribute carrying a ``# guarded-by: <lock>`` annotation
(annotations.scan_module), every lexical read/write of ``self.<attr>``
must occur inside ``with self.<lock>:`` (or inside a method whose ``def``
line documents ``# lock-held: <lock>``). Module-level guarded globals are
checked the same way against module-level ``with <lock>:`` blocks.

The check is lexical, the same approximation clang's thread-safety
analysis makes: a closure defined under a ``with`` is treated as guarded
even though it may run later. The BST_LOCKCHECK runtime mode (lockcheck.py)
closes that gap dynamically, which is why both exist.

Exemptions baked into the discipline (documented in
docs/static_analysis.md):
  * ``__init__``/``__del__`` bodies — construction and finalization are
    single-threaded by contract.
  * methods annotated ``# lock-held: <lock>`` hold that lock throughout.
  * ``# analysis: allow(guarded-by) <reason>`` suppresses one line.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from .annotations import (
    ModuleAnnotations,
    comment_map,
    is_suppressed,
    suppressions_at,
)
from .findings import Finding

CHECKER = "guarded-by"

# methods whose body runs before/after the instance is shared
_SINGLE_THREADED = {"__init__", "__del__", "__post_init__"}


def _with_locks(node: ast.With, *, self_scope: bool) -> Set[str]:
    """Lock names a ``with`` statement acquires (self.X or bare globals)."""
    out: Set[str] = set()
    for item in node.items:
        ctx = item.context_expr
        # unwrap common acquire forms: with self._lock, with LOCK,
        # with self._cond (Condition is lock-like)
        if isinstance(ctx, ast.Call):
            # e.g. with self._lock.acquire_timeout(...): not a guard we track
            continue
        if self_scope and isinstance(ctx, ast.Attribute):
            if isinstance(ctx.value, ast.Name) and ctx.value.id == "self":
                out.add(ctx.attr)
        if isinstance(ctx, ast.Name):
            out.add(ctx.id)
    return out


class _MethodChecker(ast.NodeVisitor):
    """Walks one function body tracking the lexically-held lock set."""

    def __init__(
        self,
        guarded: Dict[str, str],
        held: Set[str],
        findings: List[Finding],
        path: str,
        supp,
        *,
        self_scope: bool,
        context: str,
    ):
        self.guarded = guarded
        self.held = set(held)
        self.findings = findings
        self.path = path
        self.supp = supp
        self.self_scope = self_scope
        self.context = context

    def visit_With(self, node: ast.With) -> None:
        acquired = _with_locks(node, self_scope=self.self_scope)
        # the context expressions themselves are evaluated unguarded
        for item in node.items:
            self.visit(item.context_expr)
        before = set(self.held)
        self.held |= acquired
        for stmt in node.body:
            self.visit(stmt)
        self.held = before

    visit_AsyncWith = visit_With

    def _flag(self, node: ast.AST, attr: str, lock: str) -> None:
        line = getattr(node, "lineno", 0)
        if is_suppressed(self.supp, line, CHECKER):
            return
        self.findings.append(
            Finding(
                CHECKER,
                self.path,
                line,
                f"{self.context}: access to '{attr}' (guarded-by {lock}) "
                f"outside 'with {'self.' if self.self_scope else ''}{lock}'",
            )
        )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (
            self.self_scope
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in self.guarded
        ):
            lock = self.guarded[node.attr]
            if lock not in self.held:
                self._flag(node, f"self.{node.attr}", lock)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if not self.self_scope and node.id in self.guarded:
            lock = self.guarded[node.id]
            if lock not in self.held:
                self._flag(node, node.id, lock)
        self.generic_visit(node)


def _check_function(
    fn: ast.AST,
    guarded: Dict[str, str],
    lock_held: Dict[str, Set[str]],
    findings: List[Finding],
    path: str,
    supp,
    *,
    self_scope: bool,
    owner: str,
) -> None:
    name = fn.name
    if self_scope and name in _SINGLE_THREADED:
        return
    held = set(lock_held.get(name, ()))
    checker = _MethodChecker(
        guarded,
        held,
        findings,
        path,
        supp,
        self_scope=self_scope,
        context=f"{owner}.{name}" if owner else name,
    )
    for stmt in fn.body:
        checker.visit(stmt)


def check_module(mod: ModuleAnnotations, source: str) -> List[Finding]:
    findings: List[Finding] = []
    if mod.tree is None:
        return findings
    supp = suppressions_at(comment_map(source), mod.path)

    # class-scope: guarded self attributes
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and node.name in mod.classes:
            ca = mod.classes[node.name]
            if not ca.guarded:
                continue
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    _check_function(
                        sub,
                        ca.guarded,
                        ca.lock_held,
                        findings,
                        mod.path,
                        supp,
                        self_scope=True,
                        owner=node.name,
                    )

    # module-scope: guarded globals, checked across every top-level function
    # and class method in the file (globals are reachable from anywhere).
    # Only outermost defs are seeded — the visitor descends into closures
    # itself, so nested functions are not double-reported.
    if mod.guarded_globals:
        tops: List[ast.AST] = []
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                tops.append(node)
            elif isinstance(node, ast.ClassDef):
                tops.extend(
                    sub
                    for sub in node.body
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                )
        for node in tops:
            _check_function(
                node,
                mod.guarded_globals,
                mod.lock_held_funcs,
                findings,
                mod.path,
                supp,
                self_scope=False,
                owner="",
            )
    return findings
