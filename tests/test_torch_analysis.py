"""The port's analyzer suite (``batch_scheduler_tpu_torch/analysis/``)
held against the JAX package's (``batch_scheduler_tpu/analysis/``).

Findings are deterministic, so every comparison is exact: the same
``(checker, line, message)`` list from both packages' checkers on the
shared seeded fixtures (``tests/analysis_fixtures/``) and, file by file,
on the JAX package's own sources, a tree neither fixture was written for;
the same annotation registry from both ``scan_module`` on every annotated
file of the port. Then the gate itself: the port's analyzer over the repo
finds nothing, its CLI exits 1 on a seeded tree, and a suppression
without a reason is a finding."""

import ast
import os
import subprocess
import sys

import pytest

from batch_scheduler_tpu.analysis import annotations as ref_ann
from batch_scheduler_tpu.analysis import guards as ref_guards
from batch_scheduler_tpu.analysis import knobs as ref_knobs
from batch_scheduler_tpu.analysis import wire as ref_wire
from batch_scheduler_tpu_torch.analysis import annotations as port_ann
from batch_scheduler_tpu_torch.analysis import guards as port_guards
from batch_scheduler_tpu_torch.analysis import knobs as port_knobs
from batch_scheduler_tpu_torch.analysis import runner
from batch_scheduler_tpu_torch.analysis import wire as port_wire

REPO = runner.package_root()
FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")


def _read(path):
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def _fixture(name):
    path = os.path.join(FIXTURES, name)
    return path, _read(path)


def _triples(findings):
    return [(f.checker, f.path, f.line, f.message) for f in findings]


def _py_files(sub):
    out = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(REPO, sub)):
        dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "build"))
        out.extend(os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py"))
    return out


def _annotated(mod):
    return bool(mod.classes or mod.guarded_globals or mod.lock_held_funcs
                or mod.suppressions)


def _annotated_port_files():
    """Port files that either package's scanner finds an annotation in."""
    out = []
    for p in _py_files("batch_scheduler_tpu_torch"):
        src = _read(p)
        if _annotated(ref_ann.scan_module(p, src)) or _annotated(port_ann.scan_module(p, src)):
            out.append(os.path.relpath(p, REPO))
    return out


def _guards(ann, guards, path, src):
    return guards.check_module(ann.scan_module(path, src), src)


# -- parity on the shared fixtures ------------------------------------------


def test_guards_fixture_parity():
    path, src = _fixture("unguarded_access.py")
    ref = _guards(ref_ann, ref_guards, path, src)
    port = _guards(port_ann, port_guards, path, src)
    assert _triples(port) == _triples(ref)
    assert len(port) == 3


def test_knobs_fixture_parity():
    path, src = _fixture("undocumented_knob.py")
    readme = "| `BST_FIXTURE_INT` | `BST_FIXTURE_FLOAT` | `BST_FIXTURE_FLAG` |"
    ref = ref_knobs.check_source(path, src, readme)
    port = port_knobs.check_source(path, src, readme)
    assert _triples(port) == _triples(ref)
    assert len(port) == 3


def test_wire_fixture_parity():
    path, src = _fixture("unhandled_msgtype.py")
    tree = ast.parse(src)
    peers = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            peers[node.targets[0].id] = node.value.value
    args = (path, src, [("server dispatch", "server.py", peers["SERVER_SRC"]),
                        ("client annotation", "client.py", peers["CLIENT_SRC"])])
    ref = ref_wire.check_wire(*args)
    port = port_wire.check_wire(*args)
    assert _triples(port) == _triples(ref)
    assert sum("NEW_FRAME" in f.message for f in port) == 2


def test_metrics_fixture_parity():
    path, src = _fixture("unregistered_metric.py")
    doc = "bst_fixture_documented_total and bst_fixture_conflict are listed"
    ref = ref_wire.check_metrics([(path, src)], doc)
    port = port_wire.check_metrics([(path, src)], doc)
    assert _triples(port) == _triples(ref)
    msgs = [f.message for f in port]
    assert any("not bst_-prefixed" in m for m in msgs)
    assert any("not documented" in m for m in msgs)
    assert any("multiple kinds" in m for m in msgs)
    assert any("non-constant" in m for m in msgs)


ANNOTATED = _annotated_port_files()


def test_port_annotations_are_found():
    assert len(ANNOTATED) >= 18, ANNOTATED


def test_observatory_annotations_match_reference():
    """The gang observatory's classes carry the reference's guarded-by
    registry for the shared names (the port adds the observatory's lazy
    engine), and the guard checker finds nothing in either package's
    module."""
    port_path = os.path.join(REPO, "batch_scheduler_tpu_torch", "core", "explain.py")
    ref_path = os.path.join(REPO, "batch_scheduler_tpu", "core", "explain.py")
    port = port_ann.scan_module(port_path, _read(port_path))
    ref = ref_ann.scan_module(ref_path, _read(ref_path))
    assert port.classes["WhatIfEngine"].guarded == ref.classes["WhatIfEngine"].guarded == {
        "_baseline": "_lock", "queries": "_lock"}
    assert port.classes["Observatory"].guarded == {"_engine": "_lock"}
    assert _guards(port_ann, port_guards, port_path, _read(port_path)) == []
    holder = os.path.join(REPO, "batch_scheduler_tpu_torch", "ops", "device_state.py")
    scanned = port_ann.scan_module(holder, _read(holder))
    assert scanned.classes["DeviceStateHolder"].guarded["_borrowed"] == "_lock"
    assert "_own" in scanned.classes["DeviceStateHolder"].lock_held


@pytest.mark.parametrize("relpath", ANNOTATED)
def test_scan_module_agrees_on_port_file(relpath):
    """One annotation means the same in both packages: both scanners give
    the same registry for every annotated file of the port."""
    path = os.path.join(REPO, relpath)
    src = _read(path)
    ref, port = ref_ann.scan_module(path, src), port_ann.scan_module(path, src)

    def plain(mod):
        return (
            {name: (c.guarded, c.lock_held, c.lines) for name, c in mod.classes.items()},
            mod.guarded_globals, mod.global_lines, mod.lock_held_funcs,
            [(s.line, s.checker, s.reason) for s in mod.suppressions],
        )

    assert plain(port) == plain(ref)


# -- parity on real code: the JAX package's own sources ---------------------


def test_guards_parity_on_the_jax_package():
    files = _py_files("batch_scheduler_tpu")
    ref, port = [], []
    for path in files:
        src = _read(path)
        ref += _guards(ref_ann, ref_guards, path, src)
        port += _guards(port_ann, port_guards, path, src)
    assert _triples(port) == _triples(ref)
    annotated = sum("guarded-by:" in _read(p) for p in files)
    assert annotated >= 20


def test_knobs_parity_on_the_jax_package():
    readme = _read(os.path.join(REPO, "README.md"))
    ref, port = [], []
    reads = 0
    for path in _py_files("batch_scheduler_tpu"):
        src = _read(path)
        reads += src.count("BST_")
        ref += ref_knobs.check_source(path, src, readme)
        port += port_knobs.check_source(path, src, readme)
        # the same file against a README that documents nothing: every
        # knob read is a finding, so the readers agree on each read site
        ref += ref_knobs.check_source(path, src, "")
        port += port_knobs.check_source(path, src, "")
    assert _triples(port) == _triples(ref)
    assert reads and len(port) >= 40


def test_metrics_parity_on_the_jax_package():
    files = [(p, _read(p)) for p in _py_files("batch_scheduler_tpu")
             if os.path.basename(p) != "metrics.py"]
    obs = _read(os.path.join(REPO, "docs", "observability.md"))
    assert _triples(port_wire.check_metrics(files, obs)) == _triples(
        ref_wire.check_metrics(files, obs))
    # against an empty catalog every registration is a finding
    port = port_wire.check_metrics(files, "")
    assert _triples(port) == _triples(ref_wire.check_metrics(files, ""))
    assert len(port) >= 50


# -- the gate ----------------------------------------------------------------


def test_port_analyzer_over_the_repo_is_clean():
    findings, supps = runner.run_all(REPO)
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)
    assert all(s.reason for s in supps), supps
    assert set(runner.CHECKS) == {"guarded-by", "knobs", "wire", "metrics"}


def test_port_analyzer_cli_exits_zero_on_the_repo():
    proc = subprocess.run(
        [sys.executable, "-m", "batch_scheduler_tpu_torch.analysis"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stderr and proc.stdout == ""


def _seeded_tree(tmp_path, name, source):
    pkg = tmp_path / "batch_scheduler_tpu_torch"
    pkg.mkdir(exist_ok=True)
    (pkg / name).write_text(source)
    return tmp_path


def test_port_analyzer_cli_exits_one_on_a_seeded_tree(tmp_path):
    root = _seeded_tree(tmp_path, "seeded.py", _fixture("unguarded_access.py")[1])
    proc = subprocess.run(
        [sys.executable, "-m", "batch_scheduler_tpu_torch.analysis",
         "--check", "guarded-by", "--root", str(root)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 3, proc.stdout
    assert all(ln.startswith(os.path.join("batch_scheduler_tpu_torch", "seeded.py") + ":")
               and "[guarded-by]" in ln for ln in lines), proc.stdout


def test_reasonless_allow_is_a_finding(tmp_path):
    source = (
        "import threading\n\n\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.x = 0  # guarded-by: _lock\n\n"
        "    def peek(self):\n"
        "        return self.x  # analysis: allow(guarded-by)\n\n"
        "    def peek_reasoned(self):\n"
        "        return self.x  # analysis: allow(guarded-by) a racy read is fine here\n"
    )
    root = _seeded_tree(tmp_path, "bare.py", source)
    findings, supps = runner.run_all(str(root), ["guarded-by"])
    assert [(f.checker, f.line) for f in findings] == [("suppressions", 10)]
    assert "without a reason" in findings[0].message
    assert [(s.line, bool(s.reason)) for s in supps] == [(10, False), (13, True)]


def test_lazy_exports_resolve():
    import batch_scheduler_tpu_torch.analysis as analysis

    assert analysis.CHECKS is runner.CHECKS
    assert analysis.run_all is runner.run_all
    assert analysis.Finding.__module__.endswith("analysis.findings")
    with pytest.raises(AttributeError):
        analysis.coupling  # noqa: B018
