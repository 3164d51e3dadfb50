"""The port's CLI (``python -m batch_scheduler_tpu_torch``:
``cmd/main.py``, ``cmd/config.py``, ``version.py``) against the JAX
package's, ``tests/test_cli.py`` mirrored on both packages: the manifest,
config and gate cases, ``check-config`` / ``version``, and ``sim`` on the
README's manifests with the outcome tables compared; the two parsers
compared flag by flag (the port's only deltas are ``--device`` and the
refusals); the no-card refusal of every command that touches the device;
the read-side commands on one audit ring; and the sidecar deployment in
two child processes, every wait bounded.

Every in-process ``main(argv)`` call here puts the switch interval, the
GC thresholds and the freeze back afterwards (``runtime`` fixture)."""

import argparse
import gc
import importlib
import json
import os
import queue
import re
import subprocess
import sys
import threading
import time

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "deploy", "scheduler", "config", "batch_scheduler_config.json")
PARITY = os.path.join(REPO, "deploy", "scheduler", "config", "reference_parity_config.json")
DEVICE_COMMANDS = ("sim", "serve", "replay", "explain", "capacity")


def _m(pkg, mod):
    return importlib.import_module(f"{pkg}.{mod}")


@pytest.fixture
def runtime():
    """The interpreter knobs ``main`` sets, restored."""
    switch, thresholds = sys.getswitchinterval(), gc.get_threshold()
    yield
    sys.setswitchinterval(switch)
    gc.set_threshold(*thresholds)
    gc.unfreeze()


def _run(pkg, argv, capsys):
    """(exit code, stdout) of one in-process ``main(argv)``; the port runs
    on the CPU."""
    if pkg.endswith("_torch") and argv[0] in DEVICE_COMMANDS and "--addr" not in argv:
        argv = [argv[0], "--device", "cpu", *argv[1:]]
    rc = _m(pkg, "cmd.main").main(argv)
    return rc, capsys.readouterr().out


def _table(out):
    rows = {}
    for line in out.splitlines():
        if line.startswith("default/"):
            f = line.split()
            rows[f[0]] = (f[1], f[2], f[3])
    return rows


# -- manifests and config ------------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_example1_manifest_expands_statefulset(pkg):
    types = _m(pkg, "api.types")
    objs = _m(pkg, "api.manifest").load_manifest_file(os.path.join(REPO, "examples",
                                                                    "example1.yaml"))
    groups = [o for o in objs if isinstance(o, types.PodGroup)]
    pods = [o for o in objs if isinstance(o, types.Pod)]
    assert len(groups) == 1 and groups[0].spec.min_member == 9 and len(pods) == 9
    names = {p.metadata.name for p in pods}
    assert "web-group-valid1-0" in names and "web-group-valid1-8" in names
    label = _m(pkg, "utils.labels").POD_GROUP_LABEL
    assert all(p.metadata.labels[label] == "group1" for p in pods)
    assert all(p.resource_require() == {"cpu": 1000} for p in pods)


def test_manifest_skips_unknown_kinds_and_parses_durations():
    text = """
apiVersion: v1
kind: Service
metadata: {name: svc}
---
apiVersion: batch.scheduler.tpu/v1
kind: PodGroup
metadata: {name: g}
spec:
  minMember: 3
  maxScheduleTime: 5m
  minResources: {cpu: "2", memory: 1Gi}
"""
    got = []
    for pkg in PACKAGES:
        (pg,) = _m(pkg, "api.manifest").load_manifests(text)
        got.append((pg.metadata.name, pg.spec.min_member, pg.spec.max_schedule_time,
                    pg.spec.min_resources))
    assert got[0] == got[1] == ("g", 3, 300.0, {"cpu": 2000, "memory": 1024**3})


def _config_view(cfg):
    pc = cfg.plugin_config
    return (pc.scorer, pc.max_schedule_minutes, sorted(cfg.enabled_points),
            pc.controller_workers, pc.leader_poll_seconds, pc.min_batch_interval_seconds,
            pc.oracle_background_refresh, pc.oracle_dispatch_ahead, pc.oracle_compile_warmer,
            cfg.kubeconfig)


@pytest.mark.parametrize("path", [None, SHIPPED, PARITY], ids=["default", "shipped", "parity"])
def test_configs_load_alike(path):
    ref, port = (_config_view(_m(pkg, "cmd.config").load_scheduler_config(path))
                 for pkg in PACKAGES)
    assert ref == port
    cfg = _m(PACKAGES[1], "cmd.config").load_scheduler_config(path)
    if path == PARITY:
        assert cfg.plugin_config.scorer == "serial" and cfg.kubeconfig
        assert cfg.enabled_points == _m(PACKAGES[1], "plugin.gate").DEFAULT_ENABLED
    if path == SHIPPED:
        assert cfg.plugin_config.max_schedule_minutes == 10
        assert cfg.enabled_points == _m(PACKAGES[1], "plugin.gate").ALL_EXTENSION_POINTS


@pytest.mark.parametrize("doc", [
    {"pluginConfig": [{"name": "batch-scheduler", "args": {
        "min_batch_interval_seconds": 0.5, "oracle_background_refresh": True}}]},
    {"pluginConfig": [{"name": "batch-scheduler", "args": {
        "oracle_background_refresh": "false"}}]},
    {"kind": "Deployment"},
    {"plugins": {"bogusPoint": {"enabled": [{"name": "batch-scheduler"}]}}},
    {"plugins": {"permit": {"enabled": [{"name": "batch-scheduler"}]}},
     "clientConnection": {"kubeconfig": "/k"}},
    {"pluginConfig": [{"name": "batch-scheduler", "args": {"oracle_compile_warmer": True}}]},
], ids=["batching", "string-bool", "bad-kind", "bad-point", "one-point", "warmer"])
def test_config_documents_alike(doc):
    """The same document: the same configuration, or a ValueError, in both
    packages (the compile warmer included: the port has its bucket
    warmer)."""
    got = []
    for pkg in PACKAGES:
        try:
            got.append(_config_view(_m(pkg, "cmd.config").SchedulerConfiguration.from_dict(doc)))
        except ValueError:
            got.append("ValueError")
    assert got[0] == got[1]
    if "oracle_compile_warmer" in json.dumps(doc):
        assert got[1] != "ValueError" and got[1][8] is True


class _RecordingPlugin:
    def __init__(self, code):
        self.calls, self.code = [], code

    def less(self, a, b):
        self.calls.append("less")
        return True

    def pre_filter(self, pod):
        self.calls.append("pre_filter")

    def filter(self, pod, node):
        self.calls.append("filter")

    def score(self, pod, node):
        self.calls.append("score")
        return 7

    def permit(self, pod, node):
        self.calls.append("permit")
        return (self.code.WAIT, 1.0)

    def post_bind(self, pod, node):
        self.calls.append("post_bind")

    def reject_pod(self, uid):
        self.calls.append("reject_pod")


def _gate_trace(pkg):
    gate_mod, code = _m(pkg, "plugin.gate"), _m(pkg, "framework.types").StatusCode
    base = _RecordingPlugin(code)
    gate = gate_mod.ExtensionPointGate(base, gate_mod.DEFAULT_ENABLED)
    gate.filter(None, "n")
    out = [gate.score(None, "n")]
    gate.pre_filter(None)
    out.append(gate.permit(None, "n")[1])
    gate.post_bind(None, "n")
    gate.reject_pod("u")

    class Info:
        def __init__(self, ts):
            self.timestamp = ts

    fifo = gate_mod.ExtensionPointGate(_RecordingPlugin(code), frozenset())
    out += [fifo.less(Info(1.0), Info(2.0)), fifo.less(Info(2.0), Info(1.0)),
            fifo.permit(None, "n")[0].name]
    with pytest.raises(ValueError):
        gate_mod.ExtensionPointGate(base, {"preFilter", "bogus"})
    return base.calls, out


def test_gate_alike():
    ref, port = (_gate_trace(pkg) for pkg in PACKAGES)
    assert ref == port
    assert port[0] == ["pre_filter", "permit", "post_bind", "reject_pod"]


# -- the parsers -----------------------------------------------------------------


def _parser_view(parser):
    """Every subcommand's arguments: flags (or dest), default, choices,
    nargs, required, type and action kind, and the mutually exclusive
    groups (help text aside)."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    view = {"top": sorted(tuple(a.option_strings) for a in parser._actions)}
    for name, p in sub.choices.items():
        args = {}
        for a in p._actions:
            if isinstance(a, argparse._HelpAction):
                continue
            args[tuple(a.option_strings) or a.dest] = (
                a.dest, a.default, tuple(a.choices) if a.choices else None, a.nargs,
                a.required, getattr(a.type, "__name__", a.type), type(a).__name__)
        groups = sorted(sorted(tuple(a.option_strings) for a in g._group_actions)
                        for g in p._mutually_exclusive_groups)
        view[name] = (args, groups, [g.required for g in p._mutually_exclusive_groups])
    return view


def test_parser_parity():
    ref, port = (_parser_view(_m(pkg, "cmd.main").build_parser()) for pkg in PACKAGES)
    assert list(ref) == list(port)
    assert set(port) - {"top"} == set(_m(PACKAGES[0], "cmd.main").COMMANDS)
    assert set(_m(PACKAGES[1], "cmd.main").COMMANDS) == set(_m(PACKAGES[0], "cmd.main").COMMANDS)
    for name in port:
        if name in DEVICE_COMMANDS:
            args, groups, required = port[name]
            device = args.pop(("--device",))
            assert device[1:3] == ("cuda", ("cuda", "cpu"))
            port[name] = (args, groups, required)
        assert ref[name] == port[name], name


def test_help_lists_the_nine_commands():
    out = subprocess.run([sys.executable, "-m", "batch_scheduler_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0
    for name in _m(PACKAGES[0], "cmd.main").COMMANDS:
        assert name in out.stdout


# -- commands --------------------------------------------------------------------


def test_cli_check_config_alike(capsys, runtime):
    ref, port = (_run(pkg, ["check-config", "--config", SHIPPED], capsys) for pkg in PACKAGES)
    assert ref[0] == port[0] == 0
    assert json.loads(ref[1]) == json.loads(port[1])
    assert json.loads(port[1])["valid"] and json.loads(port[1])["scorer"] == "oracle"


def test_cli_version(capsys, runtime):
    rc, out = _run(PACKAGES[1], ["version"], capsys)
    assert rc == 0 and "batch-scheduler-tpu-torch v" in out
    info = _m(PACKAGES[1], "version").version_info()
    assert set(info) == set(_m(PACKAGES[0], "version").version_info())


def test_version_without_git(monkeypatch):
    """A git archive of the tree (no .git), or no git at all: the stamp
    still answers."""
    version = _m(PACKAGES[1], "version")
    monkeypatch.setattr(version, "_REPO_ROOT", "/nonexistent-checkout")
    assert version.version_info()["gitCommit"] == "unknown"
    assert version.version_info()["gitTreeState"] == "unknown"
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    assert "unknown" in version.version_string()


@pytest.mark.parametrize("scorer", ["oracle", "serial"])
def test_cli_sim_race_manifest_alike(scorer, capsys, runtime):
    """The README race through both CLIs: exactly one gang wins, the same
    table in both."""
    argv = ["sim", "-f", os.path.join(REPO, "examples", "race.yaml"), "--scorer", scorer,
            "--timeout", "30", "--settle", "2"]
    (rc_ref, out_ref), (rc_port, out_port) = (_run(pkg, argv, capsys) for pkg in PACKAGES)
    assert rc_ref == rc_port == 0
    assert _table(out_ref) == _table(out_port)
    rows = _table(out_port)
    assert rows["default/web-group-race1"] == ("Running", "5", "5")
    assert rows["default/web-group-race2"][2] == "0"
    assert re.search(r"sim wall: [\d.]+s .*5 of 10 pods bound", out_port)


def test_cli_sim_example1_alike(capsys, runtime):
    argv = ["sim", "-f", os.path.join(REPO, "examples", "example1.yaml"), "--nodes", "4",
            "--node-cpu", "4", "--timeout", "30", "--settle", "2"]
    (rc_ref, out_ref), (rc_port, out_port) = (_run(pkg, argv, capsys) for pkg in PACKAGES)
    assert rc_ref == rc_port == 0
    assert _table(out_ref) == _table(out_port) == {"default/group1": ("Running", "9", "9")}


def test_cli_sim_zones_manifest_pins_gang_alike(capsys, monkeypatch, runtime):
    """examples/zones.yaml: the pinned gang lands entirely on east-1 in
    both packages; the free gang also runs."""
    placements = {}
    for pkg in PACKAGES:
        harness = _m(pkg, "sim.harness")
        orig_stop = harness.SimCluster.stop

        def capturing_stop(self, _orig=orig_stop, _pkg=pkg):
            if _pkg not in placements:
                placements[_pkg] = {p.metadata.name: p.spec.node_name
                                    for p in self.clientset.pods().list() if p.spec.node_name}
            _orig(self)

        monkeypatch.setattr(harness.SimCluster, "stop", capturing_stop)
    argv = ["sim", "-f", os.path.join(REPO, "examples", "zones.yaml"), "--timeout", "30",
            "--settle", "2"]
    outs = [_run(pkg, argv, capsys) for pkg in PACKAGES]
    assert outs[0][0] == outs[1][0] == 0
    assert _table(outs[0][1]) == _table(outs[1][1])
    rows = _table(outs[1][1])
    assert rows["default/pinned-east"][0] == rows["default/free-roam"][0] == "Running"
    for pkg in PACKAGES:
        assert {v for k, v in placements[pkg].items() if k.startswith("pinned-")} == {"east-1"}


def test_cli_sim_requires_nodes_and_groups(capsys, runtime):
    assert [_run(pkg, ["sim", "--timeout", "1"], capsys)[0] for pkg in PACKAGES] == [2, 2]


@pytest.mark.parametrize("argv", [
    ["sim", "-f", "examples/race.yaml", "--timeout", "5"],
    ["serve", "--port", "0"],
    ["replay", "."],
    ["explain", "default/g", "--audit-dir", "."],
    ["capacity", "--audit-dir", "."],
], ids=lambda a: a[0])
def test_no_card_refusal(argv, capsys, runtime):
    """``--device cuda`` (the default) with no card: exit 2 naming the
    missing card, before any work — no fallback to the CPU."""
    import torch

    assert not torch.cuda.is_available()
    rc = _m(PACKAGES[1], "cmd.main").main(list(argv))
    err = capsys.readouterr().err
    assert rc == 2 and "no CUDA card" in err and "--device cpu" in err


@pytest.mark.parametrize("argv,env,needle", [
    (["serve", "--port", "0", "--device", "cpu"], {"BST_COORDINATOR": "h:1"}, "BST_COORDINATOR"),
    (["sim", "-f", "examples/race.yaml", "--device", "cpu", "--device-state", "off"], {},
     "device-state off"),
], ids=["coordinator", "device-state-off"])
def test_refusals(argv, env, needle, capsys, monkeypatch, runtime):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = _m(PACKAGES[1], "cmd.main").main(list(argv))
    assert rc == 2 and needle in capsys.readouterr().err


@pytest.mark.parametrize("extra", [["--compile-warmer"],
                                   ["--compile-warmer", "--dispatch-ahead"]],
                         ids=["warmer", "warmer-dispatch-ahead"])
def test_cli_sim_compile_warmer_alike(extra, capsys, runtime):
    """``sim --compile-warmer`` (once refused by the port) runs the README
    race with the bucket warmer on in both CLIs: the same table, exit 0."""
    argv = ["sim", "-f", os.path.join(REPO, "examples", "race.yaml"), "--timeout", "30",
            "--settle", "2", *extra]
    (rc_ref, out_ref), (rc_port, out_port) = (_run(pkg, argv, capsys) for pkg in PACKAGES)
    assert rc_ref == rc_port == 0
    assert _table(out_ref) == _table(out_port)
    assert _table(out_port)["default/web-group-race1"] == ("Running", "5", "5")


def test_main_sets_the_runtime_knobs(capsys, monkeypatch, runtime):
    """``main`` applies the switch interval and the GC thresholds as the
    reference's does (``BST_GIL_SWITCH_INTERVAL``, ``BST_GC_THRESHOLD``,
    a malformed interval falling back to 0.02)."""
    got = []
    for pkg in PACKAGES:
        for raw in ("0.005", "junk"):
            monkeypatch.setenv("BST_GIL_SWITCH_INTERVAL", raw)
            monkeypatch.setenv("BST_GC_THRESHOLD", "4321,12,34")
            sys.setswitchinterval(0.005 if raw == "junk" else 0.05)
            assert _m(pkg, "cmd.main").main(["version"]) == 0
            got.append((round(sys.getswitchinterval(), 6), gc.get_threshold()))
    capsys.readouterr()
    assert got[:2] == got[2:] == [(0.005, (4321, 12, 34)), (0.02, (4321, 12, 34))]


def test_read_side_commands_alike(tmp_path, capsys, runtime):
    """One audit ring recorded by the port's CLI (``sim --audit-dir
    --lifecycle-dir``): the port's replay (serial and top-K rungs),
    explain, capacity and timeline answer as the JAX package's do on the
    same ring."""
    audit, life = str(tmp_path / "audit"), str(tmp_path / "life")
    rc, out = _run(PACKAGES[1], ["sim", "--scenario", "synthetic", "--nodes", "24",
                                 "--groups", "6", "--members", "3", "--timeout", "60",
                                 "--settle", "2", "--audit-dir", audit, "--lifecycle-dir",
                                 life], capsys)
    assert rc == 0 and len(_table(out)) == 6
    assert os.path.getsize(os.path.join(life, "events.jsonl")) > 0

    def last_json(text, whole=False):
        lines = text.splitlines()
        if not whole:
            return json.loads(lines[-1])
        start = next(i for i, line in enumerate(lines) if line.startswith("{"))
        return json.loads("\n".join(lines[start:]))

    for against in ("steady", "topk"):
        got = [last_json(_run(pkg, ["replay", audit, "--against", against], capsys)[1])
               for pkg in PACKAGES]
        assert got[0] == got[1] and got[1]["divergent"] == 0 and got[1]["replayed"] >= 1
    gang = "default/group-003"
    got = [_run(pkg, ["explain", gang, "--audit-dir", audit], capsys) for pkg in PACKAGES]
    assert got[0][0] == got[1][0] == 0
    ref, port = (last_json(out, whole=True) for _, out in got)
    assert ref["gang"] == port["gang"] == gang and ref["source"] == port["source"]
    assert set(ref) == set(port)
    got = [_run(pkg, ["capacity", "--audit-dir", audit], capsys) for pkg in PACKAGES]
    assert got[0][0] == got[1][0] == 0
    ref, port = (last_json(out, whole=True) for _, out in got)
    assert port["divergent"] == 0 and port["replayed"] == ref["replayed"]
    got = [_run(pkg, ["timeline", gang, "--audit-dir", audit], capsys) for pkg in PACKAGES]
    assert got[0][0] == got[1][0] == 0
    ref, port = (last_json(out, whole=True) for _, out in got)
    assert ref == port and port["count"] == 1


def test_cli_sim_remote_scorer():
    """``sim --oracle-addr`` scores through the port's sidecar (``serve``),
    each half in its own child process with its own timeout: the sidecar's
    address is read line by line under a deadline, and the sim child runs
    under ``subprocess.run(timeout=...)`` — no unbounded read."""
    env = dict(os.environ, BST_BUCKET_COST="0", BST_COMPILE_LEDGER="off", BST_CAPACITY="0")
    server = subprocess.Popen(
        [sys.executable, "-u", "-m", "batch_scheduler_tpu_torch", "serve", "--port", "0",
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in server.stdout],
                     daemon=True).start()
    try:
        addr, seen, deadline = None, [], time.monotonic() + 120
        while addr is None:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                break
            seen.append(line)
            m = re.search(r"listening on ([\d.]+:\d+)", line)
            addr = m.group(1) if m else None
        assert addr, f"sidecar never reported its address: {''.join(seen)[-2000:]}"
        sim = subprocess.run(
            [sys.executable, "-m", "batch_scheduler_tpu_torch", "sim", "-f",
             os.path.join(REPO, "examples", "example1.yaml"), "--nodes", "4", "--node-cpu",
             "4", "--oracle-addr", addr, "--device", "cpu", "--timeout", "60", "--settle",
             "2"], capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
        assert sim.returncode == 0, sim.stdout + sim.stderr
        assert _table(sim.stdout)["default/group1"] == ("Running", "9", "9"), sim.stdout
    finally:
        server.terminate()
        try:
            server.wait(timeout=20)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait(timeout=10)


def test_sim_cluster_enabled_points_passthrough():
    """cfg.plugins gating reaches the runtime: with permit disabled the
    plugin never parks pods."""
    gate = _m(PACKAGES[1], "plugin.gate")
    cluster = _m(PACKAGES[1], "sim").SimCluster(
        enabled_points={"queueSort", "preFilter", "postBind"}, device="cpu")
    try:
        assert isinstance(cluster.runtime.plugin, gate.ExtensionPointGate)
        assert "permit" not in cluster.runtime.plugin.enabled
    finally:
        cluster.stop()


# -- the knob readers the CLI brings ------------------------------------------


@pytest.mark.parametrize("raw", [None, "", "array", "V1", " v2 ", "v3", "junk"])
def test_audit_format_knob_alike(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("BST_AUDIT_FORMAT", raising=False)
    else:
        monkeypatch.setenv("BST_AUDIT_FORMAT", raw)
    got = [_m(pkg, "utils.audit").audit_format() for pkg in PACKAGES]
    assert got[0] == got[1]


@pytest.mark.parametrize("raw", [None, "", "4", "1", "0", "-3", "x7"])
def test_audit_keyframe_knob_alike(raw, monkeypatch, tmp_path):
    if raw is None:
        monkeypatch.delenv("BST_AUDIT_KEYFRAME_EVERY", raising=False)
    else:
        monkeypatch.setenv("BST_AUDIT_KEYFRAME_EVERY", raw)
    got = [_m(pkg, "utils.audit").audit_keyframe_every() for pkg in PACKAGES]
    assert got[0] == got[1]
    log = _m(PACKAGES[1], "utils.audit").AuditLog(str(tmp_path))
    try:
        assert log.keyframe_every == got[1] and log.fmt == "array"
    finally:
        log.stop()


@pytest.mark.parametrize("raw", [None, "2", "1", "0", "-4", "lots"])
def test_tenant_cap_knob_alike(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("BST_TENANT_LABEL_MAX", raising=False)
    else:
        monkeypatch.setenv("BST_TENANT_LABEL_MAX", raw)
    names = [f"ns{i % 5}/g{i}" for i in range(23)]
    got = []
    for pkg in PACKAGES:
        tenancy = _m(pkg, "utils.tenancy")
        ids, labels = tenancy.batch_tenants(names, 32)
        got.append((tenancy.tenant_cap(), ids.tolist(), labels))
    assert got[0] == got[1]
