"""The port's profiler and perf observatory
(``batch_scheduler_tpu_torch/utils/profiler.py``), ``tests/test_profiler.py``
mirrored: the on-demand capture (``torch.profiler`` here, a Chrome trace),
the device-memory sampler's CPU no-op, the compile ledger (the kernel
libraries' builds and loads, ``ops._build``), the perf report with the
reference's keys, the two routes over HTTP, the bucket report and the
coarse-pass probe with the teardown drain, and the SIGTERM drain of
``serve``, and the compile-warmer cases: ``sim --dispatch-ahead
--compile-warmer`` exits cleanly, and a scorer's drain joins its warmer."""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from batch_scheduler_tpu_torch.utils import profiler

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def closed_after():
    yield
    profiler.shutdown(timeout=30.0)
    profiler.configure(profile_dir=None)


def test_capture_profile_writes_bounded_trace_dir(tmp_path, closed_after):
    """A capture on the CPU writes a loadable Chrome trace under the
    configured --profile-dir, the capture counter advances, and old
    captures are pruned oldest-first so the dir stays bounded."""
    profiler.configure(profile_dir=str(tmp_path), device="cpu")
    out = profiler.capture_profile(0.1)
    assert out["ok"], out
    assert out["trace_dir"].startswith(str(tmp_path)) and os.path.isdir(out["trace_dir"])
    assert out["files"] >= 1 and out["cuda"] is False
    with open(out["trace"]) as f:
        assert "traceEvents" in json.load(f)
    state = profiler.profile_state()
    assert state["captures"] >= 1 and not state["busy"]
    assert state["last_capture"]["trace_dir"] == out["trace_dir"]
    out2 = profiler.capture_profile(0.1)
    assert out2["ok"], out2
    profiler._prune_captures(str(tmp_path), keep=1)
    assert not os.path.exists(out["trace_dir"])
    assert os.path.isdir(out2["trace_dir"])


def test_capture_profile_rejects_concurrent_capture(tmp_path, monkeypatch, closed_after):
    """One capture at a time: a second one while the first is in flight
    answers busy, the same dict as the reference's; shutdown closes and
    configure reopens."""
    profiler.configure(profile_dir=str(tmp_path), device="cpu")
    started, release = threading.Event(), threading.Event()
    real_sleep = profiler.time.sleep

    def slow_sleep(_s):
        started.set()
        release.wait(10)

    monkeypatch.setattr(profiler.time, "sleep", slow_sleep)
    results = []
    t = threading.Thread(target=lambda: results.append(profiler.capture_profile(0.1)))
    t.start()
    assert started.wait(10)
    assert profiler.capture_profile(0.1) == {"ok": False,
                                             "error": "capture already in progress"}
    release.set()
    monkeypatch.setattr(profiler.time, "sleep", real_sleep)
    t.join(30)
    assert results and results[0]["ok"]
    assert profiler.shutdown(timeout=5.0)
    assert profiler.capture_profile(0.1) == {"ok": False, "error": "profiler shut down"}
    assert profiler.profile_state()["closed"] is True
    profiler.configure(profile_dir=str(tmp_path))
    assert profiler.profile_state()["closed"] is False


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_device_memory_sampler_is_cpu_noop(device, closed_after):
    """A process asked for the CPU, or with no card, has no device memory:
    the sampler exits after its first empty pass and the bst_device_*
    gauges stay unregistered, as the reference's CPU no-op."""
    from batch_scheduler_tpu_torch.utils.metrics import Registry

    profiler.configure(device=device)
    reg = Registry()
    sampler = profiler.DeviceMemorySampler(interval_s=0.5, registry=reg)
    assert sampler.stop(timeout=5.0)
    assert sampler.sample_once() is None
    assert profiler.sample_device_memory() is None
    for name in ("bst_device_bytes_in_use", "bst_device_peak_bytes", "bst_device_bytes_limit"):
        assert reg.get(name) is None
    assert "bst_device" not in reg.render()


def test_compile_ledger_records_and_persists(tmp_path):
    from batch_scheduler_tpu_torch.utils.metrics import Registry

    reg = Registry()
    ledger = profiler.CompileLedger(path=str(tmp_path / "ledger.jsonl"), registry=reg)
    ledger.record("assign_scan", "0123456789abcdef", 31.5, True)
    ledger.record("assign_scan", "0123456789abcdef", 0.25, False)
    ledger.record("assign_wave", "fedcba9876543210", 17.0, True, source="assign_wave.cu")
    rep = ledger.report()
    assert rep["totals"]["assign_scan"] == {"builds": 1, "loads": 1, "seconds": 31.75}
    assert rep["totals"]["assign_wave"]["builds"] == 1
    assert len(rep["recent"]) == 3
    lines = [json.loads(line) for line in (tmp_path / "ledger.jsonl").read_text().splitlines()]
    assert len(lines) == 3
    assert lines[0]["library"] == "assign_scan" and lines[0]["built"] is True
    assert lines[2]["source"] == "assign_wave.cu"
    assert all("ts" in e and "pid" in e for e in lines)
    assert reg.get("bst_oracle_compiles_total").value() == 3
    assert reg.get("bst_compile_ledger_entries_total").value() == 3


def test_compile_ledger_disabled_path(monkeypatch):
    monkeypatch.setenv("BST_COMPILE_LEDGER", "off")
    ledger = profiler.CompileLedger()
    ledger.record("assign_scan", "x", 0.5, False)
    assert ledger.entry_count() == 1  # the in-memory view still works
    assert ledger.report()["jsonl"] is None


def test_compile_ledger_default_path_is_the_build_directory(monkeypatch):
    from batch_scheduler_tpu_torch.ops import _build

    monkeypatch.delenv("BST_COMPILE_LEDGER", raising=False)
    assert profiler.CompileLedger()._resolve_path() == str(_build.BUILD_DIR / "compile-ledger.jsonl")


def test_library_load_feeds_compile_ledger(tmp_path, monkeypatch):
    """A library the build directory already holds (named by its digest)
    loads without nvcc and lands one ledger entry, built False, with its
    digest; the second call is served from the table without a new
    entry."""
    from batch_scheduler_tpu_torch.ops import _build

    if shutil.which("cc") is None:
        pytest.skip("no C compiler to build the stand-in library")
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "probe.cu").write_text("// a stand-in source\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    key = _build.digest(csrc / "probe.cu")
    c_src = tmp_path / "probe.c"
    c_src.write_text("int bst_probe(void) { return 7; }\n")
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(build / f"libprobe_{key}.so"),
                    str(c_src)], check=True)
    fresh = profiler.CompileLedger(path=str(tmp_path / "cl.jsonl"))
    monkeypatch.setattr(profiler, "COMPILE_LEDGER", fresh)
    monkeypatch.setattr(_build, "_libs", {})
    lib = _build.library("probe")
    assert lib.bst_probe() == 7
    assert _build.library("probe") is lib
    rep = fresh.report()
    assert rep["totals"] == {"probe": {"builds": 0, "loads": 1, "seconds": rep["totals"]["probe"]["seconds"]}}
    assert rep["recent"][0]["digest"] == key and rep["recent"][0]["built"] is False
    assert (tmp_path / "cl.jsonl").exists()


def _small_snapshot(resource="cpu"):
    from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot, GroupDemand
    from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node

    nodes = [make_sim_node(f"n{i:03d}", {"cpu": "8", "memory": "32Gi", "pods": "110"})
             for i in range(16)]
    groups = [GroupDemand(f"default/probe{g}", 2, member_request={resource: 1000})
              for g in range(5)]
    return ClusterSnapshot(nodes, {}, groups)


def test_bucket_report_prices_each_path(monkeypatch):
    """With BST_BUCKET_COST on, a collected batch enters its bucket's entry
    under its scan path (kernel, no plan for the plain version, a bound
    from ops.bounds whose request lanes are counted on the host, or given
    by the caller). Off (the tests' default), nothing is recorded."""
    from batch_scheduler_tpu_torch.ops import bounds, oracle

    monkeypatch.setattr(oracle, "_bucket_costs", {})
    snap = _small_snapshot()
    oracle.execute_batch_host(snap.device_args(), snap.progress_args(), device="cpu")
    assert oracle.bucket_cost_report() == {}
    monkeypatch.setenv("BST_BUCKET_COST", "1")
    for rung in ((0, 0), (8, 0), (8, 16), (0, 0)):
        with oracle.forced_scan_rung(*rung):
            host, _ = oracle.execute_batch_host(snap.device_args(), snap.progress_args(),
                                                device="cpu")
    report = oracle.bucket_cost_report()
    g, n = host["telemetry"]["g_bucket"], host["telemetry"]["n_bucket"]
    entry = report[f"{g}x{n}"]
    assert entry["batches"] == 4
    assert set(entry["rungs"]) == {"serial", "wavefront", "topk"}
    serial = entry["rungs"]["serial"]
    assert serial["batches"] == 2 and serial["kernel"] == "assign_scan" and serial["plan"] is None
    args = snap.device_args()
    lanes = int((args[2] > 0).sum())
    in_bytes = sum(a.nbytes for a in (args[0], args[2], args[3], args[4], args[6]))
    nbytes, ops = bounds.scan_work(n, args[0].shape[1], g, in_bytes, lanes)
    assert (serial["bytes"], serial["int_ops"]) == (nbytes, ops)
    assert (serial["bound_ms"], serial["bound_by"]) == bounds.bound(nbytes, ops)
    assert entry["rungs"]["topk"]["kernel"] == "assign_topk"
    # a caller's own count is the one priced (the scorer's, from its host
    # copy of a card-resident request)
    monkeypatch.setattr(oracle, "_bucket_costs", {})
    oracle.execute_batch_host(snap.device_args(), snap.progress_args(), device="cpu",
                              request_lanes=lanes + 3)
    priced = oracle.bucket_cost_report()[f"{g}x{n}"]["rungs"]["serial"]
    assert priced["int_ops"] == bounds.scan_work(n, args[0].shape[1], g, in_bytes,
                                                 lanes + 3)[1]


def test_perf_report_has_the_reference_keys():
    """Both reports carry the same sections; the phases and the scan mix of
    one registry read the same in both packages."""
    reports = []
    for pkg in PACKAGES:
        metrics = importlib.import_module(f"{pkg}.utils.metrics")
        prof = importlib.import_module(f"{pkg}.utils.profiler")
        reg = metrics.Registry()
        h = reg.histogram("bst_oracle_pack_seconds", "Host snapshot-pack time per batch")
        for v in (0.001, 0.01, 0.02, 0.5):
            h.observe(v)
        reg.counter("bst_scan_batches_total", "by path").inc(path="serial", tenant="a")
        reg.counter("bst_scan_batches_total", "by path").inc(2, path="serial", tenant="b")
        reports.append(prof.perf_report(reg))
    ref, port = reports
    assert set(ref) == set(port)
    assert ref["phases"] == port["phases"]
    assert ref["scan_rung_mix"] == port["scan_rung_mix"] == {"serial": 3.0}
    assert {"totals", "recent", "jsonl"} == set(port["compile_ledger"])
    assert set(ref["profiler"]) == set(port["profiler"])


def test_perf_and_profile_endpoints(tmp_path, closed_after):
    """/debug/perf serves the report and /debug/profile?seconds=N writes a
    trace, over HTTP; a malformed duration answers 400 and runs no
    capture."""
    from batch_scheduler_tpu_torch.utils.metrics import Registry, serve_metrics

    profiler.configure(profile_dir=str(tmp_path), device="cpu")
    server = serve_metrics(Registry(), port=0)
    try:
        port = server.server_address[1]

        def get(path, timeout=120):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=timeout) as r:
                return r.headers["Content-Type"], json.loads(r.read())

        ctype, perf = get("/debug/perf")
        assert "application/json" in ctype and "phases" in perf and "compile_ledger" in perf
        _, state = get("/debug/profile")
        assert state["busy"] is False
        _, capture = get("/debug/profile?seconds=0.1")
        assert capture["ok"], capture
        assert os.path.isdir(capture["trace_dir"]) and capture["files"] >= 1
        before = profiler.profile_state()["captures"]
        for bad in ("5s", "nan", "inf"):
            with pytest.raises(urllib.error.HTTPError) as err:
                get(f"/debug/profile?seconds={bad}")
            assert err.value.code == 400
            assert json.loads(err.value.read())["ok"] is False
        assert profiler.profile_state()["captures"] == before
    finally:
        server.shutdown()
        server.server_close()


def test_drain_route_drains_in_process_sidecars():
    """/debug/drain: a bare GET reports, ?go=1 drains every in-process
    sidecar and answers their reports (idempotent)."""
    from batch_scheduler_tpu_torch.service.server import serve_background
    from batch_scheduler_tpu_torch.utils.metrics import Registry, serve_metrics

    sidecar = serve_background(device="cpu")
    server = serve_metrics(Registry(), port=0)
    try:
        port = server.server_address[1]

        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
                return json.loads(r.read())

        state = get("/debug/drain")
        assert state["ok"] and state["servers"] >= 1 and set(state) == {"ok", "servers", "draining"}
        first = get("/debug/drain?go=1")
        assert first["servers"] == state["servers"]
        assert all(r["drained"] for r in first["reports"])
        assert get("/debug/drain?go=1")["reports"] == first["reports"]
        assert all(get("/debug/drain")["draining"])
    finally:
        server.shutdown()
        server.server_close()
        sidecar.shutdown()
        sidecar.server_close()


def test_serve_sigterm_drains_and_exits_cleanly():
    """``serve --device cpu`` in a child: after a served batch, SIGTERM
    drains (the report printed) and the process exits 0. Every wait is
    bounded."""
    env = dict(os.environ, BST_BUCKET_COST="0", BST_COMPILE_LEDGER="off", BST_CAPACITY="0")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "batch_scheduler_tpu_torch", "serve", "--port", "0",
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        line, deadline = "", time.monotonic() + 120
        while time.monotonic() < deadline and "listening on" not in line:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, proc.stderr.read()[-2000:]
        m = re.search(r"listening on ([\d.]+):(\d+)", line)
        assert m, f"no listening line: {line!r}"
        from batch_scheduler_tpu_torch.service.client import OracleClient
        from batch_scheduler_tpu_torch.sim.scenarios import tenant_oracle_stream

        req = tenant_oracle_stream(0, 1, nodes=16, gangs=4)[0]
        client = OracleClient(m.group(1), int(m.group(2)), timeout=120.0)
        assert client.schedule(req, tenant="drainer").placed.shape[0] > 0
        client.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    except BaseException:
        proc.kill()
        proc.communicate(timeout=30)
        raise
    assert proc.returncode == 0, (out[-2000:], err[-2000:])
    assert "SIGTERM: draining oracle sidecar" in out
    report = json.loads(re.search(r"drain complete: (\{.*\})", out).group(1))
    assert report["drained"] is True and report["audit_flushed"] is True


def test_sim_dispatch_ahead_with_compile_warmer_exits_cleanly():
    """``sim --dispatch-ahead --compile-warmer`` on the CPU: exit 0 and no
    abort at interpreter exit, in a real child process (an unjoined
    daemon thread dying at teardown only shows there)."""
    env = dict(os.environ, BST_CAPACITY="0")
    proc = subprocess.run(
        [sys.executable, "-m", "batch_scheduler_tpu_torch", "sim", "--scenario",
         "synthetic", "--nodes", "8", "--groups", "2", "--members", "2",
         "--dispatch-ahead", "--compile-warmer", "--timeout", "90", "--settle", "2",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "terminate called" not in proc.stderr
    assert "Aborted" not in proc.stderr


def test_scorer_drain_joins_warmer_and_telemetry_threads():
    """A scorer draining with a live warmer stops the warmer first: drain
    returns True, and again on a second call (the factory's stop drains
    again)."""
    from batch_scheduler_tpu_torch.core.oracle_scorer import OracleScorer
    from batch_scheduler_tpu_torch.sim.harness import SimCluster
    from batch_scheduler_tpu_torch.sim.scenarios import (
        make_member_pods,
        make_sim_group,
        make_sim_node,
    )

    cluster = SimCluster(scorer="oracle", oracle_dispatch_ahead=True,
                         oracle_compile_warmer=True, device="cpu")
    cluster.add_nodes([make_sim_node(f"d{i}", {"cpu": "8", "memory": "32Gi", "pods": "110"})
                       for i in range(8)])
    cluster.create_group(make_sim_group("drain-g", 2))
    cluster.start()
    try:
        cluster.create_pods(make_member_pods("drain-g", 2, {"cpu": "1"}))
        assert cluster.wait_for(lambda: cluster.scheduler.stats["binds"] >= 2, timeout=60.0)
        oracle = cluster.runtime.operation.oracle
        assert isinstance(oracle, OracleScorer)
        assert oracle._warmer is not None
        assert oracle.drain_background(timeout=120.0) is True
        assert not oracle._warmer._thread.is_alive()
        assert oracle.drain_background(timeout=30.0) is True
        assert {"warmer_hits", "warmer_misses", "warmer_shapes"} <= set(oracle.stats())
    finally:
        cluster.stop()
