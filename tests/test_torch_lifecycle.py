"""The port's gang lifecycle ledger
(``batch_scheduler_tpu_torch/utils/lifecycle.py``) against the JAX
package's: the same event script, on the same injected clock, through a
fresh ledger of each package (each on its own metrics registry) gives the
same timelines, TTP and phase histogram counts, ``since=`` pages, export
lines, offline fold and report. The clock is injected by replacing each
module's ``time`` with a scripted one, so every field, times included, is
held to exact equality; only the live trace id is left out."""

import importlib
import json

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")


class _Clock:
    """A scripted ``time`` module: ``time()`` and ``monotonic()`` read one
    value that the script advances."""

    def __init__(self, t0=1_700_000_000.0):
        self.t = t0

    def time(self):
        return self.t

    def monotonic(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _Audit:
    """Collects the ledger's ``gang_lifecycle`` audit events."""

    def __init__(self):
        self.events = []

    def record_event(self, event, **fields):
        self.events.append({"kind": event, **fields})


def _ledger(name, monkeypatch, **kw):
    mod = importlib.import_module(f"{name}.utils.lifecycle")
    metrics = importlib.import_module(f"{name}.utils.metrics")
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    reg = metrics.Registry()
    return mod, mod.GangLifecycleLedger(registry=reg, **kw), clock, reg


def _script(ledger, clock):
    """Arrivals, a deny streak with the retry ping-pong, two batch
    contexts (one with a sidecar wait), an eviction and respawn, permits,
    member binds, a delete, and gangs of two tenants and tiers."""
    for m in range(3):
        ledger.note_arrival("team-a/g1", tier=1, pods=1)
        clock.advance(0.01)
    ledger.note_arrival("team-b/g2", tier=0, pods=2)
    ledger.note_arrival("g3", tier=2, pods=1)
    clock.advance(0.5)
    ledger.note_batch_context("aid-1", {"lock_wait_seconds": 0.02})
    for _ in range(4):
        ledger.note_admitted("team-a/g1")
        clock.advance(0.2)
        ledger.note_deny("team-a/g1", "team-a/g1: cluster capacity reserved")
        clock.advance(0.3)
    ledger.note_deny("team-a/g1", "team-a/g1: cluster cannot fit gang")
    ledger.note_admitted("team-b/g2")
    clock.advance(1.5)
    ledger.note_permit("team-b/g2")
    clock.advance(0.25)
    ledger.note_bind("team-b/g2", members=2)
    ledger.note_bind("team-b/g2", members=2)
    ledger.note_batch_context(
        "aid-2", {"coalesce": {"queue_wait_seconds": 0.125}, "lock_wait_seconds": 9}
    )
    clock.advance(3.0)
    ledger.note_evicted("team-b/g2", preemptor="team-a/g1")
    ledger.note_arrival("team-b/g2", tier=0, pods=2)
    ledger.note_admitted("team-a/g1")
    ledger.note_permit("team-a/g1")
    clock.advance(12.0)
    ledger.note_bind("team-a/g1", members=3)
    ledger.note_admitted("team-b/g2")
    ledger.note_permit("team-b/g2")
    clock.advance(40.0)
    ledger.note_bind("team-b/g2", members=2)
    ledger.note_batch_context(None, None)
    ledger.note_admitted("g3")
    ledger.note_delete("g3")
    ledger.note_deny("team-c/g4", "bad telemetry")
    ledger.note_batch_context("aid-3", {"lock_wait_seconds": "junk"})
    ledger.note_deny("team-c/g4", "bad telemetry")


def _strip(obj):
    """Drop the live trace id (minted per run) wherever it appears."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k != "trace_id"}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _views(name, monkeypatch, tmp_path, **kw):
    mod, ledger, clock, reg = _ledger(name, monkeypatch, **kw)
    audit = _Audit()
    ledger.attach_audit(audit)
    export = tmp_path / name
    ledger.set_export_dir(str(export))
    _script(ledger, clock)
    ttp = reg.histogram("bst_gang_ttp_seconds")
    phase = reg.histogram("bst_gang_ttp_phase_seconds")
    pages = []
    cursor = 0
    while True:
        page = ledger.events_since(cursor, limit=5)
        pages.append(page)
        if not page["events"]:
            break
        cursor = page["cursor"]
    with open(export / "events.jsonl") as f:
        lines = [json.loads(line) for line in f]
    folded = mod.GangLifecycleLedger.fold(audit.events, per_gang=ledger.per_gang)
    return {
        "snapshot": ledger.snapshot(),
        "one_gang": ledger.snapshot(gang="team-a/g1"),
        "tenant": ledger.snapshot(tenant="team-b"),
        "limited": ledger.snapshot(limit=1),
        "none": ledger.snapshot(limit=0),
        "pages": pages,
        "limit0": ledger.events_since(0, limit=0),
        "past_tip": ledger.events_since(10_000),
        "ttp": ttp.snapshots(),
        "phases": phase.snapshots(),
        "events_total": reg.counter("bst_lifecycle_events_total").values(),
        "export": lines,
        "audit": audit.events,
        "fold": {g: mod.GangLifecycleLedger.timeline_view(r)
                 for g, r in folded.items()},
        "report": ledger.report(),
        "dropped": (ledger.dropped_gangs, ledger.stream_dropped),
    }


@pytest.mark.parametrize("kw", [
    {},
    {"per_gang": 3, "max_gangs": 2, "stream_capacity": 7},
], ids=["default-bounds", "tight-bounds"])
def test_same_script_same_ledger(monkeypatch, tmp_path, kw):
    ref, port = (_strip(_views(n, monkeypatch, tmp_path, **kw)) for n in PACKAGES)
    assert ref.keys() == port.keys()
    for key in ref:
        assert ref[key] == port[key], key


def test_timeline_semantics(monkeypatch, tmp_path):
    """The port's ledger on its own: the retry ping-pong keeps a parked
    gang at two ring slots, a respawn keeps the original arrival anchor,
    the sidecar wait is attributed once per (gang, batch), and the fold of
    the audit events rebuilds the live timelines."""
    v = _views("batch_scheduler_tpu_torch", monkeypatch, tmp_path)
    g1 = v["snapshot"]["gangs"]["team-a/g1"]
    kinds = [e["event"] for e in g1["events"]]
    assert kinds[:3] == ["arrival", "admitted", "deny"]
    assert g1["events"][1]["repeats"] == 4 and g1["events"][2]["repeats"] == 4
    assert g1["tier"] == 1 and g1["tenant"] == "team-a"
    g2 = v["snapshot"]["gangs"]["team-b/g2"]
    assert "respawn" in [e["event"] for e in g2["events"]]
    assert g2["ttp_s"] == pytest.approx(0.5 + 4 * 0.5 + 1.5 + 0.25 + 3.0 + 12.0 + 40.0)
    assert "g3" in v["snapshot"]["gangs"]
    assert v["snapshot"]["gangs"]["g3"]["events"][-1]["event"] == "delete"
    sidecar = [e.get("sidecar_wait_s") for e in g1["events"] if "sidecar_wait_s" in e]
    assert sidecar and sidecar[0] == pytest.approx(0.02)
    assert {k: r["events"] for k, r in v["fold"].items()} == {
        k: r["events"] for k, r in v["snapshot"]["gangs"].items()}
    assert sum(n for _, _, n in v["ttp"].values()) == 3  # g2 twice (respawn), g1
    assert v["report"]["gangs"] == 4
    assert v["past_tip"] == {"events": [], "cursor": 10_000, "dropped": 0}
    assert v["limit0"]["events"] == [] and v["limit0"]["cursor"] == 0


def test_export_rotation(monkeypatch, tmp_path):
    """``BST_LIFECYCLE_EXPORT_MAX_MB`` rotates the export to
    ``events.jsonl.1`` in both packages at the same line; a malformed
    value falls back to the default."""
    out = []
    for name in PACKAGES:
        monkeypatch.setenv("BST_LIFECYCLE_EXPORT_MAX_MB", "0.0005")  # 524 bytes
        _, ledger, clock, _ = _ledger(name, monkeypatch)
        ledger.set_export_dir(str(tmp_path / name))
        for i in range(12):
            ledger.note_arrival(f"ns/g{i}", tier=i % 3, pods=1)
            clock.advance(1.0)
        files = sorted(p.name for p in (tmp_path / name).iterdir())
        texts = [_strip([json.loads(x) for x in (tmp_path / name / f).read_text().splitlines()])
                 for f in files]
        out.append((files, texts))
        monkeypatch.setenv("BST_LIFECYCLE_EXPORT_MAX_MB", "not-a-number")
        mod = importlib.import_module(f"{name}.utils.lifecycle")
        assert mod._export_max_bytes() == 16 * 1024 * 1024
    assert out[0] == out[1]
    assert out[1][0] == ["events.jsonl", "events.jsonl.1"]


def test_long_poll_wakes_on_a_new_event(monkeypatch):
    import threading

    for name in PACKAGES:
        _, ledger, _, _ = _ledger(name, monkeypatch)
        got = {}

        def poll():
            got["page"] = ledger.events_since(0, timeout_s=10.0)

        t = threading.Thread(target=poll)
        t.start()
        ledger.note_arrival("ns/late", pods=1)
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert [e["gang"] for e in got["page"]["events"]] == ["ns/late"]


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_quantile_from_counts(q):
    buckets = (0.1, 1.0, 10.0, 100.0)
    cases = [([0, 0, 0, 0], 0), ([1, 3, 3, 8], 8), ([5, 5, 5, 5], 5),
             ([0, 0, 2, 2], 2), ([0, 0, 0, 4], 7)]
    for counts, total in cases:
        vals = [
            importlib.import_module(f"{n}.utils.lifecycle")._quantile_from_counts(
                buckets, counts, total, q)
            for n in PACKAGES
        ]
        assert vals[0] == vals[1]


def test_reset_clears_records_stream_and_sinks(monkeypatch, tmp_path):
    for name in PACKAGES:
        _, ledger, clock, _ = _ledger(name, monkeypatch)
        audit = _Audit()
        ledger.attach_audit(audit)
        ledger.set_export_dir(str(tmp_path / f"r-{name}"))
        ledger.note_batch_context("aid", None)
        ledger.note_arrival("ns/a")
        ledger.reset()
        ledger.note_arrival("ns/b")
        snap = ledger.snapshot()
        assert list(snap["gangs"]) == ["ns/b"]
        assert "audit_id" not in snap["gangs"]["ns/b"]["events"][0]
        assert [e["gang"] for e in audit.events] == ["ns/a"]
        assert ledger.events_since(0)["events"][0]["cursor"] == 1
