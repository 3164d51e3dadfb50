"""The port's O(churn) packers against the JAX reference's: the same churn
sequences through both packages' ``DeltaSnapshotPacker`` emit the same
padded arrays, meta columns and ``SnapshotDelta`` records, exactly — the
keyframe-reason matrix, the snapshot-lite scan, ``pack_fold`` against
``pack``, fold idempotence, in-place ``GroupDemand`` mutation and a
seeded random sweep. Also the float64 -> (hi, lo) sort keys on
hypothesis-drawn doubles, the ``EventLog`` drain / complete / overflow
contract and its default cap. Every array is an integer or a bool: the
tolerance is exact equality."""

import importlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")


def _mods(name):
    return (
        importlib.import_module(f"{name}.ops.snapshot"),
        importlib.import_module(f"{name}.sim.scenarios"),
    )


def _world(name, n=10, g=6, seed=0):
    """``n`` nodes and ``g`` gangs built from a seed with numpy — the same
    values in both packages' objects."""
    snapshot, scen = _mods(name)
    rng = np.random.default_rng(seed)
    nodes = [
        scen.make_sim_node(f"n{i:02d}", {"cpu": "16", "memory": "64Gi", "pods": "110"})
        for i in range(n)
    ]
    node_req = {
        f"n{i:02d}": {"cpu": int(rng.integers(0, 8)) * 1000, "pods": int(rng.integers(0, 5))}
        for i in range(n)
    }
    groups = [
        snapshot.GroupDemand(
            full_name=f"default/gang-{j}",
            min_member=int(rng.integers(1, 6)),
            member_request={"cpu": int(rng.integers(1, 5)) * 1000, "memory": 2**30},
            priority=int(rng.integers(0, 3)),
            creation_ts=float(rng.integers(0, 4)),
        )
        for j in range(g)
    ]
    return nodes, node_req, groups


def _emitted(snap):
    """Every array a pack emits, and its delta record."""
    d = snap.delta
    return {
        "arrays": [np.asarray(a) for a in snap.device_args() + snap.progress_args()],
        "node_valid": np.asarray(snap.node_valid),
        "meta": None if snap.meta_cols is None else [np.asarray(c) for c in snap.meta_cols],
        "delta": (d.kind, d.reason, d.generation, d.node_rows.tolist(),
                  d.group_rows.tolist(), d.meta_rows.tolist(), d.source,
                  d.policy_node_rows.tolist()),
    }


def _assert_same(a, b):
    assert a["delta"] == b["delta"]
    for x, y in zip(a["arrays"] + [a["node_valid"]], b["arrays"] + [b["node_valid"]]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)
    assert (a["meta"] is None) == (b["meta"] is None)
    if a["meta"] is not None:
        for x, y in zip(a["meta"], b["meta"]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def _assert_matches_full(name, snap, nodes, node_req, groups):
    """A pack's arrays equal a from-scratch ClusterSnapshot's."""
    snapshot, _ = _mods(name)
    fresh = snapshot.ClusterSnapshot(nodes, node_req, groups)
    for x, y in zip(snap.device_args() + snap.progress_args(),
                    fresh.device_args() + fresh.progress_args()):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def _run(steps, n=10, g=6, seed=0):
    """Apply the same ``steps`` (callables on one package's world that
    return ``(nodes, node_req, groups)`` to pack next, or a ``("fold",
    node_updates, group_updates)`` tuple) to both packages; return the
    emitted sequences, reference first."""
    seqs = []
    for name in PACKAGES:
        snapshot, _ = _mods(name)
        world = _world(name, n, g, seed)
        packer = snapshot.DeltaSnapshotPacker()
        out = [_emitted(packer.pack(*world))]
        for step in steps:
            got = step(name, world)
            if got[0] == "fold":
                snap = packer.pack_fold(got[1], got[2])
                out.append(None if snap is None else _emitted(snap))
                if snap is not None:
                    _assert_matches_full(name, snap, *got[3])
            else:
                world = got
                snap = packer.pack(*world)
                _assert_matches_full(name, snap, *world)
                out.append(_emitted(snap))
        out.append(packer.stats() if hasattr(packer, "stats") else None)
        seqs.append(out)
    return seqs


def _compare(seqs):
    ref, port = seqs
    assert len(ref) == len(port)
    for a, b in zip(ref[:-1], port[:-1]):
        assert (a is None) == (b is None)
        if a is not None:
            _assert_same(a, b)
    return [None if e is None else e["delta"] for e in port[:-1]], port[-1]


# -- the keyframe-reason matrix ----------------------------------------------


def _shrink_groups(name, world):
    nodes, node_req, groups = world
    return nodes, node_req, groups[:-1]


def _reverse_nodes(name, world):
    nodes, node_req, groups = world
    return list(reversed(nodes)), node_req, groups


def _new_lane_on_node(name, world):
    nodes, node_req, groups = world
    node_req = dict(node_req)
    node_req["n00"] = {"nvidia.com/gpu": 2}
    return nodes, node_req, groups


def _new_lane_on_demand(name, world):
    nodes, node_req, groups = world
    groups[0].member_request = {"example.com/widget": 1}
    return nodes, node_req, groups


def _node_object_update(name, world):
    nodes, node_req, groups = world
    nodes[4].metadata.resource_version += 1
    nodes[4].status.allocatable = dict(nodes[4].status.allocatable, cpu=8000)
    return nodes, node_req, groups


def _no_change(name, world):
    return world


def test_keyframe_reason_matrix_matches_reference():
    steps = [_no_change, _shrink_groups, _reverse_nodes, _new_lane_on_node,
             _new_lane_on_demand, _node_object_update, _no_change]
    deltas, stats = _compare(_run(steps))
    kinds = [(d[0], d[1]) for d in deltas]
    assert kinds == [
        ("keyframe", "first"), ("delta", ""), ("keyframe", "group-set"),
        ("keyframe", "node-list"), ("keyframe", "node-churn"),
        ("keyframe", "node-churn"), ("keyframe", "node-churn"), ("delta", ""),
    ]
    assert [d[2] for d in deltas] == list(range(1, 9))  # one generation a pack
    # group-set keeps the node rows: no full repack for it
    assert stats["lite_packs"] == 2 and stats["full_repacks"] == 5


# -- the snapshot-lite scan ---------------------------------------------------


def _node_and_group_churn(name, world):
    nodes, node_req, groups = world
    node_req = dict(node_req)
    node_req["n03"] = {"cpu": 9000, "pods": 3}
    node_req["n07"] = {"cpu": 1000, "pods": 1}
    groups[1].member_request = {"cpu": 3000}  # in place
    groups[2].scheduled = 1
    groups[4].released = True
    return nodes, node_req, groups


def _meta_churn(name, world):
    nodes, node_req, groups = world
    groups[3].priority = 50  # jumps the queue
    groups[0].creation_ts = -0.0  # ties 0.0 exactly
    return nodes, node_req, groups


def test_lite_scan_and_in_place_mutation_match_reference():
    deltas, stats = _compare(_run([_node_and_group_churn, _no_change, _meta_churn,
                                   _no_change]))
    assert deltas[1][:2] == ("delta", "") and deltas[1][6] == "scan"
    assert deltas[1][3] == [3, 7] and deltas[1][4] == [1]
    # the in-place mutation was captured: the next pack is a no-op
    assert deltas[2][3:6] == ([], [], [])
    # gang 3's priority moved; gang 0's -0.0 keys equal to its 0.0
    assert deltas[3][5] == [3]
    assert stats["order_resorts"] == 1 and stats["lite_packs"] == 4


def test_selector_drops_lite_and_stays_exact():
    def selector(name, world):
        nodes, node_req, groups = world
        groups[0].node_selector = {"zone": "a"}
        nodes[0].metadata.labels = {"zone": "a"}
        return nodes, node_req, groups

    def back(name, world):
        nodes, node_req, groups = world
        groups[0].node_selector = {}
        return nodes, node_req, groups

    deltas, stats = _compare(_run([selector, _no_change, back, _no_change]))
    # the selector packs run the full construction (per-group fit rows)
    # with the lite state dropped; clearing it re-arms the lite state,
    # and only the last pack runs the lite scan
    assert [d[0] for d in deltas] == ["keyframe"] + ["delta"] * 4
    assert stats["lite"] and stats["lite_packs"] == 1 and stats["full_repacks"] == 1


# -- pack_fold ---------------------------------------------------------------


def _fold_step(node_names, gang_index, mutate):
    """A fold of the named nodes (their requested dicts bumped) and one
    gang (``mutate`` applied to a fresh GroupDemand copy)."""
    def step(name, world):
        snapshot, _ = _mods(name)
        nodes, node_req, groups = world
        for nn in node_names:
            node_req[nn] = {"cpu": node_req[nn].get("cpu", 0) + 1000,
                            "pods": node_req[nn].get("pods", 0) + 1}
        group_updates = []
        if gang_index is not None:
            g = groups[gang_index]
            fresh = snapshot.GroupDemand(
                full_name=g.full_name, min_member=g.min_member, scheduled=g.scheduled,
                matched=g.matched, priority=g.priority, creation_ts=g.creation_ts,
                member_request=dict(g.member_request), released=g.released,
                has_pod=g.has_pod)
            mutate(fresh)
            groups[gang_index] = fresh
            group_updates.append(fresh)
        return ("fold", [(nn, dict(node_req[nn])) for nn in node_names],
                group_updates, (nodes, node_req, groups))
    return step


def _refold(name, world):
    """The same names folded again with unchanged state."""
    nodes, node_req, groups = world
    return ("fold", [("n05", dict(node_req["n05"]))], [groups[2]],
            (nodes, node_req, groups))


def test_pack_fold_matches_reference_and_pack():
    def bump(g):
        g.scheduled += 1
        g.member_request = {"cpu": 2500}

    fold = _fold_step(["n05", "n01"], 2, bump)
    deltas, stats = _compare(_run([fold, _refold, _no_change]))
    assert deltas[1][6] == "events" and deltas[1][3] == [5, 1] and deltas[1][4] == [2]
    # idempotent: the re-fold of unchanged state rewrites nothing
    assert deltas[2][6] == "events" and deltas[2][3:6] == ([], [], [])
    # the scan pack after the folds sees nothing new: fold == pack
    assert deltas[3][6] == "scan" and deltas[3][3:6] == ([], [], [])
    assert stats["fold_packs"] == 2


def test_pack_fold_against_a_scan_pack_of_the_same_state():
    """The fold and a second packer's scan pack of the same churned state
    emit equal arrays and delta rows."""
    for name in PACKAGES:
        snapshot, _ = _mods(name)
        nodes, node_req, groups = _world(name, seed=4)
        folder, scanner = snapshot.DeltaSnapshotPacker(), snapshot.DeltaSnapshotPacker()
        folder.pack(nodes, node_req, groups)
        scanner.pack(nodes, node_req, groups)
        node_req["n02"] = {"cpu": 7000, "pods": 4}
        groups[5].priority = 9
        folded = folder.pack_fold([("n02", node_req["n02"])], [groups[5]])
        scanned = scanner.pack(nodes, node_req, groups)
        a, b = _emitted(folded), _emitted(scanned)
        assert a["delta"][6] == "events" and b["delta"][6] == "scan"
        a["delta"] = a["delta"][:6]
        b["delta"] = b["delta"][:6]
        _assert_same(a, b)


def test_pack_fold_bails_match_reference():
    results = []
    for name in PACKAGES:
        snapshot, _ = _mods(name)
        nodes, node_req, groups = _world(name)
        packer = snapshot.DeltaSnapshotPacker()
        got = [packer.pack_fold([("n00", {"cpu": 1})], []) is None]
        packer.pack(nodes, node_req, groups)
        stranger = snapshot.GroupDemand(full_name="default/stranger", min_member=1,
                                        member_request={"cpu": 1})
        selector = snapshot.GroupDemand(full_name="default/gang-1", min_member=1,
                                        member_request={"cpu": 1},
                                        node_selector={"zone": "a"})
        got += [
            packer.pack_fold([("ghost", {"cpu": 1})], []) is None,
            packer.pack_fold([], [stranger]) is None,
            packer.pack_fold([("n01", {"odd.io/lane": 3})], []) is None,
            packer.pack_fold([], [selector]) is None,
        ]
        # every bail was two-phase: the next scan pack is a clean no-op
        snap = packer.pack(nodes, node_req, groups)
        got.append(_emitted(snap)["delta"])
        results.append(got)
    assert results[0] == results[1]
    assert results[1][:5] == [True] * 5 and results[1][5][3:6] == ([], [], [])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_churn_sweep_matches_reference(seed):
    """Mixed churn across rounds — node rows, demand rows (in place),
    progress tails, sort keys, folds — bit for bit in both packages."""
    rng = np.random.default_rng(seed)
    plan = []
    for _ in range(8):
        plan.append((
            [int(i) for i in rng.integers(0, 12, size=rng.integers(0, 3))],
            int(rng.integers(0, 6)), int(rng.integers(0, 4)), int(rng.integers(1, 5000)),
            bool(rng.integers(0, 2)),
        ))

    def make(rows, gi, mode, value, fold):
        def mutate(g):
            if mode == 0:
                g.member_request = {"cpu": value}
            elif mode == 1:
                g.scheduled = value % 3
                g.matched = value % 2
            elif mode == 2:
                g.priority = value % 7 - 3
            else:
                g.released = bool(value % 2)

        if fold:
            return _fold_step([f"n{i:02d}" for i in sorted(set(rows))], gi, mutate)

        def step(name, world):
            nodes, node_req, groups = world
            for i in rows:
                node_req[f"n{i:02d}"] = {"cpu": value % 8000, "pods": value % 7}
            mutate(groups[gi])
            return nodes, node_req, groups
        return step

    deltas, stats = _compare(_run([make(*p) for p in plan], n=12, g=6, seed=seed))
    assert all(d is not None and d[0] == "delta" for d in deltas[1:])


# -- sort keys ---------------------------------------------------------------

_doubles = st.floats(allow_nan=False, allow_infinity=False, width=64)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.one_of(_doubles, st.sampled_from([0.0, -0.0, 1.5, -1.5, 1e-300,
                                                      -1e-300, 2.0**52])),
                min_size=1, max_size=40))
def test_ts_sort_keys_match_reference_and_order(values):
    from batch_scheduler_tpu.ops.snapshot import _ts_sort_keys as ref_keys
    from batch_scheduler_tpu_torch.ops.snapshot import _ts_sort_keys

    ts = np.array(values, dtype=np.float64)
    hi, lo = _ts_sort_keys(ts)
    rhi, rlo = ref_keys(ts)
    assert hi.dtype == np.int32 and lo.dtype == np.int32
    assert np.array_equal(hi, rhi) and np.array_equal(lo, rlo)
    # (hi, lo) orders exactly like Python's float compare, ties included
    keys = list(zip(hi.tolist(), lo.tolist()))
    for i in range(len(values)):
        for j in range(len(values)):
            assert (keys[i] < keys[j]) == (values[i] < values[j])


# -- EventLog ----------------------------------------------------------------


def _event_logs(cap):
    return [importlib.import_module(f"{name}.ops.events").EventLog(cap=cap, label="t")
            for name in PACKAGES]


def _batch(b):
    return (sorted(b.node_names), sorted(b.group_names), b.bumps, b.blind,
            b.structural, b.overflow, b.complete, b.empty)


@pytest.mark.parametrize("case", ["coalesce", "blind", "structural", "overflow"])
def test_event_log_contract_matches_reference(case):
    out = []
    for log in _event_logs(2 if case == "overflow" else 64):
        seq = []
        if case == "coalesce":
            for _ in range(3):
                log.note_bump("node-requested", ("n1",))
            log.note_bump("node-requested", ("n2",))
            log.note_bump("node-requested", ())
            log.note_group("default/g1")
            log.note_group("default/g1")
            seq.append(log.depth())
        elif case == "blind":
            log.note_group("default/g1")
            log.note_blind()
        elif case == "structural":
            log.note_bump("node-object", ("n1",))
        else:
            for i in range(4):
                log.note_bump("node-requested", (f"n{i}",))
            seq.append(log.stats()["dropped"])
        seq.append(_batch(log.drain()))
        seq.append(_batch(log.drain()))  # a drain resets everything
        seq.append(log.depth())
        out.append(seq)
    assert out[0] == out[1]
    first = out[1][-3]
    if case == "coalesce":
        assert out[1][0] == 3 and first[2] == 5 and first[6]
    elif case == "overflow":
        # bounded names, but bump accounting is never dropped
        assert len(first[0]) == 2 and first[2] == 4 and not first[6]
    else:
        assert not first[6]
    assert out[1][-2][6] and out[1][-2][7]


def test_event_log_default_cap_matches_reference(monkeypatch):
    """The port's constant cap is the reference's default
    (``BST_EVENT_LOG_CAP`` unset), and a log built without a cap uses it."""
    from batch_scheduler_tpu.ops.events import event_log_cap
    from batch_scheduler_tpu_torch.ops.events import EVENT_LOG_CAP, EventLog

    monkeypatch.delenv("BST_EVENT_LOG_CAP", raising=False)
    assert EVENT_LOG_CAP == event_log_cap() == EventLog().cap
    log = EventLog()
    for i in range(EVENT_LOG_CAP + 1):
        log.note_bump("node-requested", (f"n{i}",))
    batch = log.drain()
    assert batch.overflow and len(batch.node_names) == EVENT_LOG_CAP
    assert batch.bumps == EVENT_LOG_CAP + 1


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_event_fed_pack_on_card_matches_cpu():
    """Events from the port's ClusterState through its EventLog and
    pack_fold, synced into a holder on cuda and one on cpu: equal resident
    rows and derived columns after every fold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from batch_scheduler_tpu_torch.ops.device_state import DeviceStateHolder
    from batch_scheduler_tpu_torch.ops.events import EventLog
    from batch_scheduler_tpu_torch.ops.snapshot import DeltaSnapshotPacker

    nodes, node_req, groups = _world("batch_scheduler_tpu_torch", n=40, g=12)
    packer = DeltaSnapshotPacker()
    holders = [DeviceStateHolder("cuda"), DeviceStateHolder("cpu")]
    log = EventLog(cap=64)
    snap = packer.pack(nodes, node_req, groups)
    for step in range(6):
        outs = [h.sync(snap) for h in holders]
        for a, b in zip(*outs):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a.cpu(), b)
        names = [f"n{(7 * step + k) % 40:02d}" for k in range(3)]
        for nn in names:
            node_req[nn] = {"cpu": 1000 * step, "pods": step}
            log.note_bump("node-requested", (nn,))
        groups[step % 12].priority = step
        log.note_group(groups[step % 12].full_name)
        batch = log.drain()
        snap = packer.pack_fold([(nn, node_req[nn]) for nn in sorted(batch.node_names)],
                                [g for g in groups if g.full_name in batch.group_names])
        assert snap is not None and snap.delta.source == "events"
