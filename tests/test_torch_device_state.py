"""The port's device-resident state (batch_scheduler_tpu_torch.ops.
device_state) on the CPU against the JAX reference's holder: the same
packer stream synced into both gives equal batch arguments at every step
(resident rows, the host tail, and the device-derived fit row and queue
order); the resync rules (a withheld delta -> ``generation``, a resident
shape that no longer matches -> ``bucket``, negative or out-of-range
scatter rows refused); the chained stable sorts against ``_derive_impl``
on random keys with heavy ties and pad sentinels; the in-place scatter;
and the cached derivation of the zero-churn steady state. Every array is
an integer or a bool: the tolerance is exact equality."""

import importlib

import numpy as np
import pytest
import torch

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
_I32_MAX = np.iinfo(np.int32).max


def _mods(name):
    return (
        importlib.import_module(f"{name}.ops.snapshot"),
        importlib.import_module(f"{name}.ops.device_state"),
        importlib.import_module(f"{name}.sim.scenarios"),
    )


def _holder(name, device="cpu"):
    ds = _mods(name)[1]
    if name.endswith("_torch"):
        return ds.DeviceStateHolder(device, label="test")
    return ds.DeviceStateHolder(label="test")


def _np(a):
    """A host copy (a CPU tensor's numpy view would follow later in-place
    scatters)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy().copy()
    return np.array(a)


def _world(name, n=24, g=10, seed=5):
    snapshot, _, scen = _mods(name)
    rng = np.random.default_rng(seed)
    nodes = [
        scen.make_sim_node(f"n{i:02d}", {"cpu": "32", "memory": "128Gi", "pods": "110"})
        for i in range(n)
    ]
    node_req = {f"n{i:02d}": {"cpu": int(rng.integers(0, 16)) * 1000, "pods": int(rng.integers(0, 9))}
                for i in range(n)}
    groups = [
        snapshot.GroupDemand(
            full_name=f"default/gang-{j:02d}", min_member=int(rng.integers(1, 8)),
            member_request={"cpu": int(rng.integers(1, 6)) * 1000},
            priority=int(rng.integers(0, 3)), creation_ts=float(rng.integers(0, 3)),
        )
        for j in range(g)
    ]
    return nodes, node_req, groups


def _churn(rng, steps, n=24, g=10):
    """A seeded churn plan: per step, node rows to rewrite, a gang and a
    field to change."""
    return [
        ([int(i) for i in rng.integers(0, n, size=rng.integers(0, 4))],
         int(rng.integers(0, g)), int(rng.integers(0, 4)), int(rng.integers(1, 9000)))
        for _ in range(steps)
    ]


def _apply(step, world):
    rows, gi, mode, value = step
    nodes, node_req, groups = world
    for i in rows:
        node_req[f"n{i:02d}"] = {"cpu": value % 30000, "pods": value % 11}
    g = groups[gi]
    if mode == 0:
        g.member_request = {"cpu": value}
    elif mode == 1:
        g.scheduled = value % 4
    elif mode == 2:
        g.priority = value % 5 - 2
    else:
        g.creation_ts = float(value % 3) - 1.0


@pytest.mark.parametrize("derive", ["on", "off"])
def test_sync_matches_reference_over_churn(monkeypatch, derive):
    """The port always derives fit and order from the meta columns; the
    reference does so with ``BST_DEVICE_DERIVE`` on and uploads its host
    columns with it off. Either way the batch args are equal."""
    monkeypatch.setenv("BST_DEVICE_DERIVE", "1" if derive == "on" else "0")
    plan = _churn(np.random.default_rng(11), 10)
    traces, stats = [], []
    for name in PACKAGES:
        snapshot = _mods(name)[0]
        world = _world(name)
        packer = snapshot.DeltaSnapshotPacker()
        holder = _holder(name)
        trace = []
        for step in [None] + plan:
            if step is not None:
                _apply(step, world)
            snap = packer.pack(*world)
            args = holder.sync(snap)
            host = snap.device_args()
            # the resident args equal the host pack, column for column
            for a, h in zip(args, host):
                assert np.array_equal(_np(a), np.asarray(h))
            trace.append([_np(a) for a in args])
        traces.append(trace)
        s = holder.stats()
        stats.append({k: s[k] for k in ("generation", "deltas_applied", "rows_scattered",
                                        "keyframes", "derived_batches", "meta_resident")})
    for ref, port in zip(*traces):
        for a, b in zip(ref, port):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    derived = ("derived_batches", "meta_resident")
    if derive == "on":
        assert stats[0] == stats[1]
    else:
        assert stats[0]["derived_batches"] == 0 and not stats[0]["meta_resident"]
        assert {k: v for k, v in stats[0].items() if k not in derived} == \
            {k: v for k, v in stats[1].items() if k not in derived}
    assert stats[1]["keyframes"] == {"first": 1} and stats[1]["deltas_applied"] == 10
    assert stats[1]["meta_resident"] and stats[1]["derived_batches"] == 11


def test_port_args_are_tensors_on_the_holder_device():
    snapshot = _mods(PACKAGES[1])[0]
    world = _world(PACKAGES[1])
    packer = snapshot.DeltaSnapshotPacker()
    holder = _holder(PACKAGES[1])
    args = holder.sync(packer.pack(*world))
    # resident lanes and the derived fit/order are tensors; the O(G) tail
    # (remaining, group_valid) stays host numpy, as in the reference
    kinds = [isinstance(a, torch.Tensor) for a in args]
    assert kinds == [True, True, True, False, True, False, True]
    assert args[4].dtype == torch.bool and args[4].shape == (1, 32)
    assert args[6].dtype == torch.int32


def test_batch_takes_resident_tensors_uncopied():
    """``batch_from_numpy`` (and so ``execute_batch_host``) takes a tensor
    already on the batch's device as it is, checks its dtype, and gives
    the same host dict as the all-numpy batch."""
    from batch_scheduler_tpu_torch.ops.convert import batch_from_numpy
    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host

    snapshot = _mods(PACKAGES[1])[0]
    snap = snapshot.DeltaSnapshotPacker().pack(*_world(PACKAGES[1]))
    holder = _holder(PACKAGES[1])
    args = holder.sync(snap)
    batch, _ = batch_from_numpy(args, snap.progress_args(), "cpu")
    for i in (0, 1, 2, 4, 6):
        assert batch[i] is args[i]
    got, _ = execute_batch_host(args, snap.progress_args(), device="cpu")
    want, _ = execute_batch_host(snap.device_args(), snap.progress_args(), device="cpu")
    for k in ("placed", "gang_feasible", "progress", "best", "best_exists",
              "assignment_nodes", "assignment_counts"):
        assert np.array_equal(got[k], want[k]), k
    bad = list(args)
    bad[1] = args[1].to(torch.int64)
    with pytest.raises(TypeError):
        batch_from_numpy(bad, snap.progress_args(), "cpu")


def _resync(name, case):
    snapshot = _mods(name)[0]
    nodes, node_req, groups = _world(name)
    packer = snapshot.DeltaSnapshotPacker()
    holder = _holder(name)
    snap = packer.pack(nodes, node_req, groups)
    holder.sync(snap)
    if case == "withheld":
        node_req["n01"] = {"cpu": 777}
        packer.pack(nodes, node_req, groups)  # delta never synced: the gap
        node_req["n02"] = {"cpu": 888}
    else:
        # the resident buffers come from a larger node bucket than the
        # next contiguous delta's
        big = snapshot.ClusterSnapshot(nodes, node_req, groups, min_buckets=(0, 64))
        holder.keyframe(big.device_args(), snap.delta.generation, "sized")
        node_req["n03"] = {"cpu": 999}
    snap = packer.pack(nodes, node_req, groups)
    args = holder.sync(snap)
    for a, h in zip(args, snap.device_args()):
        assert np.array_equal(_np(a), np.asarray(h))
    return snap.delta.kind, holder.stats()["keyframes"], holder.current_generation()


@pytest.mark.parametrize("case,reason", [("withheld", "generation"), ("bucket", "bucket")])
def test_resync_reasons_match_reference(case, reason):
    ref, port = (_resync(name, case) for name in PACKAGES)
    assert port == ref
    assert port[0] == "delta" and port[1].get(reason) == 1


@pytest.mark.parametrize("bad", [[-1], [32], [2**20], [3, -2]], ids=str)
def test_bad_scatter_rows_refused_like_reference(bad):
    out = []
    for name in PACKAGES:
        snapshot = _mods(name)[0]
        nodes, node_req, groups = _world(name)
        snap = snapshot.DeltaSnapshotPacker().pack(nodes, node_req, groups)
        holder = _holder(name)
        holder.keyframe(snap.device_args(), 1, "wire-keyframe")
        before = _np(holder.keyframe(snap.device_args(), 1, "wire-keyframe")[1])
        idx = np.array(bad, np.int32)
        rows = np.asarray(snap.requested)[: len(bad)] + 1
        small = (snap.remaining, snap.fit_mask, snap.group_valid, snap.order)
        got = [holder.apply_rows(1, 2, (idx, rows), None, small) is None,
               holder.apply_rows(1, 2, None, (idx, rows[:, :snap.group_req.shape[1]]), small) is None,
               holder.current_generation()]
        # a refusal leaves the resident rows untouched
        ok = holder.apply_rows(1, 2, None, None, small)
        assert np.array_equal(_np(ok[1]), before)
        out.append(got)
    assert out[0] == out[1] == [True, True, 1]


def test_derive_matches_reference_lexsort_on_heavy_ties():
    import jax.numpy as jnp

    from batch_scheduler_tpu.ops.device_state import _derive_impl
    from batch_scheduler_tpu_torch.ops.device_state import derive_columns

    rng = np.random.default_rng(21)
    for gb, g, spread in ((8, 8, 2), (64, 50, 2), (256, 200, 3), (1024, 1000, 4), (16, 0, 1)):
        # few distinct values per key: ties at every level
        inv_prio = np.full(gb, _I32_MAX, np.int32)
        ts_hi = np.full(gb, _I32_MAX, np.int32)
        ts_lo = np.full(gb, _I32_MAX, np.int32)
        inv_prio[:g] = ~rng.integers(-spread, spread, size=g).astype(np.int32)
        ts_hi[:g] = rng.integers(-spread, spread, size=g) + np.int32(-(2**31))
        ts_lo[:g] = rng.choice([-(2**31), -1, 0, 1, _I32_MAX - 1], size=g)
        name_rank = np.arange(gb, dtype=np.int32)
        name_rank[:g] = rng.permutation(g)
        node_valid = rng.random(gb) < 0.9
        keys = (inv_prio, ts_hi, ts_lo, name_rank)
        fit, order = derive_columns(*(torch.from_numpy(k) for k in keys),
                                    torch.from_numpy(node_valid))
        rfit, rorder = _derive_impl(*(jnp.asarray(k) for k in keys), jnp.asarray(node_valid))
        assert order.dtype == torch.int32 and fit.dtype == torch.bool
        assert np.array_equal(order.numpy(), np.asarray(rorder))
        assert np.array_equal(fit.numpy(), np.asarray(rfit))
        # pad rows sort last, in row order
        assert order[g:].tolist() == list(range(g, gb))


def test_scatter_writes_resident_buffers_in_place():
    """A contiguous delta rewrites exactly its rows inside the resident
    tensors (same storage, no new upload), and the batch args equal the
    host pack."""
    snapshot = _mods(PACKAGES[1])[0]
    nodes, node_req, groups = _world(PACKAGES[1])
    packer = snapshot.DeltaSnapshotPacker()
    holder = _holder(PACKAGES[1])
    holder.sync(packer.pack(nodes, node_req, groups))
    _, requested, group_req, *_ = holder.last_args()
    ptrs = (requested.data_ptr(), group_req.data_ptr())
    before = (_np(requested), _np(group_req))
    node_req["n05"] = {"cpu": 12345, "pods": 3}
    groups[2].member_request = {"cpu": 4321}
    snap = packer.pack(nodes, node_req, groups)
    args = holder.sync(snap)
    assert snap.delta.node_rows.tolist() == [5] and snap.delta.group_rows.tolist() == [2]
    assert (args[1].data_ptr(), args[2].data_ptr()) == ptrs
    assert args is holder.last_args()
    for a, h in zip(args, snap.device_args()):
        assert np.array_equal(_np(a), np.asarray(h))
    # only the churned rows moved
    assert np.array_equal(np.nonzero((_np(args[1]) != before[0]).any(axis=1))[0], [5])
    assert np.array_equal(np.nonzero((_np(args[2]) != before[1]).any(axis=1))[0], [2])
    s = holder.stats()
    assert s["rows_scattered"] == 2 and s["keyframes"] == {"first": 1}


def test_steady_state_reuses_the_derivation():
    """With no meta row churned the derived fit and order are the cached
    tensors (no derive runs); a priority change re-derives once."""
    snapshot = _mods(PACKAGES[1])[0]
    nodes, node_req, groups = _world(PACKAGES[1])
    packer = snapshot.DeltaSnapshotPacker()
    holder = _holder(PACKAGES[1])
    first = holder.sync(packer.pack(nodes, node_req, groups))
    for _ in range(3):
        node_req["n01"] = {"cpu": int(node_req["n01"]["cpu"]) + 1000}
        args = holder.sync(packer.pack(nodes, node_req, groups))
        assert args[4] is first[4] and args[6] is first[6]
    assert holder.stats()["derives"] == 1
    groups[3].priority = 7
    snap = packer.pack(nodes, node_req, groups)
    args = holder.sync(snap)
    assert snap.delta.meta_rows.tolist() == [3]
    assert holder.stats()["derives"] == 2 and args[6] is not first[6]
    assert np.array_equal(_np(args[6]), snap.order)
    assert holder.stats()["derived_batches"] == 5


def test_holder_copies_published_host_arrays():
    """A CPU holder never aliases a snapshot's host arrays: scattering
    the next delta leaves the earlier snapshot as it was scored."""
    snapshot = _mods(PACKAGES[1])[0]
    nodes, node_req, groups = _world(PACKAGES[1])
    packer = snapshot.DeltaSnapshotPacker()
    holder = _holder(PACKAGES[1])
    snap = packer.pack(nodes, node_req, groups)
    holder.sync(snap)
    kept = np.asarray(snap.requested).copy()
    node_req["n00"] = {"cpu": 31000, "pods": 100}
    holder.sync(packer.pack(nodes, node_req, groups))
    assert np.array_equal(snap.requested, kept)


@pytest.mark.cuda
def test_holder_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    snapshot = _mods(PACKAGES[1])[0]
    world = _world(PACKAGES[1], n=300, g=40)
    packer = snapshot.DeltaSnapshotPacker()
    holders = [_holder(PACKAGES[1], "cuda"), _holder(PACKAGES[1], "cpu")]
    plan = _churn(np.random.default_rng(4), 12, n=300, g=40)
    for step in [None] + plan:
        if step is not None:
            _apply(step, world)
        snap = packer.pack(*world)
        gpu, cpu = (h.sync(snap) for h in holders)
        for a, b in zip(gpu, cpu):
            if isinstance(a, torch.Tensor):
                assert a.device.type == "cuda"
            assert np.array_equal(_np(a), _np(b))
    assert holders[0].stats()["keyframes"] == holders[1].stats()["keyframes"] == {"first": 1}
