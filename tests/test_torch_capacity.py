"""The port's capacity observatory (batch_scheduler_tpu_torch/ops/capacity.py,
utils/timeseries.py, utils/tenancy.batch_tenants) against the JAX
package's, on the CPU:

- ``_capacity_kernel`` on seeded batches (padded rows and zero-alloc
  nodes, lanes no pending demand touches, all four tiers, several
  tenants, plans with placed gangs and zero-count backfill slots):
  integer outputs exactly, float outputs within a relative 1e-6 (the port
  sums exactly in int64 and casts once; at these sizes every float sum is
  exact in both packages);
- ``capacity_summary`` exactly (after the reference's ``_f`` rounding),
  ``batch_tenants`` and ``DownsamplingRing`` exactly;
- the sampler's budget gate under a fake clock, and the knobs' guards;
- the scorer's publish: the sample under the batch's audit id, its
  ``capacity_sample`` audit event equal to the JAX package's summary of
  the same record, the scan counter's tenant;
- the sidecar's ``capacity`` block in ``TRACE_INFO``, attributed to the
  announced tenant, and the coalescer's DRF weights read from it.
"""

import importlib
import json
import types

import numpy as np
import pytest
import torch

from batch_scheduler_tpu_torch.ops import capacity as tcap
from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host
from batch_scheduler_tpu_torch.utils import tenancy

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
FLOAT_RTOL = 1e-6
FLOAT_OUTPUTS = ("lane_alloc", "lane_free", "stranded_lane", "frag_total", "tenant_used")


def _pkg(name, module):
    return importlib.import_module(f"{name}.{module}")


@pytest.fixture(autouse=True)
def _clean_observatory_state():
    tenancy.reset_registry()
    tenancy.set_batch_tenant(None)
    yield
    tcap.set_active_sampler(None)
    tenancy.reset_registry()
    tenancy.set_batch_tenant(None)


def _batch(seed, n=37, g=13, r=5):
    """A seeded tight batch, padded by the port's pad_oracle_batch (n and
    g are not bucket sizes): some nodes with zero alloc, lane r-1 never
    requested (its ref demand is 0), per-group masks, gangs big enough
    that some stay pending and some are unplaceable; then the port's CPU
    batch for the plan. Returns (batch_args, progress_args, host, names,
    tiers)."""
    from batch_scheduler_tpu_torch.ops.bucketing import pad_oracle_batch

    rs = np.random.RandomState(seed)
    alloc = rs.randint(1, 24, size=(n, r)).astype(np.int32)
    alloc[rs.rand(n) < 0.15] = 0
    requested = (alloc * rs.rand(n, r) * 0.6).astype(np.int32)
    group_req = rs.randint(0, 5, size=(g, r)).astype(np.int32)
    group_req[:, 0] = np.maximum(group_req[:, 0], 1)
    group_req[:, r - 1] = 0
    remaining = rs.randint(0, 12, size=g).astype(np.int32)
    remaining[0] = 200  # wider than the cluster: unplaceable
    mask = rs.rand(g, n) > 0.25
    batch_args, progress_args = pad_oracle_batch(
        alloc=alloc, requested=requested, group_req=group_req, remaining=remaining,
        fit_mask=mask, group_valid=rs.rand(g) > 0.1,
        order=rs.permutation(g).astype(np.int32),
        min_member=np.maximum(remaining, 1), scheduled=rs.randint(0, 3, size=g).astype(np.int32),
        matched=rs.randint(0, 3, size=g).astype(np.int32), ineligible=np.zeros(g, bool),
        creation_rank=rs.permutation(g).astype(np.int32))
    host, _ = execute_batch_host(batch_args, progress_args, device="cpu")
    names = [f"team-{i % 3}/g{i}" if i % 5 else f"g{i}" for i in range(g)]
    tiers = np.zeros(batch_args[2].shape[0], np.int32)
    tiers[:g] = rs.randint(-1, 6, size=g)
    return batch_args, progress_args, host, names, tiers


SEEDS = (0, 1, 2, 3)


def _kernel_args(seed):
    batch_args, progress_args, host, names, tiers = _batch(seed)
    tid, labels = tenancy.batch_tenants(names, batch_args[2].shape[0])
    args = (*batch_args[:6], np.asarray(host["placed"]).astype(np.int32),
            np.asarray(host["assignment_nodes"]).astype(np.int32),
            np.asarray(host["assignment_counts"]).astype(np.int32),
            progress_args[1], progress_args[2], tid, tiers)
    return args, len(labels), host


@pytest.mark.parametrize("seed", SEEDS)
def test_capacity_kernel_matches_reference(seed):
    from batch_scheduler_tpu.ops.capacity import _capacity_kernel as jkernel

    args, tenants, host = _kernel_args(seed)
    want = jkernel(*args, tenants=tenants)
    got = tcap._capacity_kernel(*(torch.from_numpy(np.asarray(a)) for a in args),
                                tenants=tenants)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        if k in FLOAT_OUTPUTS:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    # the cases the seeds cover
    counts = np.asarray(host["assignment_counts"])
    placed = np.asarray(host["placed"])
    assert placed.any() and (counts[placed] == 0).any()  # zero-count backfill
    assert int(got["unplaceable_gangs"]) >= 1 and int(got["pending_seats"]) > 0
    assert int(got["ref_demand"][-1]) == 0  # a lane no demand touches
    assert int(got["nodes_real"]) < args[0].shape[0]  # zero-alloc and pad rows
    assert tenants == 4 and (got["tenant_used"].sum(dim=1) > 0).sum() >= 2


def test_capacity_kernel_covers_every_tier():
    from batch_scheduler_tpu.ops.capacity import _capacity_kernel as jkernel

    args, tenants, _ = _kernel_args(0)
    args = list(args)
    g = args[2].shape[0]
    args[12] = (np.arange(g) % 4).astype(np.int32)
    args[7 - 1] = np.zeros(g, np.int32)  # nothing placed: every gang pends
    want = jkernel(*args, tenants=tenants)
    got = tcap._capacity_kernel(*(torch.from_numpy(np.asarray(a)) for a in args),
                                tenants=tenants)
    np.testing.assert_array_equal(got["tier_largest"].numpy(), np.asarray(want["tier_largest"]))
    np.testing.assert_array_equal(got["tier_pending"].numpy(), np.asarray(want["tier_pending"]))
    assert (got["tier_pending"] > 0).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_capacity_summary_matches_reference(seed):
    from batch_scheduler_tpu.ops.capacity import capacity_summary as jsummary

    batch_args, progress_args, host, names, tiers = _batch(seed)
    kw = dict(group_names=names, scheduled=progress_args[1], matched=progress_args[2],
              policy_prio=tiers)
    want = jsummary(batch_args, host, **kw)
    got = tcap.capacity_summary(batch_args, host, device="cpu", **kw)
    assert got == want
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_capacity_summary_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    batch_args, progress_args, host, names, _ = _batch(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcap.capacity_summary(batch_args, host, group_names=names)


@pytest.mark.parametrize("names, g_bucket", [
    (["b/x", "a/y", "a/z", "c/w"], 6),
    ([f"ns{i % 40}/g{i}" for i in range(90)], 128),  # past the 32-label cap
    (["plain", "a/y"], None),
])
def test_batch_tenants_matches_reference(names, g_bucket):
    jt = _pkg("batch_scheduler_tpu", "utils.tenancy")
    ids, labels = tenancy.batch_tenants(names, g_bucket)
    jids, jlabels = jt.batch_tenants(names, g_bucket)
    assert labels == jlabels and labels[-1] == "other"
    np.testing.assert_array_equal(ids, jids)
    assert ids.dtype == np.int32


def test_downsampling_ring_matches_reference():
    from batch_scheduler_tpu.utils.timeseries import DownsamplingRing as JRing
    from batch_scheduler_tpu_torch.utils.timeseries import DownsamplingRing

    rings = [DownsamplingRing(capacity=4, levels=3), JRing(capacity=4, levels=3)]
    for i in range(100):
        sample = {"v": float(i), "v_max": float(i), "hist": [i, 2 * i],
                  "nested": {"a": i % 7, "flag": i % 2 == 0}, "name": f"s{i}"}
        for ring in rings:
            ring.append(float(i), sample)
    assert rings[0].series() == rings[1].series()
    assert rings[0].stats() == rings[1].stats()
    assert rings[0].last() == rings[1].last()
    assert rings[0].stats()["dropped"] > 0 and len(rings[0]) <= 12


# -- the sampler ---------------------------------------------------------------


class _Clock:
    """A fake ``time`` for ops.capacity: the monotonic clock moves only
    when the test says, and each perf_counter read advances 10 ms (a
    sample's kernel time is 10 ms)."""

    def __init__(self):
        self.now = 100.0
        self.perf = 0.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        self.perf += 0.01
        return self.perf

    def time(self):
        return self.now


def test_sampler_budget_gate_under_fake_clock(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tcap, "time", types.SimpleNamespace(
        monotonic=clock.monotonic, perf_counter=clock.perf_counter, time=clock.time))
    monkeypatch.setenv("BST_CAPACITY_BUDGET_FRAC", "0.02")
    batch_args, progress_args, host, names, _ = _batch(1)
    sampler = tcap.CapacitySampler(label="t")

    def note():
        return sampler.note_batch(batch_args, host, group_names=names, device="cpu")

    assert note() is not None  # the first sample always runs
    assert sampler.last_kernel_s == pytest.approx(0.01)
    # the next is allowed 0.01 / 0.02 = 0.5 s later
    clock.now += 0.49
    assert note() is None
    clock.now += 0.02
    assert note() is not None
    assert (sampler.samples, sampler.skipped) == (2, 1)
    # frac 1.0 samples every batch (once the last 2% slot has passed)
    monkeypatch.setenv("BST_CAPACITY", "1")  # tests/conftest.py turns it off
    monkeypatch.setenv("BST_CAPACITY_BUDGET_FRAC", "1.0")
    clock.now += 0.5
    assert note() is not None and note() is not None
    assert sampler.samples == 4
    # an erroring sample is counted, never raised, and backs off 5 s
    errors = tcap.DEFAULT_REGISTRY.counter("bst_capacity_samples_total")
    before = errors.value(outcome="error")
    assert sampler.note_batch(batch_args[:3], host, device="cpu") is None
    assert errors.value(outcome="error") == before + 1
    clock.now += 4.9
    assert note() is None
    clock.now += 0.2
    assert note() is not None
    series = sampler.series()
    assert sampler.samples == 5 and len(series) == 5
    assert series[-1]["data"]["capacity_violation"] == 1.0  # an unplaceable gang pends
    assert series[-1]["data"]["pending"] == sampler.last()["pending"]


def test_capacity_knob_parse_guards(monkeypatch):
    monkeypatch.setenv("BST_CAPACITY_BUDGET_FRAC", "junk")
    assert tcap.capacity_budget_frac() == 0.02
    monkeypatch.setenv("BST_CAPACITY_BUDGET_FRAC", "7")
    assert tcap.capacity_budget_frac() == 1.0
    monkeypatch.setenv("BST_CAPACITY", "junk-on")
    assert tcap.capacity_enabled() is True
    monkeypatch.setenv("BST_CAPACITY", "off")
    assert tcap.capacity_enabled() is False


# -- the scorer's publish -------------------------------------------------------


def _scorer_refresh(monkeypatch, audit_log=None):
    """One refresh of a CPU OracleScorer over 4 nodes and two tenants'
    gangs (one too wide to place)."""
    from batch_scheduler_tpu_torch.core import oracle_scorer as osc
    from batch_scheduler_tpu_torch.ops.snapshot import GroupDemand
    from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node

    nodes = [make_sim_node(f"s{i}", {"cpu": "8", "pods": "110"}) for i in range(4)]

    def fake_read(cluster, cache):
        return nodes, {}, [
            GroupDemand("acme/g0", 2, member_request={"cpu": 1000}, creation_ts=0.0),
            GroupDemand("acme/g1", 3, member_request={"cpu": 2000}, creation_ts=1.0),
            GroupDemand("zeta/wide", 40, member_request={"cpu": 4000}, creation_ts=2.0),
        ]

    monkeypatch.setattr(osc, "read_cluster_inputs", fake_read)
    scorer = osc.OracleScorer(device="cpu", audit_log=audit_log)
    scorer.refresh(types.SimpleNamespace(), types.SimpleNamespace())
    return scorer


def test_scorer_publish_feeds_sampler_and_scan_counter(monkeypatch):
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    monkeypatch.setenv("BST_CAPACITY", "1")  # tests/conftest.py turns it off
    monkeypatch.setenv("BST_CAPACITY_BUDGET_FRAC", "1.0")
    counter = DEFAULT_REGISTRY.counter("bst_scan_batches_total")
    before = counter.value(path="serial", tenant="acme")
    scorer = _scorer_refresh(monkeypatch)
    assert tcap.active_sampler() is scorer._capacity
    assert scorer._capacity.samples == 1
    last = scorer._capacity.last()
    assert last["placed"]["gangs"] == 2 and last["pending"]["unplaceable_gangs"] == 1
    assert [t["tenant"] for t in last["tenants"]] == ["acme", "zeta"]
    # the dominant tenant (acme: 2 of 3 gangs) labels the scan counter
    assert counter.value(path="serial", tenant="acme") == before + 1
    # a capacity-off scorer clears its predecessor's registration
    monkeypatch.setenv("BST_CAPACITY", "0")
    off = _scorer_refresh(monkeypatch)
    assert off._capacity is None and tcap.active_sampler() is None


def test_scorer_capacity_event_matches_reference_summary(monkeypatch, tmp_path):
    """The scorer's ``capacity_sample`` audit event carries its batch's
    audit id, and its summary equals the JAX package's capacity_summary
    over the same record's args (read back by the JAX package's reader)."""
    from batch_scheduler_tpu.ops.capacity import capacity_summary as jsummary
    from batch_scheduler_tpu.utils.audit import AuditReader as JReader
    from batch_scheduler_tpu_torch.utils.audit import AuditLog

    monkeypatch.setenv("BST_CAPACITY", "1")  # tests/conftest.py turns it off
    monkeypatch.setenv("BST_CAPACITY_BUDGET_FRAC", "1.0")
    log = AuditLog(str(tmp_path))
    scorer = _scorer_refresh(monkeypatch, audit_log=log)
    assert log.flush()
    log.stop()
    records = list(JReader(str(tmp_path)).records())
    events = [r for r in records if r.get("kind") == "event"]
    (batch,), _ = JReader(str(tmp_path)).batches()
    assert [e["event"] for e in events] == ["capacity_sample"]
    assert events[0]["audit_id"] == batch["audit_id"] is not None
    want = jsummary(batch["batch_args"], batch["result_arrays"],
                    group_names=batch["names"]["groups"],
                    scheduled=batch["progress_args"][1],
                    matched=batch["progress_args"][2])
    assert events[0]["summary"] == json.loads(json.dumps(want, sort_keys=True))
    assert events[0]["summary"] == json.loads(json.dumps(scorer._capacity.last()))


# -- the sidecar ---------------------------------------------------------------


def _wire_request(n=4, g=2, r=5, members=3):
    from batch_scheduler_tpu_torch.service import protocol as proto

    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = 8000
    alloc[:, 3] = 20
    group_req = np.zeros((g, r), np.int32)
    group_req[:, 0] = 1000
    group_req[:, 3] = 1
    return proto.ScheduleRequest(
        alloc=alloc, requested=np.zeros((n, r), np.int32), group_req=group_req,
        remaining=np.full(g, members, np.int32), fit_mask=np.ones((1, n), bool),
        group_valid=np.ones(g, bool), order=np.arange(g, dtype=np.int32),
        min_member=np.full(g, members, np.int32), scheduled=np.zeros(g, np.int32),
        matched=np.zeros(g, np.int32), ineligible=np.zeros(g, bool),
        creation_rank=np.arange(g, dtype=np.int32),
    )


@pytest.mark.parametrize("coalesce", [False, True])
def test_sidecar_capacity_rides_trace_info(monkeypatch, coalesce):
    """A TRACED request's TRACE_INFO telemetry carries the sidecar's
    capacity block, attributed to the announced tenant (whose share then
    weights the coalescer's DRF order); an untraced request never pays
    the sampler. Through the coalescer too, and for a wire delta (the
    mirror's resident tensors)."""
    from batch_scheduler_tpu_torch.service import OracleClient, serve_background
    from batch_scheduler_tpu_torch.service import protocol as proto
    from batch_scheduler_tpu_torch.service import server as server_mod
    from batch_scheduler_tpu_torch.utils.trace import new_trace_id

    monkeypatch.setenv("BST_CAPACITY", "1")  # tests/conftest.py turns it off
    monkeypatch.setenv("BST_CAPACITY_BUDGET_FRAC", "1.0")
    monkeypatch.setattr(server_mod, "_server_capacity", None)
    srv = serve_background(device="cpu", coalesce=coalesce)
    try:
        plain = OracleClient(*srv.address)
        plain.schedule(_wire_request(), tenant="acme")
        assert server_mod._server_capacity is None
        plain.close()
        client = OracleClient(*srv.address)
        for msg_type, payload in (
            (proto.MsgType.SCHEDULE_REQ, proto.pack_schedule_request(_wire_request())),
            (proto.MsgType.DELTA_SCHEDULE_REQ, proto.pack_delta_keyframe(1, _wire_request())),
        ):
            _, body = client._round_trip(msg_type, payload, trace_ctx=(new_trace_id(), ""),
                                         tenant="acme")
            assert proto.unpack_schedule_response(body).placed.all()
            cap = client.last_telemetry["capacity"]
            assert 0.0 <= cap["fragmentation_index"] <= 1.0
            assert cap["utilization"] and cap["pending_unplaceable_gangs"] == 0
        client.close()
        assert server_mod._server_capacity.samples == 2
        shares = server_mod._capacity_tenant_shares()
        assert set(shares) == {"acme"} and shares["acme"] > 0
        if coalesce:
            assert srv.coalescer._weights_fn is server_mod._capacity_tenant_shares
    finally:
        srv.shutdown()
        srv.server_close()


def test_sidecar_capacity_of_a_mega_demux(monkeypatch):
    """A mega group's demuxed host dict holds only the tenant's own gangs;
    the sidecar's sample pads its plan back to the batch's gang bucket
    (the reference's kernel errors on the cut dict). The summary equals the
    dedicated batch's."""
    from batch_scheduler_tpu_torch.service import server as server_mod
    from batch_scheduler_tpu_torch.service.coalescer import CoalesceJob, OracleCoalescer
    from batch_scheduler_tpu_torch.service.server import DeviceExecutor, _pad_request

    monkeypatch.setenv("BST_CAPACITY", "1")  # tests/conftest.py turns it off
    monkeypatch.setenv("BST_CAPACITY_BUDGET_FRAC", "1.0")
    monkeypatch.setattr(server_mod, "_server_capacity", None)
    executor = DeviceExecutor("cpu")
    coal = OracleCoalescer(executor, mode="mega", mega_cells=1 << 30)
    try:
        reqs = [_wire_request(n=4, g=2), _wire_request(n=6, g=3, members=2)]
        jobs = []
        for req in reqs:
            args, progress, (n, g) = _pad_request(req)
            jobs.append(CoalesceJob("acme", n, g, 5, args, progress,
                                    raw_fn=lambda req=req: (
                                        req.alloc, req.requested, req.group_req,
                                        req.remaining, req.fit_mask, req.group_valid,
                                        req.order, req.min_member, req.scheduled,
                                        req.matched, req.ineligible, req.creation_rank)))
        coal._run_mega(jobs)
        errors = tcap.DEFAULT_REGISTRY.counter("bst_capacity_samples_total")
        before = errors.value(outcome="error")
        for job in jobs:
            res = job.wait(60)
            assert res.host["placed"].shape[0] == job.g
            server_mod._maybe_server_capacity(executor, job.padded_args, job.progress_args,
                                              res.host, tenant="acme", g=job.g)
            ded, _ = execute_batch_host(job.padded_args, job.progress_args, device="cpu")
            want = tcap.capacity_summary(job.padded_args, ded, device="cpu",
                                         group_names=[f"acme/wire-{i}" for i in range(job.g)],
                                         scheduled=job.progress_args[1],
                                         matched=job.progress_args[2])
            assert server_mod._server_capacity.last() == want
            assert "capacity" in res.host["telemetry"]
        assert errors.value(outcome="error") == before
    finally:
        coal.stop()
        executor.stop()


@pytest.mark.cuda
def test_cuda_capacity_equals_cpu_and_repeats():
    """On the card: the summary from tensors on the card equals the CPU's
    (integers exactly; floats too, since both sum exactly in int64), and
    two card runs are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in SEEDS:
        args, tenants, _ = _kernel_args(seed)
        cpu = tcap._capacity_kernel(*(torch.from_numpy(np.asarray(a)) for a in args),
                                    tenants=tenants)
        runs = [tcap._capacity_kernel(*(torch.from_numpy(np.asarray(a)).cuda() for a in args),
                                      tenants=tenants) for _ in range(2)]
        for k in cpu:
            assert torch.equal(runs[0][k].cpu(), cpu[k]), k
            assert torch.equal(runs[1][k].cpu(), runs[0][k].cpu()), k
