"""The knobs the port keeps at one value, held against the JAX package's
defaults on the CPU: ``left_resources`` (the reference's reserve percent
at its default 1/1; ``tests/test_oracle.py``'s inputs and seeded ones,
exact integers), ``ChurnRescorer.warm`` (the same bucket shapes seen as
the reference's ``with_selectors=False, max_remaining=16``),
``probe_link_depth`` (the same ticks and depth as the reference's
``probe_width=8, samples=5, cap=4``) and ``TickPipeline.drain`` (drained
ticks left out of the stats series, the reference's
``record_stats=False``). Nothing in either package passes another value."""

import inspect
import time

import numpy as np
import pytest
import torch

from batch_scheduler_tpu.ops import oracle as jax_oracle
from batch_scheduler_tpu.ops import rescore as jax_rescore
from batch_scheduler_tpu.sim.scenarios import make_sim_node as jax_node
from batch_scheduler_tpu_torch.ops import oracle as port_oracle
from batch_scheduler_tpu_torch.ops import rescore as port_rescore
from batch_scheduler_tpu_torch.ops.snapshot import GroupDemand as PortDemand
from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node as port_node


def _defaults(fn, *names):
    params = inspect.signature(fn).parameters
    return tuple(params[n].default for n in names)


def test_left_resources_at_the_reference_default():
    """test_oracle.py's inputs: the port's one value is the reference's 1/1."""
    assert _defaults(jax_oracle.left_resources, "percent_num", "percent_den") == (1, 1)
    assert list(inspect.signature(port_oracle.left_resources).parameters) == [
        "alloc", "requested"]
    alloc = np.array([[8000, 1000000, 0, 100]], dtype=np.int32)
    req = np.array([[900, 0, 0, 1]], dtype=np.int32)
    port = port_oracle.left_resources(torch.from_numpy(alloc), torch.from_numpy(req))
    ref = np.asarray(jax_oracle.left_resources(alloc, req))
    assert port.tolist() == ref.tolist() == [[7100, 1000000, 0, 99]]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_left_resources_equals_reference(seed):
    rng = np.random.default_rng(seed)
    alloc = rng.integers(0, 2**30, size=(64, 5)).astype(np.int32)
    req = rng.integers(0, 2**20, size=(64, 5)).astype(np.int32)
    port = port_oracle.left_resources(torch.from_numpy(alloc), torch.from_numpy(req))
    ref = np.asarray(jax_oracle.left_resources(alloc, req))
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref)


NODES = [(f"n{i}", {"cpu": "8", "memory": "32Gi", "pods": "110"}) for i in range(6)]


@pytest.mark.parametrize("buckets", [[8], [8, 16], [8, 16, 32]])
def test_warm_equals_reference_default(buckets):
    """The port's warm visits the bucket shapes the reference's does with
    its defaults: the broadcast mask only, the same readback tier."""
    assert _defaults(jax_rescore.ChurnRescorer.warm, "with_selectors", "max_remaining") == (
        False, port_rescore._WARM_MAX_REMAINING)
    ref = jax_rescore.ChurnRescorer([jax_node(n, s) for n, s in NODES])
    port = port_rescore.ChurnRescorer([port_node(n, s) for n, s in NODES], device="cpu")
    for r in (ref, port):
        r.warm(buckets)
    keys = ("bucket_shapes", "recompiles", "ticks")
    assert {k: port.summary()[k] for k in keys} == {k: ref.summary()[k] for k in keys}
    assert port.summary()["recompiles"] == len(buckets)


class _TimedRescorer:
    """A rescorer whose tick takes a fixed time: what the probe reads."""

    def __init__(self, seconds):
        self.seconds, self.widths, self.dropped = seconds, [], 0

    def tick(self, _cluster, groups):
        self.widths.append(len(groups))
        time.sleep(self.seconds)

    def drop_last_stats(self):
        self.dropped += 1


@pytest.mark.parametrize("interval", [0.004, 0.05], ids=["capped", "depth1"])
def test_probe_link_depth_equals_reference_default(interval):
    assert _defaults(jax_rescore.probe_link_depth, "probe_width", "samples", "cap") == (
        port_rescore._PROBE_WIDTH, port_rescore._PROBE_SAMPLES, port_rescore._MAX_DEPTH)
    got = []
    for mod in (jax_rescore, port_rescore):
        r = _TimedRescorer(0.02)
        depth, rtt = mod.probe_link_depth(r, interval)
        got.append((depth, r.widths, r.dropped, rtt >= 0.02))
    assert got[0] == got[1]
    depth = port_rescore._MAX_DEPTH if interval < 0.01 else 1
    assert got[1] == (depth, [8] * 5, 5, True)


def test_drain_unrecords_as_the_reference_default():
    assert _defaults(jax_rescore.TickPipeline.drain, "record_stats") == (False,)
    r = port_rescore.ChurnRescorer([port_node(n, s) for n, s in NODES], device="cpu")
    r.warm([8])
    gangs = [PortDemand(full_name=f"default/d{i}", min_member=1,
                        member_request={"cpu": 1000}, creation_ts=float(i), has_pod=True)
             for i in range(4)]
    with port_rescore.TickPipeline(r, 2) as pipe:
        pipe.submit(gangs)
        pipe.submit(gangs)
        pipe.drain()
    assert len(r.latencies) == 0
