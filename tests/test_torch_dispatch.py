"""The batch's dispatch/collect split (``ops.oracle.dispatch_batch`` /
``collect_batch``) on the CPU: the split equals the port's
``execute_batch_host`` and the JAX package's on seeded batches in both mask
modes, with ``BST_SCAN_WAVE`` unset and at 8; pending batches collected out
of order keep their own results; the in-flight count returns to 0; the
holder's resident tensors pass through. Every output is an integer or a
flag: comparisons are exact. One case needs the card (the blob's host copy
is pinned) and skips elsewhere."""

import numpy as np
import pytest
import torch

try:
    from batch_scheduler_tpu.ops import oracle as jax_oracle
except ImportError:  # a GPU machine without JAX
    jax_oracle = None
from batch_scheduler_tpu_torch.ops import oracle as port_oracle
from batch_scheduler_tpu_torch.ops.bucketing import pad_oracle_batch
from batch_scheduler_tpu_torch.ops.device_state import DeviceStateHolder

HOST_KEYS = ("placed", "gang_feasible", "progress", "best", "best_exists",
             "assignment_nodes", "assignment_counts")
WAVE_TELEMETRY = ("wave_width", "waves_per_batch", "wave_demotions", "wave_uniform")


def _batch(seed, per_group, n=40, g=12, r=5):
    """A seeded padded batch (node bucket 64, gang bucket 16): a few
    saturated nodes, a zero-demand gang and, per group, a random fit mask."""
    rng = np.random.default_rng(seed)
    alloc = rng.integers(20, 60, size=(n, r)).astype(np.int32)
    requested = (alloc * rng.random((n, r)) * 0.5).astype(np.int32)
    requested[: n // 8] = alloc[: n // 8]
    group_req = rng.integers(1, 8, size=(g, r)).astype(np.int32)
    group_req[0] = 0
    remaining = rng.integers(5, 40, size=g).astype(np.int32)
    fit = rng.random((g, n)) < 0.7 if per_group else np.ones((1, n), bool)
    return pad_oracle_batch(
        alloc=alloc, requested=requested, group_req=group_req, remaining=remaining,
        fit_mask=fit, group_valid=np.ones(g, bool), order=rng.permutation(g),
        min_member=remaining + 1, scheduled=np.ones(g, np.int32),
        matched=rng.integers(0, 2, size=g).astype(np.int32),
        ineligible=rng.random(g) < 0.2, creation_rank=rng.permutation(g),
    )


def _assert_same(got, want):
    (host, dev), (ref_host, ref_dev) = got, want
    for k in HOST_KEYS:
        a, b = np.asarray(host[k]), np.asarray(ref_host[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in WAVE_TELEMETRY:
        assert host["telemetry"].get(k) == ref_host["telemetry"].get(k), k
    for k in ("capacity", "scores"):
        a = dev[k].cpu().numpy() if isinstance(dev[k], torch.Tensor) else np.asarray(dev[k])
        b = ref_dev[k].cpu().numpy() if isinstance(ref_dev[k], torch.Tensor) \
            else np.asarray(ref_dev[k])
        np.testing.assert_array_equal(a, b, err_msg=k)


CASES = [(mode, wave) for mode in ("broadcast", "per_group") for wave in (None, "8")]


@pytest.mark.parametrize("mode,wave", CASES, ids=[f"{m}-w{w or 'unset'}" for m, w in CASES])
def test_split_matches_execute_and_reference(mode, wave, monkeypatch):
    if wave is None:
        monkeypatch.delenv("BST_SCAN_WAVE", raising=False)
    else:
        monkeypatch.setenv("BST_SCAN_WAVE", wave)
    batch_args, progress_args = _batch(1, mode == "per_group")
    split = port_oracle.collect_batch(
        port_oracle.dispatch_batch(batch_args, progress_args, device="cpu"))
    whole = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu")
    _assert_same(split, whole)
    if jax_oracle is not None:
        _assert_same(split, jax_oracle.execute_batch_host(batch_args, progress_args))
    assert split[0]["telemetry"] == whole[0]["telemetry"]
    assert split[0]["telemetry"]["mask_mode"] == mode
    assert 0 < split[0]["placed"].sum() < 12


def test_pending_batches_collected_in_reverse_order():
    """Two batches in flight at once, collected newest first: each gets its
    own results, and the in-flight count follows them back. (Counts are
    taken against the process's count at the start: it is process-wide.)"""
    base = port_oracle.inflight_batches()
    inputs = [_batch(2, False), _batch(3, True)]
    pending = [port_oracle.dispatch_batch(b, p, device="cpu") for b, p in inputs]
    assert port_oracle.inflight_batches() == base + 2
    got = [None, None]
    got[1] = port_oracle.collect_batch(pending[1])
    assert port_oracle.inflight_batches() == base + 1
    got[0] = port_oracle.collect_batch(pending[0])
    assert port_oracle.inflight_batches() == base
    for (b, p), out in zip(inputs, got):
        _assert_same(out, port_oracle.execute_batch_host(b, p, device="cpu"))
    assert not np.array_equal(got[0][0]["assignment_nodes"], got[1][0]["assignment_nodes"])
    assert port_oracle.inflight_batches() == base


def test_inflight_count_returns_to_zero_when_collect_fails():
    batch_args, progress_args = _batch(4, False)
    base = port_oracle.inflight_batches()
    pending = port_oracle.dispatch_batch(batch_args, progress_args, device="cpu")
    assert port_oracle.inflight_batches() == base + 1
    pending.blob = None  # a blob that cannot be read
    with pytest.raises(AttributeError):
        port_oracle.collect_batch(pending)
    assert port_oracle.inflight_batches() == base


def test_resident_tensors_pass_through_dispatch():
    """The holder's resident alloc/requested/group_req tensors go through
    dispatch_batch as they are and give the numpy batch's results."""
    batch_args, progress_args = _batch(5, True)
    holder = DeviceStateHolder("cpu")
    resident = holder.keyframe(batch_args, 0, "first")
    assert all(isinstance(a, torch.Tensor) for a in resident[:3])
    pending = port_oracle.dispatch_batch(resident, progress_args, device="cpu")
    assert pending.done is None  # the CPU batch is finished at dispatch
    _assert_same(port_oracle.collect_batch(pending),
                 port_oracle.execute_batch_host(batch_args, progress_args, device="cpu"))


@pytest.mark.cuda
def test_collected_blob_is_pinned_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    batch_args, progress_args = _batch(6, True)
    base = port_oracle.inflight_batches()
    pending = port_oracle.dispatch_batch(batch_args, progress_args, device="cuda")
    assert pending.blob.device.type == "cpu" and pending.blob.is_pinned()
    assert isinstance(pending.done, torch.cuda.Event)
    got = port_oracle.collect_batch(pending)
    _assert_same(got, port_oracle.execute_batch_host(batch_args, progress_args, device="cpu"))
    assert got[0]["telemetry"]["scan"] == "cuda_kernel"
    assert port_oracle.inflight_batches() == base
