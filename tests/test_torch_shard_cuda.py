"""The two node-sharded wave kernels on the card (``csrc/shard_wave.cu``,
``csrc/shard_topk.cu``) against their plain versions, bit for bit: every
rank's summary and apply through the wrappers, on CUDA tensors (the kernels)
and on CPU copies (``ops/oracle.py``'s plain steps), for every mode at S =
1, 2 and 4, node blocks from one cluster block to sixteen (and not a
multiple of the block count), waves of 1 to 32 gangs (each of the kernels'
instantiations), both mask modes, ties at the threshold bucket, and for
the top-K kernel K from 1 to 128 with sentinels and a dense-column replay.
It needs the card and skips without one; the CPU tests hold the plain
steps to the JAX package (``tests/test_torch_sharded_*.py``) and the
kernels' decomposition to both (``tests/test_torch_shard_design.py``)."""

import numpy as np
import pytest
import torch

from batch_scheduler_tpu_torch.ops import oracle
from batch_scheduler_tpu_torch.ops.assign_scan import (
    shard_apply_cuda, shard_summary_cuda, shard_topk_apply_cuda, shard_topk_summary_cuda)


def _blocks(rng, s, nl, w, r, per_group, ties, tight=False):
    n = s * nl - int(rng.integers(0, nl // 3 + 1))
    left = rng.integers(0, 6 if ties else 3000, size=(n, r)).astype(np.int32)
    req = rng.integers(0, 4 if ties else 40, size=(w, r)).astype(np.int32)
    req[:, 0] = np.maximum(req[:, 0], 1)
    needs = rng.integers(0, 3 * nl if ties else 200, size=w).astype(np.int32)
    if tight:  # one member a node, more wanted than any K candidates hold
        left[:] = 5
        req[:] = 5
        needs[:] = 24
    mask = rng.random((w if per_group else 1, n)) < 0.8
    out = []
    for rank in range(s):
        lo, hi = min(rank * nl, n), min(rank * nl + nl, n)
        bl = np.zeros((nl, r), np.int32)
        bl[:hi - lo] = left[lo:hi]
        ml = np.zeros((mask.shape[0], nl), bool)
        ml[:, :hi - lo] = mask[:, lo:hi]
        out.append((torch.from_numpy(bl), torch.from_numpy(ml)))
    return out, torch.from_numpy(req), torch.from_numpy(needs)


def _wave_step(mode, blocks, req, needs, dev):
    """Every rank's summary (merged by a sum), then every rank's apply, on
    ``dev``: all outputs, moved to the CPU."""
    s, (nl, _) = len(blocks), blocks[0][0].shape
    w = needs.shape[0]
    k = w if mode == oracle.SHARD_SPECULATIVE else 1
    clip = needs if k == w else needs.sum(dtype=torch.int32).view(1)
    caps, hists = [], []
    for rank, (bl, ml) in enumerate(blocks):
        h = torch.full((s, k, 128), -7, dtype=torch.int32, device=dev)
        caps.append(shard_summary_cuda(bl.to(dev), req[:k].to(dev), clip.to(dev),
                                       ml[:k].contiguous().to(dev), h, rank))
        hists.append(h)
    merged = torch.stack(hists).sum(0, dtype=torch.int32)
    outs = [*caps, merged]
    for rank, (bl, ml) in enumerate(blocks):
        takes = torch.full((w, nl), -7, dtype=torch.int32, device=dev)
        feas = torch.zeros(w, dtype=torch.bool, device=dev)
        left_out = torch.full_like(bl, -7).to(dev)
        verify = (None if mode == oracle.SHARD_REPLAY else
                  torch.full((w if k == 1 else 1,), -7, dtype=torch.int32, device=dev))
        shard_apply_cuda(mode, merged, rank, caps[rank], needs.to(dev), bl.to(dev), req.to(dev),
                         ml.to(dev), takes, feas, left_out, verify)
        outs += [takes, feas, left_out] + ([verify] if verify is not None else [])
    return [o.cpu() for o in outs]


def _topk_step(mode, blocks, req, needs, k, dev):
    s, (nl, _) = len(blocks), blocks[0][0].shape
    rows = needs.shape[0] if mode == oracle.TOPK_SPECULATIVE else 1
    if mode == oracle.TOPK_REPLAY:
        needs = needs[:1]
    w = needs.shape[0]
    kk_l, _ = oracle.shard_topk_widths(k, nl, s)
    p = oracle.shard_topk_payload(mode, kk_l, w)
    caps, bufs = [], []
    for rank, (bl, ml) in enumerate(blocks):
        b = torch.full((s, rows, p), -7, dtype=torch.int32, device=dev)
        caps.append(shard_topk_summary_cuda(mode, bl.to(dev), req[:rows].to(dev), needs.to(dev),
                                            ml[:rows].contiguous().to(dev), b, rank, k))
        bufs.append(b)
    merged = torch.stack(bufs).sum(0, dtype=torch.int32)
    outs = [*caps, merged]
    for rank, (bl, ml) in enumerate(blocks):
        takes = torch.full((w, nl), -7, dtype=torch.int32, device=dev)
        feas = torch.zeros(w, dtype=torch.bool, device=dev)
        left_out = torch.full_like(bl, -7).to(dev)
        verify = (None if mode == oracle.TOPK_REPLAY else
                  torch.full((1,), -7, dtype=torch.int32, device=dev))
        dense = torch.zeros(1, dtype=torch.int32, device=dev)
        shard_topk_apply_cuda(mode, merged, rank, caps[rank], needs.to(dev), bl.to(dev),
                              req[:rows].to(dev), ml[:rows].contiguous().to(dev), takes, feas,
                              left_out, verify, dense, k)
        outs += [takes, feas, left_out, dense] + ([verify] if verify is not None else [])
    return [o.cpu() for o in outs]


CASES = [  # (S, nl, W, lanes, per-group mask, ties)
    (1, 200, 2, 3, False, False), (2, 700, 8, 5, False, True), (4, 2048, 8, 5, True, False),
    (2, 4096, 16, 4, True, True), (1, 9000, 32, 6, False, True), (2, 65536, 8, 6, False, False),
    (4, 1251, 5, 11, True, True),
]


@pytest.mark.cuda
def test_shard_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(21)
    for s, nl, w, r, per_group, ties in CASES:
        for mode in (oracle.SHARD_SPECULATIVE, oracle.SHARD_MEGA, oracle.SHARD_REPLAY):
            ww = 1 if mode == oracle.SHARD_REPLAY else w
            blocks, req, needs = _blocks(rng, s, nl, ww, r, per_group, ties)
            if mode == oracle.SHARD_MEGA:
                req[:] = req[0]
            got = _wave_step(mode, blocks, req, needs, "cuda")
            want = _wave_step(mode, blocks, req, needs, "cpu")
            for a, b in zip(got, want):
                assert torch.equal(a, b), ("shard_wave", mode, s, nl, w)
        for k in (1, 16, 128):
            for mode in (oracle.TOPK_SPECULATIVE, oracle.TOPK_MEGA, oracle.TOPK_REPLAY):
                blocks, req, needs = _blocks(rng, s, nl, w, r, per_group, ties,
                                             tight=mode == oracle.TOPK_REPLAY and k == 16)
                if mode == oracle.TOPK_MEGA:
                    req[:] = req[0]
                got = _topk_step(mode, blocks, req, needs, k, "cuda")
                want = _topk_step(mode, blocks, req, needs, k, "cpu")
                for a, b in zip(got, want):
                    assert torch.equal(a, b), ("shard_topk", mode, s, nl, w, k)
