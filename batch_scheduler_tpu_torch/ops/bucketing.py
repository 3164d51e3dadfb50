"""Shape bucketing: pad dynamic node/group counts to a small set of shapes,
and warm the shapes next to the one being served.

Buckets are powers of two (smallest 8), so a cluster whose node count
drifts between 4,997 and 5,003 packs to one shape. The padding rules are
the reference's (``batch_scheduler_tpu/ops/bucketing.py``), so both
packages produce the same padded batch from the same cluster.

``CompileWarmer`` is the counterpart of the reference's bucket precompiler.
The port compiles nothing per shape (``ops._build`` builds one library per
kernel source), so what is cold at a new bucket is the first-use work of
``ops.oracle``'s batch path at that shape: CUDA's lazy load of the kernel
instantiation the bucket's plan picks, the plan's ``lru_cache``d queries
(``scan_plan``: the card's cluster occupancy) and the shared-memory
attribute the launch sets, and the caching allocator's first blocks at the
bucket's sizes. The warmer runs one real batch at each adjacent bucket on
its own stream. That takes the first three off a later transition, not
the fourth: the caching allocator reuses a block only on the stream that
allocated it, so the serving stream's pool stays cold. Warming on the
serving stream instead would queue the warm batches ahead of served ones.

What it is worth on the card is in ``PERF.md`` section 6, from
``chip_smoke.py``'s ``warmer`` phase (fresh processes at the north star,
grown past one N bucket): at a bucket transition inside a running process
the in-process warmer showed no gain, and its batches, running beside the
served ones, made the next served batches slower. What is cold is a
process's first batch (the libraries' load and CUDA's start), which only
``warmth_snapshot`` / ``replicate`` into a standby, or ``serve --warmup``,
can reach.
"""

from __future__ import annotations

import sys
import threading
from typing import Optional

import numpy as np

from .lanes import LANE_MAX

__all__ = ["bucket_size", "wave_width_bucket", "topk_bucket", "pad_to", "pad_rows",
           "pad_oracle_batch", "adjacent_bucket_shapes", "CompileWarmer",
           "maybe_compile_warmer"]

_MIN_BUCKET = 8

# Widths the wavefront assignment scan runs at: powers of two between 2
# and 32. Below 2 the wave is the serial scan; 32 is one gang per warp of
# the CUDA kernel's per-wave selection and the reference's upper bound.
_WAVE_MIN, _WAVE_MAX = 2, 32

# Candidate widths the hierarchical top-K scan runs at (``BST_SCAN_TOPK``):
# powers of two between 4 and 128. 128 is ASSIGNMENT_TOP_K, the widest span
# a gang's compact readback reports, and the CUDA kernel's largest slice.
_TOPK_MIN, _TOPK_MAX = 4, 128


def bucket_size(n: int) -> int:
    """Smallest power-of-two bucket >= n (>= 8)."""
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def wave_width_bucket(w: int) -> int:
    """Wave width of the wavefront assignment scan for a requested ``w``
    (the ``BST_SCAN_WAVE`` knob): 0 or 1 means the serial scan and maps
    to 0; anything else rounds up to a power of two in [2, 32]."""
    if w <= 1:
        return 0
    b = _WAVE_MIN
    while b < w and b < _WAVE_MAX:
        b <<= 1
    return b


def topk_bucket(k: int) -> int:
    """Candidate width of the hierarchical top-K scan for a requested ``k``
    (the ``BST_SCAN_TOPK`` knob): 0 or less means the rung is off and maps
    to 0; anything else rounds up to a power of two in [4, 128]."""
    if k <= 0:
        return 0
    b = _TOPK_MIN
    while b < k and b < _TOPK_MAX:
        b <<= 1
    return b


def pad_to(arr: np.ndarray, size: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad ``arr`` along ``axis`` to ``size`` with ``fill``."""
    pad = size - arr.shape[axis]
    if pad < 0:
        raise ValueError(f"array dim {arr.shape[axis]} exceeds bucket {size}")
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def pad_rows(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    return pad_to(arr, size, axis=0, fill=fill)


def pad_oracle_batch(
    alloc,
    requested,
    group_req,
    remaining,
    fit_mask,
    group_valid,
    order,
    min_member,
    scheduled,
    matched,
    ineligible,
    creation_rank,
    min_buckets=(0, 0),
):
    """Bucket-pad one oracle batch with the canonical sentinel fills.

    - padded groups: zero demand, invalid, ineligible for max-progress
      selection, last in creation rank, appended at the tail of the scan
      order (remaining == 0, so they place nothing);
    - padded nodes: zero lanes (capacity 0), masked out of every fit row.

    A broadcast ``[1,N]`` fit mask keeps its single row: padded groups are
    already neutralised by zero demand + group_valid=False, and padded
    nodes by the axis-1 False fill.

    ``min_buckets=(G, N)`` sets floor bucket sizes.

    Returns ``(batch_args, progress_args)`` ready for
    ``ops.oracle.execute_batch_host``.
    """
    from .oracle import GANG_MAX

    n = alloc.shape[0]
    g = group_req.shape[0]
    nb = max(bucket_size(max(n, 1)), min_buckets[1])
    gb = max(bucket_size(max(g, 1)), min_buckets[0])
    # Enforce the member-capacity division domain (ops.lanes.LANE_MAX) at
    # the batch boundary: out-of-domain lanes would be silently clamped by
    # the oracle, not rejected.
    for name, arr in (("alloc", alloc), ("requested", requested),
                      ("group_req", group_req)):
        a = np.asarray(arr)
        if a.size and (np.abs(a.astype(np.int64)) > int(LANE_MAX)).any():
            raise OverflowError(
                f"{name} lanes exceed LANE_MAX (2**30): max abs "
                f"{int(np.abs(a.astype(np.int64)).max())}"
            )
    # The assignment scan and gang_feasible accumulate need-clipped
    # capacities over the node bucket in int32; sum <= need * nb, so the
    # admissible gang size shrinks with the node bucket: need * nb must stay
    # strictly below 2**31.
    gang_bound = min(GANG_MAX, (2**31 - 1) // nb)
    for name, arr, bound in (
        ("remaining", remaining, gang_bound),
        ("min_member", min_member, GANG_MAX),
        ("scheduled", scheduled, GANG_MAX),
        ("matched", matched, GANG_MAX),
    ):
        a = np.asarray(arr)
        if a.size and (np.abs(a.astype(np.int64)) > bound).any():
            raise OverflowError(
                f"{name} exceeds the gang bound ({bound} members at node "
                f"bucket {nb}): max abs {int(np.abs(a.astype(np.int64)).max())}"
            )
    batch_args = (
        pad_rows(np.asarray(alloc, dtype=np.int32), nb),
        pad_rows(np.asarray(requested, dtype=np.int32), nb),
        pad_rows(np.asarray(group_req, dtype=np.int32), gb),
        pad_rows(np.asarray(remaining, dtype=np.int32), gb),
        pad_to(
            np.asarray(fit_mask, dtype=bool)
            if np.asarray(fit_mask).shape[0] == 1
            else pad_rows(np.asarray(fit_mask, dtype=bool), gb, fill=False),
            nb,
            axis=1,
            fill=False,
        ),
        pad_rows(np.asarray(group_valid, dtype=bool), gb, fill=False),
        np.concatenate(
            [np.asarray(order, dtype=np.int32), np.arange(g, gb, dtype=np.int32)]
        ),
    )
    progress_args = (
        pad_rows(np.asarray(min_member, dtype=np.int32), gb),
        pad_rows(np.asarray(scheduled, dtype=np.int32), gb),
        pad_rows(np.asarray(matched, dtype=np.int32), gb),
        pad_rows(np.asarray(ineligible, dtype=bool), gb, fill=True),
        pad_rows(np.asarray(creation_rank, dtype=np.int32), gb, fill=gb - 1),
    )
    return batch_args, progress_args


def adjacent_bucket_shapes(g_bucket: int, n_bucket: int) -> list:
    """The (G, N) bucket shapes one transition away from the current
    working set: what the warmer warms. One dimension moves at a time (a
    cluster crosses one bucket boundary per transition; the cross product
    would quadruple the warm cost for shapes two transitions out)."""
    shapes = []
    for gb in (g_bucket // 2, g_bucket * 2):
        if gb >= _MIN_BUCKET:
            shapes.append((gb, n_bucket))
    for nb in (n_bucket // 2, n_bucket * 2):
        if nb >= _MIN_BUCKET:
            shapes.append((g_bucket, nb))
    return shapes


def _resize_rows(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    if arr.shape[0] >= size:
        return np.ascontiguousarray(arr[:size])
    return pad_to(arr, size, axis=0, fill=fill)


def _host_array(a) -> np.ndarray:
    """An owned host copy of a batch argument (numpy, or a tensor on any
    device)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy().copy()
    return np.array(a)


class CompileWarmer:
    """Background warmer for the bucket shapes adjacent to the serving
    working set, with the reference's interface, counters and rules.

    For each shape it is shown (``note_batch``), a daemon thread runs one
    batch at each adjacent ``(G, N)`` bucket at the served batch's wave
    width and mask mode, through ``ops.oracle``'s own batch path on
    ``device``, on a stream of its own. Warm batches are built from the
    REAL padded prototype (a pad or slice of the last served batch's
    arguments), so the launch plan, the readback tier and the mask mode
    match what serving traffic at that bucket would run. They launch the
    same kernels as served batches and are counted like them. Policy
    batches are not warmed (a warm batch carries no policy columns).

    Hit/miss accounting (``note_batch``): a served batch whose telemetry
    says ``compiled`` (the first batch of this process at its shape key,
    ``ops.oracle``) is a warmer **miss**; the first batch at a shape this
    warmer had warmed is a **hit**. Batches on steady shapes count as
    neither.
    """

    def __init__(self, device="cuda", registry=None):
        import queue

        from ..utils.metrics import DEFAULT_REGISTRY
        from .convert import device_stream, resolve_device

        self.device = resolve_device(device)
        self.stream = device_stream(self.device)
        self._q = queue.SimpleQueue()
        self._state_lock = threading.Lock()
        self._warmed: set = set()  # shapes THIS warmer ran; guarded-by: _state_lock
        self._seen: set = set()    # shapes serving traffic already ran; guarded-by: _state_lock
        self._failed: set = set()  # guarded-by: _state_lock
        self._last_key = None  # guarded-by: _state_lock
        # recent observed-shape prototypes, key -> proto (insertion-ordered,
        # bounded): the warmth-replication feed a standby sidecar warms
        # from; guarded-by: _state_lock
        self._protos: dict = {}
        # one-way flag with a single writer (stop()), read lock-free so the
        # worker sees it between warm batches
        self._stopped = False
        reg = registry or DEFAULT_REGISTRY
        self._hits = reg.counter(
            "bst_compile_warmer_hits_total",
            "Serving batches whose bucket shape the compile warmer had "
            "precompiled (cold compile absorbed off the serving path)",
        )
        self._misses = reg.counter(
            "bst_compile_warmer_misses_total",
            "Serving batches that built a new executable on the serving "
            "path (shape not precompiled in time)",
        )
        self._warms = reg.counter(
            "bst_compile_warmer_precompiles_total",
            "Bucket shapes precompiled by the warmer thread",
        )
        self._thread = threading.Thread(
            target=self._loop, name="compile-warmer", daemon=True
        )
        self._thread.start()

    @staticmethod
    def _key(g_bucket: int, n_bucket: int, lanes: int, mask_rows: int,
             wave: int) -> tuple:
        # the reference's key also carries its donate flag; the port
        # donates nothing
        return (g_bucket, n_bucket, lanes, mask_rows > 1, wave)

    def warmed_shapes(self) -> set:
        with self._state_lock:
            return set(self._warmed)

    def stats(self) -> dict:
        with self._state_lock:
            warmed = len(self._warmed)
        return {
            "warmer_hits": int(self._hits.value()),
            "warmer_misses": int(self._misses.value()),
            "warmer_shapes": warmed,
        }

    def note_batch(self, batch_args, progress_args, telemetry: dict) -> None:
        """Account one served batch against the warm set and (on a shape
        change) queue its adjacent shapes for warming. ``batch_args`` are
        the padded args the batch ran (host arrays, or tensors, which are
        copied to the host only on a shape change)."""
        telemetry = telemetry or {}
        g_bucket = int(np.shape(batch_args[2])[0])
        n_bucket = int(np.shape(batch_args[0])[0])
        lanes = int(np.shape(batch_args[0])[1])
        mask_rows = int(np.shape(batch_args[4])[0])
        wave = int(telemetry.get("wave_width", 0))
        key = self._key(g_bucket, n_bucket, lanes, mask_rows, wave)
        with self._state_lock:
            in_warmed = key in self._warmed
            is_new = key != self._last_key
            self._last_key = key
            # the served shape is warm now by definition: recorded so an
            # A->B->A oscillation never re-warms A, but kept out of
            # _warmed: steady batches are not warmer hits
            self._seen.add(key)
        if telemetry.get("compiled"):
            self._misses.inc()
        elif in_warmed and is_new:
            # a bucket TRANSITION landing on a shape the warmer ran
            self._hits.inc()
        if is_new and not self._stopped and not telemetry.get("scan_policy"):
            # snapshot the prototype: the caller keeps mutating its arrays
            proto = (
                tuple(_host_array(a) for a in batch_args),
                tuple(_host_array(a) for a in progress_args),
                wave,
                int(telemetry.get("scan_topk", 0)),
            )
            with self._state_lock:
                self._protos[key] = proto
                while len(self._protos) > 16:  # bounded replication feed
                    self._protos.pop(next(iter(self._protos)))
            self._q.put(proto + (False,))

    def warmth_snapshot(self) -> list:
        """The retained observed-shape prototypes, oldest first: feed them
        to a standby's :meth:`replicate` so its first batches after a
        promotion find the primary's shapes warm."""
        with self._state_lock:
            return list(self._protos.values())

    def replicate(self, protos) -> int:
        """Queue another warmer's :meth:`warmth_snapshot` for warming,
        INCLUDING each prototype's own shape, not just its adjacents: the
        standby has served no traffic, so the primary's steady shapes are
        exactly the cold first batches a promotion would otherwise pay.
        Replicated shapes land in the warm set, so the first batch after a
        failover at one counts as a warmer hit. Returns the number of
        prototypes enqueued."""
        n = 0
        for proto in protos or []:
            if self._stopped:
                break
            batch_args, progress_args, wave, topk = proto[:4]
            self._q.put((batch_args, progress_args, wave, topk, True))
            n += 1
        return n

    def stop(self, timeout: float = 60.0) -> bool:
        """Stop the warmer and join its thread (before the process tears
        the device down, as ``OracleScorer.drain_background`` does)."""
        self._stopped = True
        self._q.put(None)
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- worker -------------------------------------------------------------

    def _variant(self, batch_args, progress_args, gb: int, nb: int):
        (alloc, requested, group_req, remaining, fit_mask, group_valid,
         order) = batch_args
        min_member, scheduled, matched, ineligible, creation_rank = (
            progress_args
        )
        v_mask = fit_mask
        if v_mask.shape[0] > 1:
            v_mask = _resize_rows(v_mask, gb, fill=False)
        if v_mask.shape[1] != nb:
            if v_mask.shape[1] >= nb:
                v_mask = np.ascontiguousarray(v_mask[:, :nb])
            else:
                v_mask = pad_to(v_mask, nb, axis=1, fill=False)
        vbatch = (
            _resize_rows(alloc, nb),
            _resize_rows(requested, nb),
            _resize_rows(group_req, gb),
            _resize_rows(remaining, gb),
            v_mask,
            _resize_rows(group_valid, gb, fill=False),
            # any permutation runs the same kernels; arange keeps the
            # variant a valid batch on every resize
            np.arange(gb, dtype=np.int32),
        )
        vprogress = (
            _resize_rows(min_member, gb),
            _resize_rows(scheduled, gb),
            _resize_rows(matched, gb),
            _resize_rows(ineligible, gb, fill=True),
            np.arange(gb, dtype=np.int32),
        )
        return vbatch, vprogress

    def _warm_one(self, vbatch, vprogress, wave: int, topk: int) -> None:
        from .oracle import collect_batch, dispatch_batch, forced_scan_rung

        with forced_scan_rung(wave, topk):
            collect_batch(dispatch_batch(vbatch, vprogress, device=self.device))

    def _loop(self) -> None:
        import torch

        with torch.cuda.stream(self.stream):
            self._serve()

    def _serve(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            batch_args, progress_args, wave, topk, warm_self = item
            g_bucket = int(batch_args[2].shape[0])
            n_bucket = int(batch_args[0].shape[0])
            lanes = int(batch_args[0].shape[1])
            mask_rows = int(batch_args[4].shape[0])
            # replicated prototypes (warm_self) warm their OWN shape first,
            # then the adjacents; locally observed shapes were just served
            # and warm adjacents only
            shapes = (
                [(g_bucket, n_bucket)] if warm_self else []
            ) + list(adjacent_bucket_shapes(g_bucket, n_bucket))
            for gb, nb in shapes:
                key = self._key(gb, nb, lanes, mask_rows, wave)
                with self._state_lock:
                    if (
                        key in self._warmed
                        or key in self._seen
                        or key in self._failed
                    ):
                        continue
                if self._stopped:
                    return
                try:
                    vbatch, vprogress = self._variant(
                        batch_args, progress_args, gb, nb
                    )
                    self._warm_one(vbatch, vprogress, wave, topk)
                except Exception as e:  # noqa: BLE001 — warm-only, never fatal
                    print(
                        f"compile warmer: shape (G={gb}, N={nb}) failed "
                        f"({e!r}); not retried",
                        file=sys.stderr,
                    )
                    with self._state_lock:
                        self._failed.add(key)
                    continue
                with self._state_lock:
                    self._warmed.add(key)
                self._warms.inc()


def maybe_compile_warmer(device="cuda", scan_mesh=None) -> Optional[CompileWarmer]:
    """A CompileWarmer when warm batches are safe: single device only, the
    reference's one eligibility rule, shared by the sidecar server and the
    in-process scorer. The port has no mesh (ROADMAP item 11); a mesh
    passed here gets the reference's skip and None."""
    if scan_mesh is None:
        return CompileWarmer(device=device)
    print(
        "compile warmer skipped: sharded-mesh warm batches would "
        "stall live batches behind the warm compile",
        file=sys.stderr,
    )
    return None
