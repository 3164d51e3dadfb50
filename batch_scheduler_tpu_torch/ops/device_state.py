"""Device-resident cluster state: churned-row scatters instead of uploads.

The scorer's refresh used to upload every packed array per batch. This
module keeps the packed ``[N, R]`` / ``[G, R]`` lane buffers RESIDENT on
the port's device across batches and applies each refresh's churned rows
(``ops.snapshot.SnapshotDelta``) as one row scatter (``index_copy``) per
buffer; with the snapshot-lite capture it also keeps the queue-order sort
keys resident and derives the fit row and the queue order on the device. With the policy
engine on it also keeps the node policy columns (label hashes, spread
domain) resident and scatters the rows whose labels changed
(``sync_policy_cols``).
What it saves is the whole upload, which grows with the node bucket, for
a few host calls per refresh, which do not: at a few thousand nodes the
two cost about the same, at tens of thousands the upload costs more
(``chip_smoke.py`` ``residency_vs_upload``; figures in PERF.md).

``DeviceStateHolder`` is the state owner; the in-process scorer
(core.oracle_scorer.OracleScorer) syncs it from every
``DeltaSnapshotPacker`` pack under the refresh lock and runs batches from
the resident tensors.

Residency invalidation: any generation gap, node-list change, group-set
change, node churn or bucket change resyncs from a full keyframe, with the
reason counted; a raced ``apply_rows`` that returns None resyncs too.

Ordering: a scatter writes IN PLACE (``index_copy_``). Every upload,
scatter and derive is enqueued on the caller's current stream; the scorer
enters its own stream (``OracleScorer.stream``) around the sync and the
batch, so every scatter is enqueued after the batch that read the rows it
rewrites, on the same stream, and cannot overtake it. Nothing else holds
the resident tensors: a published snapshot keeps its own host arrays.

Forks (the what-if engine's state, core.explain): ``fork`` starts a holder
on its parent's tensors without a copy, and ``apply_batch`` scatters a
counterfactual's changed rows into it. Because a scatter writes in place,
a fork clones a borrowed tensor at its first write (copy-on-write,
``_own``): the parent's values and storage never change through a fork,
and neither do a fork's through its own forks. The reference's forks are
safe without this (jax arrays are immutable) and pin donation off
instead.

The port of ``batch_scheduler_tpu/ops/device_state.py`` on one explicit
``device``, without:

- the mesh and sharding branches (the sharded rungs are not ported);
- the jit row buckets (nothing here compiles per shape; unique delta rows
  keep ``index_copy_`` deterministic on CUDA);
- ``reset`` (no caller of the port drops the state);
- the knobs ``BST_DEVICE_STATE``/``BST_DEVICE_DERIVE``: the holder is
  always on (every scorer syncs one), and the columns are derived
  whenever the snapshot carries meta columns.

A failed scatter or derive raises; nothing falls back to an upload or the
CPU.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.metrics import DEFAULT_REGISTRY
from .convert import resolve_device

__all__ = ["DeviceStateHolder", "derive_columns", "device_state_report", "stage_rows"]

# the resident tensors a fork starts on (the reference's fork shares these)
_FORK_SHARED = ("_alloc", "_requested", "_group_req", "_policy_hash", "_policy_dom")


def stage_rows(idx, rows, device, row_shape) -> tuple:
    """``(index, values)`` on ``device`` for a row scatter into a buffer
    whose rows have shape ``row_shape``: int64 indices and int32 rows,
    uploaded as ONE host byte block, so staging is one copy on the current
    stream (every PyTorch call costs host time, and at a few rows that time
    is the scatter's cost)."""
    k = len(idx)
    rows = np.ascontiguousarray(rows, dtype=np.int32).reshape(k, -1)
    block = np.empty(8 * k + rows.nbytes, np.uint8)
    block[: 8 * k].view(np.int64)[:] = idx
    block[8 * k:].view(np.int32)[:] = rows.ravel()
    staged = torch.from_numpy(block).to(device)
    return (staged[: 8 * k].view(torch.int64),
            staged[8 * k:].view(torch.int32).view((k,) + tuple(row_shape)))


def derive_columns(inv_prio, ts_hi, ts_lo, name_rank, node_valid):
    """THE device-side column derivation: reproduce, from the resident
    queue-order meta columns, exactly what the host precomputes —

    - ``order``: the queue permutation. The host sorts by ``(-priority,
      creation_ts, full_name)``; the meta columns encode that as int32
      keys (``inv_prio = ~priority``; ``(ts_hi, ts_lo)`` the
      order-preserving split of the float64 timestamp,
      ops.snapshot._ts_sort_keys; ``name_rank`` the host's name order).
      torch has no lexsort: stable sorts are chained from the least
      significant key (``name_rank``) to the most (``inv_prio``), each
      gathering through the running permutation. Pad sentinels
      (INT32_MAX / row index) sort strictly after every real row, so the
      full-[Gb] sort equals pad_oracle_batch's padded order column.
    - ``fit``: the uniform-fit broadcast row IS the padded node-valid row
      (bool ``[1, Nb]``; the lite capture stamps meta columns only when
      the uniform fast path held).

    The reference's ``_derive_impl`` (``jnp.lexsort``)."""
    perm = torch.argsort(name_rank, stable=True)
    for key in (ts_lo, ts_hi, inv_prio):
        perm = perm.index_select(
            0, torch.argsort(key.index_select(0, perm), stable=True)
        )
    return node_valid[None, :], perm.to(torch.int32)


# holder registry (the /debug/perf device-state section)
_holders_lock = threading.Lock()
_holders: "weakref.WeakSet" = weakref.WeakSet()  # guarded-by: _holders_lock


def device_state_report() -> list:
    """Per-holder state summary for /debug/perf (utils.profiler): each live
    holder's ``stats()``."""
    with _holders_lock:
        live = list(_holders)
    return [h.stats() for h in live]


class DeviceStateHolder:
    """Owner of one set of device-resident oracle buffers on ``device``.

    Thread contract: every method that touches resident state takes
    ``_lock``; in the scorer the callers already serialize under the
    refresh lock.
    """

    def __init__(self, device="cuda", label: str = "local"):
        self.device = resolve_device(device)
        self.label = label
        self._lock = threading.Lock()
        self.generation = 0  # guarded-by: _lock
        # resident device tensors; None until the first keyframe
        self._alloc = None  # guarded-by: _lock
        self._requested = None  # guarded-by: _lock
        self._group_req = None  # guarded-by: _lock
        self.rows_scattered = 0  # guarded-by: _lock
        self.keyframes: Dict[str, int] = {}  # guarded-by: _lock
        self.deltas_applied = 0  # guarded-by: _lock
        # device-derived columns: the resident queue-order meta columns
        # (inv_prio, ts_hi, ts_lo, name_rank), the padded node-valid row
        # they derive fit from, the (fit, order) derivation cache, and the
        # generation the meta mirrors — None / -1 whenever the synced
        # snapshot carries no meta_cols
        self._meta = None  # guarded-by: _lock
        self._meta_nv = None  # guarded-by: _lock
        self._derived = None  # guarded-by: _lock
        self._meta_gen = -1  # guarded-by: _lock
        self.derived_batches = 0  # guarded-by: _lock
        self.derives = 0  # guarded-by: _lock
        self._last = None  # guarded-by: _lock; the last sync's batch args
        # node-side policy columns: [N,H] label hashes and [N] spread
        # domains; None until a policy pack syncs, and after a keyframe
        self._policy_hash = None  # guarded-by: _lock
        self._policy_dom = None  # guarded-by: _lock
        # a fork (``fork``) starts on its parent's tensors: the names of
        # those it still borrows, each cloned at its first in-place write
        self._forked = False
        self._borrowed: set = set()  # guarded-by: _lock
        with _holders_lock:
            _holders.add(self)

    # -- internals ----------------------------------------------------------

    def _place(self, host) -> torch.Tensor:
        """A fresh device tensor of ``host`` (always a copy, also on the
        CPU: the holder scatters in place, and a published snapshot's
        arrays must never change under it)."""
        return torch.from_numpy(np.ascontiguousarray(host)).to(
            self.device, copy=True
        )

    def _note_keyframe(self, reason: str) -> None:  # lock-held: _lock
        self.keyframes[reason] = self.keyframes.get(reason, 0) + 1
        DEFAULT_REGISTRY.counter(
            "bst_device_keyframe_resyncs_total",
            "Device-resident state resyncs from a full keyframe, by reason",
        ).inc(reason=reason)
        self._note_generation()

    def _note_generation(self) -> None:  # lock-held: _lock
        DEFAULT_REGISTRY.gauge(
            "bst_device_state_generation",
            "Generation of the device-resident cluster state (per holder)",
        ).set(float(self.generation), holder=self.label)

    def _count_scattered(self, rows: int) -> None:  # lock-held: _lock
        self.rows_scattered += rows
        DEFAULT_REGISTRY.counter(
            "bst_device_rows_scattered_total",
            "Churned rows applied to device-resident state via "
            "jit'd scatter-updates (vs a full re-upload)",
        ).inc(rows)

    def _own(self, name: str) -> torch.Tensor:  # lock-held: _lock
        """The resident tensor ``name`` ready for an in-place write: a
        tensor a fork still borrows from its parent is cloned first, so a
        write through a fork never reaches the parent (copy-on-write)."""
        if name in self._borrowed:
            setattr(self, name, getattr(self, name).clone())
            self._borrowed.discard(name)
        return getattr(self, name)

    def _scatter(self, buf: torch.Tensor, idx, rows) -> None:  # lock-held: _lock
        """Resident ``buf`` rows at ``idx`` become ``rows``, in place — THE
        row application, mirroring the host-side rewrites of
        ops.snapshot.DeltaSnapshotPacker._delta_rows / _group_rows (same
        indices, same packed values): one staged copy (``stage_rows``) and
        one ``index_copy_`` on the current stream."""
        buf.index_copy_(0, *stage_rows(idx, rows, self.device, buf.shape[1:]))

    def _resident_args(self, small_args) -> tuple:  # lock-held: _lock
        remaining, fit_mask, group_valid, order = small_args
        return (
            self._alloc, self._requested, self._group_req,
            remaining, fit_mask, group_valid, order,
        )

    # -- state transitions --------------------------------------------------

    def current_generation(self) -> int:
        with self._lock:
            return self.generation

    def keyframe(self, batch_args: tuple, generation: int, reason: str) -> tuple:
        """Install a full snapshot as the resident state and return the
        device-ready batch args. ``batch_args`` is the canonical padded
        7-tuple (ops.bucketing.pad_oracle_batch order); the big [N,R] /
        [G,R] buffers go to the device, the O(G) tail stays host — it is
        refresh-fresh by definition and tiny."""
        alloc, requested, group_req = batch_args[:3]
        with self._lock:
            self._alloc = self._place(alloc)
            self._requested = self._place(requested)
            self._group_req = self._place(group_req)
            self._policy_hash = self._policy_dom = None
            self._borrowed.clear()
            self.generation = int(generation)
            self._note_keyframe(reason)
            return self._resident_args(batch_args[3:])

    def apply_rows(
        self,
        base_generation: int,
        generation: int,
        node_update: Optional[Tuple[np.ndarray, np.ndarray]],
        group_update: Optional[Tuple[np.ndarray, np.ndarray]],
        small_args: tuple,
    ) -> Optional[tuple]:
        """Scatter churned rows into the resident buffers and return the
        device-ready batch args, or None when the delta is NOT applicable —
        no resident state, a generation gap (a dropped/duplicated delta
        must resync, never silently score stale rows), or rows that do not
        fit the resident shape. ``small_args`` is the padded
        ``(remaining, fit_mask, group_valid, order)`` tail."""
        with self._lock:
            if self._requested is None or self._group_req is None:
                return None
            if int(base_generation) != self.generation:
                return None
            # validate both updates before writing either: a refusal
            # leaves the resident state exactly as it was
            plan = []
            for name, update in (("requested", node_update),
                                 ("group_req", group_update)):
                if update is None or not len(update[0]):
                    continue
                idx, rows = update
                shape = tuple(getattr(self, "_" + name).shape)
                idx = np.asarray(idx)
                rows = np.asarray(rows)
                # both bounds: a negative index would WRAP and corrupt an
                # unrelated resident row — refuse with a resync instead,
                # exactly like an out-of-range one
                if (
                    rows.shape != (len(idx),) + shape[1:]
                    or int(idx.max()) >= shape[0]
                    or int(idx.min()) < 0
                ):
                    return None
                plan.append((name, idx, rows))
            scattered = 0
            for name, idx, rows in plan:
                self._scatter(self._own("_" + name), idx, rows)
                scattered += int(len(idx))
            self.generation = int(generation)
            self.deltas_applied += 1
            if scattered:
                self._count_scattered(scattered)
            self._note_generation()
            return self._resident_args(small_args)

    # -- the scorer-side entry point ---------------------------------------

    def sync(self, snap) -> tuple:
        """Bring the resident state up to ``snap`` (a DeltaSnapshotPacker
        product) and return device-ready batch args. Scatter-applies the
        pack's churned rows when the delta record is contiguous with the
        resident generation; otherwise resyncs from a keyframe with the
        reason counted. When the snapshot carries queue-order meta columns
        (the snapshot-lite capture), the fit-mask and order columns are
        swapped for device-DERIVED ones (_maybe_derive) — the host columns
        stay authoritative and equal by construction."""
        out = self._maybe_derive(snap, self._sync_base(snap))
        with self._lock:
            self._last = out
        return out

    def _sync_base(self, snap) -> tuple:
        batch_args = snap.device_args()
        delta = getattr(snap, "delta", None)
        if delta is None:
            return self.keyframe(batch_args, 0, "untracked")
        if delta.kind != "delta":
            return self.keyframe(batch_args, delta.generation, delta.reason)
        with self._lock:
            resident = self._requested is not None
            gen = self.generation
            shape_ok = resident and (
                tuple(self._requested.shape) == snap.requested.shape
                and tuple(self._group_req.shape) == snap.group_req.shape
            )
        if not resident:
            return self.keyframe(batch_args, delta.generation, "first")
        if delta.generation != gen + 1:
            return self.keyframe(batch_args, delta.generation, "generation")
        if not shape_ok:
            return self.keyframe(batch_args, delta.generation, "bucket")
        out = self.apply_rows(
            gen,
            delta.generation,
            (delta.node_rows, np.asarray(snap.requested)[delta.node_rows]),
            (delta.group_rows, np.asarray(snap.group_req)[delta.group_rows]),
            (snap.remaining, snap.fit_mask, snap.group_valid, snap.order),
        )
        if out is None:  # raced invalidation: resync, never stale rows
            return self.keyframe(batch_args, delta.generation, "generation")
        return out

    def _maybe_derive(self, snap, out: tuple) -> tuple:
        """Swap ``out``'s fit-mask (index 4) and order (index 6) for
        device-derived tensors when the snapshot carries meta columns.

        Residency rule: the meta columns mirror generation ``_meta_gen``;
        a contiguous ``"delta"`` pack with matching padded shapes scatters
        only ``delta.meta_rows`` (empty → the cached derivation is reused
        outright — the zero-churn steady state does no device work here);
        anything else uploads the meta wholesale. Snapshots without
        meta_cols (lite ineligible: selectors/taints, direct construction)
        drop the meta state and return the host columns untouched."""
        meta = getattr(snap, "meta_cols", None)
        if meta is None:
            with self._lock:
                self._meta = self._meta_nv = self._derived = None
                self._meta_gen = -1
            return out
        delta = getattr(snap, "delta", None)
        gen = 0 if delta is None else int(delta.generation)
        with self._lock:
            contiguous = (
                delta is not None
                and delta.kind == "delta"
                and self._meta is not None
                and self._meta_gen == gen - 1
                and tuple(self._meta[0].shape) == np.shape(meta[0])
                and tuple(self._meta_nv.shape) == np.shape(snap.node_valid)
            )
            if not contiguous:
                self._meta = tuple(self._place(c) for c in meta)
                self._meta_nv = self._place(snap.node_valid)
                self._derived = None
            elif len(delta.meta_rows):
                idx = delta.meta_rows
                # node_valid never scatters: it is immutable while the
                # lite capture is valid (any node change keyframes)
                for buf, host in zip(self._meta, meta):
                    self._scatter(buf, idx, np.asarray(host)[idx])
                self._derived = None
            if self._derived is None:
                self._derived = derive_columns(*self._meta, self._meta_nv)
                self.derives += 1
            self._meta_gen = gen
            fit, order = self._derived
            self.derived_batches += 1
            DEFAULT_REGISTRY.counter(
                "bst_refresh_derived_batches_total",
                "Batches whose fit-mask/queue-order columns were derived "
                "on device from resident meta columns instead of host "
                "precompute + upload",
            ).inc()
            return out[:4] + (fit, out[5], order)

    def sync_policy_cols(self, snap) -> Optional[tuple]:
        """Device-resident node policy columns: the [N,H] label-hash and [N]
        spread-domain columns follow the same generation stream as the
        lanes (call after ``sync``); the O(G) group columns are rebuilt per
        pack and stay host, uploaded with the batch. Returns the
        snapshot's ``policy_cols`` with the node arrays swapped for the
        resident tensors, or None when the snapshot carries no columns.
        A contiguous ``"delta"`` pack scatters ``delta.policy_node_rows``
        (none when no label changed); anything else uploads both
        columns."""
        cols = snap.policy_cols
        if cols is None:
            with self._lock:
                self._policy_hash = self._policy_dom = None
            return None
        prio, aff, anti, gang_dom, node_hash, node_dom = cols
        delta = getattr(snap, "delta", None)
        with self._lock:
            resident = (
                self._policy_hash is not None
                and tuple(self._policy_hash.shape) == np.shape(node_hash)
                and tuple(self._policy_dom.shape) == np.shape(node_dom)
            )
            if not resident or delta is None or delta.kind != "delta":
                self._policy_hash = self._place(node_hash)
                self._policy_dom = self._place(node_dom)
                self._borrowed -= {"_policy_hash", "_policy_dom"}
            elif len(delta.policy_node_rows):
                idx = delta.policy_node_rows
                self._scatter(self._own("_policy_hash"), idx, np.asarray(node_hash)[idx])
                # [N] scatters as [N, 1] rows: index_copy_ needs a row axis
                self._scatter(self._own("_policy_dom")[:, None], idx,
                              np.asarray(node_dom)[idx][:, None])
                self._count_scattered(int(len(idx)))
            return (prio, aff, anti, gang_dom, self._policy_hash, self._policy_dom)

    # -- copy-on-write forks (core.explain's what-if) -----------------------

    def fork(self, label: Optional[str] = None) -> "DeviceStateHolder":
        """A copy-on-write fork of this holder on its device: it starts on
        this holder's resident tensors and generation without a copy, and
        clones each tensor at its first in-place write (``_own``), so this
        holder's values, storage, generation and counters never change
        through the fork. The what-if engine's state: apply a
        counterfactual to the fork, score it, drop the fork."""
        out = DeviceStateHolder(self.device, label=label or f"{self.label}~fork")
        with self._lock, out._lock:
            out._forked = True
            for name in _FORK_SHARED:
                setattr(out, name, getattr(self, name))
            out._borrowed = {n for n in _FORK_SHARED if getattr(out, n) is not None}
            out.generation = self.generation
        return out

    def apply_batch(self, batch_args: tuple, base_args: tuple) -> tuple:
        """Counterfactual apply for a FORK: bring the resident tensors from
        ``base_args`` (the host arrays they mirror now) to ``batch_args``
        by scattering only the rows that differ, or install a ``fork-shape``
        keyframe when the padded shapes changed (added nodes grow the
        bucket) or nothing is resident. Returns device-ready batch args
        like ``sync``. Refused (RuntimeError) on a holder that is not a
        fork: the live holder moves only by ``sync``/``apply_rows``, checked
        by generation."""
        if not self._forked:
            raise RuntimeError(
                "apply_batch is fork-only; the live holder syncs from the "
                "packer's generation stream"
            )
        alloc, requested, group_req = (np.asarray(a) for a in batch_args[:3])
        with self._lock:
            resident = self._alloc is not None and all(
                tuple(t.shape) == a.shape
                for t, a in ((self._alloc, alloc), (self._requested, requested),
                             (self._group_req, group_req))
            )
        if not resident:
            return self.keyframe(batch_args, self.current_generation(), "fork-shape")
        with self._lock:
            scattered = 0
            for name, new, base in (("_alloc", alloc, base_args[0]),
                                    ("_requested", requested, base_args[1]),
                                    ("_group_req", group_req, base_args[2])):
                idx = np.nonzero((new != np.asarray(base)).any(axis=1))[0]
                if len(idx):
                    self._scatter(self._own(name), idx, new[idx])
                    scattered += int(len(idx))
            self.deltas_applied += 1
            self.rows_scattered += scattered
            return self._resident_args(batch_args[3:])

    # -- observability ------------------------------------------------------

    def last_args(self) -> Optional[tuple]:
        """The batch args the last ``sync`` returned (None before it): the
        resident ``alloc``/``requested``/``group_req``, the host
        ``remaining``/``group_valid`` and the fit row and order the batch
        read, for checks against a full pack."""
        with self._lock:
            return self._last

    def stats(self) -> dict:
        with self._lock:
            out = {
                "label": self.label,
                "device": str(self.device),
                "forked": self._forked,
                "generation": self.generation,
                "resident": self._requested is not None,
                "deltas_applied": self.deltas_applied,
                "rows_scattered": self.rows_scattered,
                "keyframes": dict(self.keyframes),
                "derived_batches": self.derived_batches,
                "derives": self.derives,
                "meta_resident": self._meta is not None,
                "policy_resident": self._policy_hash is not None,
            }
            if self._requested is not None:
                out["n_bucket"] = int(self._requested.shape[0])
                out["g_bucket"] = int(self._group_req.shape[0])
        return out
