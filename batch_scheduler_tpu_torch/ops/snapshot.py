"""ClusterSnapshot: host-side packing of API objects into the oracle's
padded int32 arrays (numpy).

The reference walks a ``SnapshotSharedLister`` of NodeInfo objects per pod
per cycle (reference pkg/scheduler/core/core.go:436-475,566-632). Here the
snapshot is packed once per batch into dense arrays — node allocatable /
requested lanes, per-group member requirements, and a (group × node)
placement-feasibility mask — then every group is scored in one device call.

Host-side string work (node selectors, taints — reference core.go:741-759)
happens exactly once per (group, node) per snapshot, with a fast path that
skips the quadratic walk entirely when no selectors or taints exist.

The packing is the JAX reference's (``batch_scheduler_tpu/ops/snapshot.py``
``ClusterSnapshot``), so both packages produce the same ``device_args`` /
``progress_args`` from the same cluster. So is the steady-state refresh
path: ``DeltaSnapshotPacker`` keeps the packed buffers across refreshes and
rewrites only churned rows (the snapshot-lite scan, or the O(churn) event
fold ``pack_fold``), and stamps each snapshot with the ``SnapshotDelta``
the device-resident state (``ops.device_state``) scatters. With an enabled
policy engine (``batch_scheduler_tpu_torch.policy``) every snapshot also
carries the packed policy columns (``ClusterSnapshot.policy_cols``), and,
as in the reference, the packer then takes neither the snapshot-lite
scan nor the event fold: a policy refresh is O(N+G).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..api.fit import selector_matches, tolerates_all
from ..api.types import Node, Pod, Toleration
from ..utils.metrics import DEFAULT_REGISTRY
from .bucketing import pad_oracle_batch, pad_rows
from .lanes import LaneSchema

__all__ = [
    "GroupDemand",
    "ClusterSnapshot",
    "DeltaSnapshotPacker",
    "SnapshotDelta",
    "node_requested_from_pods",
]


_EMPTY_IDX = np.zeros(0, dtype=np.int32)

_I32_MAX = np.iinfo(np.int32).max


def _ts_sort_keys(ts: np.ndarray):
    """Order-preserving (hi, lo) int32 key pair for float64 creation
    timestamps: total-ordered exactly like Python ``<`` on finite doubles
    (with ``-0.0`` collapsed onto ``0.0``, which host tuple compare also
    treats as equal). The IEEE754 bits are mapped to a monotone uint64
    (sign-flip for positives, full complement for negatives), split into
    32-bit halves, and each half biased into int32 — so a device sort
    over ``(ts_hi, ts_lo)`` reproduces the host's float ascending order
    bit-for-bit."""
    ts = np.asarray(ts, dtype=np.float64)
    ts = np.where(ts == 0.0, 0.0, ts)  # -0.0 and 0.0 must key equal
    u = ts.view(np.uint64)
    mask = np.where(
        (u >> np.uint64(63)).astype(bool),
        np.uint64(0xFFFFFFFFFFFFFFFF),
        np.uint64(0x8000000000000000),
    )
    k = u ^ mask
    hi = (k >> np.uint64(32)).astype(np.uint32) ^ np.uint32(0x80000000)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ np.uint32(0x80000000)
    return hi.view(np.int32), lo.view(np.int32)


@dataclass
class SnapshotDelta:
    """What changed between two consecutive packs — the churned-row record
    the device-resident state (ops.device_state) applies as row scatters
    instead of re-uploading a full snapshot.

    ``kind`` is ``"delta"`` when the packer's cached schema, node list and
    group set all held, so the previous pack's packed ``[N, R]`` /
    ``[G, R]`` buffers become this pack's by rewriting exactly the listed
    rows (the row VALUES live in the emitted ClusterSnapshot's padded
    arrays at the same indices — padding appends, so unpadded indices are
    valid in padded space). ``kind == "keyframe"`` means the buffers must
    be replaced wholesale; ``reason`` says why:

    - ``first``      — no previous pack
    - ``node-list``  — node names/order changed (positional keys broke)
    - ``node-churn`` — a node OBJECT changed or a churned row stopped
                       packing under the cached schema (the packer's
                       full-repack rules; the lane shifts may have moved)
    - ``group-set``  — the group name set/order changed (group row
                       indices are positional)

    ``generation`` increments once per pack; consumers verify contiguity
    (``generation == applied + 1``) before scattering, and resync from a
    keyframe on any gap — never silently score stale rows.

    ``source`` records which refresh path produced the pack: ``"scan"``
    for a full O(N+G) read of the cluster state, or ``"events"`` for an
    O(churn) event fold (``pack_fold``). ``meta_rows`` lists group rows
    whose QUEUE-ORDER meta (priority / creation_ts sort keys) churned —
    the device-derive path scatters those and re-derives the order
    permutation on the device. ``policy_node_rows`` lists the nodes whose
    packed policy row (label hashes, spread domain) this pack rewrote,
    which the holder scatters into its resident node columns.
    """

    generation: int
    kind: str  # "delta" | "keyframe"
    reason: str = ""  # keyframe reason, "" for deltas
    # churned REQUESTED node rows / group demand rows / node policy rows,
    # unpadded row indices (int32); empty on keyframes
    node_rows: np.ndarray = field(default_factory=lambda: _EMPTY_IDX)
    group_rows: np.ndarray = field(default_factory=lambda: _EMPTY_IDX)
    policy_node_rows: np.ndarray = field(default_factory=lambda: _EMPTY_IDX)
    source: str = "scan"  # "scan" | "events"
    meta_rows: np.ndarray = field(default_factory=lambda: _EMPTY_IDX)


@dataclass
class GroupDemand:
    """One PodGroup's demand as seen by the oracle."""

    full_name: str
    min_member: int
    scheduled: int = 0
    matched: int = 0
    priority: int = 0
    creation_ts: float = 0.0
    # Per-member canonical resource requirement (includes an implicit pod
    # slot); from spec.min_resources or the representative pod
    # (reference core.go:489-493).
    member_request: Dict[str, int] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    # Gang already released to bind (reference cache.go:66) — excluded from
    # max-progress selection.
    released: bool = False
    # No representative pod observed yet (reference core.go:709-710).
    has_pod: bool = True
    # Policy columns (batch_scheduler_tpu_torch.policy): label hashes of
    # the gang's soft-affinity / hard-anti-affinity targets (0 = none), the
    # spread opt-in, and the gang's currently-matched members per node
    # (the spread term's domain occupancy source).
    affinity_hash: int = 0
    anti_hash: int = 0
    spread: bool = False
    placed_nodes: Dict[str, int] = field(default_factory=dict)

    @property
    def remaining(self) -> int:
        """Members still needing placement. Matched (permitted-but-unbound)
        pods are excluded: the framework has already *assumed* them onto
        nodes, so their capacity is out of the leftover lanes — counting
        them here too would double-charge the gang and starve its own tail."""
        return max(self.min_member - self.scheduled - self.matched, 0)


def node_requested_from_pods(pods: Sequence[Pod]) -> Dict[str, int]:
    """Aggregate the canonical requested resources of pods bound to a node,
    including the implicit pod slot (reference core.go:650-654)."""
    total: Dict[str, int] = {"pods": 0}
    for p in pods:
        total["pods"] += 1
        for k, v in p.resource_require().items():
            total[k] = total.get(k, 0) + v
    return total


def _member_request_row(g: GroupDemand) -> Dict[str, int]:
    """A group's per-member demand dict with the implicit pod slot applied —
    THE conversion both the full pack and the delta packer use, so the two
    can never drift."""
    req = dict(g.member_request)
    req["pods"] = max(req.get("pods", 0), 1)
    return req


def _demand_fp(g: GroupDemand) -> tuple:
    """Content fingerprint of every oracle-visible demand field the lite
    packer diffs. Callers may mutate a GroupDemand IN PLACE between packs,
    so change detection must compare captured content, never a stored
    object reference. ``remaining`` is derived from indices 1..3. The
    policy fields come last (indices 8..11): the first eight are the
    reference's fingerprint, which the audit's v2 records carry."""
    return (
        tuple(sorted(g.member_request.items())),
        g.min_member,
        g.scheduled,
        g.matched,
        g.priority,
        g.creation_ts,
        bool(g.released),
        bool(g.has_pod),
        g.affinity_hash,
        g.anti_hash,
        bool(g.spread),
        tuple(sorted(g.placed_nodes.items())),
    )


def _count_rows_rewritten(n: int) -> None:
    DEFAULT_REGISTRY.counter(
        "bst_pack_rows_rewritten",
        "Node lane rows rewritten by the delta snapshot packer "
        "(2N on a full repack)",
    ).inc(n)


def _count_label_truncations(n: int) -> None:
    DEFAULT_REGISTRY.counter(
        "bst_policy_label_truncations_total",
        "Node labels beyond the packed hash lanes "
        "(affinity against them can never match)",
    ).inc(n)


class ClusterSnapshot:
    """Padded, device-ready view of (nodes × groups) for one batch."""

    def __init__(
        self,
        nodes: Sequence[Node],
        node_requested: Dict[str, Dict[str, int]],
        groups: Sequence[GroupDemand],
        schema: Optional[LaneSchema] = None,
        requested_lanes: Optional[np.ndarray] = None,
        alloc_lanes: Optional[np.ndarray] = None,
        group_req_lanes: Optional[np.ndarray] = None,
        min_buckets: tuple = (0, 0),
        policy_engine=None,
        node_policy_lanes: Optional[tuple] = None,
    ):
        self.node_names = [n.metadata.name for n in nodes]
        self.group_names = [g.full_name for g in groups]
        self.groups = list(groups)
        self._node_index = {n: i for i, n in enumerate(self.node_names)}
        self._group_index = {g: i for i, g in enumerate(self.group_names)}

        # a caller-pinned schema (the delta packer's) keeps the lane
        # dimension stable across successive snapshots
        self.schema = schema or LaneSchema.collect(
            [node_requested.get(n.metadata.name, {}) for n in nodes]
            + [n.status.allocatable for n in nodes]
            + [g.member_request for g in groups]
        )

        self.num_nodes = len(nodes)
        self.num_groups = len(groups)

        if alloc_lanes is not None:
            alloc = np.asarray(alloc_lanes, dtype=np.int32)
            if alloc.shape != (len(nodes), self.schema.num_lanes):
                raise ValueError(
                    f"alloc_lanes shape {alloc.shape} != "
                    f"({len(nodes)}, {self.schema.num_lanes})"
                )
        else:
            alloc = self.schema.pack_many(
                [n.status.allocatable for n in nodes], capacity=True
            )
        if requested_lanes is not None:
            # dense fast path: the caller maintains the (N, R) requested
            # array in device units. Copied: the caller keeps mutating its
            # array and the snapshot must stay what was actually scored.
            requested = np.array(requested_lanes, dtype=np.int32)
            if requested.shape != (len(nodes), self.schema.num_lanes):
                raise ValueError(
                    f"requested_lanes shape {requested.shape} != "
                    f"({len(nodes)}, {self.schema.num_lanes})"
                )
        else:
            requested = self.schema.pack_many(
                [node_requested.get(n.metadata.name, {}) for n in nodes]
            )
        node_valid = np.array(
            [not n.spec.unschedulable for n in nodes], dtype=bool
        )
        if group_req_lanes is not None:
            # delta-pack fast path: the caller (DeltaSnapshotPacker) packed
            # the member-demand rows — with the implicit pod slot already
            # applied — against THIS schema and hands over ownership.
            group_req = np.asarray(group_req_lanes, dtype=np.int32)
            if group_req.shape != (len(groups), self.schema.num_lanes):
                raise ValueError(
                    f"group_req_lanes shape {group_req.shape} != "
                    f"({len(groups)}, {self.schema.num_lanes})"
                )
        else:
            group_req = self.schema.pack_many(
                [_member_request_row(g) for g in groups]
            )

        fit = self._fit_mask(nodes, groups) & node_valid[None, :]

        # queue order: priority desc, creation asc, name (Compare semantics)
        order_host = sorted(
            range(len(groups)),
            key=lambda i: (
                -groups[i].priority,
                groups[i].creation_ts,
                groups[i].full_name,
            ),
        )
        ranks = np.empty(len(groups), dtype=np.int32)
        ranks[order_host] = np.arange(len(groups), dtype=np.int32)

        batch_args, progress_args = pad_oracle_batch(
            min_buckets=min_buckets,
            alloc=alloc,
            requested=requested,
            group_req=group_req,
            remaining=np.array([g.remaining for g in groups], dtype=np.int32),
            fit_mask=fit,
            group_valid=np.ones(len(groups), dtype=bool),
            order=np.array(order_host, dtype=np.int32),
            min_member=np.array([g.min_member for g in groups], dtype=np.int32),
            scheduled=np.array([g.scheduled for g in groups], dtype=np.int32),
            matched=np.array([g.matched for g in groups], dtype=np.int32),
            # Ineligible for max-progress selection: already released or no
            # representative pod yet.
            ineligible=np.array(
                [g.released or not g.has_pod for g in groups], dtype=bool
            ),
            creation_rank=ranks,
        )
        (
            self.alloc,
            self.requested,
            self.group_req,
            self.remaining,
            self.fit_mask,
            self.group_valid,
            self.order,
        ) = batch_args
        (
            self.min_member,
            self.scheduled,
            self.matched,
            self.ineligible,
            self.creation_rank,
        ) = progress_args
        self.node_valid = pad_rows(
            node_valid, self.alloc.shape[0], fill=False
        )
        # churned-row record stamped by DeltaSnapshotPacker.pack (None on
        # directly-constructed snapshots: no previous pack to delta from)
        self.delta: Optional[SnapshotDelta] = None
        # queue-order sort-key columns (inv_prio, ts_hi, ts_lo, name_rank),
        # padded [Gb] int32 — stamped by the packer's snapshot-lite capture
        # so ops.device_state can derive fit/order on the device; None on
        # directly-constructed snapshots (host columns stay authoritative)
        self.meta_cols: Optional[tuple] = None
        # the drained event batch an event-fold pack consumed (stamped by
        # the scorer's fold; None on scan packs)
        self.event_fold: Optional[dict] = None
        # the snapshot-lite re-fold base of an audit v2 keyframe: the
        # per-gang demand fingerprints (stamped by DeltaSnapshotPacker on
        # every snapshot-lite pack; None otherwise)
        self.lite_fps: Optional[list] = None
        # packed policy columns: built only when an enabled engine is
        # attached; policy-off snapshots carry None and every later step
        # runs the pre-policy code
        self.policy_engine = policy_engine
        self.policy_cols = None
        if policy_engine is not None and policy_engine.enabled:
            self.policy_cols = self._policy_columns(
                nodes, groups, policy_engine, node_policy_lanes
            )

    def _policy_columns(self, nodes, groups, engine, node_policy_lanes) -> tuple:
        """(prio[Gb], aff[Gb], anti[Gb], gang_dom[Gb,D], node_hash[Nb,H],
        node_dom[Nb]) int32, padded: the node columns from
        ``node_policy_lanes`` (the packer's persistent rows) or from the
        nodes' labels, the group columns from the demands."""
        from ..policy.terms import DOMAIN_BUCKETS, HASH_LANES, node_policy_row

        nb, gb = self.alloc.shape[0], self.group_req.shape[0]
        if node_policy_lanes is not None:
            node_hash = np.asarray(node_policy_lanes[0], np.int32)
            node_dom = np.asarray(node_policy_lanes[1], np.int32)
        else:
            spread_key = engine.config.spread_node_key
            node_hash = np.zeros((len(nodes), HASH_LANES), np.int32)
            node_dom = np.zeros(len(nodes), np.int32)
            truncated = 0
            for i, n in enumerate(nodes):
                node_hash[i], node_dom[i], trunc = node_policy_row(
                    n.metadata.labels or {}, spread_key
                )
                truncated += trunc
            if truncated:
                _count_label_truncations(truncated)
        prio = np.array([g.priority for g in groups], np.int32)
        aff = np.array([g.affinity_hash for g in groups], np.int32)
        anti = np.array([g.anti_hash for g in groups], np.int32)
        gang_dom = np.zeros((len(groups), DOMAIN_BUCKETS), np.int32)
        for gi, g in enumerate(groups):
            if not g.spread or not g.placed_nodes:
                continue
            for node_name, count in g.placed_nodes.items():
                ni = self._node_index.get(node_name)
                if ni is not None:
                    gang_dom[gi, int(node_dom[ni])] += int(count)
        return (
            pad_rows(prio, gb),
            pad_rows(aff, gb),
            pad_rows(anti, gb),
            pad_rows(gang_dom, gb),
            pad_rows(node_hash, nb),
            pad_rows(node_dom, nb),
        )

    def _fit_mask(
        self, nodes: Sequence[Node], groups: Sequence[GroupDemand]
    ) -> np.ndarray:
        """Per-(group,node) placement feasibility.

        Fast path: with no node selectors and no taints anywhere (the
        overwhelmingly common case) the mask is uniform — return a single
        broadcast ``[1,N]`` row. The oracle accepts either shape.
        """
        any_taints = any(n.spec.taints for n in nodes)
        if not any_taints and not any(g.node_selector for g in groups):
            return np.ones((1, len(nodes)), dtype=bool)
        mask = np.ones((len(groups), len(nodes)), dtype=bool)
        for gi, g in enumerate(groups):
            if not g.node_selector and not any_taints:
                continue
            for ni, node in enumerate(nodes):
                ok = selector_matches(g.node_selector, node.metadata.labels)
                if ok and node.spec.taints:
                    ok = tolerates_all(g.tolerations, node.spec.taints)
                mask[gi, ni] = ok
        return mask

    # -- lookups -----------------------------------------------------------

    def group_index(self, full_name: str) -> Optional[int]:
        return self._group_index.get(full_name)

    def node_index(self, name: str) -> Optional[int]:
        return self._node_index.get(name)

    def device_args(self) -> tuple:
        """Batch argument tuple for ops.oracle.execute_batch_host."""
        return (
            self.alloc,
            self.requested,
            self.group_req,
            self.remaining,
            self.fit_mask,
            self.group_valid,
            self.order,
        )

    def progress_args(self) -> tuple:
        """Progress argument tuple for ops.oracle.execute_batch_host."""
        return (
            self.min_member,
            self.scheduled,
            self.matched,
            self.ineligible,
            self.creation_rank,
        )

    def policy_payload(self):
        """The ``policy=`` argument of ``ops.oracle.dispatch_batch``:
        ``(policy_cols, terms, weights)`` when an enabled engine packed
        columns for this snapshot and scores with at least one term, else
        None (the pre-policy path). A preemption-only config packs the
        columns (the planner's tiers) but scores nothing, so its batches
        keep the base scan rungs."""
        if self.policy_cols is None or self.policy_engine is None:
            return None
        cfg = self.policy_engine.config
        if not cfg.scoring_terms:
            return None
        return (self.policy_cols, cfg.scoring_terms, cfg.weights)

    @property
    def shape(self) -> tuple:
        return (
            self.group_req.shape[0],
            self.alloc.shape[0],
            self.schema.num_lanes,
        )


@dataclass
class _LiteState:
    """The packer's persistent PADDED working set (snapshot-lite):
    everything a ClusterSnapshot carries, kept alive across packs so a
    delta-applicable refresh touches only churned rows — no per-refresh
    pad copies, no fit-mask scan, no queue-order sort.

    Mutability contract (what `_lite_snapshot` must copy vs may share):

    - ``pad_requested`` / ``pad_group_req`` and the five tail arrays are
      mutated IN PLACE per pack → copied into every emitted snapshot;
    - ``order`` / ``creation_rank`` / ``meta`` are REPLACED wholesale on
      queue-meta churn (never mutated) → shared with snapshots;
    - ``pad_alloc`` / ``fit_row`` / ``node_valid`` / ``group_valid`` are
      immutable while the lite state is valid (any alloc / taint /
      unschedulable / selector / membership change invalidates it) →
      shared.

    Validity requires: node list and gang set positionally stable, the
    uniform-fit fast path (no selectors, no taints — ``fit_row`` IS the
    padded node_valid row), and every churned value inside the
    pad_oracle_batch bounds (a violation falls back to the full path so
    the canonical OverflowError raises there)."""

    n: int
    g: int
    nb: int
    gb: int
    node_names: tuple
    group_names: tuple
    node_index: dict
    group_index: dict
    node_names_list: list
    group_names_list: list
    demands: list
    fps: list  # per-row _demand_fp — content diffs survive in-place mutation
    gang_bound: int
    pad_alloc: np.ndarray  # [Nb,R] shared (alloc churn keyframes)
    pad_requested: np.ndarray  # [Nb,R] mutated in place
    pad_group_req: np.ndarray  # [Gb,R] mutated in place
    remaining: np.ndarray  # [Gb] mutated in place
    min_member: np.ndarray  # [Gb] mutated in place
    scheduled: np.ndarray  # [Gb] mutated in place
    matched: np.ndarray  # [Gb] mutated in place
    ineligible: np.ndarray  # [Gb] mutated in place
    fit_row: np.ndarray  # [1,Nb] shared (uniform-fit invariant)
    node_valid: np.ndarray  # [Nb] shared
    group_valid: np.ndarray  # [Gb] shared
    order: np.ndarray  # [Gb] replaced wholesale on meta churn
    creation_rank: np.ndarray  # [Gb] replaced wholesale on meta churn
    meta: tuple  # (inv_prio, ts_hi, ts_lo, name_rank) [Gb] i32, replaced


def _meta_columns(demands, gb: int):
    """The padded queue-order sort keys (inv_prio, ts_hi, ts_lo) of
    ``demands``: pad sentinels are INT32_MAX, so pad rows sort strictly
    AFTER every real row (pad ts_hi exceeds any finite double's biased hi
    half)."""
    g = len(demands)
    prio = np.array([d.priority for d in demands], dtype=np.int64)
    ts_hi_r, ts_lo_r = _ts_sort_keys(
        np.array([d.creation_ts for d in demands], dtype=np.float64)
    )
    inv_prio = np.full(gb, _I32_MAX, dtype=np.int32)
    inv_prio[:g] = ~prio.astype(np.int32)
    ts_hi = np.full(gb, _I32_MAX, dtype=np.int32)
    ts_hi[:g] = ts_hi_r
    ts_lo = np.full(gb, _I32_MAX, dtype=np.int32)
    ts_lo[:g] = ts_lo_r
    return inv_prio, ts_hi, ts_lo


def _queue_meta(demands, gb: int) -> tuple:
    """The lite state's padded queue-order meta (inv_prio, ts_hi, ts_lo,
    name_rank). name_rank = the row index keeps the pad tail in
    arange(g, gb) order, so a full-[Gb] sort reproduces pad_oracle_batch's
    order column exactly."""
    g = len(demands)
    rank = np.empty(g, dtype=np.int32)
    rank[sorted(range(g), key=lambda i: demands[i].full_name)] = np.arange(
        g, dtype=np.int32
    )
    name_rank = np.arange(gb, dtype=np.int32)
    name_rank[:g] = rank
    return (*_meta_columns(demands, gb), name_rank)


class DeltaSnapshotPacker:
    """Persistent packed host buffers: rewrite only churned rows per refresh.

    The full pack walks every node/group dict every batch; on a low-churn
    steady state almost none of that work changes between refreshes. This
    packer keeps the packed ``[N, R]`` / ``[G, R]`` arrays alive across
    calls and rewrites only:

    - node **requested** rows whose requested-dict content changed (the
      resource_version does not cover scheduler-side accounting, so the
      dict is compared directly);
    - group demand rows, rebuilt from a persistent per-demand row memo
      (group membership churns; the memo makes each row a copy).

    Full repack remains the fallback whenever a node OBJECT changed
    (``(name, resource_version)`` key — the lane shifts are sized from
    the alloc peaks, so alloc churn must re-collect the schema), the node
    list changed, or a churned demand/requested row stops packing exactly
    under the cached schema (new resource name, out-of-domain value —
    ``LaneSchema.covers``).

    On top of that, the snapshot-lite working set (``_LiteState``) lets a
    positionally stable refresh emit straight from padded buffers
    (``_lite_delta_pack``), and ``pack_fold`` rewrites only the entities
    an event log named. Handed-over arrays are COPIES where the packer
    keeps mutating them: a published ClusterSnapshot stays what was
    actually scored. Not thread-safe; callers serialize packs (the
    scorer's refresh lock).

    With an enabled ``policy_engine`` every pack carries the policy
    columns: the node rows (label hashes, spread domain) persist and are
    rewritten only for nodes whose labels changed (``policy_node_rows``),
    the O(G) group columns are rebuilt per pack. As in the reference, an
    enabled engine turns off the snapshot-lite capture, and with it the
    lite scan and the event fold.

    The port of ``batch_scheduler_tpu/ops/snapshot.py``
    ``DeltaSnapshotPacker``.
    """

    def __init__(self, policy_engine=None):
        self.schema: Optional[LaneSchema] = None
        self._node_names: Optional[tuple] = None
        self._alloc_keys: list = []
        self._req_dicts: list = []  # copies: validity is dict equality
        self._alloc: Optional[np.ndarray] = None
        self._requested: Optional[np.ndarray] = None
        # persistent row memos (cleared when the schema actually changes;
        # a memo hit implies the row was validated exact at insert time)
        self._req_row_memo: Dict[tuple, np.ndarray] = {}
        self._group_row_memo: Dict[tuple, np.ndarray] = {}
        self.full_repacks = 0
        self.delta_packs = 0
        self.last_rows_rewritten = 0
        self.rows_rewritten = 0  # total over every pack
        # snapshot-lite working set (None until a capture-eligible full
        # construction; see _LiteState) + per-path counters
        self._lite: Optional[_LiteState] = None
        self.lite_packs = 0  # lite scan-path packs
        self.fold_packs = 0  # event-fold packs (pack_fold)
        self.order_resorts = 0  # queue-meta churn resorts
        # Churned-row delta emission (SnapshotDelta): one record per pack,
        # consumed by the device-resident state (ops.device_state). The
        # generation increments on EVERY pack — consumers detect gaps.
        self.generation = 0
        self.last_delta: Optional[SnapshotDelta] = None
        self._group_names: Optional[tuple] = None
        self._group_prev: Optional[np.ndarray] = None  # last [G, R] rows
        # persistent node policy rows, keyed by each node's label dict, so
        # label churn rewrites only the touched rows (independent of the
        # lane side's full-repack rules)
        self.policy_engine = policy_engine
        self._policy_labels: list = []  # per-node sorted label tuples
        self._policy_hash: Optional[np.ndarray] = None
        self._policy_dom: Optional[np.ndarray] = None
        self.policy_rows_rewritten = 0
        self._policy_rows_idx: list = []

    @classmethod
    def from_refold_base(
        cls, schema: LaneSchema, node_names, demands, arrays: dict
    ) -> "DeltaSnapshotPacker":
        """A packer whose snapshot-lite working set holds exactly
        ``arrays`` — a recorded snapshot-lite pack's padded batch and
        progress columns, keyed by ``device_args`` / ``progress_args``
        name — for ``node_names`` and ``demands`` under ``schema``. The
        audit reader (``utils.audit``) re-runs recorded event batches
        through its ``pack_fold``. The pack must have had a single
        (uniform) fit row."""
        from .oracle import GANG_MAX

        node_names = [str(nm) for nm in node_names]
        demands = list(demands)
        group_names = [d.full_name for d in demands]
        n, g = len(node_names), len(demands)
        nb = int(arrays["alloc"].shape[0])
        gb = int(arrays["group_req"].shape[0])
        lite = _LiteState(
            n=n, g=g, nb=nb, gb=gb,
            node_names=tuple(node_names),
            group_names=tuple(group_names),
            node_index={nm: i for i, nm in enumerate(node_names)},
            group_index={nm: i for i, nm in enumerate(group_names)},
            node_names_list=node_names,
            group_names_list=group_names,
            demands=demands,
            fps=[_demand_fp(d) for d in demands],
            gang_bound=min(GANG_MAX, (2**31 - 1) // max(nb, 1)),
            pad_alloc=arrays["alloc"],
            pad_requested=np.array(arrays["requested"]),
            pad_group_req=np.array(arrays["group_req"]),
            remaining=np.array(arrays["remaining"]),
            min_member=np.array(arrays["min_member"]),
            scheduled=np.array(arrays["scheduled"]),
            matched=np.array(arrays["matched"]),
            ineligible=np.array(arrays["ineligible"]),
            fit_row=arrays["fit_mask"],
            node_valid=np.asarray(arrays["fit_mask"])[0],
            group_valid=arrays["group_valid"],
            order=arrays["order"],
            creation_rank=arrays["creation_rank"],
            meta=_queue_meta(demands, gb),
        )
        packer = cls()
        packer.schema = schema
        packer._node_names = lite.node_names
        # None sentinels: the first event touching a node always re-packs
        # its row, and re-packing under the recorded schema is
        # bit-identical to the row already in the recorded pack
        packer._req_dicts = [None] * n
        packer._group_names = lite.group_names
        packer._lite = lite
        packer._requested = lite.pad_requested[:n]
        packer._group_prev = lite.pad_group_req[:g]
        return packer

    def stats(self) -> dict:
        return {
            "generation": self.generation,
            "full_repacks": self.full_repacks,
            "delta_packs": self.delta_packs,
            "lite_packs": self.lite_packs,
            "fold_packs": self.fold_packs,
            "order_resorts": self.order_resorts,
            "rows_rewritten": self.rows_rewritten,
            "last_rows_rewritten": self.last_rows_rewritten,
            "lite": self._lite is not None,
        }

    # -- internals ----------------------------------------------------------

    class _SchemaMiss(Exception):
        """A churned row no longer packs exactly under the cached schema
        (new resource name or out-of-domain value): fall back to the full
        repack, never to a silent clamp."""

    def _full_repack(self, nodes, alloc_dicts, req_dicts, groups) -> None:
        new_schema = LaneSchema.collect(
            list(req_dicts) + list(alloc_dicts)
            + [g.member_request for g in groups]
        )
        if (
            self.schema is None
            or new_schema.names != self.schema.names
            or new_schema.shifts != self.schema.shifts
        ):
            # packing actually changes: the memoized rows are stale
            self.schema = new_schema
            self._req_row_memo.clear()
            self._group_row_memo.clear()
        self._node_names = tuple(n.metadata.name for n in nodes)
        self._alloc_keys = [
            (n.metadata.name, n.metadata.resource_version) for n in nodes
        ]
        self._req_dicts = [dict(d) for d in req_dicts]
        self._alloc = self.schema.pack_many(alloc_dicts, capacity=True)
        self._requested = self.schema.pack_many(req_dicts)
        self.full_repacks += 1
        self.last_rows_rewritten = 2 * len(nodes)

    def _delta_rows(self, nodes, req_dicts) -> list:
        """Rewrite churned REQUESTED rows in place and return their row
        indices; raises _SchemaMiss when a churned row stops packing
        exactly under the cached schema — or when any node OBJECT changed
        (resource_version bump). Alloc-side churn always full-repacks: the
        lane shifts are sized from the observed alloc peaks, and a delta
        rewrite under the cached shifts could keep a stale (coarser)
        granularity after the peak node shrank.

        The rows this method rewrites host-side are exactly the rows the
        device holder (ops.device_state.DeviceStateHolder.apply_rows)
        scatters."""
        schema = self.schema
        rewritten: list = []
        req_memo = self._req_row_memo
        for i, n in enumerate(nodes):
            if (n.metadata.name, n.metadata.resource_version) != self._alloc_keys[i]:
                raise self._SchemaMiss
            d = req_dicts[i]
            if d != self._req_dicts[i]:
                key = tuple(sorted(d.items()))
                row = req_memo.get(key)
                if row is None:
                    if not schema.covers([d]):
                        raise self._SchemaMiss
                    row = schema.pack(d)
                    req_memo[key] = row
                self._requested[i] = row
                self._req_dicts[i] = dict(d)
                rewritten.append(i)
        return rewritten

    def _group_rows(self, groups) -> np.ndarray:
        """Demand rows from the persistent memo: membership churns freely
        and a memo hit is one O(R) copy. Raises _SchemaMiss on a demand
        the cached schema cannot pack exactly."""
        schema = self.schema
        memo = self._group_row_memo
        out = np.empty((len(groups), schema.num_lanes), np.int32)
        for gi, g in enumerate(groups):
            key = tuple(sorted(g.member_request.items()))
            row = memo.get(key)
            if row is None:
                d = _member_request_row(g)
                if not schema.covers([d]):
                    raise self._SchemaMiss
                row = schema.pack(d)
                memo[key] = row
            out[gi] = row
        return out

    # -- snapshot-lite ------------------------------------------------------

    class _LiteBail(Exception):
        """A churned group broke a lite invariant (selector appeared,
        value out of the pad_oracle_batch bounds): fall back to the full
        construction path — which rebuilds the fit mask, or raises the
        canonical OverflowError — never a silent clamp. Raised ONLY from
        the two-phase planner's validate pass, so a bail leaves the lite
        buffers untouched."""

    def _capture_lite(self, snap: ClusterSnapshot, nodes, groups) -> None:
        """Adopt a freshly built full ClusterSnapshot as the persistent
        lite working set (and stamp its queue-order meta columns for the
        device-derive path). Eligibility: policy engine off, and the
        uniform-fit fast path — no selectors, no taints — so the padded fit
        row IS node_valid and churned groups cannot change it."""
        self._lite = None
        if self.policy_engine is not None and self.policy_engine.enabled:
            return
        if snap.fit_mask.shape[0] != 1:
            return
        if any(g.node_selector for g in groups) or any(
            n.spec.taints for n in nodes
        ):
            return
        for g in groups:
            # the device sort key is int32: a priority outside its domain
            # cannot round-trip through ~p (host sort uses Python ints)
            if not (-(2**31) <= g.priority < 2**31):
                return
        n, g_count = snap.num_nodes, snap.num_groups
        nb, gb = snap.alloc.shape[0], snap.group_req.shape[0]
        from .oracle import GANG_MAX

        lite = _LiteState(
            n=n,
            g=g_count,
            nb=nb,
            gb=gb,
            node_names=tuple(snap.node_names),
            group_names=tuple(snap.group_names),
            node_index=snap._node_index,
            group_index=snap._group_index,
            node_names_list=snap.node_names,
            group_names_list=snap.group_names,
            demands=list(groups),
            fps=[_demand_fp(d) for d in groups],
            gang_bound=min(GANG_MAX, (2**31 - 1) // nb),
            pad_alloc=snap.alloc,
            pad_requested=np.array(snap.requested),
            pad_group_req=np.array(snap.group_req),
            remaining=np.array(snap.remaining),
            min_member=np.array(snap.min_member),
            scheduled=np.array(snap.scheduled),
            matched=np.array(snap.matched),
            ineligible=np.array(snap.ineligible),
            fit_row=snap.fit_mask,
            node_valid=snap.node_valid,
            group_valid=snap.group_valid,
            order=snap.order,
            creation_rank=snap.creation_rank,
            meta=_queue_meta(groups, gb),
        )
        self._lite = lite
        # rebind the packer's working arrays as VIEWS into the padded
        # buffers: _delta_rows keeps its exact body and its writes land
        # directly in padded space — padding appends, so unpadded indices
        # are valid there
        self._requested = lite.pad_requested[:n]
        self._group_prev = lite.pad_group_req[:g_count]
        snap.meta_cols = lite.meta
        # audit v2 re-fold base (utils.audit): the per-gang demand
        # fingerprints a keyframe record carries so a reader can prime
        # this exact lite state and re-run recorded event folds. A shallow
        # list copy — fp tuples are immutable, and later in-place
        # `fps[gi] = ...` updates must not leak into the record
        snap.lite_fps = list(lite.fps)

    def _plan_group_change(self, gi: int, old_fp: tuple, g: GroupDemand):
        """Validate-only half of a lite group update: returns None when
        nothing oracle-visible changed, else the planned write. Diffs the
        fresh demand against the CAPTURED fingerprint, not the stored
        object — callers may have mutated the same GroupDemand in place,
        which would make an attribute compare vacuous. Raises _SchemaMiss
        (covers miss → keyframe like _group_rows) or _LiteBail
        (invariant/bound break → full path). MUST NOT mutate lite state —
        a bail after partial writes would tear the positional diff the
        delta consumers scatter from."""
        fp = _demand_fp(g)
        row = None
        if fp[0] != old_fp[0]:
            row = self._group_row_memo.get(fp[0])
            if row is None:
                d = _member_request_row(g)
                if not self.schema.covers([d]):
                    raise self._SchemaMiss
                row = self.schema.pack(d)
                self._group_row_memo[fp[0]] = row
        tail = None
        if fp[1:4] != old_fp[1:4]:
            from .oracle import GANG_MAX

            # mirror pad_oracle_batch's progress bounds: a violating value
            # must surface as ITS OverflowError via the full path
            if (
                max(abs(g.min_member), abs(g.scheduled), abs(g.matched))
                > GANG_MAX
                or g.remaining > self._lite.gang_bound
            ):
                raise self._LiteBail
            tail = (g.min_member, g.scheduled, g.matched, g.remaining)
        inel = bool(g.released or not g.has_pod)
        inel_changed = fp[6:8] != old_fp[6:8]
        meta_changed = fp[4:6] != old_fp[4:6]
        if meta_changed and not (-(2**31) <= g.priority < 2**31):
            raise self._LiteBail
        if g.node_selector:
            raise self._LiteBail  # uniform-fit invariant broke
        if row is None and tail is None and not inel_changed and not meta_changed:
            return None
        return (gi, g, fp, row, tail, inel_changed, inel, meta_changed)

    def _apply_group_changes(self, changes) -> tuple:
        """Apply planned group updates to the lite buffers; resort the
        queue order when any sort key churned. Returns (group_rows,
        meta_rows) index lists for the delta record."""
        lite = self._lite
        group_rows: list = []
        meta_rows: list = []
        for gi, g, fp, row, tail, inel_changed, inel, meta_changed in changes:
            if row is not None:
                lite.pad_group_req[gi] = row
                group_rows.append(gi)
            if tail is not None:
                mm, sc, ma, rem = tail
                lite.min_member[gi] = mm
                lite.scheduled[gi] = sc
                lite.matched[gi] = ma
                lite.remaining[gi] = rem
            if inel_changed:
                lite.ineligible[gi] = inel
            if meta_changed:
                meta_rows.append(gi)
            lite.demands[gi] = g
            lite.fps[gi] = fp
        if meta_rows:
            self._lite_resort()
        return group_rows, meta_rows

    def _lite_resort(self) -> None:
        """A queue sort key (priority / creation_ts) churned: rebuild the
        order permutation, creation ranks and meta columns WHOLESALE
        (replaced, never mutated — emitted snapshots share the old
        arrays). The O(G log G) host sort stays authoritative; the device
        derives the same permutation from the meta columns
        (ops.device_state)."""
        lite = self._lite
        g, gb = lite.g, lite.gb
        demands = lite.demands
        order_host = sorted(
            range(g),
            key=lambda i: (
                -demands[i].priority,
                demands[i].creation_ts,
                demands[i].full_name,
            ),
        )
        ranks = np.empty(g, dtype=np.int32)
        ranks[order_host] = np.arange(g, dtype=np.int32)
        order = np.concatenate(
            [
                np.asarray(order_host, dtype=np.int32),
                np.arange(g, gb, dtype=np.int32),
            ]
        )
        creation_rank = np.full(gb, gb - 1, dtype=np.int32)
        creation_rank[:g] = ranks
        inv_prio, ts_hi, ts_lo = _meta_columns(demands, gb)
        lite.order = order
        lite.creation_rank = creation_rank
        lite.meta = (inv_prio, ts_hi, ts_lo, lite.meta[3])
        self.order_resorts += 1
        DEFAULT_REGISTRY.counter(
            "bst_refresh_order_resorts_total",
            "Queue-order resorts forced by priority/creation-ts churn on "
            "the snapshot-lite path",
        ).inc()

    def _lite_snapshot(self, delta: SnapshotDelta) -> ClusterSnapshot:
        """Materialise a ClusterSnapshot from the lite working set without
        running __init__: in-place-mutated buffers are copied (a published
        snapshot must not alias buffers this packer mutates), wholesale-
        replaced and immutable ones are shared."""
        lite = self._lite
        snap = ClusterSnapshot.__new__(ClusterSnapshot)
        snap.node_names = lite.node_names_list
        snap.group_names = lite.group_names_list
        snap.groups = list(lite.demands)
        snap._node_index = lite.node_index
        snap._group_index = lite.group_index
        snap.schema = self.schema
        snap.num_nodes = lite.n
        snap.num_groups = lite.g
        snap.alloc = lite.pad_alloc
        snap.requested = lite.pad_requested.copy()
        snap.group_req = lite.pad_group_req.copy()
        snap.remaining = lite.remaining.copy()
        snap.fit_mask = lite.fit_row
        snap.group_valid = lite.group_valid
        snap.order = lite.order
        snap.min_member = lite.min_member.copy()
        snap.scheduled = lite.scheduled.copy()
        snap.matched = lite.matched.copy()
        snap.ineligible = lite.ineligible.copy()
        snap.creation_rank = lite.creation_rank
        snap.node_valid = lite.node_valid
        snap.meta_cols = lite.meta
        snap.delta = delta
        snap.event_fold = None
        snap.lite_fps = list(lite.fps)  # audit v2 re-fold base, as above
        snap.policy_engine = None  # the lite state exists with policy off only
        snap.policy_cols = None
        return snap

    def _lite_emit(
        self, node_rows, group_rows, meta_rows, source: str
    ) -> ClusterSnapshot:
        self.generation += 1
        delta = SnapshotDelta(
            self.generation,
            "delta",
            node_rows=np.asarray(node_rows, dtype=np.int32),
            group_rows=np.asarray(group_rows, dtype=np.int32),
            source=source,
            meta_rows=np.asarray(meta_rows, dtype=np.int32),
        )
        self.last_delta = delta
        self.delta_packs += 1
        self.last_rows_rewritten = len(node_rows)
        self.rows_rewritten += self.last_rows_rewritten
        _count_rows_rewritten(self.last_rows_rewritten)
        DEFAULT_REGISTRY.counter(
            "bst_refresh_lite_packs_total",
            "Snapshot-lite packs that skipped the full ClusterSnapshot "
            "construction, by refresh path (scan | fold)",
        ).inc(path="fold" if source == "events" else "scan")
        return self._lite_snapshot(delta)

    def _lite_delta_pack(self, groups, node_idx) -> Optional[ClusterSnapshot]:
        """Lite scan pack: the node side is already rewritten in place
        (_delta_rows writes through the padded-buffer view); one O(G)
        compare over the demand list plans the group side. Returns the
        emitted snapshot, or None to fall back to the full construction
        path — the planner is two-phase, so a bail leaves the buffers
        exactly as the previous pack published them. Raises _SchemaMiss
        exactly like _group_rows (caller keyframes "node-churn")."""
        lite = self._lite
        try:
            changes = []
            for gi, (old_fp, g) in enumerate(zip(lite.fps, groups)):
                c = self._plan_group_change(gi, old_fp, g)
                if c is not None:
                    changes.append(c)
        except self._LiteBail:
            return None
        group_rows, meta_rows = self._apply_group_changes(changes)
        self.lite_packs += 1
        return self._lite_emit(node_idx, group_rows, meta_rows, "scan")

    def pack_fold(
        self, node_updates, group_updates
    ) -> Optional[ClusterSnapshot]:
        """O(churn) event-fold pack: rewrite ONLY the named entities —
        nothing else is read, which is the whole point. Caller contract
        (core.oracle_scorer._try_fold): the node list, gang set and every
        unnamed entity's state are UNCHANGED since the last pack — proven
        by the event log's version-bump accounting and the status cache's
        mutation counter, never assumed. Returns None when the fold does
        not apply (no lite state, unknown name, schema covers miss, bound
        violation): the caller falls back to the full scan ``pack()``,
        which is always correct.

        ``node_updates``: iterable of ``(node_name, requested_dict)``
        (fresh ``cluster.node_requested`` reads);
        ``group_updates``: iterable of fresh ``GroupDemand`` reads for
        the named gangs. The fold is idempotent — updates carry current
        state, not event payloads, so a name folded twice converges."""
        lite = self._lite
        if lite is None or self.schema is None:
            return None
        schema = self.schema
        node_plan: list = []
        try:
            for name, d in node_updates:
                i = lite.node_index.get(name)
                if i is None:
                    return None
                if d == self._req_dicts[i]:
                    continue
                key = tuple(sorted(d.items()))
                row = self._req_row_memo.get(key)
                if row is None:
                    if not schema.covers([d]):
                        return None
                    row = schema.pack(d)
                    self._req_row_memo[key] = row
                node_plan.append((i, row, dict(d)))
            changes = []
            for g in group_updates:
                gi = lite.group_index.get(g.full_name)
                if gi is None:
                    return None
                c = self._plan_group_change(gi, lite.fps[gi], g)
                if c is not None:
                    changes.append(c)
        except (self._SchemaMiss, self._LiteBail):
            return None
        node_rows: list = []
        for i, row, d in node_plan:
            # writes through the same padded buffer _delta_rows targets
            # (self._requested is its [:n] view)
            lite.pad_requested[i] = row
            self._req_dicts[i] = d
            node_rows.append(i)
        group_rows, meta_rows = self._apply_group_changes(changes)
        self.fold_packs += 1
        return self._lite_emit(node_rows, group_rows, meta_rows, "events")

    def _policy_node_rows(self, nodes) -> Optional[tuple]:
        """Persistent node policy columns: rewrite only rows whose LABELS
        changed (the spread key lives in the labels). Returns (hash[N, H],
        dom[N]) copies for the snapshot, or None when no enabled engine is
        attached."""
        engine = self.policy_engine
        if engine is None or not engine.enabled:
            return None
        from ..policy.terms import HASH_LANES, node_policy_row

        spread_key = engine.config.spread_node_key
        n = len(nodes)
        if self._policy_hash is None or self._policy_hash.shape != (n, HASH_LANES):
            self._policy_hash = np.zeros((n, HASH_LANES), np.int32)
            self._policy_dom = np.zeros(n, np.int32)
            self._policy_labels = [None] * n
        rewritten_idx: list = []
        truncated = 0
        for i, node in enumerate(nodes):
            labels = node.metadata.labels or {}
            key = tuple(sorted(labels.items()))
            if self._policy_labels[i] == key:
                continue
            self._policy_hash[i], self._policy_dom[i], trunc = node_policy_row(
                labels, spread_key
            )
            self._policy_labels[i] = key
            rewritten_idx.append(i)
            truncated += trunc
        self.policy_rows_rewritten = len(rewritten_idx)
        self._policy_rows_idx = rewritten_idx
        if rewritten_idx:
            DEFAULT_REGISTRY.counter(
                "bst_pack_policy_rows_rewritten",
                "Node policy (label-hash/spread-domain) rows rewritten by "
                "the delta snapshot packer",
            ).inc(len(rewritten_idx))
        if truncated:
            _count_label_truncations(truncated)
        return self._policy_hash.copy(), self._policy_dom.copy()

    def pack(
        self,
        nodes: Sequence[Node],
        node_requested: Dict[str, Dict[str, int]],
        groups: Sequence[GroupDemand],
    ) -> ClusterSnapshot:
        """Build one ClusterSnapshot, rewriting only churned rows when the
        cached schema and node list still hold."""
        alloc_dicts = [n.status.allocatable for n in nodes]
        req_dicts = [node_requested.get(n.metadata.name, {}) for n in nodes]
        names = tuple(n.metadata.name for n in nodes)
        group_names = tuple(g.full_name for g in groups)
        if names != self._node_names:
            # node list changed: the policy row cache is positionally keyed
            self._policy_hash = None

        had_prev = self._alloc is not None
        keyframe_reason = None
        node_idx: list = []
        group_req = None
        if had_prev and names == self._node_names:
            try:
                node_idx = self._delta_rows(nodes, req_dicts)
                # snapshot-lite fast path: positionally-stable node list
                # AND gang set, uniform fit — emit straight from the
                # persistent padded working set (no pad copies, no fit
                # scan, no sort)
                if (
                    self._lite is not None
                    and group_names == self._lite.group_names
                ):
                    snap = self._lite_delta_pack(groups, node_idx)
                    if snap is not None:
                        return snap
                group_req = self._group_rows(groups)
                self.delta_packs += 1
                self.last_rows_rewritten = len(node_idx)
            except self._SchemaMiss:
                group_req = None
                keyframe_reason = "node-churn"
        elif had_prev:
            keyframe_reason = "node-list"
        else:
            keyframe_reason = "first"
        if group_req is None:
            self._full_repack(nodes, alloc_dicts, req_dicts, groups)
            group_req = self._group_rows(groups)
        self.rows_rewritten += self.last_rows_rewritten
        _count_rows_rewritten(self.last_rows_rewritten)

        # group-side churn: with the group NAME SET stable, row indices are
        # positional and the per-row diff against the previous pack is the
        # scatter list; a changed set invalidates positional indices (and
        # the lane-side delta stays host-valid — only CONSUMERS of the
        # record must resync from a keyframe)
        group_idx: list = []
        if keyframe_reason is None:
            if (
                group_names != self._group_names
                or self._group_prev is None
                or self._group_prev.shape != group_req.shape
            ):
                keyframe_reason = "group-set"
            elif len(groups):
                group_idx = np.nonzero(
                    (group_req != self._group_prev).any(axis=1)
                )[0].tolist()
        self._group_names = group_names
        self._group_prev = group_req  # read-only on both sides; no copy

        node_policy = self._policy_node_rows(nodes)
        self.generation += 1
        if keyframe_reason is None:
            delta = SnapshotDelta(
                self.generation,
                "delta",
                node_rows=np.asarray(node_idx, np.int32),
                group_rows=np.asarray(group_idx, np.int32),
                policy_node_rows=np.asarray(self._policy_rows_idx, np.int32),
            )
        else:
            delta = SnapshotDelta(
                self.generation, "keyframe", reason=keyframe_reason
            )
        self.last_delta = delta

        snap = ClusterSnapshot(
            nodes,
            node_requested,
            groups,
            schema=self.schema,
            alloc_lanes=self._alloc.copy(),
            requested_lanes=self._requested,  # ClusterSnapshot copies
            group_req_lanes=group_req,  # freshly allocated per pack
            policy_engine=self.policy_engine,
            node_policy_lanes=node_policy,
        )
        snap.delta = delta
        # every full construction re-captures (or drops) the lite working
        # set — keyframes and legacy deltas both leave it coherent
        self._capture_lite(snap, nodes, groups)
        return snap
