"""Resource lanes: the fixed vector layout resources are packed into on device.

The reference models resources as a Go struct of int64 fields plus a scalar
map (``nodeinfo.Resource`` handled at reference pkg/scheduler/core/core.go:
656-668). Here it is a dense ``int32[R]`` lane vector, so a whole cluster becomes one
``int32[N, R]`` array the oracle streams through on the device.

Lane units are chosen so exact integer comparison semantics survive int32.
Every lane value is bounded by ``LANE_MAX = 2**30`` — the clamped domain of
the oracle's member-capacity division (ops.oracle._member_capacity), shared
with the JAX reference so both packages compute on identical lanes:

- ``cpu``                millicores   (max ~1.07M cores/node)
- ``memory``             KiB          (max 1 TiB/node at shift 0)
- ``ephemeral-storage``  KiB          (max 1 TiB/node at shift 0)
- ``pods``               count
- extended resources     raw integer counts

Values larger than the base unit allows (the reference carries int64
quantities with no cap) do NOT abort packing. Two mechanisms keep big
clusters schedulable:

1. **Per-lane auto-scaling**: ``LaneSchema.collect`` inspects every value in
   the snapshot and gives each lane a power-of-two ``shift`` so the largest
   observed value fits below ``LANE_MAX``. A 2 TiB-memory node simply packs
   in 2 KiB units for that snapshot. Capacities round **down** and requests
   round **up** in the shifted unit, so ``capacity >= request`` can never
   pass due to rounding.
2. **Safe saturation**: a value outside the shifted domain of the schema it
   is packed with (a schema collected from other dicts) never aborts. ``pack`` then clamps instead of raising: capacities clamp
   to ``LANE_MAX - 1`` (a conservative *underestimate* — the node still
   schedules, it just looks no larger than the domain bound) and requests
   clamp to ``LANE_MAX`` (strictly above any clamped capacity, so an
   unrepresentable request can never be falsely admitted).

Gang feasibility on device is computed in *member counts* (small integers),
never in raw byte sums, which is what keeps 5k-node clusters inside int32
(see ops.oracle).
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LaneSchema", "CORE_LANES", "INT32_MAX", "LANE_MAX"]

CORE_LANES: Tuple[str, ...] = ("cpu", "memory", "ephemeral-storage", "pods")
# Lanes stored as KiB on device (canonical host unit is bytes).
_KIB_LANES = frozenset({"memory", "ephemeral-storage"})

INT32_MAX = np.int32(2**31 - 1)
# Hard per-value bound: the member-capacity division domain (see module doc).
LANE_MAX = np.int32(2**30)


def _to_device_unit(name: str, value: int, *, capacity: bool) -> int:
    if name in _KIB_LANES:
        if capacity:
            return value // 1024
        return -((-value) // 1024)  # ceil
    return value


def _apply_shift(value: int, shift: int, *, capacity: bool) -> int:
    if shift == 0:
        return value
    if capacity:
        return value >> shift  # floor (arithmetic shift: floor for negatives too)
    return -((-value) >> shift)  # ceil


class LaneSchema:
    """Maps resource names <-> lane indices (+ per-lane unit shifts) for one
    cluster snapshot."""

    def __init__(
        self,
        extended: Sequence[str] = (),
        shifts: Optional[Dict[str, int]] = None,
    ):
        self.names: Tuple[str, ...] = CORE_LANES + tuple(extended)
        self.index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}
        # Per-lane power-of-two unit coarsening (see module doc, mechanism 1).
        self.shifts: Tuple[int, ...] = tuple(
            int((shifts or {}).get(n, 0)) for n in self.names
        )
        self._warned_clamp = False

    @property
    def num_lanes(self) -> int:
        return len(self.names)

    @classmethod
    def collect(cls, resource_dicts: Iterable[Dict[str, int]]) -> "LaneSchema":
        """Build a schema covering every resource name seen in the snapshot,
        with per-lane shifts sized so every observed value packs exactly."""
        extended = set()
        max_seen: Dict[str, int] = {}
        for d in resource_dicts:
            for name, value in d.items():
                if name not in CORE_LANES:
                    extended.add(name)
                # Conservative bound: the ceil-rounded request conversion is
                # the larger of the two unit conversions by at most 1.
                dev = abs(_to_device_unit(name, int(value), capacity=False))
                if dev > max_seen.get(name, 0):
                    max_seen[name] = dev
        shifts = {}
        for name, peak in max_seen.items():
            shift = 0
            while (peak >> shift) >= int(LANE_MAX):
                shift += 1
            if shift:
                shifts[name] = shift
        return cls(sorted(extended), shifts=shifts)

    def pack(self, resources: Dict[str, int], *, capacity: bool = False) -> np.ndarray:
        """Pack one canonical resource dict into an int32[R] lane vector.

        Unknown resource names are an error: schemas are built with
        ``collect`` over the full snapshot, so a miss is a caller bug — and
        silently dropping a lane would break the reference's rule that a
        request for a resource the node lacks must fail feasibility
        (reference pkg/scheduler/core/core.go:686-696).

        Values outside the shifted domain saturate safely instead of
        raising (see module doc, mechanism 2).
        """
        vec = np.zeros(self.num_lanes, dtype=np.int64)
        for name, value in resources.items():
            i = self.index.get(name)
            if i is None:
                raise KeyError(f"resource {name!r} not in lane schema {self.names}")
            vec[i] = self._lane_value(i, name, value, capacity)
        cap_bound = self._domain_bound(capacity)
        if (vec > cap_bound).any() or (vec < -cap_bound).any():
            if not self._warned_clamp:
                self._warned_clamp = True
                warnings.warn(
                    f"resource vector exceeds the shifted lane domain and was "
                    f"clamped ({'capacity floor' if capacity else 'request'} "
                    f"bound {cap_bound}): {dict(zip(self.names, vec))}; "
                    "re-collect the schema to restore exact packing"
                )
            np.clip(vec, -cap_bound, cap_bound, out=vec)
        return vec.astype(np.int32)

    def covers(self, resource_dicts: Sequence[Dict[str, int]]) -> bool:
        """True iff every name is in the schema AND every (request-side)
        value packs exactly (no clamp): the validity check for packing a
        churned row under a cached schema (ops.snapshot.DeltaSnapshotPacker)
        instead of re-collecting."""
        bound = self._domain_bound(capacity=False)
        for d in resource_dicts:
            for name, value in d.items():
                i = self.index.get(name)
                if i is None:
                    return False
                v = self._lane_value(i, name, value, capacity=False)
                if v > bound or v < -bound:
                    return False
        return True

    def _lane_value(self, i: int, name: str, value: int, capacity: bool) -> int:
        """The shifted device-unit value lane ``i`` would store for
        ``value``."""
        dev = _to_device_unit(name, int(value), capacity=capacity)
        return _apply_shift(dev, self.shifts[i], capacity=capacity)

    @staticmethod
    def _domain_bound(capacity: bool) -> int:
        return int(LANE_MAX) - 1 if capacity else int(LANE_MAX)

    def pack_many(
        self, dicts: Sequence[Dict[str, int]], *, capacity: bool = False
    ) -> np.ndarray:
        """Pack a sequence of resource dicts into int32[len, R].

        Identical dicts (the overwhelmingly common case: homogeneous node
        pools, uniform gang members) are packed once and memoized — this is
        the 5k-node snapshot hot loop on the host."""
        if not dicts:
            return np.zeros((0, self.num_lanes), dtype=np.int32)
        out = np.empty((len(dicts), self.num_lanes), dtype=np.int32)
        memo = {}
        for i, d in enumerate(dicts):
            key = tuple(sorted(d.items()))
            row = memo.get(key)
            if row is None:
                row = self.pack(d, capacity=capacity)
                memo[key] = row
            out[i] = row
        return out
