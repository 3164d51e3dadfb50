"""Policy term registry: each policy is a pure function of the packed
policy columns, composed per gang into the assignment scan's selection
key.

The port of ``batch_scheduler_tpu/policy/terms.py``, with the terms as
functions on int32 tensors. They are the plain versions the policy scan
kernel (``csrc/assign_scan.cu``'s composite-key variant, through
``ops.assign_scan.assign_gangs_policy_cuda``) is held against.

Packed columns (built on the host once per snapshot, ops.snapshot):

- ``prio[G]``       priority class per gang (the field queue order sorts on)
- ``aff[G]``        soft-affinity label hash (0 = no preference)
- ``anti[G]``       anti-affinity label hash (0 = none; HARD exclusion)
- ``gang_dom[G,D]`` members of the gang already placed per spread-domain
                    bucket (all zero when the gang did not opt into spread)
- ``node_hash[N,H]`` label hashes of each node's first H labels (0-padded)
- ``node_dom[N]``   spread-domain bucket of each node

A term maps those to either a per-node int32 PENALTY (soft: added to the
tightness bucket so penalized nodes are consumed later, never excluded) or
a per-node 0/1 KEEP mask (hard: multiplied into the gang's capacity row).
With every term disabled the composite is identically zero / all ones, so
policy-off batches equal the base scan by construction.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, Tuple

import numpy as np
import torch

__all__ = [
    "DOMAIN_BUCKETS",
    "HASH_LANES",
    "TERM_REGISTRY",
    "SCORING_TERMS",
    "register_term",
    "label_hash",
    "parse_label_ref",
    "node_policy_row",
    "compose_terms",
    "compose_keep_dense",
]

# Spread-domain hash buckets: a hash collision only makes two domains share
# a spread count (more spreading), never an unsafe placement.
DOMAIN_BUCKETS = 16

# Label-hash lanes per node: the first H node labels (sorted by key) ride
# the packed column; affinity against a label beyond the H-th never
# matches.
HASH_LANES = 4


def label_hash(key: str, value: str) -> int:
    """Stable positive int32 hash of one ``key=value`` label pair; never 0
    (0 is the empty-lane sentinel in the packed columns)."""
    h = zlib.crc32(f"{key}={value}".encode()) & 0x7FFFFFFF
    return h or 1


def parse_label_ref(raw: str) -> Tuple[str, str]:
    """Parse a policy label value naming a node label: "key:value" (or the
    "key=value" spelling). Returns ("", "") for an unparseable value: a
    mistyped policy label degrades to "no constraint", never to an error
    while packing."""
    for sep in (":", "="):
        if sep in raw:
            k, _, v = raw.partition(sep)
            if k and v:
                return k, v
    return "", ""


def node_policy_row(labels: Dict[str, str], spread_key: str):
    """One node's packed policy columns: (hash_lanes[H], domain_bucket,
    truncated_label_count). Host numpy, called by the packer once per node
    whose labels changed."""
    row = np.zeros(HASH_LANES, np.int32)
    keys = sorted(labels)
    for i, k in enumerate(keys[:HASH_LANES]):
        row[i] = label_hash(k, labels[k])
    dom = 0
    sv = labels.get(spread_key)
    if sv is not None:
        dom = label_hash(spread_key, sv) % DOMAIN_BUCKETS
    return row, dom, max(0, len(keys) - HASH_LANES)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

# name -> (kind, fn). Kinds:
#   "penalty"  fn(ctx) -> pen[N] int32 >= 0 added into the selection key
#   "mask"     fn(ctx) -> keep[N] int32 0/1 multiplied into capacity
#   "gate"     no device fn; toggles a control-plane behavior (preemption)
# ctx is a dict of per-gang scalars, node columns and weights (see
# compose_terms for the keys).
TERM_REGISTRY: Dict[str, Tuple[str, Callable]] = {}


def register_term(name: str, kind: str = "penalty"):
    """Register one policy term (decorator)."""

    def deco(fn):
        TERM_REGISTRY[name] = (kind, fn)
        return fn

    return deco


@register_term("affinity", "penalty")
def _affinity_term(ctx):
    """Soft node affinity: a gang with ``aff`` set pays ``w_aff`` on every
    node whose label lanes do not contain the hash."""
    aff = ctx["aff"]
    match = (ctx["node_hash"] == aff).any(dim=-1)  # [N]
    want = aff > 0
    return torch.where(want & ~match, ctx["w_aff"], 0).to(torch.int32)


@register_term("anti-affinity", "mask")
def _anti_affinity_term(ctx):
    """Hard anti-affinity: nodes carrying the gang's ``anti`` label leave
    its capacity row, like a failed node selector."""
    anti = ctx["anti"]
    hit = (ctx["node_hash"] == anti).any(dim=-1)  # [N]
    return torch.where((anti > 0) & hit, 0, 1).to(torch.int32)


@register_term("spread", "penalty")
def _spread_term(ctx):
    """Spread penalty: a node whose spread domain already holds k of this
    gang's members pays ``w_spread * min(k, spread_cap)``. A domain index
    outside the row is clamped into it (the reference's
    ``jnp.take(..., mode="clip")``)."""
    dom_row = ctx["gang_dom"]
    occupancy = dom_row[ctx["node_dom"].clamp(0, dom_row.shape[0] - 1).long()]
    return (torch.minimum(occupancy, ctx["spread_cap"]) * ctx["w_spread"]).to(torch.int32)


# Preemption is a control-plane gate, not a device scoring term: enabling
# it arms the victim planner (policy.preempt) on the deny path.
register_term("preempt", "gate")(lambda ctx: None)

# Terms with a device-side scoring contribution, in composite order.
SCORING_TERMS = ("affinity", "anti-affinity", "spread")


def compose_terms(terms: tuple, weights: tuple):
    """Compose the enabled scoring terms into one per-gang function
    ``fn(aff, anti, dom_row, node_hash, node_dom) -> (pen[N], keep[N])``.

    ``terms`` is the tuple of enabled term names and ``weights`` the
    ``(w_aff, w_spread, spread_cap)`` triple. Unknown names are ignored
    (a version-skewed config degrades, it does not fail a batch); "gate"
    terms contribute nothing here."""
    w_aff, w_spread, spread_cap = (tuple(weights) + (0, 0, 0))[:3]
    consts = {}  # device -> the three weights as int32 scalars, made once

    def fn(aff, anti, dom_row, node_hash, node_dom):
        dev = node_dom.device
        if dev not in consts:
            consts[dev] = tuple(torch.tensor(w, dtype=torch.int32, device=dev)
                                for w in (w_aff, w_spread, spread_cap))
        ctx = {
            "aff": aff,
            "anti": anti,
            "gang_dom": dom_row,
            "node_hash": node_hash,
            "node_dom": node_dom,
            **dict(zip(("w_aff", "w_spread", "spread_cap"), consts[dev])),
        }
        n = node_dom.shape[0]
        pen = torch.zeros(n, dtype=torch.int32, device=dev)
        keep = torch.ones(n, dtype=torch.int32, device=dev)
        for name in terms:
            entry = TERM_REGISTRY.get(name)
            if entry is None:
                continue
            kind, term = entry
            if kind == "penalty":
                pen = pen + term(ctx)
            elif kind == "mask":
                keep = keep * term(ctx)
        return pen, keep

    return fn


def compose_keep_dense(terms: tuple, anti, node_hash):
    """The [G, N] hard-mask product of every enabled mask term, applied to
    the batch head's capacity matrix so feasibility and scores agree with
    what the policy scan will refuse to take. The only mask term is
    anti-affinity; unknown names are ignored like compose_terms."""
    if "anti-affinity" not in terms:
        return torch.ones((anti.shape[0], 1), dtype=torch.int32, device=anti.device)
    hit = (node_hash[None, :, :] == anti[:, None, None]).any(dim=-1)  # [G, N]
    return torch.where((anti[:, None] > 0) & hit, 0, 1).to(torch.int32)
