"""The gang-placement scans as hand-written CUDA kernels, with their plain
PyTorch versions and launch counters.

The port's counterpart of ``batch_scheduler_tpu/ops/pallas_assign.py``
``assign_gangs_pallas``: the serial scan (``_kernel``) is
``csrc/assign_scan.cu``, the wavefront scan (``_kernel_wave``) is
``csrc/assign_wave.cu``; each source's header says what bounds it and how
it is laid out. ``ops/_build.py`` compiles them with ``nvcc`` at first use.

``assign_gangs_cuda`` takes the same arguments and returns the same
``(alloc[G,N] int32, placed[G] bool, left_after[N,R] int32)`` as the plain
``assign_gangs_plain`` (``ops.oracle.assign_gangs``). Its kernel runs as
one thread-block cluster laid out by ``kernel_plan`` and divides by the
multiply-shift numbers of ``division_magic``;
``assign_gangs_wave_cuda`` adds the wave width and returns the per-wave
``(conflicts, megas)`` flags too, as ``ops.oracle.assign_gangs_wavefront``
does with ``with_stats=True``. Its kernel is a cluster too
(``wave_kernel_plan``); the uniform flags depend on the inputs alone, and
a prepare kernel computes them (plain version: ``wave_uniform``) with the
division numbers before the scan. ``assign_gangs_policy_cuda`` is the
serial scan with the policy terms' composite selection key
(``ops.oracle.assign_gangs_policy``): the serial kernel's source built
with ``BST_POLICY_SCAN`` (library ``assign_policy``), laid out by
``kernel_plan(..., policy=True)``. ``assign_gangs_topk_cuda`` is the
hierarchical top-K scan (``ops.oracle.assign_gangs_topk``, whose reference
is lax): ``csrc/assign_topk.cu``, a cluster laid out by
``topk_kernel_plan`` after a prepare kernel of its own (each position's
gang row with its division numbers, and the uniform flags), returning the
three per-wave series. For tensors on the CPU each runs its
plain version; for CUDA tensors it launches its kernel or raises. There is
no switch that turns a kernel off.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.metrics import DEFAULT_REGISTRY
from . import _build
from .lanes import LANE_MAX
from .oracle import assign_gangs as assign_gangs_plain
from .oracle import assign_gangs_policy, assign_gangs_topk, assign_gangs_wavefront

__all__ = [
    "assign_gangs_cuda", "assign_gangs_plain", "assign_gangs_policy_cuda",
    "assign_gangs_topk_cuda", "assign_gangs_wave_cuda", "division_magic", "kernel_plan",
    "policy_scan_plan", "scan_plan", "ScanPlan", "shard_apply_cuda", "shard_summary_cuda",
    "topk_kernel_plan", "topk_kernel_shared_need", "topk_scan_plan", "TopkPlan",
    "wave_kernel_plan", "wave_scan_plan", "wave_uniform", "CLUSTER_SIZES", "WAVE_WIDTHS",
]

_THREADS = 1024  # the kernels' largest block
WAVE_WIDTHS = (2, 4, 8, 16, 32)  # the widths ops.bucketing.wave_width_bucket gives
_MAX_WAVE = 32  # the wave kernel sizes its inboxes and stage for this width
_MAX_TOPK = 128  # the top-K kernel's widest candidate slice (topk_bucket's top)
# the kernels' cluster sizes, largest first: 16 needs the non-portable
# cluster size, 8 is the portable limit
CLUSTER_SIZES = (16, 8)
_MIN_BLOCK_NODES = 256  # below this many nodes a block, fewer blocks
# nodes a thread that either kernel keeps per node across a step; a plan
# with more (buckets past 2^20 nodes) runs them as slabs of this many, with
# the leftover in global scratch
_PER_THREAD_MAX = 64
# assign_wave.cu's shared-memory layout, in ints: kInbox (16 block slots of
# a 128-bin histogram and a 4-int flag word) and kStageRows (a wave's
# indices, needs and flag, ahead of its request rows)
_K_INBOX = 16 * (128 + 4)
_K_STAGE_ROWS = 100
# the policy variant of the serial kernel (assign_scan.cu built with
# BST_POLICY_SCAN): each gang's policy row (aff, anti and its 16 spread
# domain counts, padded to 20 ints), staged by 18 threads into one of two
# parity slots; and the node columns (4 label hashes and the spread domain,
# 5 ints a node) beside a leftover kept in shared memory
_POLICY_ROW = 20
_POLICY_STAGERS = 18
_POLICY_NODE_INTS = 5
_HASH_LANES, _DOMAIN_BUCKETS = 4, 16  # policy.terms' HASH_LANES, DOMAIN_BUCKETS


# the launch entry point's C signature, bst_<name>(pointers..., ints..., stream)
_LAUNCH_ARGS = {"assign_scan": (11, 10), "assign_wave": (14, 11), "assign_policy": (16, 14),
                "assign_topk": (15, 16)}


@functools.lru_cache(maxsize=None)
def _entry_points(name: str):
    """(launch, shared_budget, error_string) of ``csrc/<name>.cu``."""
    lib = _build.library(name)
    launch = getattr(lib, f"bst_{name}")
    pointers, ints = _LAUNCH_ARGS[name]
    launch.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    budget = getattr(lib, f"bst_{name}_shared_budget")
    budget.argtypes = [ctypes.c_int]
    budget.restype = ctypes.c_int
    err = lib.bst_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return launch, budget, err


@functools.lru_cache(maxsize=None)
def _shared_budget(device_index: int, name: str = "assign_scan") -> int:
    _, budget, err = _entry_points(name)
    got = budget(device_index)
    if got < 0:
        raise RuntimeError(
            f"{name} shared-memory query failed: "
            f"{err(-got).decode(errors='replace')}"
        )
    return got


class ScanPlan(NamedTuple):
    """A scan kernel's launch shape. Block b of the cluster owns nodes
    ``[b * block_nodes, (b + 1) * block_nodes)`` (cut at N), each thread
    ``per_thread`` consecutive ones. The leftover lives in each block's
    shared memory (``leftover == "shared"``) or in a global scratch slab of
    ``scratch_ints`` ints; ``shared_bytes`` is the dynamic shared memory."""

    cluster_blocks: int
    block_nodes: int
    threads: int
    per_thread: int
    leftover: str
    shared_bytes: int
    scratch_ints: int


def kernel_plan(n: int, r: int, cluster_max: int, shared_budget: int,
                policy: bool = False) -> ScanPlan:
    """The serial kernel's launch shape for N nodes and R lanes, with at
    most ``cluster_max`` blocks and ``shared_budget`` bytes of dynamic
    shared memory a block (``bst_assign_scan_shared_budget``); with
    ``policy`` the shape of its policy variant (see below).

    C is the largest power of two <= ``cluster_max`` that leaves each block
    at least 256 nodes (1 for small buckets). A block has ceil(N/C) nodes,
    each thread the fewest that 1024 threads allow. Dynamic shared memory
    holds two staged gang rows (4 ints a lane: request, magic, shift,
    padding) and two 128-bin histograms a warp, and the leftover (R ints a
    node) when it fits the budget beside them; else the leftover goes in
    global scratch. Past 64 nodes a thread (buckets above 2^20 nodes at 16
    blocks) the kernel runs a thread's nodes as slabs of 64, from global
    scratch.

    The policy variant also stages each gang's policy row (18 more staging
    threads, two rows of 20 ints) and, when the leftover is in shared
    memory, keeps the node columns there beside it (5 ints a node); with
    the leftover in global scratch it reads them from the inputs."""
    stagers = 3 * r + (_POLICY_STAGERS if policy else 0)
    if stagers > _THREADS:
        raise ValueError(f"{r} lanes exceed the scan kernel's {_THREADS // 3}")
    c, block_nodes, per = _node_split(n, cluster_max)
    threads = max(-(-block_nodes // per), stagers)
    threads = -(-threads // 32) * 32
    # gang rows, policy rows, warp histograms
    fixed = 2 * 4 * r + (2 * _POLICY_ROW if policy else 0) + 2 * (threads // 32) * 128
    leftover = (r + (_POLICY_NODE_INTS if policy else 0)) * per * threads
    if per <= _PER_THREAD_MAX and 4 * (fixed + leftover) <= shared_budget:
        return ScanPlan(c, block_nodes, threads, per, "shared", 4 * (fixed + leftover), 0)
    return ScanPlan(c, block_nodes, threads, per, "global", 4 * fixed, c * r * per * threads)


def _node_split(n: int, cluster_max: int) -> tuple:
    """(C, nodes a block, nodes a thread): C is the largest power of two
    <= ``cluster_max`` that leaves each block at least 256 nodes (1 for
    small buckets), a block has ceil(N/C) nodes, each thread the fewest
    that 1024 threads allow."""
    c = 1
    while c * 2 <= cluster_max and c * 2 * _MIN_BLOCK_NODES <= n:
        c *= 2
    block_nodes = max(-(-n // c), 1)
    return c, block_nodes, -(-block_nodes // _THREADS)


def wave_kernel_plan(n: int, r: int, cluster_max: int, shared_budget: int) -> ScanPlan:
    """The wave kernel's launch shape for N nodes and R lanes, with at most
    ``cluster_max`` blocks and ``shared_budget`` bytes of dynamic shared
    memory a block (``bst_assign_wave_shared_budget``). The node split is
    the serial kernel's (``kernel_plan``); threads cover a block's nodes.
    Dynamic shared memory holds two inboxes of 16 slots (a histogram and a
    flag word, 132 ints each), two stages of a wave's gangs (100 ints of
    indices, needs and flag, and 4 ints a lane for each of 32 positions:
    request, magic, shift, padding) and two 128-bin histograms a warp; the
    leftover and the checked replay's wave-start leftover (R ints a node
    each) join them when they fit the budget, else both go in global
    scratch, as they always do past 64 nodes a thread (the kernel's slabs).
    The shape does not depend on the width."""
    c, block_nodes, per = _node_split(n, cluster_max)
    threads = -(-block_nodes // per)
    threads = -(-threads // 32) * 32
    # inboxes, stages, warp histograms
    fixed = 2 * _K_INBOX + 2 * (_K_STAGE_ROWS + 4 * _MAX_WAVE * r) + 2 * (threads // 32) * 128
    leftover = 2 * r * per * threads  # the leftover and the wave-start leftover
    if per <= _PER_THREAD_MAX and 4 * (fixed + leftover) <= shared_budget:
        return ScanPlan(c, block_nodes, threads, per, "shared", 4 * (fixed + leftover), 0)
    return ScanPlan(c, block_nodes, threads, per, "global", 4 * fixed, c * leftover)


def _device_plan(name: str, layout, n: int, r: int, device_index: int) -> ScanPlan:
    """``layout(n, r, cluster_max, budget)`` at the largest of
    ``CLUSTER_SIZES`` that ``cudaOccupancyMaxActiveClusters`` says device
    ``device_index`` can schedule for kernel ``name``. Raises RuntimeError
    when none can be."""
    lib = _build.library(name)
    fits = getattr(lib, f"bst_{name}_clusters")
    fits.argtypes = [ctypes.c_int] * 5
    fits.restype = ctypes.c_int
    _, _, err = _entry_points(name)
    budget = _shared_budget(device_index, name)
    with torch.cuda.device(device_index):
        for cluster_max in CLUSTER_SIZES:
            plan = layout(n, r, cluster_max, budget)
            got = fits(plan.cluster_blocks, plan.threads, plan.per_thread,
                       int(plan.leftover == "shared"), plan.shared_bytes)
            if got < 0:
                raise RuntimeError(
                    f"{name} occupancy query failed for {plan}: "
                    f"{err(-got).decode(errors='replace')}"
                )
            if got > 0:
                return plan
    raise RuntimeError(f"no cluster of the {name} kernel can be scheduled: {plan}")


@functools.lru_cache(maxsize=None)
def scan_plan(n: int, r: int, device_index: int) -> ScanPlan:
    """The plan ``assign_gangs_cuda`` launches on CUDA device
    ``device_index``: ``kernel_plan`` at the largest cluster the device can
    schedule."""
    return _device_plan("assign_scan", kernel_plan, n, r, device_index)


@functools.lru_cache(maxsize=None)
def policy_scan_plan(n: int, r: int, device_index: int) -> ScanPlan:
    """The plan ``assign_gangs_policy_cuda`` launches on CUDA device
    ``device_index``: ``kernel_plan(..., policy=True)`` at the largest
    cluster the device can schedule."""
    return _device_plan("assign_policy", functools.partial(kernel_plan, policy=True),
                        n, r, device_index)


@functools.lru_cache(maxsize=None)
def wave_scan_plan(n: int, r: int, device_index: int) -> ScanPlan:
    """The plan ``assign_gangs_wave_cuda`` launches on CUDA device
    ``device_index``: ``wave_kernel_plan`` at the largest cluster the
    device can schedule."""
    return _device_plan("assign_wave", wave_kernel_plan, n, r, device_index)


def division_magic(divisors: torch.Tensor) -> tuple:
    """``(magic, shift)`` int32 tensors of the divisors' shape: for
    d = clamp(divisor, 1, 2^30), ``shift`` is l = ceil(log2 d) and
    ``magic`` holds the 32 bits of m = floor(2^(31+l) / d) + 1 (< 2^32).
    For every v in [0, 2^30], floor(v / d) = (v * m) >> (31 + l), which the
    scan kernel computes as ``umulhi(v, m) >> (l - 1)`` (v itself when
    l = 0): m * d - 2^(31+l) lies in (0, 2^l], so the rounding error stays
    below one for any v < 2^31."""
    d = divisors.to(torch.int64).clamp(1, int(LANE_MAX))
    powers = torch.ones((), dtype=torch.int64, device=d.device) << torch.arange(
        31, dtype=torch.int64, device=d.device)
    shift = (d[..., None] > powers).sum(-1)  # the powers of two below d
    m = torch.div(torch.ones_like(d) << (31 + shift), d, rounding_mode="floor") + 1
    magic = torch.where(m >= 2**31, m - 2**32, m).to(torch.int32)
    return magic, shift.to(torch.int32)


def wave_uniform(group_req, remaining, fit_mask, order, wave: int):
    """bool[S], S = ceil(G / wave): whether each wave of the scan order takes
    the uniform branch of ``ops.oracle.assign_gangs_wavefront`` — every
    position's request row equals the first's, in per-group mode every mask
    row equals the first's, and the wave's needs sum to at most
    (2^31 - 1) // N. Positions past G (and out-of-range order entries) are
    inert: a zero request row, need 0 and, per group, an empty mask row.
    The flags depend on the inputs alone, so on the card the launch's
    prepare kernel computes them before the scan; this is its plain
    version."""
    g, r = group_req.shape
    n = fit_mask.shape[1]
    steps = -(-g // wave)
    pad = steps * wave - g
    ok = (order >= 0) & (order < g)
    idx = torch.where(ok, order, 0).long()

    def padded(rows):
        return torch.cat([rows, rows.new_zeros((pad,) + rows.shape[1:])]).reshape(
            (steps, wave) + rows.shape[1:])

    req = padded(torch.where(ok[:, None], group_req[idx], 0))
    mega = (req == req[:, :1]).flatten(1).all(dim=1)
    if fit_mask.shape[0] != 1:
        rows = padded(fit_mask[idx] & ok[:, None])
        mega &= (rows == rows[:, :1]).flatten(1).all(dim=1)
    need = padded(torch.where(ok, remaining[idx], 0).to(torch.int64))
    return mega & (need.sum(dim=1) <= (2**31 - 1) // max(n, 1))


def _check(left0, group_req, remaining, fit_mask, order):
    if left0.dim() != 2:
        raise ValueError(f"left0 must be [N,R], got {tuple(left0.shape)}")
    n, r = left0.shape
    g = group_req.shape[0]
    if group_req.shape != (g, r):
        raise ValueError(f"group_req must be [G,{r}], got {tuple(group_req.shape)}")
    if remaining.shape != (g,) or order.shape != (g,):
        raise ValueError(
            f"remaining and order must be [{g}], got "
            f"{tuple(remaining.shape)} and {tuple(order.shape)}"
        )
    if fit_mask.dim() != 2 or fit_mask.shape[1] != n or fit_mask.shape[0] not in (1, g):
        raise ValueError(
            f"fit_mask rows {tuple(fit_mask.shape)} must be [1,{n}] or [{g},{n}]"
        )
    for name, t, dtype in (
        ("left0", left0, torch.int32), ("group_req", group_req, torch.int32),
        ("remaining", remaining, torch.int32), ("fit_mask", fit_mask, torch.bool),
        ("order", order, torch.int32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != left0.device:
            raise ValueError(f"{name} is on {t.device}, left0 on {left0.device}")


def _check_cuda(caller, left0, group_req, remaining, fit_mask, order):
    if left0.device.type != "cuda":
        raise ValueError(f"{caller} takes CPU or CUDA tensors, not {left0.device}")
    for name, t in (("left0", left0), ("group_req", group_req),
                    ("remaining", remaining), ("fit_mask", fit_mask),
                    ("order", order)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _count_launch(kernel: str) -> None:
    """One launch of ``kernel`` into ``bst_kernel_launches_total``: each
    wrapper counts here beside its ``.launches``, where it launches, so a
    process's /metrics carries its kernels' own launch counts."""
    DEFAULT_REGISTRY.counter(
        "bst_kernel_launches_total",
        "Launches of each hand-written kernel, counted by its wrapper",
    ).inc(kernel=kernel)


def assign_gangs_cuda(left0, group_req, remaining, fit_mask, order):
    """The assignment scan: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``order`` must be a permutation of [0, G)
    (``pad_oracle_batch`` builds one). Every launch adds one to
    ``assign_gangs_cuda.launches``."""
    _check(left0, group_req, remaining, fit_mask, order)
    dev = left0.device
    if dev.type == "cpu":
        return assign_gangs_plain(left0, group_req, remaining, fit_mask, order)
    _check_cuda("assign_gangs_cuda", left0, group_req, remaining, fit_mask, order)
    n, r = left0.shape
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = _launch_scan(scan_plan(n, r, index), left0, group_req, remaining, fit_mask, order)
    assign_gangs_cuda.launches += 1
    _count_launch("assign_scan")
    return out


assign_gangs_cuda.launches = 0


def _launch_scan(plan: ScanPlan, left0, group_req, remaining, fit_mask, order):
    """One launch of the serial kernel with ``plan`` on checked CUDA inputs."""
    n, r = left0.shape
    g = group_req.shape[0]
    dev = left0.device
    launch, _, err = _entry_points("assign_scan")
    with torch.cuda.device(dev):
        magic, shift = division_magic(group_req)
        # alloc must start zeroed: the kernel writes only nonzero takes
        alloc = torch.zeros((g, n), dtype=torch.int32, device=dev)
        placed = torch.zeros(g, dtype=torch.bool, device=dev)
        left_after = torch.empty_like(left0)
        scratch = (
            torch.empty(plan.scratch_ints, dtype=torch.int32, device=dev)
            if plan.leftover == "global" else None
        )
        rc = launch(
            left0.data_ptr(), group_req.data_ptr(), remaining.data_ptr(),
            fit_mask.data_ptr(), order.data_ptr(), magic.data_ptr(),
            shift.data_ptr(), alloc.data_ptr(), placed.data_ptr(),
            left_after.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            n, g, r, int(fit_mask.shape[0] != 1), plan.cluster_blocks,
            plan.block_nodes, plan.threads, plan.per_thread,
            int(plan.leftover == "shared"), plan.shared_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"assign_scan kernel launch failed for {plan}: "
            f"{err(rc).decode(errors='replace')} (CUDA error {rc})"
        )
    return alloc, placed, left_after


def assign_gangs_wave_cuda(left0, group_req, remaining, fit_mask, order, wave: int):
    """The wavefront assignment scan at width ``wave`` (one of
    ``WAVE_WIDTHS``): the CUDA kernel for CUDA tensors, the plain
    ``assign_gangs_wavefront(..., with_stats=True)`` for CPU tensors.
    Returns ``(alloc, placed, left_after, (conflicts[S], megas[S]))``,
    S = ceil(G / wave). ``order`` must be a permutation of [0, G) and
    ``remaining`` non-negative (``pad_oracle_batch`` and the packers give
    both). Every launch adds one to ``assign_gangs_wave_cuda.launches``."""
    if not isinstance(wave, int) or wave not in WAVE_WIDTHS:
        raise ValueError(f"wave must be one of {WAVE_WIDTHS}, got {wave!r}")
    _check(left0, group_req, remaining, fit_mask, order)
    dev = left0.device
    if dev.type == "cpu":
        return assign_gangs_wavefront(left0, group_req, remaining, fit_mask,
                                      order, wave=wave, with_stats=True)
    _check_cuda("assign_gangs_wave_cuda", left0, group_req, remaining, fit_mask, order)
    n, r = left0.shape
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = _launch_wave(wave_scan_plan(n, r, index), left0, group_req, remaining,
                       fit_mask, order, wave)
    assign_gangs_wave_cuda.launches += 1
    _count_launch("assign_wave")
    return out


assign_gangs_wave_cuda.launches = 0


def _launch_wave(plan: ScanPlan, left0, group_req, remaining, fit_mask, order, wave: int):
    """One launch of the wave kernel with ``plan`` on checked CUDA inputs."""
    n, r = left0.shape
    g = group_req.shape[0]
    dev = left0.device
    steps = -(-g // wave)
    launch, _, err = _entry_points("assign_wave")
    with torch.cuda.device(dev):
        # written by the launch's prepare kernel: division_magic's numbers
        # and the two halves of wave_uniform's flags (the second half only
        # where a mask row differs, so it starts zeroed)
        magic = torch.empty_like(group_req)
        shift = torch.empty_like(group_req)
        uniform = torch.zeros(2 * steps, dtype=torch.uint8, device=dev)
        megas = torch.empty(steps, dtype=torch.bool, device=dev)
        # alloc must start zeroed: the kernel writes only nonzero takes
        alloc = torch.zeros((g, n), dtype=torch.int32, device=dev)
        placed = torch.zeros(g, dtype=torch.bool, device=dev)
        left_after = torch.empty_like(left0)
        conflicts = torch.empty(steps, dtype=torch.bool, device=dev)
        scratch = (
            torch.empty(plan.scratch_ints, dtype=torch.int32, device=dev)
            if plan.leftover == "global" else None
        )
        rc = launch(
            left0.data_ptr(), group_req.data_ptr(), remaining.data_ptr(),
            fit_mask.data_ptr(), order.data_ptr(), magic.data_ptr(),
            shift.data_ptr(), uniform.data_ptr(), megas.data_ptr(), alloc.data_ptr(),
            placed.data_ptr(), left_after.data_ptr(), conflicts.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            n, g, r, int(fit_mask.shape[0] != 1), wave, plan.cluster_blocks,
            plan.block_nodes, plan.threads, plan.per_thread,
            int(plan.leftover == "shared"), plan.shared_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"assign_wave kernel launch failed for {plan}: "
            f"{err(rc).decode(errors='replace')} (CUDA error {rc})"
        )
    return alloc, placed, left_after, (conflicts, megas)


def _policy_weights(terms, weights) -> tuple:
    """(anti_on, w_aff, w_spread, spread_cap) for the kernel from the
    enabled terms and the ``(w_aff, w_spread, spread_cap)`` weights, as
    ``policy.terms.compose_terms`` composes them: a disabled penalty term
    has weight 0, a term named k times adds its penalty k times (k * w in
    int32, as the sum of k int32 penalties wraps), unknown names are
    ignored. Raises ValueError on a weight outside int32."""
    w_aff, w_spread, spread_cap = (tuple(weights) + (0, 0, 0))[:3]
    for name, w in (("affinity", w_aff), ("spread", w_spread), ("spread cap", spread_cap)):
        if not -(2**31) <= int(w) < 2**31:
            raise ValueError(f"{name} weight {w} is outside int32")

    def wrap(v: int) -> int:
        return (v + 2**31) % 2**32 - 2**31

    terms = tuple(terms)
    return (int("anti-affinity" in terms), wrap(terms.count("affinity") * int(w_aff)),
            wrap(terms.count("spread") * int(w_spread)), int(spread_cap))


def _check_policy(g, n, dev, prio, aff, anti, gang_dom, node_hash, node_dom):
    for name, t, shape in (
        ("prio", prio, (g,)), ("aff", aff, (g,)), ("anti", anti, (g,)),
        ("gang_dom", gang_dom, (g, _DOMAIN_BUCKETS)), ("node_hash", node_hash, (n, _HASH_LANES)),
        ("node_dom", node_dom, (n,)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, left0 on {dev}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def assign_gangs_policy_cuda(left0, group_req, remaining, fit_mask, order, prio, aff,
                             anti, gang_dom, node_hash, node_dom, terms, weights):
    """The policy scan (``ops.oracle.assign_gangs_policy``, whose docstring
    gives the arguments): the composite-key variant of the serial kernel
    for CUDA tensors, the plain version for CPU tensors. The columns are
    int32: ``prio``/``aff``/``anti`` [G], ``gang_dom`` [G, 16],
    ``node_hash`` [N, 4], ``node_dom`` [N]. ``order`` must be a permutation
    of [0, G). Every launch adds one to
    ``assign_gangs_policy_cuda.launches``."""
    _check(left0, group_req, remaining, fit_mask, order)
    dev = left0.device
    n, r = left0.shape
    _check_policy(group_req.shape[0], n, dev, prio, aff, anti, gang_dom, node_hash, node_dom)
    if dev.type == "cpu":
        return assign_gangs_policy(left0, group_req, remaining, fit_mask, order, prio, aff,
                                   anti, gang_dom, node_hash, node_dom, terms, weights)
    _check_cuda("assign_gangs_policy_cuda", left0, group_req, remaining, fit_mask, order)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = _launch_policy(policy_scan_plan(n, r, index), left0, group_req, remaining,
                         fit_mask, order, aff, anti, gang_dom, node_hash, node_dom,
                         _policy_weights(terms, weights))
    assign_gangs_policy_cuda.launches += 1
    _count_launch("assign_policy")
    return out


assign_gangs_policy_cuda.launches = 0


def _launch_policy(plan: ScanPlan, left0, group_req, remaining, fit_mask, order, aff, anti,
                   gang_dom, node_hash, node_dom, policy_ints):
    """One launch of the policy variant with ``plan`` on checked CUDA
    inputs; ``policy_ints`` is ``_policy_weights``' tuple."""
    n, r = left0.shape
    g = group_req.shape[0]
    dev = left0.device
    launch, _, err = _entry_points("assign_policy")
    with torch.cuda.device(dev):
        magic, shift = division_magic(group_req)
        # alloc must start zeroed: the kernel writes only nonzero takes
        alloc = torch.zeros((g, n), dtype=torch.int32, device=dev)
        placed = torch.zeros(g, dtype=torch.bool, device=dev)
        left_after = torch.empty_like(left0)
        scratch = (
            torch.empty(plan.scratch_ints, dtype=torch.int32, device=dev)
            if plan.leftover == "global" else None
        )
        rc = launch(
            left0.data_ptr(), group_req.data_ptr(), remaining.data_ptr(),
            fit_mask.data_ptr(), order.data_ptr(), magic.data_ptr(),
            shift.data_ptr(), alloc.data_ptr(), placed.data_ptr(),
            left_after.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            aff.data_ptr(), anti.data_ptr(), gang_dom.data_ptr(),
            node_hash.data_ptr(), node_dom.data_ptr(),
            n, g, r, int(fit_mask.shape[0] != 1), plan.cluster_blocks,
            plan.block_nodes, plan.threads, plan.per_thread,
            int(plan.leftover == "shared"), plan.shared_bytes, *policy_ints,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"assign_policy kernel launch failed for {plan}: "
            f"{err(rc).decode(errors='replace')} (CUDA error {rc})"
        )
    return alloc, placed, left_after


# the top-K kernel's lists: at most 256 entries a gang (kk plus a margin of
# at most 32), and at most 256 touched nodes carried through a replay; its
# blocks have at most 512 threads (128 registers a thread)
_TOPK_THREADS = 512
_TOPK_LIST_MAX = 256
_TOPK_MARGIN = 32
_TOPK_TOUCHED = 256


class TopkPlan(NamedTuple):
    """The top-K kernel's launch shape: ``ScanPlan``'s fields, then the
    gathered list's length a gang (``list_len`` = kk + margin), the most
    touched nodes a carried replay keeps (``touched_max``) and where the
    sweep's tightness keys live (``keys``: "shared", or "recompute" from
    the leftover) and how many publish buffers alternate between the
    cluster's exchanges (``publish_buffers``: 2, or 1 with a barrier
    opening each exchange)."""

    cluster_blocks: int
    block_nodes: int
    threads: int
    per_thread: int
    leftover: str
    shared_bytes: int
    scratch_ints: int
    list_len: int
    touched_max: int
    keys: str
    publish_buffers: int


def topk_kernel_plan(n: int, r: int, wave: int, kk: int, cluster_max: int,
                     shared_budget: int) -> TopkPlan:
    """The top-K kernel's launch shape for N nodes, R lanes, width ``wave``
    and ``kk`` candidates a gang, with at most ``cluster_max`` blocks and
    ``shared_budget`` bytes of dynamic shared memory a block
    (``bst_assign_topk_shared_budget``): the serial kernel's blocks
    (``_node_split``), each thread the fewest of a block's nodes that 512
    threads allow.

    Dynamic shared memory (``_topk_shared_bytes``) holds the wave's fixed
    tables: two stages of the wave's lane rows, two publish buffers (a
    cumulative 128-bin histogram, a pooled sum and a sorted list of
    ``list_len`` candidates a position), the gathered lists, the takes,
    and a scratch area (an unsorted list, the conflict check's entries or
    a carried replay's ``touched_max`` nodes). The leftover (R ints a node)
    joins them when it fits the budget, else it lives in global scratch
    (``scratch_ints``); then the sweep's key bytes (a byte a node and
    position) when they fit too, else the kernel recomputes them. In order
    of preference: the keys in shared memory, then recomputed; the leftover
    in shared memory, then in global scratch; two publish buffers, then
    one; the margin ``list_len - kk`` from min(kk, 32), halving down to 0.
    The first layout that fits is the plan. With the H100's budget (232,448
    bytes less the kernel's static shared memory) at W=8 in 16 blocks and
    R=6, the leftover stays on chip up to the 65,536-node bucket at K=16
    and 128: the north star and the acceptance bucket [2048, 65536];
    XLClusterSpec()'s bucket [4096, 131072] keeps it in global scratch, its
    keys in shared memory. Raises ValueError when no layout fits."""
    c, block_nodes, _ = _node_split(n, cluster_max)
    per = -(-block_nodes // _TOPK_THREADS)
    threads = -(-block_nodes // per)
    threads = -(-threads // 32) * 32
    touched = max(kk, min(wave * kk, _TOPK_TOUCHED))
    margins = []
    m = min(kk, _TOPK_MARGIN, _TOPK_LIST_MAX - kk)
    while m > 0:
        margins.append(m)
        m //= 2
    margins.append(0)
    for keys in ("shared", "recompute"):
        for leftover in ("shared", "global"):
            for bufs in (2, 1):
                for margin in margins:
                    need = _topk_shared_bytes(wave, kk, kk + margin, touched, r, per, threads,
                                              leftover == "shared", keys == "shared", bufs)
                    if need <= shared_budget:
                        scratch = c * r * per * threads if leftover == "global" else 0
                        return TopkPlan(c, block_nodes, threads, per, leftover, need, scratch,
                                        kk + margin, touched, keys, bufs)
    raise ValueError(f"no top-K layout fits {shared_budget} bytes of shared memory at "
                     f"N={n}, R={r}, W={wave}, kk={kk}")


def _topk_shared_bytes(wave: int, kk: int, list_len: int, touched: int, r: int, per: int,
                       threads: int, shared_left: bool, shared_keys: bool,
                       publish_buffers: int) -> int:
    """assign_topk.cu's dynamic shared memory (its ``layout``, 16-byte
    aligned parts): the stages [W][R+1] of 16 bytes (two when a thread a
    stage entry can read the next wave's ahead, else one); the publish
    buffers of [W][128] ints, [W] int64 and [W][L] (composite, capacity) pairs; the
    gathered lists [W][L] pairs; the takes [W][kk]; the block scans'
    [32][2W] ints; the gather offsets and counts [W][16] each; the scratch
    (the largest of an unsorted list [W][L] pairs, the conflict check's two
    [W][kk] pairs, and a carried replay's tables); with one node a thread,
    the per-warp key counts [threads / 32][128] ints; the keys
    [W][per][threads] bytes; the leftover [R][per][threads] ints."""
    def al(b):
        return (b + 15) // 16 * 16

    pub = al(wave * 128 * 4) + al(wave * 8) + al(wave * list_len * 8)
    carried = (al(touched * r * 4) + 4 * al(touched * 4) + al(list_len * 4) + al(kk * 8)
               + al(kk * 4))
    scr = max(wave * list_len * 8, wave * kk * 16, carried)
    stages = 2 if wave * (r + 1) <= threads else 1
    total = (al(stages * wave * (r + 1) * 16) + publish_buffers * pub + al(wave * list_len * 8)
             + al(wave * kk * 4)
             + al(64 * wave * 4) + al(2 * wave * 16 * 4) + al(scr))
    if per == 1:
        total += al(threads // 32 * 128 * 4)
    if shared_keys:
        total += al(wave * per * threads)
    if shared_left:
        total += r * per * threads * 4
    return total


@functools.lru_cache(maxsize=None)
def topk_scan_plan(n: int, r: int, wave: int, kk: int, device_index: int) -> TopkPlan:
    """The plan ``assign_gangs_topk_cuda`` launches on CUDA device
    ``device_index``: ``topk_kernel_plan`` at the largest cluster the device
    can schedule, with its shared-memory budget."""
    return _device_plan(
        "assign_topk",
        lambda n_, r_, cmax, budget: topk_kernel_plan(n_, r_, wave, kk, cmax, budget),
        n, r, device_index)


def topk_kernel_shared_need(plan: TopkPlan, wave: int, kk: int, r: int) -> int:
    """The dynamic shared memory the built kernel's own layout asks for
    with ``plan`` (``bst_assign_topk_shared_need``), to hold the plan's
    ``shared_bytes`` to."""
    fn = _build.library("assign_topk").bst_assign_topk_shared_need
    fn.argtypes = [ctypes.c_int] * 10
    fn.restype = ctypes.c_longlong
    return fn(wave, kk, plan.list_len, plan.touched_max, r, plan.per_thread, plan.threads,
              int(plan.leftover == "shared"), int(plan.keys == "shared"), plan.publish_buffers)


def assign_gangs_topk_cuda(left0, group_req, remaining, fit_mask, order, wave: int, k: int):
    """The hierarchical top-K assignment scan at width ``wave`` (one of
    ``WAVE_WIDTHS``) with ``k`` candidates a gang (1..128; the scan uses
    ``max(2, min(k, N))``): the CUDA kernel for CUDA tensors, the plain
    ``ops.oracle.assign_gangs_topk(..., with_stats=True)`` for CPU tensors.
    Returns ``(alloc, placed, left_after, (conflicts[S], megas[S],
    dense_demotions[S]))``, S = ceil(G / wave). ``order`` must be a
    permutation of [0, G) and ``remaining`` non-negative. Every launch adds
    one to ``assign_gangs_topk_cuda.launches`` and leaves in
    ``assign_gangs_topk_cuda.replay_counts`` a 2-int tensor on the card: the
    replayed gangs whose candidates came from the wave's carried lists, and
    those that ranked afresh (report-only; the plain version has none)."""
    if not isinstance(wave, int) or wave not in WAVE_WIDTHS:
        raise ValueError(f"wave must be one of {WAVE_WIDTHS}, got {wave!r}")
    if not isinstance(k, int) or not 1 <= k <= _MAX_TOPK:
        raise ValueError(f"k must be an int in [1, {_MAX_TOPK}], got {k!r}")
    _check(left0, group_req, remaining, fit_mask, order)
    dev = left0.device
    if dev.type == "cpu":
        return assign_gangs_topk(left0, group_req, remaining, fit_mask, order,
                                 wave=wave, k=k, with_stats=True)
    _check_cuda("assign_gangs_topk_cuda", left0, group_req, remaining, fit_mask, order)
    n, r = left0.shape
    kk = max(2, min(k, n))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out, counts = _launch_topk(topk_scan_plan(n, r, wave, kk, index), left0, group_req,
                               remaining, fit_mask, order, wave, kk)
    assign_gangs_topk_cuda.launches += 1
    assign_gangs_topk_cuda.replay_counts = counts
    _count_launch("assign_topk")
    return out


assign_gangs_topk_cuda.launches = 0
assign_gangs_topk_cuda.replay_counts = None


def _launch_topk(plan: TopkPlan, left0, group_req, remaining, fit_mask, order, wave: int,
                 kk: int):
    """One launch of the top-K kernel with ``plan`` on checked CUDA inputs:
    (outputs, the 2-int replay counts)."""
    n, r = left0.shape
    g = group_req.shape[0]
    dev = left0.device
    steps = -(-g // wave)
    launch, _, err = _entry_points("assign_topk")
    with torch.cuda.device(dev):
        stage = torch.empty((steps * wave * (r + 1), 4), dtype=torch.int32, device=dev)
        uniform = torch.zeros(2 * steps, dtype=torch.uint8, device=dev)
        # alloc must start zeroed: the kernel writes only nonzero takes
        alloc = torch.zeros((g, n), dtype=torch.int32, device=dev)
        placed = torch.zeros(g, dtype=torch.bool, device=dev)
        left_after = torch.empty_like(left0)
        conflicts = torch.empty(steps, dtype=torch.bool, device=dev)
        megas = torch.empty(steps, dtype=torch.bool, device=dev)
        demotions = torch.empty(steps, dtype=torch.int32, device=dev)
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        scratch = (torch.empty(plan.scratch_ints, dtype=torch.int32, device=dev)
                   if plan.leftover == "global" else None)
        rc = launch(
            left0.data_ptr(), group_req.data_ptr(), remaining.data_ptr(),
            fit_mask.data_ptr(), order.data_ptr(), stage.data_ptr(), uniform.data_ptr(),
            alloc.data_ptr(), placed.data_ptr(), left_after.data_ptr(),
            conflicts.data_ptr(), megas.data_ptr(), demotions.data_ptr(), counts.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            n, g, r, int(fit_mask.shape[0] != 1), wave, kk, plan.list_len, plan.touched_max,
            plan.cluster_blocks, plan.block_nodes, plan.threads, plan.per_thread,
            int(plan.leftover == "shared"), int(plan.keys == "shared"), plan.publish_buffers,
            plan.shared_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"assign_topk kernel launch failed for {plan}: "
            f"{err(rc).decode(errors='replace')} (CUDA error {rc})"
        )
    return (alloc, placed, left_after, (conflicts, megas, demotions)), counts


# -- the node-sharded scan's wave steps (csrc/shard_wave.cu) -----------------
#
# Its reference is lax: the body of the reference's ``assign_gangs_sharded``
# shard_map (ops/oracle.py:802). The plain versions are
# ``ops.oracle.shard_wave_summary`` / ``shard_wave_apply``; the orchestration
# with the collectives is ``ops.oracle.assign_gangs_sharded``. Both wrappers
# count into the kernel ``shard_wave``.

_SHARD_MAX_LANES = 32  # the apply kernel keeps a node's leftover lanes in registers


@functools.lru_cache(maxsize=None)
def _shard_entry_points():
    """(summary, apply, error_string) of ``csrc/shard_wave.cu``."""
    lib = _build.library("shard_wave")
    summary = lib.bst_shard_summary
    summary.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    summary.restype = ctypes.c_int
    apply = lib.bst_shard_apply
    apply.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    apply.restype = ctypes.c_int
    err = lib.bst_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return summary, apply, err


def _check_shard(caller, left_l, req_rows, mask_rows, **tensors):
    if left_l.dim() != 2 or req_rows.dim() != 2 or req_rows.shape[1] != left_l.shape[1]:
        raise ValueError(f"{caller}: left [nl,R] and request rows [k,R], got "
                         f"{tuple(left_l.shape)} and {tuple(req_rows.shape)}")
    if mask_rows.dim() != 2 or mask_rows.shape[1] != left_l.shape[0] or mask_rows.dtype != torch.bool:
        raise ValueError(f"{caller}: mask rows must be bool [k or 1, {left_l.shape[0]}], got "
                         f"{mask_rows.dtype} {tuple(mask_rows.shape)}")
    for name, t in (("left", left_l), ("req_rows", req_rows), *tensors.items()):
        if t is None:
            continue
        if t.device != left_l.device:
            raise ValueError(f"{caller}: {name} is on {t.device}, left on {left_l.device}")
        if left_l.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{caller}: {name} must be contiguous")
    if left_l.device.type == "cuda" and left_l.shape[1] > _SHARD_MAX_LANES:
        raise ValueError(f"{caller}: at most {_SHARD_MAX_LANES} lanes, got {left_l.shape[1]}")


def shard_summary_cuda(left_l, req_rows, clip, mask_rows, hist, rank: int):
    """The summary step of one wave on a rank's node block
    (``ops.oracle.shard_wave_summary``, which runs for CPU tensors): the
    ``[k, nl]`` member capacities, returned, and the rank's ``[k, 128]``
    histogram in row ``rank`` of ``hist`` ``[S, k, 128]`` (the other rows
    zeroed). On CUDA tensors the kernel runs or this raises. Every launch
    adds one to ``shard_summary_cuda.launches``."""
    _check_shard("shard_summary_cuda", left_l, req_rows, mask_rows, clip=clip, hist=hist)
    k = req_rows.shape[0]
    if hist.dim() != 3 or hist.shape[1:] != (k, 128) or not 0 <= rank < hist.shape[0]:
        raise ValueError(f"hist must be [S, {k}, 128] with rank < S, got {tuple(hist.shape)}")
    if left_l.device.type == "cpu":
        from .oracle import shard_wave_summary

        return shard_wave_summary(left_l, req_rows, clip, mask_rows, hist, rank)
    nl, r = left_l.shape
    dev = left_l.device
    summary, _, err = _shard_entry_points()
    with torch.cuda.device(dev):
        cap = torch.empty((k, nl), dtype=torch.int32, device=dev)
        rc = summary(
            left_l.data_ptr(), req_rows.data_ptr(), clip.data_ptr(), mask_rows.data_ptr(),
            cap.data_ptr(), hist.data_ptr(), nl, r, k, int(mask_rows.shape[0] != 1) * nl,
            hist.shape[0], rank, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"shard_wave summary launch failed: "
                           f"{err(rc).decode(errors='replace')} (CUDA error {rc})")
    shard_summary_cuda.launches += 1
    _count_launch("shard_wave")
    return cap


shard_summary_cuda.launches = 0


def shard_apply_cuda(mode: int, merged, rank: int, cap, needs, left_l, req_rows, mask_rows,
                     takes_out, feas_out, left_out, verify, taken=None):
    """The apply step of one wave on a rank's node block
    (``ops.oracle.shard_wave_apply``, whose docstring gives the modes and
    outputs, runs for CPU tensors): this rank's slice of the take vector
    into ``takes_out`` / ``feas_out``, the candidate leftover into
    ``left_out`` and the conflict bit or feasibility sums into ``verify``
    (None for ``SHARD_REPLAY``). ``taken`` is not read: the kernel keeps a
    uniform wave's stream boundaries on chip (the argument stays for
    callers that time either version of the kernel). On CUDA tensors the
    kernel runs or this raises. Every launch adds one to
    ``shard_apply_cuda.launches``."""
    from .oracle import SHARD_MEGA, SHARD_REPLAY, shard_wave_apply

    _check_shard("shard_apply_cuda", left_l, req_rows, mask_rows, merged=merged, cap=cap,
                 needs=needs, takes_out=takes_out, feas_out=feas_out, left_out=left_out,
                 verify=verify)
    w = needs.shape[0]
    k = 1 if mode in (SHARD_MEGA, SHARD_REPLAY) else w
    nl = left_l.shape[0]
    if merged.shape[1:] != (k, 128) or cap.shape != (k, nl) or takes_out.shape != (w, nl):
        raise ValueError(f"mode {mode}: merged [S,{k},128], cap [{k},{nl}], takes [{w},{nl}]; got "
                         f"{tuple(merged.shape)}, {tuple(cap.shape)}, {tuple(takes_out.shape)}")
    if (verify is None) != (mode == SHARD_REPLAY):
        raise ValueError("verify is None exactly for SHARD_REPLAY")
    if left_l.device.type == "cpu":
        return shard_wave_apply(mode, merged, rank, cap, needs, left_l, req_rows, mask_rows,
                                takes_out, feas_out, left_out, verify)
    r = left_l.shape[1]
    dev = left_l.device
    _, apply, err = _shard_entry_points()
    with torch.cuda.device(dev):
        rc = apply(
            merged.data_ptr(), cap.data_ptr(), needs.data_ptr(), left_l.data_ptr(),
            req_rows.data_ptr(), mask_rows.data_ptr(), takes_out.data_ptr(),
            feas_out.data_ptr(), left_out.data_ptr(),
            verify.data_ptr() if verify is not None else None,
            mode, nl, r, w, merged.shape[0], rank, int(mask_rows.shape[0] != 1) * nl,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"shard_wave apply launch failed (mode {mode}): "
                           f"{err(rc).decode(errors='replace')} (CUDA error {rc})")
    shard_apply_cuda.launches += 1
    _count_launch("shard_wave")
    return None


shard_apply_cuda.launches = 0


# -- the node-sharded top-K scan's steps (csrc/shard_topk.cu) ----------------
#
# Its reference is lax: the body of the reference's
# ``assign_gangs_topk_sharded`` shard_map (ops/oracle.py:1435). The plain
# versions are ``ops.oracle.shard_topk_summary`` / ``shard_topk_apply``; the
# orchestration with the collectives is ``ops.oracle.assign_gangs_topk_sharded``.
# Both wrappers count into the kernel ``shard_topk``.

_SHARD_TOPK_POOL = 1024  # S * kk_l: the apply kernel ranks the merged candidates in one block


@functools.lru_cache(maxsize=None)
def _shard_topk_entry_points():
    """(summary, apply, error_string) of ``csrc/shard_topk.cu``."""
    lib = _build.library("shard_topk")
    summary = lib.bst_shard_topk_summary
    summary.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    summary.restype = ctypes.c_int
    apply = lib.bst_shard_topk_apply
    apply.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    apply.restype = ctypes.c_int
    err = lib.bst_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return summary, apply, err


def _check_topk_rows(caller, mode, buf, req_rows, needs, nl, k):
    from .oracle import TOPK_SPECULATIVE, shard_topk_payload, shard_topk_widths

    if mode not in (0, 1, 2):
        raise ValueError(f"{caller}: mode {mode} is not one of 0, 1, 2")
    rows = req_rows.shape[0]
    w = needs.shape[0]
    want_rows = w if mode == TOPK_SPECULATIVE else 1
    kk_l, _ = shard_topk_widths(k, nl, buf.shape[0])
    p = shard_topk_payload(mode, kk_l, w)
    if rows != want_rows or buf.dim() != 3 or tuple(buf.shape[1:]) != (want_rows, p):
        raise ValueError(f"{caller}: mode {mode} wants {want_rows} request rows and a buffer "
                         f"[S, {want_rows}, {p}], got {rows} rows and {tuple(buf.shape)}")
    if mode == 2 and w != 1:
        raise ValueError(f"{caller}: a replayed gang has one need, got {w}")
    if buf.dtype != torch.int32 or needs.dtype != torch.int32:
        raise ValueError(f"{caller}: the buffer and needs must be int32")
    if buf.device.type == "cuda":
        if not 1 <= k <= _MAX_TOPK or w > _MAX_WAVE or buf.shape[0] * kk_l > _SHARD_TOPK_POOL:
            raise ValueError(f"{caller}: k in 1..{_MAX_TOPK}, at most {_MAX_WAVE} gangs a wave "
                             f"and S * kk_l <= {_SHARD_TOPK_POOL}; got k={k}, w={w}, "
                             f"S={buf.shape[0]}")
    return kk_l


def shard_topk_summary_cuda(mode: int, left_l, req_rows, needs, mask_rows, buf, rank: int, k: int):
    """The summary step of one wave (or replayed gang) of the node-sharded
    top-K scan on a rank's node block (``ops.oracle.shard_topk_summary``,
    which runs for CPU tensors and whose docstring gives the modes): the
    ``[rows, nl]`` member capacities, returned, and the rank's candidate
    payload in row ``rank`` of ``buf`` ``[S, rows, P]`` (the other rows
    zeroed). On CUDA tensors the kernel runs or this raises. Every launch
    adds one to ``shard_topk_summary_cuda.launches``."""
    _check_shard("shard_topk_summary_cuda", left_l, req_rows, mask_rows, needs=needs, buf=buf)
    nl, r = left_l.shape
    kk_l = _check_topk_rows("shard_topk_summary_cuda", mode, buf, req_rows, needs, nl, k)
    if not 0 <= rank < buf.shape[0]:
        raise ValueError(f"rank {rank} outside the buffer's {buf.shape[0]} ranks")
    if left_l.device.type == "cpu":
        from .oracle import shard_topk_summary

        return shard_topk_summary(mode, left_l, req_rows, needs, mask_rows, buf, rank, k)
    dev = left_l.device
    rows = req_rows.shape[0]
    summary, _, err = _shard_topk_entry_points()
    with torch.cuda.device(dev):
        cap = torch.empty((rows, nl), dtype=torch.int32, device=dev)
        rc = summary(
            left_l.data_ptr(), req_rows.data_ptr(), needs.data_ptr(), mask_rows.data_ptr(),
            cap.data_ptr(), buf.data_ptr(), mode, nl, r, needs.shape[0],
            int(mask_rows.shape[0] != 1) * nl, buf.shape[0], rank, kk_l,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"shard_topk summary launch failed (mode {mode}): "
                           f"{err(rc).decode(errors='replace')} (CUDA error {rc})")
    shard_topk_summary_cuda.launches += 1
    _count_launch("shard_topk")
    return cap


shard_topk_summary_cuda.launches = 0


def shard_topk_apply_cuda(mode: int, merged, rank: int, cap, needs, left_l, req_rows, mask_rows,
                          takes_out, feas_out, left_out, verify, dense, k: int, stream_take=None):
    """The apply step of one wave (or replayed gang) of the node-sharded
    top-K scan on a rank's node block (``ops.oracle.shard_topk_apply``, whose
    docstring gives the modes and outputs, runs for CPU tensors): this
    rank's takes into ``takes_out`` / ``feas_out``, the candidate leftover
    into ``left_out``, the verify word (None for ``TOPK_REPLAY``) and a
    replayed gang's dense-column demotion added into ``dense[0]``.
    ``stream_take`` is not read: the kernel keeps a mega wave's member
    stream on chip (the argument stays for callers that time either version
    of the kernel). On CUDA tensors the kernel runs or this raises. Every
    launch adds one to ``shard_topk_apply_cuda.launches``."""
    from .oracle import TOPK_REPLAY, TOPK_SPECULATIVE, shard_topk_apply, shard_topk_widths

    _check_shard("shard_topk_apply_cuda", left_l, req_rows, mask_rows, merged=merged, cap=cap,
                 needs=needs, takes_out=takes_out, feas_out=feas_out, left_out=left_out,
                 verify=verify, dense=dense)
    nl, r = left_l.shape
    _check_topk_rows("shard_topk_apply_cuda", mode, merged, req_rows, needs, nl, k)
    w = needs.shape[0]
    rows = req_rows.shape[0]
    if cap.shape != (rows, nl) or takes_out.shape != (w, nl) or feas_out.shape != (w,):
        raise ValueError(f"mode {mode}: cap [{rows},{nl}], takes [{w},{nl}], feas [{w}]; got "
                         f"{tuple(cap.shape)}, {tuple(takes_out.shape)}, {tuple(feas_out.shape)}")
    if (verify is None) != (mode == TOPK_REPLAY) or dense is None or dense.numel() != 1:
        raise ValueError("verify is None exactly for TOPK_REPLAY, and dense is one int32 word")
    if not 0 <= rank < merged.shape[0]:
        raise ValueError(f"rank {rank} outside the buffer's {merged.shape[0]} ranks")
    if left_l.device.type == "cpu":
        return shard_topk_apply(mode, merged, rank, cap, needs, left_l, req_rows, mask_rows,
                                takes_out, feas_out, left_out, verify, dense, k)
    s = merged.shape[0]
    kk_l, kk = shard_topk_widths(k, nl, s)
    dev = left_l.device
    _, apply, err = _shard_topk_entry_points()
    with torch.cuda.device(dev):
        rc = apply(
            merged.data_ptr(), cap.data_ptr(), needs.data_ptr(), left_l.data_ptr(),
            req_rows.data_ptr(), mask_rows.data_ptr(), takes_out.data_ptr(), feas_out.data_ptr(),
            left_out.data_ptr(), verify.data_ptr() if verify is not None else None,
            dense.data_ptr(), mode, nl, r, w, s, rank, kk_l, kk, int(mask_rows.shape[0] != 1) * nl,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"shard_topk apply launch failed (mode {mode}): "
                           f"{err(rc).decode(errors='replace')} (CUDA error {rc})")
    shard_topk_apply_cuda.launches += 1
    _count_launch("shard_topk")
    return None


shard_topk_apply_cuda.launches = 0
