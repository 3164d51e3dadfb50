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
``topk_kernel_plan``, with the same prepare kernel as the wave kernel's,
returning the three per-wave series. For tensors on the CPU each runs its
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
    "policy_scan_plan", "scan_plan", "ScanPlan", "topk_kernel_plan", "topk_scan_plan",
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
                "assign_topk": (16, 11)}


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


def topk_kernel_plan(n: int, r: int, wave: int, kk: int, cluster_max: int) -> ScanPlan:
    """The top-K kernel's launch shape for N nodes, R lanes, width ``wave``
    and ``kk`` candidates a gang, with at most ``cluster_max`` blocks: the
    serial kernel's node split (``_node_split``), threads covering a block's
    nodes. The leftover always lives in global scratch (``scratch_ints``:
    R ints a node slot), beside a byte a node slot and wave position for the
    tightness keys. Dynamic shared memory (``_topk_shared_bytes``) holds the
    wave's lane rows, a 128-bin count histogram a position and five
    ``[wave, kk]`` candidate tables."""
    c, block_nodes, per = _node_split(n, cluster_max)
    threads = -(-block_nodes // per)
    threads = -(-threads // 32) * 32
    return ScanPlan(c, block_nodes, threads, per, "global", _topk_shared_bytes(wave, kk, r),
                    c * r * per * threads)


def _topk_shared_bytes(wave: int, kk: int, r: int) -> int:
    """assign_topk.cu's dynamic shared memory: rows [W][R] (16 bytes each),
    hist [W][128], four [W][kk] tables of (node, capacity) pairs and the
    [W][kk] takes."""
    return wave * (16 * r + 4 * 128 + 36 * kk)


@functools.lru_cache(maxsize=None)
def topk_scan_plan(n: int, r: int, wave: int, kk: int, device_index: int) -> ScanPlan:
    """The plan ``assign_gangs_topk_cuda`` launches on CUDA device
    ``device_index``: ``topk_kernel_plan`` at the largest cluster the device
    can schedule."""
    return _device_plan(
        "assign_topk", lambda n_, r_, cmax, _budget: topk_kernel_plan(n_, r_, wave, kk, cmax),
        n, r, device_index)


def assign_gangs_topk_cuda(left0, group_req, remaining, fit_mask, order, wave: int, k: int):
    """The hierarchical top-K assignment scan at width ``wave`` (one of
    ``WAVE_WIDTHS``) with ``k`` candidates a gang (1..128; the scan uses
    ``max(2, min(k, N))``): the CUDA kernel for CUDA tensors, the plain
    ``ops.oracle.assign_gangs_topk(..., with_stats=True)`` for CPU tensors.
    Returns ``(alloc, placed, left_after, (conflicts[S], megas[S],
    dense_demotions[S]))``, S = ceil(G / wave). ``order`` must be a
    permutation of [0, G) and ``remaining`` non-negative. Every launch adds
    one to ``assign_gangs_topk_cuda.launches``."""
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
    out = _launch_topk(topk_scan_plan(n, r, wave, kk, index), left0, group_req, remaining,
                       fit_mask, order, wave, kk)
    assign_gangs_topk_cuda.launches += 1
    _count_launch("assign_topk")
    return out


assign_gangs_topk_cuda.launches = 0


def _launch_topk(plan: ScanPlan, left0, group_req, remaining, fit_mask, order, wave: int,
                 kk: int):
    """One launch of the top-K kernel with ``plan`` on checked CUDA inputs."""
    n, r = left0.shape
    g = group_req.shape[0]
    dev = left0.device
    steps = -(-g // wave)
    launch, _, err = _entry_points("assign_topk")
    with torch.cuda.device(dev):
        magic = torch.empty_like(group_req)
        shift = torch.empty_like(group_req)
        uniform = torch.zeros(2 * steps, dtype=torch.uint8, device=dev)
        # alloc must start zeroed: the kernel writes only nonzero takes
        alloc = torch.zeros((g, n), dtype=torch.int32, device=dev)
        placed = torch.zeros(g, dtype=torch.bool, device=dev)
        left_after = torch.empty_like(left0)
        conflicts = torch.empty(steps, dtype=torch.bool, device=dev)
        megas = torch.empty(steps, dtype=torch.bool, device=dev)
        demotions = torch.empty(steps, dtype=torch.int32, device=dev)
        scratch = torch.empty(plan.scratch_ints, dtype=torch.int32, device=dev)
        keys = torch.empty(plan.cluster_blocks * wave * plan.per_thread * plan.threads,
                           dtype=torch.uint8, device=dev)
        rc = launch(
            left0.data_ptr(), group_req.data_ptr(), remaining.data_ptr(),
            fit_mask.data_ptr(), order.data_ptr(), magic.data_ptr(), shift.data_ptr(),
            uniform.data_ptr(), alloc.data_ptr(), placed.data_ptr(), left_after.data_ptr(),
            conflicts.data_ptr(), megas.data_ptr(), demotions.data_ptr(),
            scratch.data_ptr(), keys.data_ptr(),
            n, g, r, int(fit_mask.shape[0] != 1), wave, kk, plan.cluster_blocks,
            plan.block_nodes, plan.threads, plan.per_thread, plan.shared_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"assign_topk kernel launch failed for {plan}: "
            f"{err(rc).decode(errors='replace')} (CUDA error {rc})"
        )
    return alloc, placed, left_after, (conflicts, megas, demotions)
