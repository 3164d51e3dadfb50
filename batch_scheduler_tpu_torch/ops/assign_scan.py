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
does with ``with_stats=True``. For tensors on the CPU each runs its plain
version; for CUDA tensors it launches its kernel or raises. There is no
switch that turns a kernel off.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .lanes import LANE_MAX
from .oracle import assign_gangs as assign_gangs_plain
from .oracle import assign_gangs_wavefront

__all__ = [
    "assign_gangs_cuda", "assign_gangs_plain", "assign_gangs_wave_cuda",
    "division_magic", "kernel_plan", "scan_plan", "ScanPlan", "wave_plan",
    "CLUSTER_SIZES", "WAVE_WIDTHS",
]

_THREADS = 1024  # the wave kernel's block size, the serial kernel's largest
WAVE_WIDTHS = (2, 4, 8, 16, 32)  # the widths ops.bucketing.wave_width_bucket gives
# the serial kernel's cluster sizes, largest first: 16 needs the
# non-portable cluster size, 8 is the portable limit
CLUSTER_SIZES = (16, 8)
_MIN_BLOCK_NODES = 256  # below this many nodes a block, fewer blocks
_PER_THREAD_MAX = 64  # nodes a thread: the kernel has instantiations for powers of two to 64


# the launch entry point's C signature, bst_<name>(pointers..., ints..., stream)
_LAUNCH_ARGS = {"assign_scan": (11, 10), "assign_wave": (11, 6)}


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
    """The serial kernel's launch shape. Block b of the cluster owns nodes
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


def kernel_plan(n: int, r: int, cluster_max: int, shared_budget: int) -> ScanPlan:
    """The serial kernel's launch shape for N nodes and R lanes, with at
    most ``cluster_max`` blocks and ``shared_budget`` bytes of dynamic
    shared memory a block (``bst_assign_scan_shared_budget``).

    C is the largest power of two <= ``cluster_max`` that leaves each block
    at least 256 nodes (1 for small buckets). A block has ceil(N/C) nodes,
    each thread the fewest that 1024 threads allow. Dynamic shared memory
    holds two staged gang rows (4 ints a lane: request, magic, shift,
    padding) and two 128-bin histograms a warp, and the leftover (R ints a
    node) when it fits the budget beside them; else the leftover goes in
    global scratch."""
    if 3 * r > _THREADS:
        raise ValueError(f"{r} lanes exceed the scan kernel's {_THREADS // 3}")
    c = 1
    while c * 2 <= cluster_max and c * 2 * _MIN_BLOCK_NODES <= n:
        c *= 2
    block_nodes = max(-(-n // c), 1)
    per = -(-block_nodes // _THREADS)
    if per > _PER_THREAD_MAX:
        raise ValueError(
            f"{n} nodes exceed the scan kernel's {_PER_THREAD_MAX * _THREADS * c} "
            f"at {c} blocks"
        )
    threads = max(-(-block_nodes // per), 3 * r)
    threads = -(-threads // 32) * 32
    fixed = 2 * 4 * r + 2 * (threads // 32) * 128  # gang rows, warp histograms
    leftover = r * per * threads
    if 4 * (fixed + leftover) <= shared_budget:
        return ScanPlan(c, block_nodes, threads, per, "shared", 4 * (fixed + leftover), 0)
    return ScanPlan(c, block_nodes, threads, per, "global", 4 * fixed, c * leftover)


@functools.lru_cache(maxsize=None)
def scan_plan(n: int, r: int, device_index: int) -> ScanPlan:
    """The plan ``assign_gangs_cuda`` launches on CUDA device
    ``device_index``: ``kernel_plan`` at the largest of ``CLUSTER_SIZES``
    that ``cudaOccupancyMaxActiveClusters`` says the device can schedule.
    Raises RuntimeError when none can be."""
    lib = _build.library("assign_scan")
    fits = lib.bst_assign_scan_clusters
    fits.argtypes = [ctypes.c_int] * 5
    fits.restype = ctypes.c_int
    _, _, err = _entry_points("assign_scan")
    budget = _shared_budget(device_index)
    with torch.cuda.device(device_index):
        for cluster_max in CLUSTER_SIZES:
            plan = kernel_plan(n, r, cluster_max, budget)
            got = fits(plan.cluster_blocks, plan.threads, plan.per_thread,
                       int(plan.leftover == "shared"), plan.shared_bytes)
            if got < 0:
                raise RuntimeError(
                    f"assign_scan occupancy query failed for {plan}: "
                    f"{err(-got).decode(errors='replace')}"
                )
            if got > 0:
                return plan
    raise RuntimeError(f"no cluster of the assign_scan kernel can be scheduled: {plan}")


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


def wave_plan(n: int, r: int) -> int:
    """The ints of leftover the wavefront kernel keeps (R rows of 1024
    thread runs; it recomputes capacities instead of keeping a row)."""
    # each thread owns ceil(N/1024) nodes; an odd stride spreads a warp's
    # runs over 32 shared-memory banks
    return r * _THREADS * (-(-n // _THREADS) | 1)


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


def _wave_shared_bytes(dev, work_ints: int) -> int:
    """Dynamic shared memory for a wave launch: the working set's bytes when
    they fit the kernel's budget on ``dev``, else 0 (global scratch)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return work_ints * 4 if work_ints * 4 <= _shared_budget(index, "assign_wave") else 0


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
    S = ceil(G / wave). ``order`` must be a permutation of [0, G). Every
    launch adds one to ``assign_gangs_wave_cuda.launches``."""
    if not isinstance(wave, int) or wave not in WAVE_WIDTHS:
        raise ValueError(f"wave must be one of {WAVE_WIDTHS}, got {wave!r}")
    _check(left0, group_req, remaining, fit_mask, order)
    dev = left0.device
    if dev.type == "cpu":
        return assign_gangs_wavefront(left0, group_req, remaining, fit_mask,
                                      order, wave=wave, with_stats=True)
    _check_cuda("assign_gangs_wave_cuda", left0, group_req, remaining, fit_mask, order)
    n, r = left0.shape
    g = group_req.shape[0]
    steps = -(-g // wave)
    launch, _, err = _entry_points("assign_wave")
    work_ints = wave_plan(n, r)
    shared_bytes = _wave_shared_bytes(dev, work_ints)
    with torch.cuda.device(dev):
        # alloc must start zeroed: the kernel writes only nonzero takes
        alloc = torch.zeros((g, n), dtype=torch.int32, device=dev)
        placed = torch.zeros(g, dtype=torch.bool, device=dev)
        left_after = torch.empty_like(left0)
        conflicts = torch.zeros(steps, dtype=torch.bool, device=dev)
        megas = torch.zeros(steps, dtype=torch.bool, device=dev)
        scratch = (
            torch.empty(work_ints, dtype=torch.int32, device=dev)
            if shared_bytes == 0 else None
        )
        rc = launch(
            left0.data_ptr(), group_req.data_ptr(), remaining.data_ptr(),
            fit_mask.data_ptr(), order.data_ptr(), alloc.data_ptr(),
            placed.data_ptr(), left_after.data_ptr(), conflicts.data_ptr(),
            megas.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            n, g, r, int(fit_mask.shape[0] != 1), wave, shared_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"assign_wave kernel launch failed: "
            f"{err(rc).decode(errors='replace')} (CUDA error {rc})"
        )
    assign_gangs_wave_cuda.launches += 1
    return alloc, placed, left_after, (conflicts, megas)


assign_gangs_wave_cuda.launches = 0
