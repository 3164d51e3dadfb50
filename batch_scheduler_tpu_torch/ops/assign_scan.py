"""The gang-placement scans as hand-written CUDA kernels, with their plain
PyTorch versions and launch counters.

The port's counterpart of ``batch_scheduler_tpu/ops/pallas_assign.py``
``assign_gangs_pallas``: the serial scan (``_kernel``) is
``csrc/assign_scan.cu``, the wavefront scan (``_kernel_wave``) is
``csrc/assign_wave.cu``; each source's header says what bounds it and how
it is laid out. ``ops/_build.py`` compiles them with ``nvcc`` at first use.

``assign_gangs_cuda`` takes the same arguments and returns the same
``(alloc[G,N] int32, placed[G] bool, left_after[N,R] int32)`` as the plain
``assign_gangs_plain`` (``ops.oracle.assign_gangs``);
``assign_gangs_wave_cuda`` adds the wave width and returns the per-wave
``(conflicts, megas)`` flags too, as ``ops.oracle.assign_gangs_wavefront``
does with ``with_stats=True``. For tensors on the CPU each runs its plain
version; for CUDA tensors it launches its kernel or raises. There is no
switch that turns a kernel off.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .oracle import assign_gangs as assign_gangs_plain
from .oracle import assign_gangs_wavefront

__all__ = [
    "assign_gangs_cuda", "assign_gangs_plain", "assign_gangs_wave_cuda",
    "kernel_plan", "wave_plan", "WAVE_WIDTHS",
]

_THREADS = 1024  # both kernels' block size (kThreads in the sources)
WAVE_WIDTHS = (2, 4, 8, 16, 32)  # the widths ops.bucketing.wave_width_bucket gives


# the launch entry point's C signature, bst_<name>(pointers..., ints..., stream)
_LAUNCH_ARGS = {"assign_scan": (9, 5), "assign_wave": (11, 6)}


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


def _per_thread_stride(n: int) -> int:
    # each thread owns ceil(N/1024) nodes; an odd stride spreads a warp's
    # runs over 32 shared-memory banks
    return -(-n // _THREADS) | 1


def kernel_plan(n: int, r: int) -> tuple:
    """``(work_ints, stride)``: the ints of leftover + capacity working set
    the serial kernel keeps ((R+1) rows of 1024 thread runs of ``stride``
    slots) and the odd per-thread run stride, as the kernel computes them."""
    stride = _per_thread_stride(n)
    return (r + 1) * _THREADS * stride, stride


def wave_plan(n: int, r: int) -> int:
    """The ints of leftover the wavefront kernel keeps (R rows of 1024
    thread runs; it recomputes capacities instead of keeping a row)."""
    return r * _THREADS * _per_thread_stride(n)


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


def _shared_bytes(dev, work_ints: int, name: str) -> int:
    """Dynamic shared memory for a launch: the working set's bytes when
    they fit the kernel's budget on ``dev``, else 0 (global scratch)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return work_ints * 4 if work_ints * 4 <= _shared_budget(index, name) else 0


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
    g = group_req.shape[0]
    launch, _, err = _entry_points("assign_scan")
    work_ints, _ = kernel_plan(n, r)
    shared_bytes = _shared_bytes(dev, work_ints, "assign_scan")
    with torch.cuda.device(dev):
        # alloc must start zeroed: the kernel writes only nonzero takes
        alloc = torch.zeros((g, n), dtype=torch.int32, device=dev)
        placed = torch.zeros(g, dtype=torch.bool, device=dev)
        left_after = torch.empty_like(left0)
        scratch = (
            torch.empty(work_ints, dtype=torch.int32, device=dev)
            if shared_bytes == 0 else None
        )
        rc = launch(
            left0.data_ptr(), group_req.data_ptr(), remaining.data_ptr(),
            fit_mask.data_ptr(), order.data_ptr(), alloc.data_ptr(),
            placed.data_ptr(), left_after.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            n, g, r, int(fit_mask.shape[0] != 1), shared_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"assign_scan kernel launch failed: "
            f"{err(rc).decode(errors='replace')} (CUDA error {rc})"
        )
    assign_gangs_cuda.launches += 1
    return alloc, placed, left_after


assign_gangs_cuda.launches = 0


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
    shared_bytes = _shared_bytes(dev, work_ints, "assign_wave")
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
