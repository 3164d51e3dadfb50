"""The packed batch carried across: numpy arrays in, torch tensors out.

``batch_from_numpy`` takes the tuples a ``ClusterSnapshot`` packs
(``device_args()`` / ``progress_args()`` — of this package or of the JAX
reference, whose layouts are the same) and places them on the port's
device with the dtypes the port's oracle takes, so both packages compute
on identical inputs. A tensor already on the target device (the
device-resident state of ``ops.device_state``) is taken as it is: its
dtype is checked and nothing is copied.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["resolve_device", "device_stream", "batch_from_numpy", "args_from_numpy",
           "policy_from_numpy", "BATCH_DTYPES", "PROGRESS_DTYPES"]

# (alloc, requested, group_req, remaining, fit_mask, group_valid, order)
BATCH_DTYPES = (np.int32, np.int32, np.int32, np.int32, np.bool_, np.bool_, np.int32)
# (min_member, scheduled, matched, ineligible, creation_rank)
PROGRESS_DTYPES = (np.int32, np.int32, np.int32, np.bool_, np.int32)


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on. ``cuda`` (the default of
    every entry point) raises when this machine has no usable CUDA device:
    the port never moves to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the port's plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def device_stream(dev: torch.device):
    """The stream one scorer or re-scorer enqueues all its device work on,
    in order: a new CUDA stream on a CUDA device, None on the CPU. Callers
    enter it with ``torch.cuda.stream(...)``, a no-op for None, on every
    thread that touches their tensors."""
    return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    index = lambda d: torch.cuda.current_device() if d.index is None else d.index  # noqa: E731
    return index(a) == index(b)


def _place_one(a, dt, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        if not _same_device(a.device, dev):
            raise ValueError(
                f"tensor on {a.device} passed to a batch on {dev}: resident "
                "tensors must live on the batch's device"
            )
        want = torch.from_numpy(np.zeros(0, dtype=dt)).dtype
        if a.dtype != want:
            raise TypeError(f"resident tensor has dtype {a.dtype}, expected {want}")
        return a
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a), dtype=dt)).to(dev)


def _place(arrays: Sequence, dtypes: Sequence, dev: torch.device) -> Tuple:
    if len(arrays) != len(dtypes):
        raise ValueError(f"expected {len(dtypes)} arrays, got {len(arrays)}")
    return tuple(_place_one(a, dt, dev) for a, dt in zip(arrays, dtypes))


def batch_from_numpy(batch_args, progress_args, device="cuda"):
    """``(batch, progress)`` tensor tuples on ``device`` from the packed
    numpy batch: int32 lanes, counts and order; bool masks. Tensors
    already on ``device`` pass through uncopied."""
    dev = resolve_device(device)
    return (
        _place(batch_args, BATCH_DTYPES, dev),
        _place(progress_args, PROGRESS_DTYPES, dev),
    )


def args_from_numpy(batch_args, device="cuda"):
    """The packed 7-tuple alone as tensors on ``device`` (the first half of
    ``batch_from_numpy``)."""
    return _place(batch_args, BATCH_DTYPES, resolve_device(device))


def policy_from_numpy(policy_cols, device="cuda"):
    """The six packed policy columns (``ClusterSnapshot.policy_cols``:
    prio, aff, anti, gang_dom, node_hash, node_dom) as int32 tensors on
    ``device``; the holder's resident node columns pass through uncopied."""
    return _place(policy_cols, (np.int32,) * 6, resolve_device(device))
