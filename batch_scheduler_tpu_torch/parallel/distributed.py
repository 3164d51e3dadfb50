"""Multi-process bootstrap for the oracle's mesh.

The port of ``batch_scheduler_tpu/parallel/distributed.py``. JAX runs one
process per host and one program over every device of the job; PyTorch runs
one process per rank, each with its own device, joined by a
``torch.distributed`` process group. ``init_distributed`` wires that group
from the reference's environment variables, so the same service binary
works in one process (no-op) and across ranks (the coordinator address is
the only required setting). ``global_mesh`` then builds the (groups x
nodes) mesh over every rank of the job.

Backends: ``nccl`` for ranks on CUDA devices (one card a rank), ``gloo``
for CPU ranks. Ranks that share one card pass ``backend="gloo"``
themselves (NCCL does not take two ranks on one device); nothing switches
the backend on a failure.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import torch.distributed as dist

from ..ops.convert import resolve_device
from .mesh import make_mesh

__all__ = ["init_distributed", "global_mesh"]

_initialized = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> bool:
    """Join this process to the job's process group.

    Reads ``BST_COORDINATOR`` (``host:port`` of rank 0's store),
    ``BST_NUM_PROCESSES`` and ``BST_PROCESS_ID`` when the arguments are
    omitted, as the reference does, and calls
    ``torch.distributed.init_process_group(backend,
    init_method="tcp://<coordinator>", world_size, rank)``. ``backend``
    defaults to ``nccl`` for a ``cuda`` ``device`` and ``gloo`` for
    ``cpu``. Returns True once the group is up; False for the
    single-process no-op (no coordinator configured)."""
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get("BST_COORDINATOR")
    if not coordinator_address:
        return False
    # the reference's parse guard: an absent or garbled count or id is the
    # single-process topology (with a warning), never a renumbered host
    try:
        num_processes = num_processes or int(os.environ.get("BST_NUM_PROCESSES", "1"))
    except ValueError:
        warnings.warn("ignoring unparseable BST_NUM_PROCESSES; assuming 1 process")
        num_processes = 1
    try:
        process_id = (
            process_id if process_id is not None
            else int(os.environ.get("BST_PROCESS_ID", "0"))
        )
    except ValueError:
        warnings.warn("ignoring unparseable BST_PROCESS_ID; assuming id 0")
        process_id = 0
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    _initialized = True
    return True


def global_mesh(device="cuda"):
    """The (groups x nodes) mesh over every rank of the job, on this rank's
    ``device``. Without a process group (``init_distributed`` returned
    False) it is a mesh of this process alone, over a one-rank group."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
    return make_mesh(device=dev)
