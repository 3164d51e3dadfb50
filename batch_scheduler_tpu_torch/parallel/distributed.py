"""Multi-process bootstrap for the oracle's mesh.

The port of ``batch_scheduler_tpu/parallel/distributed.py``. JAX runs one
process per host and one program over every device of the job; PyTorch runs
one process per rank, each with its own device, joined by a
``torch.distributed`` process group. ``init_distributed`` wires that group
from the reference's environment variables, so the same service binary
works in one process (no-op) and across ranks (the coordinator address is
the only required setting). ``global_mesh`` then builds the (groups x
nodes) mesh over every rank of the job.

Backends follow the topology: ``nccl`` where every rank has a card of its
own (on every host, no more ranks than that host's cards), ``gloo`` where
ranks share one (NCCL takes one rank a device) and for CPU ranks; each rank
publishes its host and card count on the coordinator's store, so every rank
makes the same choice (``topology_backend``). Rank ``r`` on CUDA runs on
``cuda:{r % device_count}`` (``rank_device``). Nothing switches the backend
on a failure. The rendezvous is bounded (``COORDINATOR_TIMEOUT_S``): a
coordinator that cannot be reached raises instead of waiting for
``init_process_group``'s half-hour default.
"""

from __future__ import annotations

import datetime
import os
import socket
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.convert import resolve_device
from .mesh import make_mesh

__all__ = ["COLLECTIVE_TIMEOUT_S", "COORDINATOR_TIMEOUT_S", "init_distributed", "global_mesh",
           "rank_device", "topology_backend"]

_initialized = False

# how long joining the process group may take before it raises: the
# rendezvous on the coordinator's store, which every rank must reach
COORDINATOR_TIMEOUT_S = 60.0
# how long one collective may wait: a follower waits in one for rank 0's
# next message for as long as the sidecar is idle
COLLECTIVE_TIMEOUT_S = 30 * 24 * 3600.0


def rank_device(device, rank: int) -> torch.device:
    """This rank's device: ``cuda:{rank % device_count}`` for a CUDA
    ``device`` given without an index, else ``device`` itself."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def topology_backend(store, world_size: int, rank: int, cards: int,
                     host: Optional[str] = None) -> str:
    """The backend every rank of the job agrees on: publishes this rank's
    ``host`` (default: this machine's name) and ``cards`` (its CUDA cards,
    0 for a CPU rank) on ``store``, reads every rank's, and gives ``nccl``
    when no host runs more ranks than it has cards, else ``gloo``. Waits
    for every rank's entry up to the store's timeout."""
    host = host or socket.gethostname()
    store.set(f"bst/topology/{rank}", f"{cards}:{host}")
    ranks, host_cards = {}, {}
    for r in range(world_size):
        n, _, h = store.get(f"bst/topology/{r}").decode().partition(":")
        ranks[h] = ranks.get(h, 0) + 1
        host_cards[h] = min(host_cards.get(h, int(n)), int(n))
    return "nccl" if all(ranks[h] <= host_cards[h] for h in ranks) else "gloo"


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
    omitted, as the reference does, meets the other ranks on the
    coordinator's ``TCPStore`` (rank 0 hosts it) and calls
    ``torch.distributed.init_process_group(backend, store=..., world_size,
    rank)``. ``backend`` defaults by the topology (``topology_backend``, on
    that store): ``nccl`` for a ``cuda`` ``device`` when every rank has a
    card of its own on its host, else ``gloo`` (ranks sharing a card, or
    ``cpu``). ``COORDINATOR_TIMEOUT_S`` bounds the
    rendezvous: a coordinator that cannot be reached, or a rank that never
    comes, raises; a collective waits up to ``COLLECTIVE_TIMEOUT_S``. Returns True once the group is
    up; False for the single-process no-op (no coordinator configured)."""
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
    host, _, port = coordinator_address.rpartition(":")
    store = dist.TCPStore(
        host, int(port), num_processes, process_id == 0,
        timeout=datetime.timedelta(seconds=COORDINATOR_TIMEOUT_S),
    )
    if backend is None:
        cuda = resolve_device(device).type == "cuda"
        backend = topology_backend(store, num_processes, process_id,
                                   torch.cuda.device_count() if cuda else 0)
    dist.init_process_group(
        backend, store=store, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    _initialized = True
    return True


def global_mesh(device="cuda"):
    """The (groups x nodes) mesh over every rank of the job, on this rank's
    device (``rank_device``). Without a process group (``init_distributed``
    returned False) it is a mesh of this process alone, over a one-rank
    group."""
    if not dist.is_initialized():
        dev = resolve_device(device)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
    return make_mesh(device=rank_device(device, dist.get_rank()))
