"""The oracle's rank mesh: ``torch.distributed`` bootstrap, the mesh, the
sharded batch and its collective counts, and the followers' loop (the port
of ``batch_scheduler_tpu/parallel``, without its three readers of XLA's
compiled artefacts)."""

from .distributed import global_mesh, init_distributed
from .mesh import (
    ShardMesh,
    follow,
    make_mesh,
    shard_snapshot_args,
    sharded_collective_counts,
    sharded_scan_collective_counts,
    sharded_schedule_batch,
    stop_followers,
)

__all__ = [
    "ShardMesh",
    "follow",
    "global_mesh",
    "init_distributed",
    "make_mesh",
    "shard_snapshot_args",
    "sharded_collective_counts",
    "sharded_scan_collective_counts",
    "sharded_schedule_batch",
    "stop_followers",
]
