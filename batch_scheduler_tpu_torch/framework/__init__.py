from .cluster import ClusterState

__all__ = ["ClusterState"]
