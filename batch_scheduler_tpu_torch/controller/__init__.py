from .controller import GC_HORIZON_SECONDS, PodGroupController

__all__ = ["GC_HORIZON_SECONDS", "PodGroupController"]
