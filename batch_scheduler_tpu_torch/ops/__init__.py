"""Host packing (numpy) and the device batch (torch + the CUDA scan)."""

from .rescore import ChurnRescorer, TickPipeline, probe_link_depth

__all__ = ["ChurnRescorer", "TickPipeline", "probe_link_depth"]
