from .batch_plugin import PLUGIN_NAME, BatchSchedulingPlugin
from .factory import PluginConfig, PluginRuntime, new_plugin_runtime
from .leader import FileLease, InMemoryLease, LeaseRecord, try_run_controller

__all__ = [
    "PLUGIN_NAME",
    "BatchSchedulingPlugin",
    "PluginConfig",
    "PluginRuntime",
    "new_plugin_runtime",
    "FileLease",
    "InMemoryLease",
    "LeaseRecord",
    "try_run_controller",
]
