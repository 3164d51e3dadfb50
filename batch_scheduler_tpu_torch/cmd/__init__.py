"""CLI layer — the port's counterpart of ``batch_scheduler_tpu/cmd``
(the reference's ``cmd/scheduler`` entry point,
reference cmd/scheduler/main.go:28-36)."""

from .config import SchedulerConfiguration, load_scheduler_config
from .main import main

__all__ = ["main", "SchedulerConfiguration", "load_scheduler_config"]
