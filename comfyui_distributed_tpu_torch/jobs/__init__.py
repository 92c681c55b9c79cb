"""Elastic-tier job state: queues, heartbeats, timeout and requeue (the
port's own copy of comfyui_distributed_tpu/jobs/)."""

from .models import CollectorJob, TileJob  # noqa: F401
from .store import JobStore  # noqa: F401
