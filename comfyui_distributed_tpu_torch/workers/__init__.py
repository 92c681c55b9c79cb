"""Worker processes: launch, stop, PID records, the master watchdog,
machine detection and the master's start-up and shutdown."""

from .process_manager import WorkerProcessManager, get_worker_manager  # noqa: F401
