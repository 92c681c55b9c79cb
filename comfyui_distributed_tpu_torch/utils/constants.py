"""Timeouts, intervals and sizes of the elastic tier and the server,
each overridable by an environment variable.

The port's own copy of the knobs of comfyui_distributed_tpu/utils/
constants.py that it reads, with the same CDT_* names and defaults.
Values are read once, at import.
"""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


# --- roles ---------------------------------------------------------------
# Worker processes carry this variable; it marks the server's role.
WORKER_ENV_FLAG = "CDT_IS_WORKER"
# A launched worker carries its master's PID here; the worker's
# watchdog (workers/monitor.py) exits when that process is gone.
MASTER_PID_ENV = "CDT_MASTER_PID"
# The card a launched worker sees, from its config entry's cuda_device.
CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"

# --- heartbeat / liveness ------------------------------------------------
HEARTBEAT_INTERVAL_SECONDS = _env_float("CDT_HEARTBEAT_INTERVAL", 5.0)
HEARTBEAT_TIMEOUT_SECONDS = _env_float("CDT_HEARTBEAT_TIMEOUT", 60.0)

# --- payloads ------------------------------------------------------------
# The largest request body the server reads (413 past it), the room a
# worker leaves under it when it sizes a flush, and the most tiles in
# one flush.
MAX_PAYLOAD_SIZE = _env_int("CDT_MAX_PAYLOAD_SIZE", 50 * 1024 * 1024)
PAYLOAD_HEADROOM = 1024 * 1024
MAX_TILE_BATCH = _env_int("CDT_MAX_BATCH", 20)

# --- probes / retries ----------------------------------------------------
PROBE_TIMEOUT_SECONDS = _env_float("CDT_PROBE_TIMEOUT", 5.0)
DISPATCH_TIMEOUT_SECONDS = _env_float("CDT_DISPATCH_TIMEOUT", 30.0)
PROBE_CONCURRENCY = _env_int("CDT_ORCHESTRATION_PROBE_CONCURRENCY", 8)
REQUEST_RETRY_COUNT = _env_int("CDT_REQUEST_RETRIES", 5)
REQUEST_RETRY_BACKOFF = _env_float("CDT_REQUEST_BACKOFF", 0.5)
WORK_PULL_RETRY_COUNT = _env_int("CDT_WORK_PULL_RETRIES", 10)
WORK_PULL_RETRY_CAP_SECONDS = _env_float("CDT_WORK_PULL_RETRY_CAP", 30.0)

# --- request lifecycle ---------------------------------------------------
# Failed delivery attempts (timeout requeues) a tile may accumulate
# before it leaves the pull set as poison, and what the job then does:
# "degrade" completes it with the region blended from the base image,
# "fail" raises JobPoisoned.
TILE_MAX_ATTEMPTS = _env_int("CDT_TILE_MAX_ATTEMPTS", 3)
POISON_POLICY = os.environ.get("CDT_POISON_POLICY", "degrade")
# Default end-to-end job deadline in seconds when a request names none
# (0 = none).
JOB_DEADLINE_DEFAULT_SECONDS = _env_float("CDT_JOB_DEADLINE_DEFAULT", 0.0)

# --- elastic tile pipeline (graph/tile_pipeline.py) ----------------------
# CDT_PIPELINE=0 runs the pull/sample/encode/submit stages serially on
# the calling thread; otherwise the puller and I/O stages get threads.
PIPELINE_ENABLED = os.environ.get("CDT_PIPELINE", "1") != "0"
# Device batches the sampler may run ahead of the I/O stage.
PIPELINE_DEPTH = _env_int("CDT_PIPELINE_DEPTH", 1)
# Pull the next grant while the device samples the current one.
PIPELINE_PREFETCH = os.environ.get("CDT_PIPELINE_PREFETCH", "1") != "0"

# --- circuit breaker (resilience/health.py) ------------------------------
CIRCUIT_SUSPECT_THRESHOLD = _env_int("CDT_CIRCUIT_SUSPECT_AFTER", 2)
CIRCUIT_FAILURE_THRESHOLD = _env_int("CDT_CIRCUIT_FAILURES", 5)
CIRCUIT_COOLDOWN_SECONDS = _env_float("CDT_CIRCUIT_COOLDOWN", 30.0)

# --- media sync ----------------------------------------------------------
MEDIA_SYNC_TIMEOUT_SECONDS = _env_float("CDT_MEDIA_SYNC_TIMEOUT", 120.0)

# --- worker processes ----------------------------------------------------
AUTO_LAUNCH_DELAY_SECONDS = _env_float("CDT_AUTO_LAUNCH_DELAY", 2.0)
MONITOR_POLL_INTERVAL_SECONDS = _env_float("CDT_MONITOR_POLL_INTERVAL", 2.0)

# --- job init races ------------------------------------------------------
# How long a result submission or a pull waits for the master to create
# the job, and the worker's job-ready poll.
JOB_INIT_GRACE_SECONDS = _env_float("CDT_JOB_INIT_GRACE", 10.0)
JOB_READY_POLL_ATTEMPTS = _env_int("CDT_JOB_READY_POLLS", 20)
JOB_READY_POLL_INTERVAL = _env_float("CDT_JOB_READY_POLL_INTERVAL", 1.0)
QUEUE_POLL_INTERVAL_SECONDS = _env_float("CDT_QUEUE_POLL_INTERVAL", 0.1)
# The master's collector waits for worker images in this many slices of
# the worker timeout, checking for an interrupt between them.
COLLECTOR_WAIT_SLICES = _env_int("CDT_COLLECTOR_WAIT_SLICES", 20)

# --- network -------------------------------------------------------------
DEFAULT_MASTER_PORT = _env_int("CDT_MASTER_PORT", 8188)

# --- debug ---------------------------------------------------------------
DEBUG_FLAG_TTL_SECONDS = 5.0


def deterministic_blend() -> bool:
    """CDT_DETERMINISTIC_BLEND=1 composites the master's canvas in sorted
    tile order at the end instead of in arrival order (read per job)."""
    return os.environ.get("CDT_DETERMINISTIC_BLEND") == "1"
