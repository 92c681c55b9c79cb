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
# The largest audio waveform an envelope carries (its float32 bytes).
MAX_AUDIO_PAYLOAD_BYTES = _env_int("CDT_MAX_AUDIO_PAYLOAD_BYTES", 256 * 1024 * 1024)

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
# Brownout (scheduler/brownout.py): when the queue-wait p95 crosses its
# threshold, admission sheds one more lowest-priority lane (never the
# top one); a level steps at most once a cooldown and steps back once
# the signals fall under half their thresholds.
SHED_WAIT_P95_SECONDS = _env_float("CDT_SHED_WAIT_P95", 20.0)
SHED_WINDOW_SAMPLES = _env_int("CDT_SHED_WINDOW", 64)
SHED_COOLDOWN_SECONDS = _env_float("CDT_SHED_COOLDOWN", 5.0)

# --- watchdog (telemetry/watchdog.py) --------------------------------------
# A worker whose rolling-median tile latency exceeds STRAGGLER_FACTOR x
# the global rolling median (with MIN_SAMPLES completions in its window)
# is flagged suspect; a job with no completion for STALL seconds while
# tiles are in flight gets them speculatively re-enqueued. CDT_WATCHDOG=0
# turns the server's watchdog off entirely.
WATCHDOG_INTERVAL_SECONDS = _env_float("CDT_WATCHDOG_INTERVAL", 2.0)
WATCHDOG_STRAGGLER_FACTOR = _env_float("CDT_WATCHDOG_STRAGGLER_FACTOR", 4.0)
WATCHDOG_MIN_SAMPLES = _env_int("CDT_WATCHDOG_MIN_SAMPLES", 3)
WATCHDOG_STALL_SECONDS = _env_float("CDT_WATCHDOG_STALL_SECONDS", 30.0)
WATCHDOG_LATENCY_WINDOW = _env_int("CDT_WATCHDOG_LATENCY_WINDOW", 64)

# --- scheduler control plane (scheduler/) ----------------------------------
# Admission lanes in strict priority order as "name:depth"; a request
# lands in its payload's `lane` (default SCHED_DEFAULT_LANE). A full lane
# answers 429 with Retry-After.
SCHED_LANES = os.environ.get("CDT_SCHED_LANES", "interactive:64,batch:256,background:1024")
SCHED_DEFAULT_LANE = os.environ.get("CDT_SCHED_DEFAULT_LANE", "interactive")
# Orchestrations running at once; the rest wait in their lane
# (deficit round robin over tenants) for a grant.
SCHED_MAX_ACTIVE = _env_int("CDT_SCHED_MAX_ACTIVE", 4)
# DRR quantum in cost units a tenant visit; a tenant's replenishment is
# quantum x its weight ("tenantA=3,tenantB=1"; unlisted tenants weigh 1).
SCHED_QUANTUM = _env_float("CDT_SCHED_QUANTUM", 1.0)
SCHED_TENANT_WEIGHTS = os.environ.get("CDT_SCHED_TENANT_WEIGHTS", "")
# How long the queue route parks a request for its grant before 429.
SCHED_GRANT_TIMEOUT_SECONDS = _env_float("CDT_SCHED_GRANT_TIMEOUT", 120.0)
# Placement (scheduler/placement.py): an EWMA over each worker's
# pull-to-submit tile latency; a grant scales with the worker's relative
# speed (BASE_PULL_BATCH at 1.0, at most MAX_PULL_BATCH); in the last
# TAIL_TILES of a job, suspect workers and workers slower than
# TRIM_RATIO x the mean are denied pulls.
SCHED_EWMA_ALPHA = _env_float("CDT_SCHED_EWMA_ALPHA", 0.25)
SCHED_MIN_SAMPLES = _env_int("CDT_SCHED_MIN_SAMPLES", 2)
SCHED_BASE_PULL_BATCH = _env_int("CDT_SCHED_BASE_PULL_BATCH", 2)
SCHED_MAX_PULL_BATCH = _env_int("CDT_SCHED_MAX_PULL_BATCH", 8)
SCHED_TAIL_TILES = _env_int("CDT_SCHED_TAIL_TILES", 2)
SCHED_TRIM_RATIO = _env_float("CDT_SCHED_TRIM_RATIO", 0.5)
# Preemption (scheduler/preempt.py): 1 lets a higher-lane arrival flag
# running lower-lane jobs (their pulls read as drained until the flags
# lift); inert while every job shares one lane. PREEMPT_BROWNOUT_LEVEL
# is the brownout level from which shed lanes' running jobs are flagged
# too (0 = never).
PREEMPT_ENABLED = _env_int("CDT_PREEMPT", 1)
PREEMPT_BROWNOUT_LEVEL = _env_int("CDT_PREEMPT_BROWNOUT_LEVEL", 0)

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


# --- content-addressed tile result cache (cache/) --------------------------
# CDT_CACHE=1 makes the elastic master consult its tile cache before it
# creates a job (hits settle straight into the job and never reach a
# worker) and populate it as tiles blend. Read per job.
def cache_enabled() -> bool:
    return _env_int("CDT_CACHE", 0) == 1


# RAM LRU budget for tile results (MB); an entry larger than the whole
# budget lives on disk only
CACHE_RAM_MB = _env_float("CDT_CACHE_RAM_MB", 256.0)
# disk tier budget (MB): the oldest files by mtime go past it; 0 = none
CACHE_DISK_MB = _env_float("CDT_CACHE_DISK_MB", 1024.0)
CACHE_DIR_DISABLED_VALUES = ("0", "off", "none")


def cache_dir() -> str | None:
    """The disk tier's directory (CDT_CACHE_DIR); None = RAM only."""
    raw = os.environ.get("CDT_CACHE_DIR", "").strip()
    if not raw or raw.lower() in CACHE_DIR_DISABLED_VALUES:
        return None
    return raw


# --- adapter plane (adapters/) ----------------------------------------------
def adapter_cache_mb() -> float:
    """The operand cache's budget (MB) for decoded adapter operands."""
    return _env_float("CDT_ADAPTER_CACHE_MB", 256.0)


def adapter_cold_cost() -> float:
    """DRR admission cost multiplier of a job whose adapter operands are
    not in the operand cache; 1.0 (the default) leaves cost unchanged."""
    return _env_float("CDT_ADAPTER_COLD_COST", 1.0)


def budget_tenants() -> tuple[str, ...]:
    """CDT_BUDGET_TENANTS: tenants whose requests without a lane ride
    the cheap lane."""
    raw = os.environ.get("CDT_BUDGET_TENANTS", "")
    return tuple(sorted({t.strip() for t in raw.split(",") if t.strip()}))


def cheap_lane() -> str:
    """The lane budget tenants ride (CDT_CHEAP_LANE, default background)."""
    return os.environ.get("CDT_CHEAP_LANE", "background").strip() or "background"


def cache_cost_enabled() -> bool:
    """CDT_CACHE_COST=1 discounts a tenant's DRR admission cost by its
    recent share of tiles settled from the tile cache; 0 (the default)
    keeps admission cost blind to hits."""
    return _env_int("CDT_CACHE_COST", 0) == 1


def cache_cost_floor() -> float:
    """The least fraction of full cost a discounted admission pays
    (CDT_CACHE_COST_FLOOR, default 0.25)."""
    return min(1.0, max(0.0, _env_float("CDT_CACHE_COST_FLOOR", 0.25)))


# --- telemetry (telemetry/) -------------------------------------------------
# The transfer ledger (telemetry/profiling.py): 0 turns off the
# per-dispatch device/host split, the transfer bytes and the host-tax
# ratio. While it is on, each tile's dispatch waits for the card inside
# its bracket. Read at every dispatch (ledger_if_enabled), so a profiler
# may flip the attribute between runs.
PROFILING_ENABLED = os.environ.get("CDT_PROFILING", "1") != "0"
# The usage meter (telemetry/usage.py): 0 turns off the per-dispatch
# chip-time attribution records and the store's usage notes. Read at
# each use.
USAGE_ENABLED = os.environ.get("CDT_USAGE", "1") != "0"
# 1 multiplies a request's DRR admission cost by its tenant's measured
# chip seconds a tile over the fleet mean (the master's usage
# aggregator).
USAGE_COST_ENABLED = _env_int("CDT_USAGE_COST", 0) == 1
# Usage entries idle this long fold into retired aggregates and their
# series leave the store.
USAGE_TTL_SECONDS = _env_float("CDT_USAGE_TTL", 3600.0)
# Per-subscriber bound of the event bus (telemetry/events.py): a
# /distributed/events consumer slower than the event rate loses its
# oldest events.
EVENT_QUEUE_SIZE = _env_int("CDT_EVENT_QUEUE_SIZE", 512)

# --- push grants (graph/usdu_elastic.py::GrantSignal) -----------------------
# Workers hold the master's /distributed/events stream and wake on
# pushed grant_available frames; 0 keeps the pure pull protocol.
PUSH_GRANTS_ENABLED = os.environ.get("CDT_PUSH_GRANTS", "1") != "0"
# How long a worker parks on the grant signal after an empty pull before
# it concludes the queue is drained.
PUSH_WAIT_SECONDS = _env_float("CDT_PUSH_WAIT", 1.0)

# --- fleet plane (telemetry/fleet.py, telemetry/slo.py) ---------------------
# 0 turns the master's fleet plane off (its routes answer enabled=false).
FLEET_ENABLED = os.environ.get("CDT_FLEET", "1") != "0"
# Seconds between the master's sampling passes (sweep, rollup, SLO burn).
FLEET_INTERVAL_SECONDS = _env_float("CDT_FLEET_INTERVAL", 10.0)
# Least seconds between a worker's piggybacked snapshots (<= 0: none).
FLEET_SNAPSHOT_SECONDS = _env_float("CDT_FLEET_SNAPSHOT_SECONDS", 10.0)
# A worker silent this long leaves the fleet view with its series.
FLEET_TTL_SECONDS = _env_float("CDT_FLEET_TTL", 120.0)
# SLO latency target: the tile pull-to-submit p95.
SLO_TILE_P95_SECONDS = _env_float("CDT_SLO_TILE_P95", 5.0)

# --- profiler capture (telemetry/profiling.py::ProfilerCapture) -------------
# A torch.profiler capture asked for more seconds than this is clamped;
# an unstopped capture auto-stops at its duration.
PROFILE_MAX_SECONDS = _env_float("CDT_PROFILE_MAX_SECONDS", 30.0)
# Retention under CDT_PROFILE_DIR: the oldest trace directories go past
# this many or this many MB (never the newest capture).
PROFILE_MAX_CAPTURES = _env_int("CDT_PROFILE_MAX", 8)
PROFILE_MAX_MB = _env_float("CDT_PROFILE_MAX_MB", 512.0)
# 1 lets every incident bundle take a short capture of its own on the
# incident writer thread, lasting PROFILE_AUTO_SECONDS.
PROFILE_AUTO_ENABLED = _env_int("CDT_PROFILE_AUTO", 0) == 1
PROFILE_AUTO_SECONDS = _env_float("CDT_PROFILE_AUTO_SECONDS", 2.0)


def profile_dir_from_env() -> str | None:
    """CDT_PROFILE_DIR, read at each call; unset or empty turns the
    profiler capture and its routes off."""
    raw = os.environ.get("CDT_PROFILE_DIR", "").strip()
    return raw or None


# --- incident plane (telemetry/flight.py, telemetry/incidents.py) ----------
# The flight recorder: an event-bus tap that keeps the last events and
# span closes in bounded drop-oldest rings, so a bundle captured after a
# trigger holds what came before it. 0 turns it off.
FLIGHT_ENABLED = os.environ.get("CDT_FLIGHT", "1") != "0"
FLIGHT_EVENT_CAPACITY = _env_int("CDT_FLIGHT_EVENTS", 2048)
FLIGHT_SPAN_CAPACITY = _env_int("CDT_FLIGHT_SPANS", 2048)
# Incident bundles, written into CDT_INCIDENT_DIR (unset: no incident
# manager) on alert_fired, a quarantined tile, a deadline cancel, a
# failover or a manual POST. A trigger key re-firing inside DEBOUNCE
# seconds captures nothing; any two automatic captures are at least
# MIN_INTERVAL seconds apart.
INCIDENT_DEBOUNCE_SECONDS = _env_float("CDT_INCIDENT_DEBOUNCE", 300.0)
INCIDENT_MIN_INTERVAL_SECONDS = _env_float("CDT_INCIDENT_MIN_INTERVAL", 10.0)
# Retention: the oldest bundles go past this many or this many MB.
INCIDENT_MAX_BUNDLES = _env_int("CDT_INCIDENT_MAX", 32)
INCIDENT_MAX_MB = _env_float("CDT_INCIDENT_MAX_MB", 64.0)
# Seconds of fleet and usage history a bundle takes around its trigger.
INCIDENT_WINDOW_SECONDS = _env_float("CDT_INCIDENT_WINDOW", 600.0)


def incident_dir_from_env() -> str | None:
    """CDT_INCIDENT_DIR, read at each call; unset or empty turns the
    incident manager off."""
    raw = os.environ.get("CDT_INCIDENT_DIR", "").strip()
    return raw or None
