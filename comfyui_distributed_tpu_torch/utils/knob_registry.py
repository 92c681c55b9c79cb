"""Registry of every ``CDT_*`` environment knob the port reads.

The port's own registry, beside comfyui_distributed_tpu/utils/
knob_registry.py: it lists exactly the knobs some module of
``comfyui_distributed_tpu_torch`` reads, no more and no fewer
(tests/test_torch_knob_registry.py scans the package for every whole-
string ``CDT_*`` constant, as the JAX package's lint does, and holds the
two sets equal). An incident bundle's ``knobs`` section is this registry
resolved against the environment (telemetry/incidents.py::
resolved_knobs), so a bundle never claims a setting the port ignores.

``default`` is the rendered default: what the port's reading site
resolves with the variable unset, as a string. Where a knob means what
it means in the JAX package, ``effect`` is the JAX text.
"""

from __future__ import annotations

from typing import NamedTuple


class Knob(NamedTuple):
    name: str
    default: str
    subsystem: str
    effect: str


KNOBS: tuple[Knob, ...] = (
    # --- roles -------------------------------------------------------------
    Knob("CDT_IS_WORKER", "unset", "roles",
         "Set on spawned worker processes; suppresses master-only startup (auto-launch, "
         "signal cleanup) and flips `python -m comfyui_distributed_tpu_torch` into worker "
         "mode."),
    Knob("CDT_MASTER_PID", "unset", "roles",
         "Master PID a worker watches; the worker exits when that process dies."),
    Knob("CDT_HOST", "127.0.0.1", "roles",
         "Bind address for the HTTP server (pass 0.0.0.0 to serve the LAN)."),
    # --- liveness ----------------------------------------------------------
    Knob("CDT_HEARTBEAT_INTERVAL", "5.0", "liveness",
         "Seconds between worker heartbeats to the master job store."),
    Knob("CDT_HEARTBEAT_TIMEOUT", "60.0", "liveness",
         "Seconds without a heartbeat before a worker's tiles are requeued."),
    Knob("CDT_COLLECTOR_WAIT_SLICES", "20", "liveness",
         "The result collector waits in timeout/N slices so interrupts propagate fast."),
    # --- payloads ----------------------------------------------------------
    Knob("CDT_MAX_PAYLOAD_SIZE", "52428800", "payloads",
         "Maximum HTTP payload bytes accepted by the API (50 MB default)."),
    Knob("CDT_MAX_BATCH", "20", "payloads",
         "Maximum tiles per submit flush from a worker."),
    Knob("CDT_MAX_AUDIO_PAYLOAD_BYTES", "268435456", "payloads",
         "Maximum decoded audio payload bytes (256 MB default)."),
    # --- orchestration -----------------------------------------------------
    Knob("CDT_ORCHESTRATION_PROBE_CONCURRENCY", "8", "orchestration",
         "Concurrent worker liveness probes during dispatch."),
    Knob("CDT_MEDIA_SYNC_TIMEOUT", "120.0", "orchestration",
         "Per-file media sync upload timeout in seconds."),
    Knob("CDT_PROBE_TIMEOUT", "5.0", "orchestration",
         "Worker liveness probe timeout in seconds."),
    Knob("CDT_DISPATCH_TIMEOUT", "30.0", "orchestration",
         "Per-worker prompt dispatch timeout in seconds."),
    Knob("CDT_REQUEST_RETRIES", "5", "orchestration",
         "Retry attempts for idempotent master<->worker HTTP requests."),
    Knob("CDT_REQUEST_BACKOFF", "0.5", "orchestration",
         "Base seconds for exponential retry backoff (with jitter)."),
    Knob("CDT_WORK_PULL_RETRIES", "10", "orchestration",
         "Worker-side retry attempts for tile pull requests."),
    Knob("CDT_WORK_PULL_RETRY_CAP", "30.0", "orchestration",
         "Ceiling in seconds on the pull-retry backoff."),
    # --- resilience --------------------------------------------------------
    Knob("CDT_CIRCUIT_SUSPECT_AFTER", "2", "resilience",
         "Consecutive transport failures before a worker is marked suspect."),
    Knob("CDT_CIRCUIT_FAILURES", "5", "resilience",
         "Failure threshold that opens the circuit (quarantine + tile requeue)."),
    Knob("CDT_CIRCUIT_COOLDOWN", "30.0", "resilience",
         "Seconds a quarantined worker waits before a half-open probe."),
    Knob("CDT_DETERMINISTIC_BLEND", "unset", "resilience",
         "`1` forces sorted-order deferred compositing so the blended canvas is "
         "bit-identical regardless of tile arrival order (chip_smoke.py and "
         "profile_elastic.py set it)."),
    # --- lifecycle ---------------------------------------------------------
    Knob("CDT_JOB_DEADLINE_DEFAULT", "0.0", "lifecycle",
         "Default end-to-end job deadline in seconds applied when a request names none; 0 "
         "= no default deadline."),
    Knob("CDT_POISON_POLICY", "degrade", "lifecycle",
         "`degrade` completes a job with poison-quarantined tiles blended from the base "
         "image; `fail` raises a terminal JobPoisoned error."),
    Knob("CDT_SHED_COOLDOWN", "5.0", "lifecycle",
         "Seconds between brownout level steps (hysteresis against flapping)."),
    Knob("CDT_SHED_WAIT_P95", "20.0", "lifecycle",
         "Queue-wait p95 seconds above which the brownout controller sheds one more "
         "lowest-priority lane (the premium lane never sheds)."),
    Knob("CDT_SHED_WINDOW", "64", "lifecycle",
         "Rolling sample window for the brownout controller's p95 signals."),
    Knob("CDT_TILE_MAX_ATTEMPTS", "3", "lifecycle",
         "Failed delivery attempts (crash/timeout requeues) a tile may accumulate before "
         "it is quarantined out of the pull set as poison."),
    # --- watchdog ----------------------------------------------------------
    Knob("CDT_WATCHDOG", "1", "watchdog",
         "`0` disables the server's background straggler/stall monitor thread."),
    Knob("CDT_WATCHDOG_INTERVAL", "2.0", "watchdog",
         "Seconds between watchdog evaluation steps."),
    Knob("CDT_WATCHDOG_STRAGGLER_FACTOR", "4.0", "watchdog",
         "A worker whose rolling median tile latency exceeds this multiple of the global "
         "median is flagged suspect."),
    Knob("CDT_WATCHDOG_MIN_SAMPLES", "3", "watchdog",
         "Minimum completions in a worker's window before straggler verdicts."),
    Knob("CDT_WATCHDOG_STALL_SECONDS", "30.0", "watchdog",
         "A job quiet this long with tiles in flight triggers speculative re-dispatch."),
    Knob("CDT_WATCHDOG_LATENCY_WINDOW", "64", "watchdog",
         "Rolling latency window length per worker."),
    # --- scheduler ---------------------------------------------------------
    Knob("CDT_SCHED_LANES", "interactive:64,batch:256,background:1024", "scheduler",
         "Admission lanes in strict priority order as name:depth pairs; a full lane "
         "answers HTTP 429 + Retry-After."),
    Knob("CDT_SCHED_DEFAULT_LANE", "interactive", "scheduler",
         "Lane used when a queue request names none."),
    Knob("CDT_SCHED_MAX_ACTIVE", "4", "scheduler",
         "Orchestrations allowed to run concurrently; the rest wait in lanes."),
    Knob("CDT_SCHED_QUANTUM", "1.0", "scheduler",
         "Deficit-round-robin quantum (cost units) added per tenant visit."),
    Knob("CDT_SCHED_TENANT_WEIGHTS", "empty", "scheduler",
         "Per-tenant DRR weights as `tenantA=3,tenantB=1`; unlisted tenants weigh 1."),
    Knob("CDT_SCHED_GRANT_TIMEOUT", "120.0", "scheduler",
         "Seconds the queue route parks a request awaiting its grant before 429."),
    Knob("CDT_SCHED_EWMA_ALPHA", "0.25", "scheduler",
         "Smoothing factor for per-worker tile-latency speed EWMAs."),
    Knob("CDT_SCHED_MIN_SAMPLES", "2", "scheduler",
         "Samples required before a worker's speed EWMA influences placement."),
    Knob("CDT_SCHED_BASE_PULL_BATCH", "2", "scheduler",
         "Pull grant size for a speed-1.0 worker."),
    Knob("CDT_SCHED_MAX_PULL_BATCH", "8", "scheduler",
         "Ceiling on speed-scaled pull grant sizes."),
    Knob("CDT_SCHED_TAIL_TILES", "2", "scheduler",
         "Within this many remaining tiles, suspect/slow workers are denied pulls."),
    Knob("CDT_SCHED_TRIM_RATIO", "0.5", "scheduler",
         "Workers slower than this fraction of fleet mean speed are trimmed from the job "
         "tail."),
    Knob("CDT_PREEMPT", "1", "scheduler",
         "Preemption: a premium-lane arrival flags running lower-lane jobs, whose pulls "
         "read drained until the flags lift. Inert while every job shares one lane; `0` "
         "disables entirely."),
    Knob("CDT_PREEMPT_BROWNOUT_LEVEL", "0", "scheduler",
         "Brownout shed level at/above which running jobs in shed lanes are flagged too "
         "(not just refused admission); `0` keeps brownout admission-only."),
    # --- pipeline ----------------------------------------------------------
    Knob("CDT_PIPELINE", "1", "pipeline",
         "`0` replaces the staged tile pipeline with the serial per-tile loop."),
    Knob("CDT_PIPELINE_DEPTH", "1", "pipeline",
         "In-flight device batches the sampler may run ahead of the I/O stage."),
    Knob("CDT_PIPELINE_PREFETCH", "1", "pipeline",
         "`0` disables claiming the next grant while the device samples the current one."),
    # --- ha ----------------------------------------------------------------
    Knob("CDT_PUSH_GRANTS", "1", "ha",
         "`0` disables push-mode grants: workers then pull-poll instead of waking on "
         "pushed grant_available events over /distributed/events."),
    Knob("CDT_PUSH_WAIT", "1.0", "ha",
         "Seconds a push-mode worker parks on the grant signal after an empty pull before "
         "concluding the queue is drained."),
    # --- telemetry ---------------------------------------------------------
    Knob("CDT_METRIC_MAX_SERIES", "128", "telemetry",
         "Per-metric label-series cap; excess series collapse into `_overflow`."),
    Knob("CDT_EVENT_QUEUE_SIZE", "512", "telemetry",
         "Bounded per-subscriber queue for /distributed/events (drop-oldest)."),
    Knob("CDT_FLEET", "1", "telemetry",
         "`0` disables the fleet observability plane (monitor thread, master-side "
         "sampling, SLO evaluation; routes answer enabled=false)."),
    Knob("CDT_FLEET_INTERVAL", "10.0", "telemetry",
         "Seconds between master-side fleet sampling passes (sweep + rollup + SLO "
         "burn-rate evaluation)."),
    Knob("CDT_FLEET_SNAPSHOT_SECONDS", "10.0", "telemetry",
         "Minimum seconds between a worker's piggybacked telemetry snapshots on "
         "heartbeat/request_image; <=0 disables the piggyback."),
    Knob("CDT_FLEET_TTL", "120.0", "telemetry",
         "Seconds without a snapshot before a worker is evicted from the fleet view (all "
         "its retained series drop)."),
    Knob("CDT_PROFILE_AUTO", "0", "telemetry",
         "`1` makes every incident bundle take a short torch.profiler capture (requires "
         "CDT_PROFILE_DIR; the bundle records the capture ids)."),
    Knob("CDT_PROFILE_AUTO_SECONDS", "2.0", "telemetry",
         "Duration in seconds of the automatic incident-triggered capture."),
    Knob("CDT_PROFILE_DIR", "unset", "telemetry",
         "Directory retained torch.profiler captures are written into (one Chrome-trace "
         "JSON each); unset disables the /distributed/profile capture routes. The transfer "
         "ledger works without it."),
    Knob("CDT_PROFILE_MAX", "8", "telemetry",
         "Retained trace capture count; oldest captures pruned beyond it."),
    Knob("CDT_PROFILE_MAX_MB", "512.0", "telemetry",
         "Total on-disk trace budget in MB; oldest captures pruned beyond it."),
    Knob("CDT_PROFILE_MAX_SECONDS", "30.0", "telemetry",
         "Ceiling clamped onto any requested capture duration; every capture auto-stops at "
         "this bound even if /profile/stop never arrives."),
    Knob("CDT_PROFILING", "1", "telemetry",
         "`0` disables the transfer ledger (device/host time split, host-tax ratio, "
         "h2d/d2h byte accounting) on the elastic tier and its fleet-snapshot piggyback."),
    Knob("CDT_SLO_TILE_P95", "5.0", "telemetry",
         "Tile pull-to-submit latency target the tile_latency SLO classifies samples "
         "against (seconds)."),
    Knob("CDT_USAGE", "1", "telemetry",
         "`0` disables chip-time attribution records on the elastic tier and the "
         "master-side usage aggregation (GET /distributed/usage answers enabled=false)."),
    Knob("CDT_USAGE_COST", "0", "telemetry",
         "`1` multiplies DRR admission cost by the tenant's measured chip-seconds-per-tile "
         "ratio vs the fleet mean (clamped to [0.1, 10]), replacing the static "
         "estimated_tiles-only cost."),
    Knob("CDT_USAGE_TTL", "3600.0", "telemetry",
         "Seconds of inactivity before a job/tenant usage entry folds into retired "
         "aggregates and its retained series evict."),
    # --- cache -------------------------------------------------------------
    Knob("CDT_CACHE", "0", "cache",
         "`1` enables the master-side content-addressed tile result cache: hits settle "
         "into the job at grant time (never dispatched) and blend from cached pixels."),
    Knob("CDT_CACHE_DIR", "unset", "cache",
         "Directory for the CRC-checked disk tier; unset/`0`/`off`/`none` keeps the cache "
         "RAM-only."),
    Knob("CDT_CACHE_DISK_MB", "1024.0", "cache",
         "Disk-tier byte budget in MB (oldest entries pruned beyond it; 0 = unbounded)."),
    Knob("CDT_CACHE_RAM_MB", "256.0", "cache",
         "Host-RAM LRU byte budget in MB; an entry larger than the whole budget is stored "
         "disk-only."),
    Knob("CDT_CACHE_COST", "0", "cache",
         "`1` discounts DRR admission cost by the tenant's measured cache-hit share (tiles "
         "that settle from cache never burn chip time); bounded below by "
         "CDT_CACHE_COST_FLOOR."),
    Knob("CDT_CACHE_COST_FLOOR", "0.25", "cache",
         "Lower bound on the cache-hit admission discount multiplier: even an all-hits "
         "tenant pays this fraction of full cost."),
    # --- adapters ----------------------------------------------------------
    Knob("CDT_ADAPTER_CACHE_MB", "256.0", "adapters",
         "Host-RAM LRU byte budget in MB for decoded adapter operands (per-adapter "
         "rank-bucketed down/up pairs)."),
    Knob("CDT_ADAPTER_COLD_COST", "1.0", "adapters",
         "DRR admission cost multiplier for requests whose adapter plan is not resident in "
         "the operand cache; 1.0 disables the cold surcharge."),
    Knob("CDT_ADAPTER_RANK_BUCKETS", "4,8,16,32,64", "adapters",
         "Comma-separated rank-bucket set adapter operands zero-pad to."),
    Knob("CDT_BUDGET_TENANTS", "empty", "adapters",
         "Comma-separated tenant ids routed to the cheap lane at the queue route when "
         "their request names no explicit lane."),
    Knob("CDT_CHEAP_LANE", "background", "adapters",
         "The lane CDT_BUDGET_TENANTS route to."),
    # --- incidents ---------------------------------------------------------
    Knob("CDT_FLIGHT", "1", "incidents",
         "`0` disables the always-on flight recorder (the bus tap that retains recent "
         "events + span closes for incident bundles)."),
    Knob("CDT_FLIGHT_EVENTS", "2048", "incidents",
         "Flight-recorder event ring capacity (drop-oldest; drops counted in "
         "cdt_flight_dropped_total)."),
    Knob("CDT_FLIGHT_SPANS", "2048", "incidents",
         "Flight-recorder span-close ring capacity (drop-oldest)."),
    Knob("CDT_INCIDENT_DIR", "unset", "incidents",
         "Directory incident debug bundles are captured into; unset disables the incident "
         "manager."),
    Knob("CDT_INCIDENT_DEBOUNCE", "300.0", "incidents",
         "Seconds a trigger key (e.g. one SLO's alert) is debounced after a capture — a "
         "re-firing alert inside the window captures nothing."),
    Knob("CDT_INCIDENT_MIN_INTERVAL", "10.0", "incidents",
         "Global floor in seconds between ANY two automatic captures — an alert storm "
         "across many keys still cannot melt the disk."),
    Knob("CDT_INCIDENT_MAX", "32", "incidents",
         "Retained bundle count; the oldest bundles are pruned beyond it."),
    Knob("CDT_INCIDENT_MAX_MB", "64.0", "incidents",
         "Total on-disk bundle budget in MB; oldest pruned beyond it."),
    Knob("CDT_INCIDENT_WINDOW", "600.0", "incidents",
         "Seconds of retained fleet history pulled into a bundle around the trigger (the "
         "/distributed/fleet ?since= window)."),
    # --- jobs --------------------------------------------------------------
    Knob("CDT_JOB_INIT_GRACE", "10.0", "jobs",
         "Seconds result submission waits for the master-side queue to appear."),
    Knob("CDT_JOB_READY_POLLS", "20", "jobs",
         "Worker-side job-ready poll attempts before giving up."),
    Knob("CDT_JOB_READY_POLL_INTERVAL", "1.0", "jobs",
         "Seconds between worker-side job-ready polls."),
    Knob("CDT_QUEUE_POLL_INTERVAL", "0.1", "jobs",
         "Master collection-loop poll interval in seconds."),
    # --- workers -----------------------------------------------------------
    Knob("CDT_AUTO_LAUNCH_DELAY", "2.0", "workers",
         "Delay before auto-launching configured local workers at startup."),
    Knob("CDT_MONITOR_POLL_INTERVAL", "2.0", "workers",
         "Master-liveness poll interval inside worker processes."),
    Knob("CDT_LOG_DIR", "./logs/workers", "workers",
         "Directory for per-worker stdout/stderr log files."),
    # --- network -----------------------------------------------------------
    Knob("CDT_MASTER_PORT", "8188", "network",
         "Default master HTTP port."),
    Knob("CDT_CONFIG_PATH", "./cdt_torch_config.json", "network",
         "Overrides the JSON config file location."),
    # --- models ------------------------------------------------------------
    Knob("CDT_CHECKPOINT_DIR", "unset", "models",
         "Root directory (or direct file path) for model checkpoints "
         "(`<name>.{safetensors,ckpt,gguf}`)."),
    Knob("CDT_CLIP_VOCAB", "bundled asset dir", "models",
         "Directory holding OpenAI CLIP vocab.json/merges.txt."),
    Knob("CDT_T5_SPM", "unset", "models",
         "A SentencePiece model for T5 tokenization; the port reads none and its T5 "
         "tokenizer raises when this is set (unset uses the committed fallback vocab)."),
    Knob("CDT_LORA_DIR", "empty", "models",
         "Root directory for LoRA adapter files."),
    # --- graph-io ----------------------------------------------------------
    Knob("CDT_DATA_DIR", "./data", "graph-io",
         "Root data directory (inputs/outputs default beneath it)."),
    Knob("CDT_INPUT_DIR", "<data>/input", "graph-io",
         "Input image directory."),
    Knob("CDT_OUTPUT_DIR", "<data>/output", "graph-io",
         "Output image directory."),
)


def knob_names() -> set[str]:
    return {knob.name for knob in KNOBS}


def by_subsystem() -> dict[str, list[Knob]]:
    grouped: dict[str, list[Knob]] = {}
    for knob in KNOBS:
        grouped.setdefault(knob.subsystem, []).append(knob)
    return {sub: sorted(entries) for sub, entries in sorted(grouped.items())}
