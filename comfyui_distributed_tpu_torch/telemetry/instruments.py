"""Canonical instrument definitions: every metric name in one place.

The port's own copy of comfyui_distributed_tpu/telemetry/instruments.py,
limited to the families whose counting code exists in the port. Names,
help texts and label names are the JAX package's, letter for letter, so
a dashboard built against a JAX master reads a port master unchanged.
The JAX families the port does not register yet are listed, by the
ROADMAP step that brings each, in tests/test_torch_telemetry.py
(STILL_TO_PORT): durability, the mesh, the cross-job tier and the
`cdt_jax_*` compile gauges, which have no counterpart here. Two help
texts are worded apart from the JAX package's
(`cdt_cache_unsettled_admission_cost`: the JAX text cites the
package's change history and a runbook; `cdt_profile_captures_total`
names torch.profiler where the JAX text names jax.profiler); their
names, kinds and labels are the JAX families'.

Accessors are get-or-create against the CURRENT global registry, so a
test that resets the registry gets fresh instruments transparently.
Live-state gauges (queue depths, breaker states) are scrape-time
collectors bound per server via `bind_server_collectors`.
"""

from __future__ import annotations

from typing import Callable

from .metrics import Counter, Gauge, Histogram, get_metrics_registry

# Breaker states in gauge encoding.
BREAKER_STATE_CODES = {
    "healthy": 0,
    "suspect": 1,
    "quarantined": 2,
    "probing": 3,
    "recovered": 4,
}


# --- job store ------------------------------------------------------------

def store_pulls_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_store_pulls_total",
        "Tile/image pull RPCs against the JobStore by outcome (task|empty)",
        ("worker_id", "outcome"),
    )


def store_submits_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_store_submits_total",
        "Result submissions by outcome (accepted|duplicate)",
        ("worker_id", "outcome"),
    )


def store_heartbeats_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_store_heartbeats_total",
        "Heartbeats recorded per worker (explicit + piggybacked)",
        ("worker_id",),
    )


def store_requeued_tasks_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_store_requeued_tasks_total",
        "Tasks returned to the pending queue by reason "
        "(timeout|quarantine|speculative|released)",
        ("worker_id", "reason"),
    )


# --- request lifecycle (deadlines / cancel / poison) ----------------------

def jobs_cancelled_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_jobs_cancelled_total",
        "Jobs reaching the terminal cancelled state by reason "
        "(client|deadline|chaos|...)",
        ("reason",),
    )


def cancel_refunded_tiles_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_cancel_refunded_tiles_total",
        "Tiles refunded by job cancellation by kind (pending|in_flight)",
        ("kind",),
    )


def poison_pardons_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_poison_pardons_total",
        "Breaker pardons issued to workers whose failures traced to a "
        "poison-quarantined tile",
    )


def shed_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_shed_total",
        "Admissions shed by the brownout controller, by lane",
        ("lane",),
    )


def brownout_level() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_brownout_level",
        "Current brownout level (number of lowest-priority lanes shed)",
    )


def preempt_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_preempt_total",
        "Step-level preemption requests raised by the scheduler "
        "coordinator against running lower-lane jobs, by reason "
        "(premium_arrival|brownout|manual)",
        ("reason",),
    )


def poison_quarantined_tiles_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_poison_quarantined_tiles_total",
        "Tiles quarantined out of the pull set after exhausting their "
        "delivery-attempt budget",
    )


# --- dispatch / orchestration --------------------------------------------

def dispatch_seconds() -> Histogram:
    return get_metrics_registry().histogram(
        "cdt_dispatch_seconds",
        "Prompt dispatch latency per worker by outcome "
        "(ok|rejected|unreachable|error)",
        ("worker_id", "outcome"),
    )


def orchestrations_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_orchestrations_total",
        "Distributed queue orchestrations by mode (fan_out|load_balance)",
        ("mode",),
    )


def media_sync_seconds() -> Histogram:
    return get_metrics_registry().histogram(
        "cdt_media_sync_seconds",
        "Media sync duration per worker",
        ("worker_id",),
    )


def media_sync_uploads_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_media_sync_uploads_total",
        "Media files uploaded to workers by outcome (ok|failed)",
        ("worker_id", "outcome"),
    )


def collector_results_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_collector_results_total",
        "Images accepted into collector queues per worker",
        ("worker_id",),
    )


# --- resilience -----------------------------------------------------------

def retries_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_retries_total",
        "Retry attempts by retry_async, labelled by operation",
        ("op",),
    )


def breaker_transitions_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_worker_breaker_transitions_total",
        "Circuit-breaker state transitions per worker",
        ("worker_id", "from_state", "to_state"),
    )


def breaker_state() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_worker_breaker_state",
        "Circuit-breaker state per worker "
        "(0=healthy 1=suspect 2=quarantined 3=probing 4=recovered)",
        ("worker_id",),
    )


def push_grants_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_push_grants_total",
        "Tasks announced over pushed grant_available events "
        "(CDT_PUSH_GRANTS; workers wake on these instead of "
        "pull-polling)",
    )


def worker_master_errors_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_worker_master_errors_total",
        "Worker->master RPC failures by operation (heartbeat|pull|"
        "submit|transport); consecutive failures back off "
        "exponentially so a master outage never becomes a log/request "
        "flood",
        ("op",),
    )


# --- runtime health (telemetry/runtime.py) --------------------------------

def device_memory_bytes() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_device_memory_bytes",
        "Accelerator memory stats per device (bytes_in_use, "
        "peak_bytes_in_use, bytes_limit, ... from device.memory_stats)",
        ("device", "stat"),
    )


def host_rss_bytes() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_host_rss_bytes",
        "Resident set size of this process",
    )


# --- content-addressed tile result cache (cache/) -------------------------

def cache_lookups_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_cache_lookups_total",
        "Tile-cache lookups by outcome (hit_ram|hit_disk|miss) — "
        "mirrored by delta from the store's cumulative stats at scrape "
        "time",
        ("outcome",),
    )


def cache_settled_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_cache_settled_total",
        "Tiles settled into jobs straight from the tile cache at grant "
        "time (they completed without ever entering the pull set)",
    )


def cache_corrupt_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_cache_corrupt_total",
        "Disk-tier cache entries that failed CRC/format validation on "
        "read (deleted and degraded to a miss, never a wrong canvas)",
    )


def cache_bytes() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_cache_bytes",
        "Bytes resident per tile-cache tier (ram|disk) at scrape time",
        ("tier",),
    )


def cache_hit_ratio() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_cache_hit_ratio",
        "Lifetime tile-cache hit rate (hits / lookups) at scrape time",
    )


# --- adapter plane (adapters/) ---------------------------------------------

def adapter_cache_lookups_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_adapter_cache_lookups_total",
        "Adapter operand-cache lookups by outcome (hit|miss) — a miss "
        "means a safetensors decode + operand layout ran on the host "
        "(docs/operator-runbook.md §adapter thrashing)",
        ("outcome",),
    )


def adapter_cache_evictions_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_adapter_cache_evictions_total",
        "Adapter operand entries evicted by the byte-budget LRU "
        "(CDT_ADAPTER_CACHE_MB); sustained growth alongside misses = "
        "the working set exceeds the budget (thrashing)",
    )


def adapter_cache_bytes() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_adapter_cache_bytes",
        "Resident bytes of decoded adapter operands in the host LRU",
    )


def adapter_jobs_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_adapter_jobs_total",
        "Jobs admitted carrying a non-empty adapter plan",
        ("tier",),
    )


# --- device-time profiling plane (telemetry/profiling.py) ------------------

def transfer_bytes_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_transfer_bytes_total",
        "Bytes moved across the device↔host boundary by direction "
        "(h2d|d2h), mirrored by delta from the transfer ledger at "
        "scrape time",
        ("direction",),
    )


def device_execute_seconds() -> Histogram:
    return get_metrics_registry().histogram(
        "cdt_device_execute_seconds",
        "Bracketed wall time of one compiled device dispatch (the "
        "transfer ledger's device side; eager/stub dispatches are "
        "excluded by construction)",
        ("role", "tier"),
    )


def host_tax_ratio() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_host_tax_ratio",
        "host_ns / (host_ns + device_ns) from the transfer ledger at "
        "scrape time — the fraction of attributable wall time spent on "
        "host gather/encode/ship instead of device execution (1.0 when "
        "no device time was observed)",
        ("role",),
    )


def profile_captures_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_profile_captures_total",
        "On-demand torch.profiler captures by outcome "
        "(started|stopped|busy|errors|auto_stopped), mirrored by delta "
        "from the capture manager's counters at scrape time",
        ("outcome",),
    )


# --- incident plane (telemetry/flight.py, telemetry/incidents.py) ---------

def incidents_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_incidents_total",
        "Incident debug bundles captured, by trigger "
        "(alert_fired|tile_quarantined|job_deadline|failover|manual)",
        ("trigger",),
    )


def incident_capture_seconds() -> Histogram:
    return get_metrics_registry().histogram(
        "cdt_incident_capture_seconds",
        "Wall time of one incident-bundle capture (gather + serialize "
        "+ atomic write + prune) on the single-flight writer thread",
    )


def flight_dropped_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_flight_dropped_total",
        "Flight-recorder ring evictions by stream (events|spans) — "
        "history lost to the bounded window before any capture",
        ("stream",),
    )


# --- USDU tile pipeline ---------------------------------------------------

def tile_stage_seconds() -> Histogram:
    return get_metrics_registry().histogram(
        "cdt_tile_stage_seconds",
        "Per-tile stage latency (pull|sample|readback|encode|submit|"
        "decode|blend) by role (master|worker)",
        ("stage", "role"),
    )


def tiles_processed_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_tiles_processed_total",
        "Tiles fully processed per role",
        ("role",),
    )


# --- elastic tile pipeline (graph/tile_pipeline.py) ------------------------

def pipeline_batches_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_pipeline_batches_total",
        "Batched device dispatches in the elastic tile pipeline by "
        "role and grant-chunk size",
        ("role", "bucket"),
    )


def pipeline_inflight() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_pipeline_inflight",
        "Device batches dispatched but not yet read back per role "
        "(bounded by CDT_PIPELINE_DEPTH)",
        ("role",),
    )


# --- queue / live state (scrape-time collectors) --------------------------
# The `server` label (e.g. "master:8188", "worker:8189") keeps the
# series of several DistributedServers in one process apart: a
# co-hosted master+worker pair (chip_smoke's elastic phase, the tests)
# shares the process-global registry.

def prompt_queue_depth() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_prompt_queue_depth",
        "Prompts queued (including the one executing) per server",
        ("server",),
    )


def tile_jobs_active() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_tile_jobs_active",
        "Tile/image jobs currently registered per server",
        ("server",),
    )


def tile_queue_depth() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_tile_queue_depth",
        "Pending tasks across all tile/image jobs per server",
        ("server",),
    )


def tiles_in_flight() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_tiles_in_flight",
        "Tasks pulled by a worker but not yet completed, per server",
        ("server",),
    )


def collector_jobs_active() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_collector_jobs_active",
        "Collector queues currently registered per server",
        ("server",),
    )


# --- watchdog (telemetry/watchdog.py) -------------------------------------

def worker_tile_seconds() -> Histogram:
    return get_metrics_registry().histogram(
        "cdt_worker_tile_seconds",
        "Pull-to-submit latency per worker (the straggler-detection "
        "signal; cardinality-capped per the registry's series bound)",
        ("worker_id",),
    )


def watchdog_stragglers_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_watchdog_stragglers_total",
        "Workers flagged as stragglers (rolling-median tile latency "
        "above k x the global rolling median)",
        ("worker_id",),
    )


def watchdog_stalls_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_watchdog_stalls_total",
        "Stalled executions detected (no completion progress for the "
        "stall window while tiles were in flight)",
    )


# --- the event bus (telemetry/events.py) -----------------------------------


def event_subscriber_queue_depth() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_event_subscriber_queue_depth",
        "Events queued per event-bus subscriber at scrape time "
        "(bounded by CDT_EVENT_QUEUE_SIZE)",
        ("subscriber",),
    )


def event_subscriber_dropped() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_event_subscriber_dropped",
        "Cumulative drop-oldest evictions per event-bus subscriber "
        "(a slow consumer loses its oldest events, never the bus)",
        ("subscriber",),
    )


# --- scheduler control plane (scheduler/) ---------------------------------

# Scheduler states in gauge encoding.
SCHED_STATE_CODES = {"running": 0, "paused": 1, "draining": 2}


def sched_admissions_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_sched_admissions_total",
        "Admission decisions by outcome (admitted|rejected_full|"
        "rejected_draining|cancelled)",
        ("lane", "tenant", "outcome"),
    )


def sched_grants_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_sched_grants_total",
        "Requests granted an orchestration slot per lane/tenant",
        ("lane", "tenant"),
    )


def sched_wait_seconds() -> Histogram:
    return get_metrics_registry().histogram(
        "cdt_sched_wait_seconds",
        "Queue wait from admission to grant per lane/tenant",
        ("lane", "tenant"),
    )


def sched_lane_depth() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_sched_lane_depth",
        "Requests queued (admitted, not yet granted) per lane per server",
        ("lane", "server"),
    )


def sched_active() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_sched_active",
        "Granted orchestrations currently holding a slot per server",
        ("server",),
    )


def sched_state() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_sched_state",
        "Scheduler state per server (0=running 1=paused 2=draining)",
        ("server",),
    )


def sched_worker_speed_ratio() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_sched_worker_speed_ratio",
        "Placement speed weight per worker (1.0 = fleet mean; pull "
        "batches scale with it)",
        ("worker_id", "server"),
    )


def cache_unsettled_admission_cost() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_cache_unsettled_admission_cost",
        "Cumulative DRR admission cost charged for tiles that later "
        "settled free from the tile cache at grant time — the "
        "full-cost-until-settle gap, surfaced so operators can see how "
        "much fair-share weight cached tenants are over-paying",
        ("server",),
    )


# --- fleet plane (telemetry/fleet.py, telemetry/slo.py) -------------------

def fleet_snapshots_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_fleet_snapshots_total",
        "Worker telemetry snapshots received piggybacked on "
        "heartbeat/request_image RPCs, by outcome "
        "(accepted|bad_version|malformed)",
        ("outcome",),
    )


def fleet_evictions_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_fleet_evictions_total",
        "Workers evicted from the fleet registry by reason "
        "(ttl|forgotten|capacity) — every eviction drops the worker's "
        "retained series",
        ("reason",),
    )


def fleet_workers() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_fleet_workers",
        "Workers currently tracked by the fleet registry (snapshotting "
        "within the CDT_FLEET_TTL window)",
    )


def fleet_series() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_fleet_series",
        "Retained time-series count in the fleet store (bounded per "
        "name by CDT_METRIC_MAX_SERIES)",
    )


def alert_active() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_alert_active",
        "1 while the named SLO's burn-rate alert is open, 0 otherwise "
        "(transitions also publish alert_fired/alert_resolved events)",
        ("slo",),
    )


def slo_burn_rate() -> Gauge:
    return get_metrics_registry().gauge(
        "cdt_slo_burn_rate",
        "Error-budget burn rate per SLO over each rule's LONG window "
        "(1.0 = burning exactly at budget-exhaustion rate)",
        ("slo", "window"),
    )


# --- usage attribution, mirrored from the master's aggregator -------------

def usage_chip_seconds_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_usage_chip_seconds_total",
        "Measured chip-seconds attributed to each (tenant, lane) by the "
        "usage meter's dispatch records (mirrored from the aggregator "
        "at scrape time; cardinality bounded by the usage key cap)",
        ("tenant", "lane"),
    )


def usage_tiles_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_usage_tiles_total",
        "Tiles finished per (tenant, lane) as metered by the usage "
        "attribution plane",
        ("tenant", "lane"),
    )


def usage_waste_seconds_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_usage_waste_seconds_total",
        "Measured chip-seconds charged to waste buckets by reason "
        "(padding|preempt_recompute|speculation|poison_retry)",
        ("reason",),
    )


def usage_cached_tiles_total() -> Counter:
    return get_metrics_registry().counter(
        "cdt_usage_cached_tiles_total",
        "Tiles settled from the content-addressed tile cache per "
        "(tenant, lane) — the `cached` attribution bucket: they count "
        "toward the tenant's tiles at ~zero chip-time",
        ("tenant", "lane"),
    )


_LIVE_GAUGES = (
    prompt_queue_depth,
    tile_jobs_active,
    tile_queue_depth,
    tiles_in_flight,
    collector_jobs_active,
)


def bind_server_collectors(server) -> Callable[[], None]:
    """Register scrape-time collectors mirroring one server's live
    state (prompt queue, JobStore, breaker registry, tile cache,
    transfer ledger) into gauges. Returns an unbind callable (the
    server calls it on stop) that also drops the server's gauge series
    from the scrape."""
    from ..cache.store import get_tile_cache
    from ..resilience.health import get_health_registry
    from ..utils import constants
    from .flight import peek_flight_recorder
    from .profiling import get_profiler_capture, peek_transfer_ledger
    from .runtime import ensure_runtime_collectors

    # host RSS and the card's memory ride the same scrape;
    # process-global, bound once per registry
    ensure_runtime_collectors()
    # the tile-pipeline instruments are present from the first scrape,
    # before any tile job ran on this server
    pipeline_batches_total()
    pipeline_inflight()
    # tile-cache instruments whenever the cache is live in this process
    if get_tile_cache() is not None:
        cache_lookups_total()
        cache_settled_total()
        cache_corrupt_total()
        cache_bytes()
        cache_hit_ratio()
    # profiling instruments while the transfer ledger is on (CDT_PROFILING,
    # on by default)
    if constants.PROFILING_ENABLED:
        transfer_bytes_total()
        device_execute_seconds()
        host_tax_ratio()
    # the fleet plane's instruments from the first scrape on a master
    # that runs it, before any worker snapshotted
    fleet = getattr(server, "fleet", None)
    if fleet is not None:
        fleet_snapshots_total()
        fleet_evictions_total()
        fleet_workers()
        fleet_series()
        alert_active()
        slo_burn_rate()
        if getattr(fleet, "usage", None) is not None:
            usage_chip_seconds_total()
            usage_tiles_total()
            usage_waste_seconds_total()
            usage_cached_tiles_total()
    if getattr(server, "scheduler", None) is not None:
        cache_unsettled_admission_cost()
    # the incident plane's instruments from the first scrape: the flight
    # drops wherever a recorder exists, the capture instruments on a
    # master with an incident manager, the profiler captures wherever
    # CDT_PROFILE_DIR turns them on
    if peek_flight_recorder() is not None:
        flight_dropped_total()
    if getattr(server, "incidents", None) is not None:
        incidents_total()
        incident_capture_seconds()
    if get_profiler_capture() is not None:
        profile_captures_total()

    label = f"{'worker' if server.is_worker else 'master'}:{server.port}"
    # worker ids this server's placement policy last reported: stale
    # series are removed per server (a global clear would clobber a
    # co-hosted server's series between its scrapes)
    speed_series_seen: set[str] = set()

    def collect() -> None:
        prompt_queue_depth().set(server.queue_remaining, server=label)
        stats = server.job_store.stats_unlocked()
        tile_jobs_active().set(stats["tile_jobs"], server=label)
        tile_queue_depth().set(stats["queue_depth"], server=label)
        tiles_in_flight().set(stats["in_flight"], server=label)
        collector_jobs_active().set(stats["collectors"], server=label)
        scheduler = getattr(server, "scheduler", None)
        if scheduler is not None:
            queue = scheduler.queue
            sched_state().set(SCHED_STATE_CODES.get(queue.state, -1), server=label)
            sched_active().set(len(queue.active), server=label)
            for lane_name in queue.lane_order:
                sched_lane_depth().set(queue.lanes[lane_name].depth(), lane=lane_name,
                                       server=label)
            speed_gauge = sched_worker_speed_ratio()
            weights = scheduler.placement.weights()
            # dropped workers must not freeze a series
            for worker_id in speed_series_seen - weights.keys():
                speed_gauge.remove(worker_id=worker_id, server=label)
            speed_series_seen.clear()
            speed_series_seen.update(weights)
            for worker_id, ratio in weights.items():
                speed_gauge.set(ratio, worker_id=worker_id, server=label)
            # the DRR admission-cost gap: cost charged at admission for
            # tiles the cache later settled free
            cache_unsettled_admission_cost().set(
                float(getattr(scheduler, "unsettled_admission_cost", 0.0)), server=label)
        slo = getattr(server, "slo", None)
        if slo is not None:
            # alert gauges reflect the engine's current state even if no
            # transition fired since the last step; burn rates ride along
            active_gauge = alert_active()
            burn_gauge = slo_burn_rate()
            for spec_name in slo.specs:
                active_gauge.set(1.0 if slo.is_active(spec_name) else 0.0, slo=spec_name)
                try:
                    verdict = slo.evaluate(spec_name)
                except Exception:  # noqa: BLE001 - the scrape survives an evaluation
                    continue
                for rule in verdict["rules"]:
                    burn_gauge.set(rule["burn_long"], slo=spec_name,
                                   window=f"{int(rule['long_s'])}s")
        # Usage attribution counters mirror the aggregator's cumulative
        # rollup by DELTA against its own high-water marks (shared by
        # co-hosted servers' collectors, so a chip-second counts once).
        usage = getattr(fleet, "usage", None) if fleet is not None else None
        if usage is not None:
            rollup = usage.rollup()
            marks = usage.scrape_mirrored
            # exact (tenant, lane) slices from the aggregator's monotonic
            # pair view (live + retired)
            by_pair = usage.pair_totals()
            for (tenant, lane) in sorted(by_pair):
                pair_stats = by_pair[(tenant, lane)]
                for key, value, counter in (
                    (f"chip:{tenant}:{lane}", pair_stats["chip_s"], usage_chip_seconds_total()),
                    (f"tiles:{tenant}:{lane}", pair_stats["tiles"], usage_tiles_total()),
                    (f"cached:{tenant}:{lane}", pair_stats.get("cached", 0.0),
                     usage_cached_tiles_total()),
                ):
                    delta = value - marks.get(key, 0.0)
                    if delta > 0:
                        counter.inc(delta, tenant=tenant, lane=lane)
                        marks[key] = value
            waste_counter = usage_waste_seconds_total()
            for reason in sorted(rollup["totals"]["waste_s"]):
                value = rollup["totals"]["waste_s"][reason]
                delta = value - marks.get(f"waste:{reason}", 0.0)
                if delta > 0:
                    waste_counter.inc(delta, reason=reason)
                    marks[f"waste:{reason}"] = value
        # Tile-cache stats: gauges set directly, counters mirrored by
        # DELTA against the cache's own high-water marks (shared across
        # co-hosted collectors so a lookup is counted exactly once).
        tile_cache = get_tile_cache()
        if tile_cache is not None:
            cstats = tile_cache.stats()
            cache_bytes().set(cstats["ram_bytes"], tier="ram")
            cache_bytes().set(cstats["disk_bytes"], tier="disk")
            cache_hit_ratio().set(cstats["hit_rate"])
            cache_marks = tile_cache.scrape_mirrored
            lookup_counter = cache_lookups_total()
            for outcome, value in (
                ("hit_ram", cstats["hits_ram"]),
                ("hit_disk", cstats["hits_disk"]),
                ("miss", cstats["misses"]),
            ):
                delta = value - cache_marks.get(outcome, 0)
                if delta > 0:
                    lookup_counter.inc(delta, outcome=outcome)
                    cache_marks[outcome] = value
            delta = cstats["corrupt"] - cache_marks.get("corrupt", 0)
            if delta > 0:
                cache_corrupt_total().inc(delta)
                cache_marks["corrupt"] = cstats["corrupt"]
        # Transfer-ledger mirroring: the direction byte counters move by
        # DELTA against the ledger's own high-water marks (shared across
        # co-hosted collectors), the host-tax gauge reads the live ratio:
        # one ledger a process, so co-hosted roles read the same number.
        ledger = peek_transfer_ledger()
        if ledger is not None:
            lsnap = ledger.snapshot()
            bytes_counter = transfer_bytes_total()
            for direction in sorted(lsnap["transfer"]):
                value = lsnap["transfer"][direction]["bytes"]
                mark_key = f"bytes:{direction}"
                delta = value - ledger.scrape_mirrored.get(mark_key, 0)
                if delta > 0:
                    bytes_counter.inc(delta, direction=direction)
                    ledger.scrape_mirrored[mark_key] = value
            host_tax_ratio().set(
                lsnap["host_tax"],
                role="worker" if server.is_worker else "master",
            )
        # The flight recorder's drops and the profiler capture's outcomes
        # are plain ints on their owners (the recorder's tap must not
        # touch a metric: it runs inside publish); the counters mirror
        # them by DELTA against the owners' own marks, shared by
        # co-hosted servers' collectors so each counts once.
        recorder = peek_flight_recorder()
        if recorder is not None:
            drop_counter = flight_dropped_total()
            for stream, dropped in recorder.drop_totals().items():
                delta = dropped - recorder.scrape_mirrored.get(stream, 0)
                if delta > 0:
                    drop_counter.inc(delta, stream=stream)
                    recorder.scrape_mirrored[stream] = dropped
        capture = get_profiler_capture()
        if capture is not None:
            capture_counter = profile_captures_total()
            for outcome in sorted(capture.counters):
                value = capture.counters[outcome]
                delta = value - capture.scrape_mirrored.get(outcome, 0)
                if delta > 0:
                    capture_counter.inc(delta, outcome=outcome)
                    capture.scrape_mirrored[outcome] = value
        # Event-bus consumers (a /distributed/events client is a queue):
        # depth and cumulative drops per subscriber, cleared then refilled
        # so a departed subscriber's series drops instead of freezing.
        from .events import get_event_bus

        depth_gauge = event_subscriber_queue_depth()
        drop_gauge = event_subscriber_dropped()
        depth_gauge.clear()
        drop_gauge.clear()
        for sub_stats in get_event_bus().stats()["subscribers"]:
            depth_gauge.set(sub_stats["queue_depth"], subscriber=sub_stats["name"])
            drop_gauge.set(sub_stats["dropped"], subscriber=sub_stats["name"])
        gauge = breaker_state()
        # Clear-then-refill: a worker removed from the registry must drop
        # its series, not freeze at its last state.
        gauge.clear()
        for worker_id, health in get_health_registry().snapshot().items():
            gauge.set(
                BREAKER_STATE_CODES.get(health["state"], -1), worker_id=worker_id
            )

    unregister = get_metrics_registry().register_collector(collect)

    def unbind() -> None:
        unregister()
        for accessor in _LIVE_GAUGES:
            accessor().remove(server=label)
        event_subscriber_queue_depth().clear()
        event_subscriber_dropped().clear()
        slo = getattr(server, "slo", None)
        if slo is not None:
            for spec_name in slo.specs:
                alert_active().remove(slo=spec_name)
            slo_burn_rate().clear()
        scheduler = getattr(server, "scheduler", None)
        if scheduler is not None:
            cache_unsettled_admission_cost().remove(server=label)
            sched_state().remove(server=label)
            sched_active().remove(server=label)
            for lane_name in scheduler.queue.lane_order:
                sched_lane_depth().remove(lane=lane_name, server=label)
            for worker_id in speed_series_seen:
                sched_worker_speed_ratio().remove(worker_id=worker_id, server=label)

    return unbind
