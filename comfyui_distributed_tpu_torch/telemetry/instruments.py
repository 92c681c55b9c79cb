"""Canonical instrument definitions: every metric name in one place.

The port's own copy of comfyui_distributed_tpu/telemetry/instruments.py,
limited to the families whose counting code exists in the port. Names,
help texts and label names are the JAX package's, letter for letter, so
a dashboard built against a JAX master reads a port master unchanged.
The JAX families the port does not register yet are listed, by the
ROADMAP step that brings each, in tests/test_torch_telemetry.py
(STILL_TO_PORT): the scheduler, the watchdog, the fleet plane and its
usage aggregation, durability, the mesh, the cross-job tier, the
incident plane, the profiler capture, and the `cdt_jax_*` compile
gauges, which have no counterpart here.

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
    from .profiling import peek_transfer_ledger
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

    label = f"{'worker' if server.is_worker else 'master'}:{server.port}"

    def collect() -> None:
        prompt_queue_depth().set(server.queue_remaining, server=label)
        stats = server.job_store.stats_unlocked()
        tile_jobs_active().set(stats["tile_jobs"], server=label)
        tile_queue_depth().set(stats["queue_depth"], server=label)
        tiles_in_flight().set(stats["in_flight"], server=label)
        collector_jobs_active().set(stats["collectors"], server=label)
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

    return unbind
