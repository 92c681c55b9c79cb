"""Fleet observability: worker telemetry aggregation on the master.

The port's own copy of comfyui_distributed_tpu/telemetry/fleet.py. The
telemetry core is strictly per-process — every master and worker has
its own registry, and the master can see nothing about the fleet it
schedules beyond breaker states and placement weights. This module is
the master-side signal plane:

- **workers produce** a compact, versioned metrics snapshot
  (`local_snapshot()`: tile-stage p50/p95, tiles processed, pipeline
  inflight, the card's memory watermark and host RSS from
  telemetry/runtime.py, the device count) in the JAX package's schema
  and version, and piggyback it onto the heartbeat / `request_image`
  RPCs they already send (graph/usdu_elastic.HTTPWorkClient) — no new
  RPC, no new socket, at most one snapshot per
  `CDT_FLEET_SNAPSHOT_SECONDS`. Its `jax` block (XLA compiles and the
  compilation cache) reads zeros: nothing here is compiled by XLA. Its
  `devices` is 1 and its `mesh` empty: the mesh is ROADMAP.md Queue 1
  item 6;

- the **`FleetRegistry`** on the master validates the snapshot version,
  merges per-worker state, derives tiles/sec rates from successive
  snapshots (master clock, never the worker's), retains the
  load-bearing series in a two-tier `SeriesStore`
  (telemetry/timeseries.py), and rolls the fleet up: worker/device
  counts, aggregate tiles/sec (and per chip), stage-p95 envelope,
  compile/cache totals, memory watermarks;

- `sample()` adds the **master-side** series an autoscaler needs: queue-wait p95 (the brownout controller's wait window),
  journal-append p95, per-worker speed EWMAs + grant capacity from
  scheduler/placement.py, deadline-miss and shed counters — and feeds
  the cumulative admission/deadline counters into the SLO engine
  (telemetry/slo.py).

Eviction: a worker that stops snapshotting for `CDT_FLEET_TTL` seconds
— or that the placement policy / health registry forgets — has ALL its
per-worker series dropped (`forget_worker`), and the registry tracks
at most `MAX_TRACKED_WORKERS` (the placement policy's bound): snapshots
ride unauthenticated RPCs, so a worker-id churn storm must not grow
master memory.

Served by `GET /distributed/fleet` (rollups + per-worker drill-down +
`?since=` windowed history) and pushed as `fleet_rollup` events on the
process bus for the web panel's fleet card.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from ..utils import constants
from ..utils.logging import debug_log
from .timeseries import SeriesStore

# Snapshot wire-format version: the master ignores snapshots whose
# major version it does not speak (a newer worker against an older
# master degrades to "no fleet telemetry", never to a parse error).
# v2 (usage-metering PR) adds the cumulative `usage` block; v1
# snapshots stay accepted — the merge is version-gated, so an older
# worker degrades to "no usage telemetry", never to a drop.
# v3 (profiling PR) adds the cumulative `profiling` transfer-ledger
# block; same degradation rule (older worker = no host-tax telemetry).
SNAPSHOT_VERSION = 3
ACCEPTED_SNAPSHOT_VERSIONS = (1, 2, 3)

# Same bound the placement policy applies to advertised capacity
# (scheduler/placement.py): snapshots arrive on unauthenticated RPCs.
MAX_TRACKED_WORKERS = 1024

# Series names (label vocabulary: worker_id only — stage breakdowns
# stay in the latest-snapshot drill-down, not in retained series, so
# worker churn costs O(workers), not O(workers x stages)).
S_QUEUE_WAIT_P95 = "fleet_queue_wait_p95"
S_JOURNAL_P95 = "fleet_journal_p95"
S_TILES_PER_S = "fleet_tiles_per_s"
S_TILES_PER_CHIP_S = "fleet_tiles_per_chip_s"
S_DEADLINE_MISS = "fleet_deadline_miss_total"
S_SHED = "fleet_shed_total"
S_WORKER_TILES_PER_S = "fleet_worker_tiles_per_s"
S_WORKER_SPEED = "fleet_worker_speed_ratio"
S_WORKER_DEVICES = "fleet_worker_devices"

# The windowed-history series /distributed/fleet?since= serves.
HISTORY_SERIES = (
    S_QUEUE_WAIT_P95,
    S_JOURNAL_P95,
    S_TILES_PER_S,
    S_TILES_PER_CHIP_S,
    S_DEADLINE_MISS,
    S_SHED,
)
WORKER_HISTORY_SERIES = (
    S_WORKER_TILES_PER_S,
    S_WORKER_SPEED,
    S_WORKER_DEVICES,
)


# --- worker side: snapshot production --------------------------------------


def local_snapshot(role: str = "worker") -> dict[str, Any]:
    """Build this process's compact telemetry snapshot from the global
    registry + runtime readings. Pure read — never creates a CUDA
    context (the runtime collectors' own guarantee)."""
    from . import instruments
    from .metrics import histogram_quantile

    snap: dict[str, Any] = {"v": SNAPSHOT_VERSION, "role": role}
    # per-stage latency quantiles from the local stage histogram
    stages: dict[str, dict[str, float]] = {}
    hist = instruments.tile_stage_seconds()
    for key, data in hist.series_snapshot().items():
        stage, sample_role = key
        if sample_role != role or not data["count"]:
            continue
        stages[stage] = {
            "p50": histogram_quantile(
                hist.bounds, data["buckets"], data["count"], 0.5
            ),
            "p95": histogram_quantile(
                hist.bounds, data["buckets"], data["count"], 0.95
            ),
            "count": data["count"],
        }
    snap["stages"] = stages
    snap["tiles_total"] = instruments.tiles_processed_total().value(role=role)
    snap["inflight"] = instruments.pipeline_inflight().value(role=role)
    # runtime health (the card's memory watermark, RSS)
    try:
        from .runtime import runtime_snapshot

        rt = runtime_snapshot()
    except Exception:  # noqa: BLE001 - telemetry is best effort
        rt = {}
    snap["jax"] = {
        k: rt.get(k, 0)
        for k in ("compiles", "compile_time_s", "cache_hits", "cache_misses")
    }
    hbm_peak = 0
    for device in rt.get("devices", []) or []:
        memory = device.get("memory") or {}
        hbm_peak = max(
            hbm_peak,
            int(memory.get("peak_bytes_in_use")
                or memory.get("bytes_in_use") or 0),
        )
    snap["mem"] = {
        "hbm_peak_bytes": hbm_peak,
        "rss_bytes": int(rt.get("host_rss_bytes") or 0),
    }
    # one card a participant: the mesh is not ported
    snap["mesh"] = {}
    snap["devices"] = 1
    # v2: this process's cumulative chip-time attribution (the master
    # adopts it by delta with a counter-reset clamp)
    if constants.USAGE_ENABLED:
        try:
            from .usage import get_usage_meter

            snap["usage"] = get_usage_meter().snapshot(role=role)
        except Exception:  # noqa: BLE001 - usage block is advisory
            pass
    # v3: this process's cumulative transfer ledger (device/host split
    # + bytes moved); rollup sums the raw cumulative blocks — host-tax
    # is recomputed fleet-wide from the summed ns, not averaged.
    if constants.PROFILING_ENABLED:
        try:
            from .profiling import get_transfer_ledger

            snap["profiling"] = get_transfer_ledger().snapshot(role=role)
        except Exception:  # noqa: BLE001 - profiling block is advisory
            pass
    return snap


# --- master side: the registry ---------------------------------------------


class FleetRegistry:
    """Per-worker snapshot merge + fleet rollups + series retention."""

    def __init__(
        self,
        store: Optional[SeriesStore] = None,
        clock: Callable[[], float] = time.time,
        ttl: Optional[float] = None,
        max_workers: int = MAX_TRACKED_WORKERS,
    ) -> None:
        self.clock = clock
        self.store = store if store is not None else SeriesStore(clock=clock)
        self.ttl = ttl if ttl is not None else constants.FLEET_TTL_SECONDS
        self.max_workers = int(max_workers)
        # chip-time attribution plane (telemetry/usage.py): adopts the
        # v2 snapshots' usage blocks, retains per-tenant series in the
        # SAME store, and serves GET /distributed/usage. None when
        # CDT_USAGE=0.
        self.usage: Optional[Any] = None
        if constants.USAGE_ENABLED:
            from .usage import UsageAggregator

            self.usage = UsageAggregator(store=self.store, clock=clock)
            self.usage.on_evict_tenant = (
                lambda tenant: self.store.evict_label("tenant", tenant)
            )
        self._lock = threading.Lock()
        # worker_id -> {"snap", "seen", "rate", "prev_tiles", "prev_ts"}
        self._workers: dict[str, dict[str, Any]] = {}
        # master-side sources (bound once by the server)
        self._scheduler: Any = None
        self._job_store: Any = None
        self._slo: Any = None
        # master's own tiles counter baseline for its rate sample
        self._master_prev: Optional[tuple[float, float]] = None
        self._last_rollup: dict[str, Any] = {}

    # --- wiring -----------------------------------------------------------

    def bind_master(
        self, scheduler: Any = None, job_store: Any = None, slo: Any = None
    ) -> None:
        """Attach the master-side signal sources `sample()` reads:
        the scheduler control (brownout windows, placement weights,
        admission totals), the job store (depth stats), and the SLO
        engine the sampled counters feed."""
        self._scheduler = scheduler
        self._job_store = job_store
        self._slo = slo

    # --- worker snapshots --------------------------------------------------

    def note_snapshot(self, worker_id: str, snap: Any) -> bool:
        """Merge one piggybacked worker snapshot; returns False (and
        counts the drop) for malformed payloads, unknown versions, or a
        new worker beyond the tracking bound with nothing to evict."""
        from . import instruments

        worker_id = str(worker_id)
        if not isinstance(snap, dict):
            instruments.fleet_snapshots_total().inc(outcome="malformed")
            return False
        try:
            version = int(snap.get("v"))
        except (TypeError, ValueError):
            version = -1
        if version not in ACCEPTED_SNAPSHOT_VERSIONS:
            instruments.fleet_snapshots_total().inc(outcome="bad_version")
            return False
        now = self.clock()
        evicted: Optional[str] = None
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is None:
                if len(self._workers) >= self.max_workers:
                    # evict the longest-unseen worker — garbage ids
                    # (never re-snapshotting) age out first
                    evicted = min(
                        self._workers, key=lambda w: self._workers[w]["seen"]
                    )
                    del self._workers[evicted]
                entry = {
                    "snap": {}, "seen": now, "rate": 0.0,
                    "prev_tiles": None, "prev_ts": None,
                }
                self._workers[worker_id] = entry
            tiles_total = _as_float(snap.get("tiles_total"))
            prev_tiles, prev_ts = entry["prev_tiles"], entry["prev_ts"]
            if (
                tiles_total is not None
                and prev_tiles is not None
                and now > prev_ts
                and tiles_total >= prev_tiles
            ):
                entry["rate"] = (tiles_total - prev_tiles) / (now - prev_ts)
            if tiles_total is not None:
                entry["prev_tiles"], entry["prev_ts"] = tiles_total, now
            entry["snap"] = snap
            entry["seen"] = now
        if evicted is not None:
            self._drop_series(evicted, reason="capacity")
        instruments.fleet_snapshots_total().inc(outcome="accepted")
        # v2: adopt the worker's cumulative usage meter by delta
        # (counter-reset clamped inside the aggregator)
        if version >= 2 and self.usage is not None and "usage" in snap:
            self.usage.adopt(worker_id, snap.get("usage"))
        # per-worker retained series (master clock, bounded vocabulary)
        rate = entry["rate"]
        self.store.record(S_WORKER_TILES_PER_S, rate, worker_id=worker_id)
        devices = _as_float(snap.get("devices")) or 1
        self.store.record(S_WORKER_DEVICES, devices, worker_id=worker_id)
        return True

    # --- eviction -----------------------------------------------------------

    def forget_worker(self, worker_id: str, reason: str = "forgotten") -> None:
        """Drop a worker's latest state AND all its retained series —
        the seam the placement policy / health registry call when they
        forget a worker, and the TTL sweep's eviction path."""
        worker_id = str(worker_id)
        with self._lock:
            self._workers.pop(worker_id, None)
        if self.usage is not None:
            self.usage.forget_worker(worker_id)
        self._drop_series(worker_id, reason=reason)

    def _drop_series(self, worker_id: str, reason: str) -> None:
        from . import instruments

        dropped = self.store.evict_label("worker_id", worker_id)
        instruments.fleet_evictions_total().inc(reason=reason)
        debug_log(
            f"fleet: evicted worker {worker_id} ({reason}; "
            f"{dropped} series dropped)"
        )

    def sweep(self) -> list[str]:
        """TTL eviction: workers whose last snapshot is older than the
        TTL depart the fleet view (their breaker state may outlive this
        — the fleet view tracks telemetry liveness, not job liveness)."""
        now = self.clock()
        with self._lock:
            stale = [
                wid for wid, entry in self._workers.items()
                if now - entry["seen"] > self.ttl
            ]
        for wid in stale:
            self.forget_worker(wid, reason="ttl")
        return stale

    # --- master-side sampling ----------------------------------------------

    def sample(self) -> dict[str, Any]:
        """One master-side sampling pass: record the load-bearing
        series, feed the SLO engine's counter-sourced specs, and cache
        the rollup. Called by the FleetMonitor every CDT_FLEET_INTERVAL
        (and directly by tests)."""
        from . import instruments

        now = self.clock()
        scheduler = self._scheduler
        if scheduler is not None:
            try:
                signals = scheduler.brownout.signals()
                self.store.record(
                    S_QUEUE_WAIT_P95, signals["wait_p95"], ts=now
                )
                self.store.record(S_JOURNAL_P95, signals["journal_p95"], ts=now)
                shed = float(sum(scheduler.brownout.shed_counts.values()))
                self.store.record(S_SHED, shed, ts=now)
                totals = scheduler.queue.totals
                admitted = float(totals.get("admitted", 0))
                # availability counts EVERY refused admission as bad —
                # brownout sheds AND saturation/drain rejections (the
                # full-queue outage is exactly the case the SLO exists
                # for), matching the spec's served description
                bad = (
                    shed
                    + float(totals.get("rejected_full", 0))
                    + float(totals.get("rejected_draining", 0))
                )
                if self._slo is not None:
                    self._slo.set_counts(
                        "availability", bad=bad, total=admitted + bad
                    )
            except Exception as exc:  # noqa: BLE001 - sampling best effort
                debug_log(f"fleet: scheduler sample failed: {exc}")
            try:
                weights = scheduler.placement.weights()
                for wid, ratio in weights.items():
                    self.store.record(S_WORKER_SPEED, ratio, worker_id=wid)
            except Exception as exc:  # noqa: BLE001
                debug_log(f"fleet: placement sample failed: {exc}")
        try:
            deadline_miss = instruments.jobs_cancelled_total().value(
                reason="deadline"
            )
            self.store.record(S_DEADLINE_MISS, deadline_miss, ts=now)
            if self._slo is not None and scheduler is not None:
                admitted = float(scheduler.queue.totals.get("admitted", 0))
                self._slo.set_counts(
                    "deadline_miss", bad=deadline_miss, total=admitted
                )
        except Exception as exc:  # noqa: BLE001
            debug_log(f"fleet: deadline sample failed: {exc}")
        # the master is a fleet participant too: derive its own rate
        # from the local tiles counter, like a worker snapshot would
        master_rate = 0.0
        try:
            tiles = instruments.tiles_processed_total().value(role="master")
            if self._master_prev is not None and now > self._master_prev[0]:
                prev_ts, prev_tiles = self._master_prev
                if tiles >= prev_tiles:
                    master_rate = (tiles - prev_tiles) / (now - prev_ts)
            self._master_prev = (now, tiles)
        except Exception:  # noqa: BLE001
            pass
        rollup = self.rollup(master_rate=master_rate)
        self.store.record(S_TILES_PER_S, rollup["tiles_per_s"], ts=now)
        self.store.record(
            S_TILES_PER_CHIP_S, rollup["tiles_per_chip_s"], ts=now
        )
        instruments.fleet_workers().set(rollup["workers"])
        instruments.fleet_series().set(self.store.series_count())
        self._last_rollup = rollup
        return rollup

    def step(self) -> dict[str, Any]:
        """sweep + sample + publish one `fleet_rollup` event (and one
        `usage_rollup` when the attribution plane is on)."""
        self.sweep()
        rollup = self.sample()
        from .events import get_event_bus

        try:
            get_event_bus().publish("fleet_rollup", **rollup)
        except Exception:  # noqa: BLE001 - push side is best effort
            pass
        if self.usage is not None:
            try:
                # one aggregation pass: tenant cost EWMAs, retained
                # per-tenant/waste series, idle-entry sweep — then the
                # web panel's usage card refreshes off the event
                usage_rollup = self.usage.sample()
                get_event_bus().publish("usage_rollup", **usage_rollup)
            except Exception as exc:  # noqa: BLE001 - best effort
                debug_log(f"fleet: usage sample failed: {exc}")
        # the tile result cache (cache/) feeds the panel's Cache card
        # the same push-side way; absent cache (CDT_CACHE=0) = no event
        try:
            from ..cache.store import get_tile_cache

            tile_cache = get_tile_cache()
            if tile_cache is not None:
                get_event_bus().publish("cache_stats", **tile_cache.stats())
        except Exception as exc:  # noqa: BLE001 - best effort
            debug_log(f"fleet: cache stats publish failed: {exc}")
        return rollup

    # --- rollups / surfaces --------------------------------------------------

    def rollup(self, master_rate: float = 0.0) -> dict[str, Any]:
        """Fleet-level aggregation of the latest worker snapshots:
        sums for rates/counters, max envelopes for latency quantiles
        and memory watermarks (the conservative roll-up — a fleet p95
        is AT MOST the worst worker's p95)."""
        with self._lock:
            entries = {
                wid: dict(entry) for wid, entry in self._workers.items()
            }
        devices = 0
        tiles_per_s = master_rate
        inflight = 0.0
        stages: dict[str, dict[str, float]] = {}
        jax_tallies = {"compiles": 0.0, "cache_hits": 0.0, "cache_misses": 0.0}
        hbm_peak = 0
        rss_max = 0
        for entry in entries.values():
            snap = entry["snap"]
            devices += int(_as_float(snap.get("devices")) or 1)
            tiles_per_s += float(entry["rate"])
            inflight += _as_float(snap.get("inflight")) or 0.0
            for stage, q in (snap.get("stages") or {}).items():
                if not isinstance(q, dict):
                    continue
                bucket = stages.setdefault(
                    str(stage), {"p95": 0.0, "count": 0}
                )
                bucket["p95"] = max(bucket["p95"], _as_float(q.get("p95")) or 0.0)
                bucket["count"] += int(_as_float(q.get("count")) or 0)
            jax = snap.get("jax") or {}
            for key in jax_tallies:
                jax_tallies[key] += _as_float(jax.get(key)) or 0.0
            mem = snap.get("mem") or {}
            hbm_peak = max(hbm_peak, int(_as_float(mem.get("hbm_peak_bytes")) or 0))
            rss_max = max(rss_max, int(_as_float(mem.get("rss_bytes")) or 0))
        # v3: sum worker transfer-ledger blocks + the master's own
        # local ledger; host_tax recomputed from summed integer ns
        profiling = None
        try:
            from .profiling import merge_profiling_blocks, peek_transfer_ledger

            blocks = [
                entry["snap"].get("profiling") for entry in entries.values()
            ]
            local = peek_transfer_ledger()
            if local is not None:
                blocks.append(local.snapshot(role="master"))
            blocks = [b for b in blocks if b]
            if blocks:
                profiling = merge_profiling_blocks(blocks)
        except Exception as exc:  # noqa: BLE001 - rollup is advisory
            debug_log(f"fleet: profiling rollup failed: {exc}")
        return {
            "workers": len(entries),
            "devices": devices,
            "tiles_per_s": round(tiles_per_s, 4),
            "tiles_per_chip_s": round(tiles_per_s / max(1, devices), 4),
            "inflight": inflight,
            "stages": stages,
            "jax": {k: v for k, v in jax_tallies.items()},
            "mem": {"hbm_peak_bytes": hbm_peak, "rss_max_bytes": rss_max},
            "profiling": profiling,
            "alerts_active": (
                sorted(self._slo.active()) if self._slo is not None else []
            ),
        }

    def worker_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._workers)

    def status(
        self, since_s: Optional[float] = None, worker: Optional[str] = None
    ) -> dict[str, Any]:
        """The /distributed/fleet payload: rollup + per-worker
        drill-down (+ windowed history when `since_s` is given; scoped
        to one worker's series with `worker`)."""
        now = self.clock()
        with self._lock:
            workers = {
                wid: {
                    "seen_ago_s": round(now - entry["seen"], 3),
                    "tiles_per_s": round(entry["rate"], 4),
                    "snapshot": entry["snap"],
                }
                for wid, entry in self._workers.items()
                if worker is None or wid == worker
            }
        out: dict[str, Any] = {
            "version": SNAPSHOT_VERSION,
            "ttl_seconds": self.ttl,
            "rollup": self._last_rollup or self.rollup(),
            "workers": workers,
            "series": {
                "count": self.store.series_count(),
                "by_name": self.store.counts_by_name(),
                "overflows": self.store.overflows,
            },
        }
        if since_s is not None:
            history: dict[str, Any] = {
                name: self.store.window(name, since_s)
                for name in HISTORY_SERIES
            }
            per_worker: dict[str, dict] = {}
            for name in WORKER_HISTORY_SERIES:
                for wid in self.store.label_values(name, "worker_id"):
                    if worker is not None and wid != worker:
                        continue
                    per_worker.setdefault(wid, {})[name] = self.store.window(
                        name, since_s, worker_id=wid
                    )
            history["workers"] = per_worker
            out["history"] = history
            out["since_seconds"] = float(since_s)
        return out


def _as_float(value: Any) -> Optional[float]:
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


# --- the monitor thread ------------------------------------------------------


class FleetMonitor:
    """Periodic loop: fleet sweep/sample + SLO evaluation on one
    background thread (watchdog idiom: `step()` is directly callable,
    the clock lives in the registry/engine, and tests never need the
    thread)."""

    def __init__(
        self,
        registry: FleetRegistry,
        slo: Any = None,
        interval: Optional[float] = None,
    ) -> None:
        self.registry = registry
        self.slo = slo
        self.interval = (
            interval if interval is not None
            else constants.FLEET_INTERVAL_SECONDS
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def step(self) -> dict[str, Any]:
        rollup = self.registry.step()
        if self.slo is not None:
            self.slo.step()
        return rollup

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(self.interval):
                try:
                    self.step()
                except Exception as exc:  # noqa: BLE001 - monitor survives
                    debug_log(f"fleet monitor step failed: {exc}")

        self._thread = threading.Thread(
            target=run, name="cdt-fleet-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
