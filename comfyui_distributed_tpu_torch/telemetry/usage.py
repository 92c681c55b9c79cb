"""Usage metering: chip-time attribution for every dispatch.

The port's own copy of the `UsageMeter` of
comfyui_distributed_tpu/telemetry/usage.py:

- **attribution records** — the elastic tier times every device
  dispatch (`GrantSampler.sample` in graph/tile_pipeline.py) and hands
  the measured time to `UsageMeter.note_dispatch` together with one
  entry per device SLOT: real slots charge their owning job (and
  through the job-attrs map, its tenant + lane), wraparound-padding
  slots charge the ``padding`` waste bucket, and slots re-running steps
  a preempted tile had already completed charge ``preempt_recompute``.
  The port's dispatches are one tile each (K = 1): one real slot.

- **exact conservation** — all accounting is integer *chip-
  nanoseconds* (``measured_seconds × chips``, rounded once). A
  dispatch's chip-time divides evenly across its slots and the integer
  remainder lands in the ``overhead`` bucket, so

      attributed + waste(padding) + waste(preempt_recompute) + overhead
          == measured dispatch chip-time        (EXACTLY, per record
                                                 and cumulatively)

- **store-side waste** — work the dispatch could not know was wasted
  is charged where the verdict lands: a quarantine-class requeue (the
  poison-tile retry path) charges ``poison_retry`` with the failed
  attempt's assignment duration. These buckets ride outside the
  per-dispatch conservation identity (``totals["dispatch"]`` carries
  the exact family; ``waste_s`` the full taxonomy).

- **cached tiles** — tiles the master's tile cache settled count
  toward their job's tiles at the measured settle time, outside the
  identity (no dispatch happened).

Memory is bounded: at most `MAX_TRACKED_KEYS` job entries per role;
idle entries are swept into per-(role, tenant, lane) aggregates.
Attribution order is a pure function of the slot sequence and every
exported mapping is sorted, so two replays of the same dispatch stream
give identical rollups.

- **master-side aggregation** — `UsageAggregator` (owned by the
  master's FleetRegistry, telemetry/fleet.py) holds the master's own
  records and adopts each worker's cumulative meter from the snapshot
  the worker piggybacks on its pulls and heartbeats, by delta with a
  counter-reset clamp (a worker that restarted starts a fresh
  baseline). It serves ``GET /distributed/usage``, mirrors into the
  ``cdt_usage_*`` families at scrape time, and gives the scheduler
  each tenant's measured cost ratio (CDT_USAGE_COST).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from ..utils.logging import debug_log

# The waste taxonomy. Dispatch-family reasons participate in the per-dispatch conservation
# identity; store-family reasons are measured on the master's clock.
DISPATCH_WASTE_REASONS = ("padding", "preempt_recompute")
STORE_WASTE_REASONS = ("speculation", "poison_retry")
WASTE_REASONS = DISPATCH_WASTE_REASONS + STORE_WASTE_REASONS

# Slot kinds accepted by note_dispatch.
SLOT_REAL = "real"
SLOT_PADDING = "padding"
SLOT_RECOMPUTE = "recompute"

# Job ids and tenant names arrive on RPCs: a bound on what an
# unauthenticated caller can make the meter keep.
MAX_TRACKED_KEYS = 1024

DEFAULT_TENANT = "default"

_NS = 1_000_000_000


def _to_ns(seconds: float) -> int:
    return max(0, int(round(float(seconds) * _NS)))


def _s(ns: int) -> float:
    return ns / _NS


class _JobUsage:
    """Cumulative counters for one (role, job): integer chip-ns."""

    __slots__ = (
        "chip_ns", "steps", "tiles", "waste_ns", "cached_tiles",
        "cached_ns", "last_active",
    )

    def __init__(self) -> None:
        self.chip_ns = 0
        self.steps = 0
        self.tiles = 0
        # recompute/store waste charged against this job's tiles
        self.waste_ns = 0
        # tiles settled from the content-addressed cache (a subset of
        # `tiles` — they bump the cost denominator at near-zero chip
        # time) and the measured lookup/settle time charged for them
        # (the `cached` bucket: OUTSIDE the dispatch conservation
        # identity, like the store-family waste — no device dispatch
        # happened)
        self.cached_tiles = 0
        self.cached_ns = 0
        self.last_active = 0.0

    def as_dict(self) -> dict[str, Any]:
        return {
            "chip_s": _s(self.chip_ns),
            "steps": self.steps,
            "tiles": self.tiles,
            "waste_s": _s(self.waste_ns),
            "cached_tiles": self.cached_tiles,
            "cached_s": _s(self.cached_ns),
        }


class UsageMeter:
    """Per-process chip-time attribution. Thread-safe; the executor
    threads, the pipeline's I/O thread, and the server loop all write
    concurrently. The clock is injectable (activity timestamps
    only — never measurement: callers measure their own dispatches)."""

    def __init__(
        self,
        clock: Callable[[], float] = time.time,
        max_keys: int = MAX_TRACKED_KEYS,
    ) -> None:
        self.clock = clock
        self.max_keys = int(max_keys)
        self._lock = threading.Lock()
        # role -> job_id -> _JobUsage
        self._jobs: dict[str, dict[str, _JobUsage]] = {}
        # job_id -> (tenant, lane): fed by the store at job creation;
        # bounded like the job maps
        self._attrs: dict[str, tuple[str, str]] = {}
        # job_id -> adapter plan id ("hash@strength[+...]"): the
        # adapter plane's attribution join — metering a personalized
        # job must say WHICH personalization burned the chip time
        self._adapter_attrs: dict[str, str] = {}
        # role -> reason -> ns
        self._waste: dict[str, dict[str, int]] = {}
        # the `cached` bucket: tiles settled from the tile cache and the
        # (near-zero) measured settle time charged for them, per role —
        # outside the dispatch conservation identity by construction
        self._cached_tiles: dict[str, int] = {}
        self._cached_ns: dict[str, int] = {}
        # exact dispatch-family totals per role (the conservation set)
        self._dispatch_ns: dict[str, int] = {}
        self._attributed_ns: dict[str, int] = {}
        self._overhead_ns: dict[str, int] = {}
        self._dispatches: dict[str, int] = {}
        # counters folded out of evicted job entries, keyed by the
        # (role, tenant, lane) resolved AT EVICTION TIME — so the
        # tenant rollup (and the scrape mirror's per-pair counters)
        # stay monotonic and role-filtered views stay separate after a
        # sweep. Bounded: overflow folds into the default key.
        self._retired: dict[tuple[str, str, str], dict[str, int]] = {}

    # --- attrs ------------------------------------------------------------

    def note_job_attrs(self, job_id: str, tenant: Any, lane: Any) -> None:
        """Record a job's owning tenant + admission lane (the store's
        job creation feeds this; last write wins)."""
        job_id = str(job_id)
        with self._lock:
            if job_id not in self._attrs and len(self._attrs) >= self.max_keys:
                # oldest-inserted eviction: attrs are an advisory map,
                # unresolved jobs simply report the default tenant
                self._attrs.pop(next(iter(self._attrs)))
            self._attrs[job_id] = (
                str(tenant) if tenant else DEFAULT_TENANT,
                str(lane) if lane else "",
            )

    def job_attrs(self, job_id: str) -> tuple[str, str]:
        with self._lock:
            return self._attrs.get(str(job_id), (DEFAULT_TENANT, ""))

    def note_job_adapter(self, job_id: str, adapter_id: Any) -> None:
        """Record a job's adapter plan id (adapters/registry
        ``adapter_plan_key`` rendered compactly); "" clears. Bounded
        with the same oldest-inserted rule as the attrs map."""
        job_id = str(job_id)
        adapter_id = str(adapter_id or "")
        with self._lock:
            if not adapter_id:
                self._adapter_attrs.pop(job_id, None)
                return
            if (
                job_id not in self._adapter_attrs
                and len(self._adapter_attrs) >= self.max_keys
            ):
                self._adapter_attrs.pop(next(iter(self._adapter_attrs)))
            self._adapter_attrs[job_id] = adapter_id

    def job_adapter(self, job_id: str) -> str:
        with self._lock:
            return self._adapter_attrs.get(str(job_id), "")

    # --- recording --------------------------------------------------------

    def _job(self, role: str, job_id: str, now: float) -> _JobUsage:
        by_job = self._jobs.setdefault(role, {})
        entry = by_job.get(job_id)
        if entry is None:
            if len(by_job) >= self.max_keys:
                # evict the longest-idle entry, folding its counters
                # into the retired aggregate so totals stay conserved
                victim_id = min(by_job, key=lambda j: by_job[j].last_active)
                self._retire(role, victim_id, by_job.pop(victim_id))
            entry = _JobUsage()
            by_job[job_id] = entry
        entry.last_active = now
        return entry

    def _retire(self, role: str, job_id: str, entry: _JobUsage) -> None:
        """Fold an evicted job's counters into the retired aggregate
        under its (role, tenant, lane) — resolved NOW, while the attrs
        map still knows the job. Caller holds the lock."""
        tenant, lane = self._attrs.get(str(job_id), (DEFAULT_TENANT, ""))
        key = (role, tenant, lane)
        if key not in self._retired and len(self._retired) >= self.max_keys:
            key = (role, DEFAULT_TENANT, "")
        bucket = self._retired.setdefault(
            key, {"chip_ns": 0, "tiles": 0, "steps": 0, "waste_ns": 0,
                  "cached_tiles": 0, "cached_ns": 0},
        )
        bucket["chip_ns"] += entry.chip_ns
        bucket["tiles"] += entry.tiles
        bucket["steps"] += entry.steps
        bucket["waste_ns"] += entry.waste_ns
        bucket["cached_tiles"] += entry.cached_tiles
        bucket["cached_ns"] += entry.cached_ns

    def note_dispatch(
        self,
        *,
        tier: str,
        role: str,
        elapsed_s: float,
        chips: int,
        slots: list[dict[str, Any]],
    ) -> dict[str, Any]:
        """Attribute one measured device dispatch across its slots.

        ``slots`` has exactly one entry per device slot of the padded
        bucket: ``{"job_id": str, "kind": real|padding|recompute}``.
        The measured chip-time (``elapsed_s × chips``, integer ns)
        divides evenly across the slots; the division remainder charges
        ``overhead``. Returns the record's exact split (tests pin the
        conservation identity on it)."""
        del tier  # reserved for future per-tier drill-down
        if not slots:
            return {"chip_ns": 0, "attributed_ns": 0, "waste_ns": 0,
                    "overhead_ns": 0}
        chip_ns = _to_ns(elapsed_s) * max(1, int(chips))
        share = chip_ns // len(slots)
        overhead = chip_ns - share * len(slots)
        attributed = 0
        waste = 0
        now = self.clock()
        with self._lock:
            for slot in slots:
                kind = slot.get("kind", SLOT_REAL)
                if kind == SLOT_PADDING:
                    by_reason = self._waste.setdefault(role, {})
                    by_reason["padding"] = by_reason.get("padding", 0) + share
                    waste += share
                    continue
                job_id = str(slot.get("job_id", ""))
                entry = self._job(role, job_id, now)
                if kind == SLOT_RECOMPUTE:
                    by_reason = self._waste.setdefault(role, {})
                    by_reason["preempt_recompute"] = (
                        by_reason.get("preempt_recompute", 0) + share
                    )
                    entry.waste_ns += share
                    entry.steps += 1
                    waste += share
                else:
                    entry.chip_ns += share
                    entry.steps += 1
                    attributed += share
            self._dispatch_ns[role] = self._dispatch_ns.get(role, 0) + chip_ns
            self._attributed_ns[role] = (
                self._attributed_ns.get(role, 0) + attributed
            )
            self._overhead_ns[role] = self._overhead_ns.get(role, 0) + overhead
            self._dispatches[role] = self._dispatches.get(role, 0) + 1
        return {
            "chip_ns": chip_ns,
            "attributed_ns": attributed,
            "waste_ns": waste,
            "overhead_ns": overhead,
        }

    def note_tiles(self, role: str, job_id: str, n: int = 1) -> None:
        """Count finished tiles (the denominator of chip-s-per-tile)."""
        now = self.clock()
        with self._lock:
            self._job(str(role), str(job_id), now).tiles += int(n)

    def note_cached(
        self, role: str, job_id: str, tiles: int, seconds: float = 0.0
    ) -> None:
        """Charge cache-settled tiles to the ``cached`` bucket: they
        count toward the job's finished ``tiles`` (the cost-model
        denominator — this is what makes likely-hit jobs admit as
        near-free under the DRR measured-cost hook) at the near-zero
        measured lookup/settle time, which rides OUTSIDE the dispatch
        conservation identity exactly like the store-family waste — no
        device dispatch happened."""
        n = int(tiles)
        if n <= 0:
            return
        ns = _to_ns(seconds)
        now = self.clock()
        with self._lock:
            entry = self._job(str(role), str(job_id), now)
            entry.tiles += n
            entry.cached_tiles += n
            entry.cached_ns += ns
            role = str(role)
            self._cached_tiles[role] = self._cached_tiles.get(role, 0) + n
            self._cached_ns[role] = self._cached_ns.get(role, 0) + ns

    def note_waste(
        self, role: str, reason: str, seconds: float,
        job_id: Optional[str] = None, chips: int = 1,
    ) -> None:
        """Charge a store-family waste bucket (speculation loser /
        poison retry): measured on the caller's clock, outside the
        dispatch conservation identity."""
        ns = _to_ns(seconds) * max(1, int(chips))
        if ns <= 0:
            return
        now = self.clock()
        with self._lock:
            by_reason = self._waste.setdefault(str(role), {})
            by_reason[str(reason)] = by_reason.get(str(reason), 0) + ns
            if job_id is not None:
                self._job(str(role), str(job_id), now).waste_ns += ns

    # --- eviction ---------------------------------------------------------

    def sweep(self, ttl_s: float) -> list[str]:
        """Fold job entries idle longer than ``ttl_s`` into the retired
        aggregate; returns the evicted job ids (sorted)."""
        now = self.clock()
        evicted: list[str] = []
        with self._lock:
            for role in sorted(self._jobs):
                by_job = self._jobs[role]
                stale = sorted(
                    j for j, e in by_job.items()
                    if now - e.last_active > ttl_s
                )
                for job_id in stale:
                    # retire BEFORE dropping the attrs so the fold
                    # lands under the job's real tenant/lane
                    self._retire(role, job_id, by_job.pop(job_id))
                    evicted.append(job_id)
            # attrs depart only once NO role still tracks the job
            live = {
                j for by_job in self._jobs.values() for j in by_job
            }
            for job_id in sorted(set(evicted)):
                if job_id not in live:
                    self._attrs.pop(job_id, None)
                    self._adapter_attrs.pop(job_id, None)
        return evicted

    # --- export -----------------------------------------------------------

    def snapshot(self, role: str = "worker") -> dict[str, Any]:
        """This process's cumulative usage for one role — the compact
        block the fleet telemetry snapshot carries (floats; ns precision
        is a process-local concern)."""
        with self._lock:
            jobs = {
                job_id: entry.as_dict()
                for job_id, entry in sorted(
                    self._jobs.get(role, {}).items()
                )
            }
            waste = {
                reason: _s(ns)
                for reason, ns in sorted(self._waste.get(role, {}).items())
            }
            return {
                "jobs": jobs,
                "waste_s": waste,
                "dispatch_chip_s": _s(self._dispatch_ns.get(role, 0)),
                "attributed_chip_s": _s(self._attributed_ns.get(role, 0)),
                "overhead_s": _s(self._overhead_ns.get(role, 0)),
                "dispatches": self._dispatches.get(role, 0),
                "cached_tiles": self._cached_tiles.get(role, 0),
                "cached_s": _s(self._cached_ns.get(role, 0)),
            }

    def totals(
        self, roles: Optional[tuple[str, ...]] = None
    ) -> dict[str, Any]:
        """Exact totals (all roles by default); ``conserved`` is the
        test-pinned identity over the dispatch family (integer ns —
        exact)."""

        def _keep(role: str) -> bool:
            return roles is None or role in roles

        with self._lock:
            dispatch_ns = sum(
                ns for r, ns in self._dispatch_ns.items() if _keep(r)
            )
            attributed_ns = sum(
                ns for r, ns in self._attributed_ns.items() if _keep(r)
            )
            overhead_ns = sum(
                ns for r, ns in self._overhead_ns.items() if _keep(r)
            )
            waste_ns: dict[str, int] = {}
            for role, by_reason in self._waste.items():
                if not _keep(role):
                    continue
                for reason, ns in by_reason.items():
                    waste_ns[reason] = waste_ns.get(reason, 0) + ns
            dispatch_waste_ns = sum(
                waste_ns.get(r, 0) for r in DISPATCH_WASTE_REASONS
            )
            return {
                "dispatch_chip_ns": dispatch_ns,
                "attributed_ns": attributed_ns,
                "dispatch_waste_ns": dispatch_waste_ns,
                "overhead_ns": overhead_ns,
                "waste_ns": {r: waste_ns[r] for r in sorted(waste_ns)},
                "dispatches": sum(
                    n for r, n in self._dispatches.items() if _keep(r)
                ),
                # the cached bucket rides OUTSIDE the conservation set:
                # no dispatch happened for these tiles, so adding them
                # to the identity would un-balance it by construction
                "cached_tiles": sum(
                    n for r, n in self._cached_tiles.items() if _keep(r)
                ),
                "cached_ns": sum(
                    ns for r, ns in self._cached_ns.items() if _keep(r)
                ),
                "conserved": (
                    attributed_ns + dispatch_waste_ns + overhead_ns
                    == dispatch_ns
                ),
            }

    def pair_totals(
        self, roles: Optional[tuple[str, ...]] = None
    ) -> dict[tuple[str, str], dict[str, float]]:
        """Cumulative (tenant, lane) -> {chip_s, tiles} across live AND
        retired entries — MONOTONIC per pair (eviction moves a job's
        counters into the retired fold without changing the sum), which
        is what the scrape-mirror counters delta against."""
        out: dict[tuple[str, str], dict[str, float]] = {}

        def add(
            tenant: str, lane: str, chip_ns: int, tiles: int, cached: int
        ) -> None:
            agg = out.setdefault(
                (tenant, lane), {"chip_s": 0.0, "tiles": 0.0, "cached": 0.0}
            )
            agg["chip_s"] += _s(chip_ns)
            agg["tiles"] += tiles
            agg["cached"] += cached

        with self._lock:
            for role in sorted(self._jobs):
                if roles is not None and role not in roles:
                    continue
                for job_id in sorted(self._jobs[role]):
                    entry = self._jobs[role][job_id]
                    tenant, lane = self._attrs.get(
                        job_id, (DEFAULT_TENANT, "")
                    )
                    add(
                        tenant, lane, entry.chip_ns, entry.tiles,
                        entry.cached_tiles,
                    )
            for (role, tenant, lane) in sorted(self._retired):
                if roles is not None and role not in roles:
                    continue
                bucket = self._retired[(role, tenant, lane)]
                add(
                    tenant, lane, bucket["chip_ns"], bucket["tiles"],
                    bucket.get("cached_tiles", 0),
                )
        return out

    def rollup(
        self, roles: Optional[tuple[str, ...]] = None
    ) -> dict[str, Any]:
        """Per-tenant/per-lane view across this process's roles (all by
        default; a fleet-wide view restricts to ``("master",)`` so a
        co-hosted worker's records count exactly once, through its
        adopted snapshots). Jobs resolve
        through the attrs map; retired counters fold into the default
        tenant."""
        with self._lock:
            tenants: dict[str, dict[str, Any]] = {}
            lanes: dict[str, dict[str, Any]] = {}
            adapters: dict[str, dict[str, Any]] = {}
            jobs_out: dict[str, dict[str, Any]] = {}
            for role in sorted(self._jobs):
                if roles is not None and role not in roles:
                    continue
                for job_id in sorted(self._jobs[role]):
                    entry = self._jobs[role][job_id]
                    tenant, lane = self._attrs.get(
                        job_id, (DEFAULT_TENANT, "")
                    )
                    adapter_id = self._adapter_attrs.get(job_id, "")
                    if adapter_id:
                        ad = adapters.setdefault(
                            adapter_id, {"chip_s": 0.0, "tiles": 0}
                        )
                        ad["chip_s"] += _s(entry.chip_ns)
                        ad["tiles"] += entry.tiles
                    t = tenants.setdefault(
                        tenant, {"chip_s": 0.0, "tiles": 0, "steps": 0,
                                 "waste_s": 0.0, "cached_tiles": 0}
                    )
                    t["chip_s"] += _s(entry.chip_ns)
                    t["tiles"] += entry.tiles
                    t["steps"] += entry.steps
                    t["waste_s"] += _s(entry.waste_ns)
                    t["cached_tiles"] += entry.cached_tiles
                    ln = lanes.setdefault(
                        lane, {"chip_s": 0.0, "tiles": 0}
                    )
                    ln["chip_s"] += _s(entry.chip_ns)
                    ln["tiles"] += entry.tiles
                    job_out = jobs_out.setdefault(
                        job_id,
                        {"tenant": tenant, "lane": lane,
                         "adapter": adapter_id, "chip_s": 0.0,
                         "tiles": 0, "steps": 0, "waste_s": 0.0,
                         "cached_tiles": 0, "roles": []},
                    )
                    job_out["chip_s"] += _s(entry.chip_ns)
                    job_out["tiles"] += entry.tiles
                    job_out["steps"] += entry.steps
                    job_out["waste_s"] += _s(entry.waste_ns)
                    job_out["cached_tiles"] += entry.cached_tiles
                    job_out["roles"].append(role)
            for (role, tenant, lane) in sorted(self._retired):
                if roles is not None and role not in roles:
                    continue
                bucket = self._retired[(role, tenant, lane)]
                t = tenants.setdefault(
                    tenant,
                    {"chip_s": 0.0, "tiles": 0, "steps": 0, "waste_s": 0.0,
                     "cached_tiles": 0},
                )
                t["chip_s"] += _s(bucket["chip_ns"])
                t["tiles"] += bucket["tiles"]
                t["steps"] += bucket["steps"]
                t["waste_s"] += _s(bucket["waste_ns"])
                t["cached_tiles"] += bucket.get("cached_tiles", 0)
                ln = lanes.setdefault(lane, {"chip_s": 0.0, "tiles": 0})
                ln["chip_s"] += _s(bucket["chip_ns"])
                ln["tiles"] += bucket["tiles"]
        totals = self.totals(roles)
        total_chip = _s(totals["dispatch_chip_ns"])
        for stats in tenants.values():
            stats["chip_share"] = (
                round(stats["chip_s"] / total_chip, 6) if total_chip else 0.0
            )
        return {
            "tenants": {t: tenants[t] for t in sorted(tenants)},
            "lanes": {ln: lanes[ln] for ln in sorted(lanes)},
            "adapters": {a: adapters[a] for a in sorted(adapters)},
            "jobs": jobs_out,
            "totals": {
                "chip_s": total_chip,
                "attributed_s": _s(totals["attributed_ns"]),
                "overhead_s": _s(totals["overhead_ns"]),
                "waste_s": {
                    r: _s(ns) for r, ns in totals["waste_ns"].items()
                },
                "dispatches": totals["dispatches"],
                "cached_tiles": totals["cached_tiles"],
                "cached_s": _s(totals["cached_ns"]),
                "conserved": totals["conserved"],
            },
        }


# --- process-global meter -----------------------------------------------------

_METER_LOCK = threading.Lock()
_METER: Optional[UsageMeter] = None


def get_usage_meter() -> UsageMeter:
    global _METER
    with _METER_LOCK:
        if _METER is None:
            _METER = UsageMeter()
        return _METER


def _reset_usage_meter_for_tests() -> UsageMeter:
    global _METER
    with _METER_LOCK:
        _METER = UsageMeter()
        return _METER


def set_usage_meter(meter: Optional[UsageMeter]) -> Optional[UsageMeter]:
    """Swap the process-global meter and return the previous one: a test
    or a profiler installs a fresh meter around a run so its usage is
    isolated from the process's cumulative accounting (and restores the
    previous meter on exit)."""
    global _METER
    with _METER_LOCK:
        previous, _METER = _METER, meter
        return previous


# --- master-side aggregation --------------------------------------------------

# Series names retained in the fleet SeriesStore (label vocabulary:
# tenant / reason only — per-job history stays in the live drill-down).
S_TENANT_CHIP_S = "usage_tenant_chip_s"
S_TENANT_TILES = "usage_tenant_tiles"
S_WASTE_S = "usage_waste_s"

# cost_ratio clamp: a measured-cost tenant can weigh at most 10x / at
# least 0.1x the fleet mean in DRR admission accounting.
COST_RATIO_MIN = 0.1
COST_RATIO_MAX = 10.0
_EWMA_ALPHA = 0.3


class _AdoptedJob:
    __slots__ = (
        "chip_ns", "steps", "tiles", "waste_ns", "cached_tiles",
        "cached_ns", "last_active",
    )

    def __init__(self) -> None:
        self.chip_ns = 0
        self.steps = 0
        self.tiles = 0
        self.waste_ns = 0
        self.cached_tiles = 0
        self.cached_ns = 0
        self.last_active = 0.0


class UsageAggregator:
    """Fleet-wide usage on the master: the local meter's records
    (master role) plus worker meters adopted by delta from their
    piggybacked snapshots. Owned by the FleetRegistry; read by
    ``GET /distributed/usage``, the scrape mirror, the ``usage_rollup``
    event and the scheduler's measured-cost hook."""

    def __init__(
        self,
        meter: Optional[UsageMeter] = None,
        store: Any = None,
        clock: Callable[[], float] = time.time,
        ttl: Optional[float] = None,
        max_keys: int = MAX_TRACKED_KEYS,
    ) -> None:
        from ..utils import constants

        self.meter = meter if meter is not None else get_usage_meter()
        self.store = store  # telemetry/timeseries.SeriesStore (optional)
        self.clock = clock
        self.ttl = ttl if ttl is not None else constants.USAGE_TTL_SECONDS
        self.max_keys = int(max_keys)
        self._lock = threading.Lock()
        # adopted worker usage: job_id -> _AdoptedJob (fleet-cumulative)
        self._adopted_jobs: dict[str, _AdoptedJob] = {}
        # adopted waste: reason -> ns
        self._adopted_waste: dict[str, int] = {}
        # adopted exact dispatch-family totals
        self._adopted_dispatch_ns = 0
        self._adopted_attributed_ns = 0
        self._adopted_overhead_ns = 0
        self._adopted_dispatches = 0
        # counter-reset clamp state: worker_id -> path -> last seen
        self._worker_prev: dict[str, dict[str, float]] = {}
        # tenant cost model: tenant -> {"ewma", "prev_chip_ns", "prev_tiles"}
        self._cost: dict[str, dict[str, float]] = {}
        self._cost_global: Optional[float] = None
        # retired adopted counters (evicted jobs), keyed by the
        # (tenant, lane) resolved at eviction time — keeps the tenant
        # rollup and the per-pair scrape counters monotonic. Bounded:
        # overflow folds into the default pair.
        self._retired: dict[tuple[str, str], dict[str, int]] = {}
        # scrape mirror high-water marks (instruments.py counts deltas
        # against these so co-hosted servers' collectors never double-
        # count): path -> last mirrored value
        self.scrape_mirrored: dict[str, float] = {}
        # fired when an idle tenant departs (fleet wires series eviction)
        self.on_evict_tenant: Optional[Callable[[str], None]] = None

    # --- adoption ---------------------------------------------------------

    @staticmethod
    def _delta(prev: dict[str, float], path: str, value: float) -> float:
        """Cumulative-counter delta with the reset clamp: a value below
        the last seen one means the worker restarted — adopt the new
        total as a fresh baseline (never a negative delta)."""
        last = prev.get(path)
        prev[path] = value
        if last is None or value < last:
            return max(0.0, value)
        return value - last

    def adopt(self, worker_id: str, usage: Any) -> bool:
        """Merge one worker's cumulative usage snapshot by delta.
        Malformed payloads are dropped (False); the snapshot rode an
        unauthenticated RPC."""
        if not isinstance(usage, dict):
            return False
        worker_id = str(worker_id)
        now = self.clock()
        with self._lock:
            prev = self._worker_prev.get(worker_id)
            if prev is None:
                if len(self._worker_prev) >= self.max_keys:
                    self._worker_prev.pop(next(iter(self._worker_prev)))
                prev = {}
                self._worker_prev[worker_id] = prev
            jobs = usage.get("jobs")
            if isinstance(jobs, dict):
                # prune baselines for jobs the worker's own (bounded)
                # meter no longer reports — they cannot reappear in a
                # later snapshot, so keeping their paths would grow
                # this map one entry per job id served, forever
                current_ids = {str(j) for j in jobs}
                for path in [p for p in prev if p.startswith("job:")]:
                    if path[4:].rsplit(":", 1)[0] not in current_ids:
                        del prev[path]
                for job_id in sorted(jobs):
                    stats = jobs[job_id]
                    if not isinstance(stats, dict):
                        continue
                    entry = self._adopted_job(str(job_id), now)
                    entry.chip_ns += _to_ns(self._delta(
                        prev, f"job:{job_id}:chip_s",
                        _as_float(stats.get("chip_s")),
                    ))
                    entry.waste_ns += _to_ns(self._delta(
                        prev, f"job:{job_id}:waste_s",
                        _as_float(stats.get("waste_s")),
                    ))
                    entry.steps += int(self._delta(
                        prev, f"job:{job_id}:steps",
                        _as_float(stats.get("steps")),
                    ))
                    entry.tiles += int(self._delta(
                        prev, f"job:{job_id}:tiles",
                        _as_float(stats.get("tiles")),
                    ))
                    # version-tolerant: a pre-cache worker's snapshot
                    # simply lacks the fields (delta from 0 of 0)
                    entry.cached_tiles += int(self._delta(
                        prev, f"job:{job_id}:cached_tiles",
                        _as_float(stats.get("cached_tiles")),
                    ))
                    entry.cached_ns += _to_ns(self._delta(
                        prev, f"job:{job_id}:cached_s",
                        _as_float(stats.get("cached_s")),
                    ))
            waste = usage.get("waste_s")
            if isinstance(waste, dict):
                for reason in sorted(waste):
                    delta = self._delta(
                        prev, f"waste:{reason}", _as_float(waste[reason])
                    )
                    self._adopted_waste[str(reason)] = (
                        self._adopted_waste.get(str(reason), 0)
                        + _to_ns(delta)
                    )
            self._adopted_dispatch_ns += _to_ns(self._delta(
                prev, "dispatch_chip_s",
                _as_float(usage.get("dispatch_chip_s")),
            ))
            self._adopted_attributed_ns += _to_ns(self._delta(
                prev, "attributed_chip_s",
                _as_float(usage.get("attributed_chip_s")),
            ))
            self._adopted_overhead_ns += _to_ns(self._delta(
                prev, "overhead_s", _as_float(usage.get("overhead_s")),
            ))
            self._adopted_dispatches += int(self._delta(
                prev, "dispatches", _as_float(usage.get("dispatches")),
            ))
        return True

    def _adopted_job(self, job_id: str, now: float) -> _AdoptedJob:
        entry = self._adopted_jobs.get(job_id)
        if entry is None:
            if len(self._adopted_jobs) >= self.max_keys:
                victim = min(
                    self._adopted_jobs,
                    key=lambda j: self._adopted_jobs[j].last_active,
                )
                self._retire(victim, self._adopted_jobs.pop(victim))
            entry = _AdoptedJob()
            self._adopted_jobs[job_id] = entry
        entry.last_active = now
        return entry

    def _retire(self, job_id: str, entry: _AdoptedJob) -> None:
        tenant, lane = self.meter.job_attrs(job_id)
        key = (tenant, lane)
        if key not in self._retired and len(self._retired) >= self.max_keys:
            key = (DEFAULT_TENANT, "")
        bucket = self._retired.setdefault(
            key, {"chip_ns": 0, "tiles": 0, "steps": 0, "waste_ns": 0,
                  "cached_tiles": 0, "cached_ns": 0},
        )
        bucket["chip_ns"] += entry.chip_ns
        bucket["tiles"] += entry.tiles
        bucket["steps"] += entry.steps
        bucket["waste_ns"] += entry.waste_ns
        bucket["cached_tiles"] += entry.cached_tiles
        bucket["cached_ns"] += entry.cached_ns

    def forget_worker(self, worker_id: str) -> None:
        """Drop a departed worker's reset-clamp baselines (its adopted
        counters stay — usage already burned doesn't un-burn)."""
        with self._lock:
            self._worker_prev.pop(str(worker_id), None)

    # --- sampling (FleetRegistry.sample calls this) ------------------------

    def sample(self) -> dict[str, Any]:
        """One aggregation pass: update the tenant cost EWMAs, record
        the retained series, sweep idle entries, and return the rollup
        (published as the ``usage_rollup`` bus event)."""
        rollup = self.rollup()
        now = self.clock()
        with self._lock:
            self._update_cost_locked(rollup)
        if self.store is not None:
            for tenant in sorted(rollup["tenants"]):
                stats = rollup["tenants"][tenant]
                self.store.record(
                    S_TENANT_CHIP_S, stats["chip_s"], ts=now, tenant=tenant
                )
                self.store.record(
                    S_TENANT_TILES, stats["tiles"], ts=now, tenant=tenant
                )
            for reason in sorted(rollup["totals"]["waste_s"]):
                self.store.record(
                    S_WASTE_S, rollup["totals"]["waste_s"][reason],
                    ts=now, reason=reason,
                )
        self._sweep(now)
        return rollup

    def _update_cost_locked(self, rollup: dict[str, Any]) -> None:
        """Per-tenant chip-seconds-per-tile EWMA from the rollup's
        cumulative counters: each pass samples delta(chip)/delta(tiles)
        since the previous pass."""
        global_dchip = 0.0
        global_dtiles = 0.0
        for tenant in sorted(rollup["tenants"]):
            stats = rollup["tenants"][tenant]
            state = self._cost.setdefault(
                tenant, {"ewma": 0.0, "prev_chip_s": 0.0, "prev_tiles": 0.0}
            )
            dchip = max(0.0, stats["chip_s"] - state["prev_chip_s"])
            dtiles = max(0.0, stats["tiles"] - state["prev_tiles"])
            state["prev_chip_s"] = stats["chip_s"]
            state["prev_tiles"] = stats["tiles"]
            global_dchip += dchip
            global_dtiles += dtiles
            if dtiles > 0:
                sample = dchip / dtiles
                state["ewma"] = (
                    sample if state["ewma"] <= 0.0
                    else (1 - _EWMA_ALPHA) * state["ewma"]
                    + _EWMA_ALPHA * sample
                )
        if global_dtiles > 0:
            sample = global_dchip / global_dtiles
            self._cost_global = (
                sample if not self._cost_global
                else (1 - _EWMA_ALPHA) * self._cost_global
                + _EWMA_ALPHA * sample
            )

    def _sweep(self, now: float) -> None:
        """TTL eviction: fold idle adopted jobs into the retired
        aggregate and drop idle tenant cost entries, firing the series
        eviction seam for each departed tenant."""
        self.meter.sweep(self.ttl)
        departed: list[str] = []
        with self._lock:
            stale = sorted(
                j for j, e in self._adopted_jobs.items()
                if now - e.last_active > self.ttl
            )
            for job_id in stale:
                self._retire(job_id, self._adopted_jobs.pop(job_id))
            # a tenant with no surviving jobs in either source departs
            # the cost model (its series evict through the seam)
            live_tenants = {
                self.meter.job_attrs(j)[0]
                for j in list(self._adopted_jobs)
            }
        live_tenants |= {
            self.meter.job_attrs(j)[0]
            for j in self.meter.rollup()["jobs"]
        }
        with self._lock:
            for tenant in sorted(self._cost):
                if tenant not in live_tenants and tenant != DEFAULT_TENANT:
                    del self._cost[tenant]
                    departed.append(tenant)
        for tenant in departed:
            seam = self.on_evict_tenant
            if seam is not None:
                try:
                    seam(tenant)
                except Exception as exc:  # noqa: BLE001 - advisory seam
                    debug_log(f"usage tenant eviction seam failed: {exc}")

    # --- the measured cost model -------------------------------------------

    def cost_ratio(self, tenant: str) -> float:
        """Measured chip-s-per-tile of `tenant` relative to the fleet
        mean, clamped to [0.1, 10]; 1.0 until both EWMAs have samples.
        The CDT_USAGE_COST admission hook multiplies DRR cost by it."""
        with self._lock:
            state = self._cost.get(str(tenant))
            if (
                state is None
                or state["ewma"] <= 0.0
                or not self._cost_global
            ):
                return 1.0
            ratio = state["ewma"] / self._cost_global
        return min(COST_RATIO_MAX, max(COST_RATIO_MIN, ratio))

    # --- export -----------------------------------------------------------

    def rollup(self) -> dict[str, Any]:
        """Fleet-wide per-tenant/per-lane/per-job usage: the local
        meter's rollup plus the adopted worker counters, every job
        resolved through the meter's (store-fed) attrs map."""
        local = self.meter.rollup(roles=("master",))
        tenants = {
            t: dict(stats) for t, stats in local["tenants"].items()
        }
        lanes = {ln: dict(stats) for ln, stats in local["lanes"].items()}
        jobs = {j: dict(stats) for j, stats in local["jobs"].items()}
        with self._lock:
            adopted_jobs = sorted(self._adopted_jobs.items())
            adopted_waste = dict(self._adopted_waste)
            adopted_retired = {
                key: dict(bucket)
                for key, bucket in sorted(self._retired.items())
            }
            adopted = {
                "dispatch_ns": self._adopted_dispatch_ns,
                "attributed_ns": self._adopted_attributed_ns,
                "overhead_ns": self._adopted_overhead_ns,
                "dispatches": self._adopted_dispatches,
            }
        for job_id, entry in adopted_jobs:
            tenant, lane = self.meter.job_attrs(job_id)
            t = tenants.setdefault(
                tenant, {"chip_s": 0.0, "tiles": 0, "steps": 0,
                         "waste_s": 0.0, "cached_tiles": 0}
            )
            t["chip_s"] += _s(entry.chip_ns)
            t["tiles"] += entry.tiles
            t["steps"] += entry.steps
            t["waste_s"] += _s(entry.waste_ns)
            t["cached_tiles"] = t.get("cached_tiles", 0) + entry.cached_tiles
            ln = lanes.setdefault(lane, {"chip_s": 0.0, "tiles": 0})
            ln["chip_s"] += _s(entry.chip_ns)
            ln["tiles"] += entry.tiles
            job_out = jobs.setdefault(
                job_id,
                {"tenant": tenant, "lane": lane, "chip_s": 0.0, "tiles": 0,
                 "steps": 0, "waste_s": 0.0, "cached_tiles": 0,
                 "roles": []},
            )
            job_out["chip_s"] += _s(entry.chip_ns)
            job_out["tiles"] += entry.tiles
            job_out["steps"] += entry.steps
            job_out["waste_s"] += _s(entry.waste_ns)
            job_out["cached_tiles"] = (
                job_out.get("cached_tiles", 0) + entry.cached_tiles
            )
            if "worker(adopted)" not in job_out["roles"]:
                job_out["roles"].append("worker(adopted)")
        for (tenant, lane), bucket in adopted_retired.items():
            t = tenants.setdefault(
                tenant,
                {"chip_s": 0.0, "tiles": 0, "steps": 0, "waste_s": 0.0,
                 "cached_tiles": 0},
            )
            t["chip_s"] += _s(bucket["chip_ns"])
            t["tiles"] += bucket["tiles"]
            t["steps"] += bucket["steps"]
            t["waste_s"] += _s(bucket["waste_ns"])
            t["cached_tiles"] = (
                t.get("cached_tiles", 0) + bucket.get("cached_tiles", 0)
            )
            ln = lanes.setdefault(lane, {"chip_s": 0.0, "tiles": 0})
            ln["chip_s"] += _s(bucket["chip_ns"])
            ln["tiles"] += bucket["tiles"]
        totals = dict(local["totals"])
        totals["chip_s"] += _s(adopted["dispatch_ns"])
        totals["attributed_s"] += _s(adopted["attributed_ns"])
        totals["overhead_s"] += _s(adopted["overhead_ns"])
        totals["dispatches"] += adopted["dispatches"]
        totals["cached_tiles"] = totals.get("cached_tiles", 0) + sum(
            entry.cached_tiles for _, entry in adopted_jobs
        ) + sum(
            bucket.get("cached_tiles", 0)
            for bucket in adopted_retired.values()
        )
        totals["cached_s"] = totals.get("cached_s", 0.0) + _s(sum(
            entry.cached_ns for _, entry in adopted_jobs
        ) + sum(
            bucket.get("cached_ns", 0)
            for bucket in adopted_retired.values()
        ))
        waste_all = dict(totals["waste_s"])
        for reason, ns in sorted(adopted_waste.items()):
            waste_all[reason] = waste_all.get(reason, 0.0) + _s(ns)
        totals["waste_s"] = {r: waste_all[r] for r in sorted(waste_all)}
        total_chip = totals["chip_s"]
        for stats in tenants.values():
            stats["chip_share"] = (
                round(stats["chip_s"] / total_chip, 6) if total_chip else 0.0
            )
        dispatch_waste = sum(
            totals["waste_s"].get(r, 0.0) for r in DISPATCH_WASTE_REASONS
        )
        totals["waste_share"] = (
            round(dispatch_waste / total_chip, 6) if total_chip else 0.0
        )
        return {
            "tenants": {t: tenants[t] for t in sorted(tenants)},
            "lanes": {ln: lanes[ln] for ln in sorted(lanes)},
            "jobs": jobs,
            "totals": totals,
        }

    def pair_totals(self) -> dict[tuple[str, str], dict[str, float]]:
        """Monotonic cumulative (tenant, lane) -> {chip_s, tiles}: the
        local meter's master-role pairs plus adopted live AND retired
        counters. Job eviction moves counters between the live and
        retired folds without changing a pair's sum, so the scrape
        mirror's high-water deltas never undercount after a sweep."""
        out = self.meter.pair_totals(roles=("master",))
        with self._lock:
            live = [
                (job_id, entry.chip_ns, entry.tiles, entry.cached_tiles)
                for job_id, entry in sorted(self._adopted_jobs.items())
            ]
            retired = [
                (key, bucket["chip_ns"], bucket["tiles"],
                 bucket.get("cached_tiles", 0))
                for key, bucket in sorted(self._retired.items())
            ]
        for job_id, chip_ns, tiles, cached in live:
            pair = self.meter.job_attrs(job_id)
            agg = out.setdefault(
                pair, {"chip_s": 0.0, "tiles": 0.0, "cached": 0.0}
            )
            agg["chip_s"] += _s(chip_ns)
            agg["tiles"] += tiles
            agg["cached"] = agg.get("cached", 0.0) + cached
        for pair, chip_ns, tiles, cached in retired:
            agg = out.setdefault(
                pair, {"chip_s": 0.0, "tiles": 0.0, "cached": 0.0}
            )
            agg["chip_s"] += _s(chip_ns)
            agg["tiles"] += tiles
            agg["cached"] = agg.get("cached", 0.0) + cached
        return out

    def cost_snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "global_chip_s_per_tile": self._cost_global,
                "tenants": {
                    t: {
                        "chip_s_per_tile": state["ewma"],
                        "cost_ratio": None,
                    }
                    for t, state in sorted(self._cost.items())
                },
            }

    def status(
        self, since_s: Optional[float] = None, tenant: Optional[str] = None
    ) -> dict[str, Any]:
        """The GET /distributed/usage payload: rollup + per-tenant
        drill-down (+ windowed series history with ``?since=``)."""
        rollup = self.rollup()
        if tenant is not None:
            rollup["tenants"] = {
                t: s for t, s in rollup["tenants"].items() if t == tenant
            }
            rollup["jobs"] = {
                j: s for j, s in rollup["jobs"].items()
                if s.get("tenant") == tenant
            }
        cost = self.cost_snapshot()
        for t, entry in cost["tenants"].items():
            entry["cost_ratio"] = self.cost_ratio(t)
        out: dict[str, Any] = {
            "enabled": True,
            "rollup": rollup,
            "cost_model": cost,
            "conservation": self.meter.totals(),
        }
        if since_s is not None and self.store is not None:
            history: dict[str, Any] = {"tenants": {}, "waste": {}}
            for t in self.store.label_values(S_TENANT_CHIP_S, "tenant"):
                if tenant is not None and t != tenant:
                    continue
                history["tenants"][t] = {
                    S_TENANT_CHIP_S: self.store.window(
                        S_TENANT_CHIP_S, since_s, tenant=t
                    ),
                    S_TENANT_TILES: self.store.window(
                        S_TENANT_TILES, since_s, tenant=t
                    ),
                }
            for reason in self.store.label_values(S_WASTE_S, "reason"):
                history["waste"][reason] = self.store.window(
                    S_WASTE_S, since_s, reason=reason
                )
            out["history"] = history
            out["since_seconds"] = float(since_s)
        return out


def _as_float(value: Any) -> float:
    try:
        out = float(value)
    except (TypeError, ValueError):
        return 0.0
    return out if out == out and out not in (float("inf"), float("-inf")) else 0.0
