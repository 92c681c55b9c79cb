"""SchedulerControl: the one object a DistributedServer owns.

The port's own copy of comfyui_distributed_tpu/scheduler/control.py.
Couples the admission queue (fair-share grant order, backpressure,
pause/resume/drain) with the placement policy (worker speed weights,
batch sizing, tail trimming) and maps request payloads onto tenants,
lanes, and costs. The `/distributed/scheduler/*` routes
(api/scheduler_routes.py) and the queue route's admission gate
(api/job_routes.py) talk to this, never to the internals directly.
"""

from __future__ import annotations

import enum
import time
from typing import Any, Callable, Optional

from ..telemetry.events import get_event_bus
from ..utils.logging import log
from .brownout import BrownoutController
from .placement import PlacementPolicy
from .queue import AdmissionQueue, DeadlineUnmeetable, SchedulerOverloaded, Ticket


class SchedulerState(enum.Enum):
    RUNNING = "running"
    PAUSED = "paused"
    DRAINING = "draining"


class SchedulerControl:
    def __init__(
        self,
        health: Any = None,
        clock: Callable[[], float] = time.monotonic,
        queue: Optional[AdmissionQueue] = None,
        placement: Optional[PlacementPolicy] = None,
        brownout: Optional[BrownoutController] = None,
    ) -> None:
        self.queue = queue or AdmissionQueue(clock=clock)
        self.placement = placement or PlacementPolicy(health=health)
        # Load-shed controller above the lanes: fed queue waits by the
        # admission queue and, on a journaling master, append latencies by
        # the DurabilityManager (api/server.py); consulted before every
        # submit.
        self.brownout = brownout or BrownoutController(
            self.queue.lane_order, clock=clock
        )
        self.queue.wait_sink = self.brownout.note_queue_wait
        # Measured-cost seam (CDT_USAGE_COST=1): the server wires this
        # to UsageAggregator.cost_ratio — a tenant's measured
        # chip-seconds-per-tile relative to the fleet mean — so DRR
        # admission cost meters what the tenant actually burns, not
        # just the client's estimated_tiles.
        self.usage_cost: Optional[Callable[[str], float]] = None
        # Admission-gap accounting (the DRR full-cost-until-settle
        # leftover): admission charges the FULL estimated-tiles cost,
        # but tiles later settled from the content-addressed cache
        # never burn chip time — the fair-share meter over-charged the
        # tenant by (settled tiles x per-tile admitted cost). The gap
        # accumulates here (cumulative cost units) and is surfaced as
        # `cdt_cache_unsettled_admission_cost` at scrape. Per-tile cost
        # is the tenant's LAST admitted per-tile cost — bounded map,
        # oldest-admitted evicted (tenant ids arrive from the network).
        self.unsettled_admission_cost = 0.0
        self._tenant_tile_cost: dict[str, float] = {}
        self._max_tenant_tile_cost = 1024
        # Cache-hit admission discount (CDT_CACHE_COST=1): per-tenant
        # admitted-vs-settled tile counters feed a bounded multiplier —
        # a tenant whose recent tiles mostly settle from the tile cache
        # pays proportionally less at admission, floored by
        # CDT_CACHE_COST_FLOOR so a cold burst can't ride an unbounded
        # discount. Counters halve past the window so the hit share
        # tracks RECENT behavior, not all-time history; both maps are
        # bounded like _tenant_tile_cost (tenant ids are network input).
        self._tenant_admitted_tiles: dict[str, float] = {}
        self._tenant_settled_tiles: dict[str, float] = {}
        self._cache_hit_window = 4096.0

    # --- payload mapping --------------------------------------------------

    def resolve_lane(self, lane: Optional[str]) -> str:
        """The lane a payload will actually land in (unknown lanes
        route to the lowest class, exactly as queue.submit does)."""
        from ..utils import constants

        lane_name = lane or constants.SCHED_DEFAULT_LANE
        if lane_name not in self.queue.lanes:
            return self.queue.lane_order[-1]
        return lane_name

    def submit_payload(self, payload: Any) -> Ticket:
        """Admit one parsed QueueRequestPayload. Cost is the request's
        estimated tile count when the client provided one
        (`estimated_tiles` in the body), else 1 — so fair share meters
        tile WORK, and a tenant of huge upscales can't starve a tenant
        of small ones by request-count arithmetic.

        Two lifecycle gates run BEFORE the lane sees the request:

        - **brownout** — a shed lane answers 429 without consuming
          queue depth, a grant slot, or journal bandwidth;
        - **deadline admission** — a request whose end-to-end deadline
          is already unmeetable (estimated queue wait exceeds it)
          answers 429 instead of burning work that must miss.
        """
        lane_name = self.resolve_lane(payload.lane)
        if self.brownout.should_shed(lane_name):
            self.brownout.record_shed(lane_name)
            raise SchedulerOverloaded(
                f"lane {lane_name!r} is shed (brownout level "
                f"{self.brownout.level}); retry later or use a higher "
                "priority lane",
                lane=lane_name,
                retry_after=self.queue.estimate_retry_after(lane_name),
            )
        deadline_s = getattr(payload, "deadline_s", None)
        if deadline_s is not None:
            estimated = self.queue.estimate_wait(lane_name)
            if estimated >= float(deadline_s):
                raise DeadlineUnmeetable(
                    f"deadline {float(deadline_s):g}s cannot be met: "
                    f"estimated queue wait is {estimated:.1f}s",
                    lane=lane_name,
                    retry_after=self.queue.estimate_retry_after(lane_name),
                    deadline_s=float(deadline_s),
                    estimated_wait=estimated,
                )
        cost = 1.0
        tiles = 1.0
        estimated_tiles = payload.extra.get("estimated_tiles")
        try:
            if estimated_tiles is not None and float(estimated_tiles) > 0:
                cost = float(estimated_tiles)
                tiles = float(estimated_tiles)
        except (TypeError, ValueError):
            pass
        cost *= self._measured_cost_ratio(payload.tenant)
        cost *= self._adapter_cost(payload)
        cost *= self._cache_cost(payload.tenant)
        self._note_admitted_cost(payload.tenant, cost / tiles)
        self._note_admitted_tiles(payload.tenant, tiles)
        return self.queue.submit(
            tenant=payload.tenant,
            lane=payload.lane,
            cost=cost,
            trace_id=payload.trace_id,
        )

    def _note_admitted_cost(self, tenant: str, per_tile_cost: float) -> None:
        tenant = str(tenant)
        self._tenant_tile_cost.pop(tenant, None)
        while len(self._tenant_tile_cost) >= self._max_tenant_tile_cost:
            self._tenant_tile_cost.pop(next(iter(self._tenant_tile_cost)))
        self._tenant_tile_cost[tenant] = float(per_tile_cost)

    def note_cache_settled(self, tenant: str, tiles: int) -> float:
        """One cache settle's contribution to the admission gap:
        ``tiles`` of this tenant completed from the tile cache after
        admission charged their full per-tile cost. Returns the gap
        added (cost units). Fed by JobStore.settle_sink; an unknown
        tenant (admitted before this process started, or a direct
        executor call that bypassed admission) charges the static 1.0
        per-tile cost — the same fallback admission itself uses.

        With the CDT_CACHE_COST discount on, the recorded per-tile
        admitted cost already carries the discount, so each settle
        lands a strictly smaller gap on the
        `cdt_cache_unsettled_admission_cost` gauge — admission
        pre-paying the expected hits IS what drops the gauge."""
        tiles = int(tiles)
        if tiles <= 0:
            return 0.0
        per_tile = self._tenant_tile_cost.get(str(tenant), 1.0)
        gap = tiles * per_tile
        self.unsettled_admission_cost += gap
        self._note_settled_tiles(tenant, tiles)
        return gap

    def _cache_cost(self, tenant: str) -> float:
        """The CDT_CACHE_COST multiplier: 1 - (tenant's recent cache-hit
        share), floored by CDT_CACHE_COST_FLOOR. Tiles the cache index
        keeps settling never burn chip time, so charging full freight
        for them at DRR admission double-bills the tenant. 1.0 when the
        knob is off or the tenant has no settle history yet."""
        from ..utils import constants

        if not constants.cache_cost_enabled():
            return 1.0
        admitted = self._tenant_admitted_tiles.get(str(tenant), 0.0)
        settled = self._tenant_settled_tiles.get(str(tenant), 0.0)
        if admitted <= 0.0 or settled <= 0.0:
            return 1.0
        hit_share = min(1.0, settled / admitted)
        return max(constants.cache_cost_floor(), 1.0 - hit_share)

    def _note_admitted_tiles(self, tenant: str, tiles: float) -> None:
        tenant = str(tenant)
        adm = self._tenant_admitted_tiles
        prev = adm.pop(tenant, 0.0)
        while len(adm) >= self._max_tenant_tile_cost:
            adm.pop(next(iter(adm)))
        total = prev + float(tiles)
        if total > self._cache_hit_window:
            # halve BOTH counters so the hit share tracks recent
            # behavior instead of freezing on all-time history
            total *= 0.5
            settled = self._tenant_settled_tiles.get(tenant, 0.0)
            if settled:
                self._tenant_settled_tiles[tenant] = settled * 0.5
        adm[tenant] = total

    def _note_settled_tiles(self, tenant: str, tiles: float) -> None:
        tenant = str(tenant)
        st = self._tenant_settled_tiles
        prev = st.pop(tenant, 0.0)
        while len(st) >= self._max_tenant_tile_cost:
            st.pop(next(iter(st)))
        st[tenant] = prev + float(tiles)

    def _adapter_cost(self, payload: Any) -> float:
        """The CDT_ADAPTER_COLD_COST multiplier: a request whose
        adapter plan is NOT resident in the host operand cache pays a
        cold surcharge at DRR admission — the decode + operand build
        it will trigger is real work the fair-share meter should see.
        1.0 (off by default) when the knob is unset, the request wears
        no adapters, or every adapter is warm. Advisory: a broken
        cache peek must never fail admission."""
        from ..adapters import adapter_admission_cost

        specs = getattr(payload, "adapters", None) or []
        hashes = [
            getattr(s, "content_hash", "") for s in specs
            if getattr(s, "content_hash", "")
        ]
        return adapter_admission_cost(hashes)

    def _measured_cost_ratio(self, tenant: str) -> float:
        """The CDT_USAGE_COST multiplier: the tenant's measured
        chip-seconds-per-tile relative to the fleet mean (clamped by
        the aggregator). 1.0 when the knob is off, the seam is unwired,
        or the ratio is degenerate — the static cost is the fallback,
        never a failure."""
        from ..utils import constants

        if not constants.USAGE_COST_ENABLED or self.usage_cost is None:
            return 1.0
        try:
            ratio = float(self.usage_cost(tenant))
        except Exception as exc:  # noqa: BLE001 - advisory model
            log(f"scheduler: usage cost ratio for {tenant!r} failed: {exc}")
            return 1.0
        if not (ratio > 0.0) or ratio != ratio:
            return 1.0
        return ratio

    # --- state machine ----------------------------------------------------

    @property
    def state(self) -> SchedulerState:
        return SchedulerState(self.queue.state)

    def pause(self) -> SchedulerState:
        self.queue.pause()
        self._publish_state()
        return self.state

    def resume(self) -> SchedulerState:
        self.queue.resume()
        self._publish_state()
        return self.state

    def drain(self) -> SchedulerState:
        self.queue.drain()
        self._publish_state()
        return self.state

    def _publish_state(self) -> None:
        get_event_bus().publish(
            "scheduler_state",
            state=self.queue.state,
            active=len(self.queue.active),
            queued=self.queue.queued(),
        )

    # --- reprioritization -------------------------------------------------

    def reprioritize(
        self,
        ticket_id: Optional[str] = None,
        lane: Optional[str] = None,
        tenant: Optional[str] = None,
        weight: Optional[float] = None,
    ) -> dict:
        """Two shapes: {ticket_id, lane} moves one queued request to
        another priority class; {tenant, weight} retunes a tenant's
        fair share live. Both may appear in one call."""
        moved = None
        if ticket_id is not None:
            if not lane:
                raise ValueError("'lane' is required to move a ticket")
            moved = self.queue.reprioritize(ticket_id, lane)
            if moved:
                log(f"scheduler: ticket {ticket_id} moved to lane {lane!r}")
        if tenant is not None:
            if weight is None:
                raise ValueError("'weight' is required to retune a tenant")
            self.queue.set_weight(tenant, float(weight))
            log(f"scheduler: tenant {tenant!r} weight set to {float(weight):g}")
        return {
            "moved": moved,
            "tenant_weights": dict(self.queue.tenant_weights),
        }

    # --- exported state ----------------------------------------------------

    def export_state(self) -> dict:
        """The admission aggregates and the placement speed model, the
        state a restarted master would restore."""
        return {
            "admission": self.queue.export_state(),
            "placement": self.placement.export_state(),
        }

    def restore_state(self, state: dict) -> None:
        admission = state.get("admission")
        if isinstance(admission, dict):
            self.queue.restore_state(admission)
        placement = state.get("placement")
        if isinstance(placement, dict):
            self.placement.restore_state(placement)

    # --- observability ----------------------------------------------------

    def status(self) -> dict:
        return {
            "state": self.queue.state,
            "admission": self.queue.snapshot(),
            "placement": self.placement.snapshot(),
            "worker_weights": self.placement.weights(),
            "brownout": self.brownout.snapshot(),
            "unsettled_admission_cost": round(
                self.unsettled_admission_cost, 6
            ),
        }
