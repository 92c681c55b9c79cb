"""Multi-lane admission queue with per-tenant fair share.

The port's own copy of comfyui_distributed_tpu/scheduler/queue.py. The Borg/vLLM lesson applied to the distributed queue route: requests
are *admitted* into a priority lane, wait their turn under
deficit-round-robin (DRR) across tenants, and only then *granted* one
of `max_active` orchestration slots. A full lane rejects with explicit
backpressure (the route maps `SchedulerSaturated` to HTTP 429 +
``Retry-After``); drain mode closes admission while everything already
admitted completes.

Fairness is classic DRR (Shreedhar & Varghese): each lane keeps one
FIFO per tenant plus a deficit counter; a tenant at the head of the
rotation is replenished ``quantum x weight`` once per visit and serves
requests while its deficit covers their cost (cost = the request's
estimated tile count, so fair share is over *tile work*, not request
count). Two backlogged tenants with weights 3:1 therefore receive tile
work 3:1 regardless of arrival order or request sizes.

Single-loop discipline: every method is expected on the server loop
(route handlers, pump, and control routes all live there); the clock
is injectable so tier-1 tests drive fairness over a fake timeline.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import math
import time
from typing import Callable, Iterable, Optional

from ..telemetry import instruments
from ..telemetry.events import get_event_bus
from ..utils import constants
from ..utils.exceptions import DistributedError
from ..utils.logging import log

# Scheduler admission states (mirrored by control.SchedulerState).
RUNNING = "running"
PAUSED = "paused"
DRAINING = "draining"


class SchedulerSaturated(DistributedError):
    """Lane at capacity (or grant wait expired): back off and retry."""

    def __init__(self, message: str, lane: str, retry_after: float):
        super().__init__(message)
        self.lane = lane
        self.retry_after = retry_after


class AdmissionClosed(DistributedError):
    """Drain mode: no new work is admitted until resume."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = retry_after


class SchedulerOverloaded(SchedulerSaturated):
    """Brownout: this lane is currently SHED by the load-shed
    controller (scheduler/brownout.py) — rejected before consuming
    queue depth or a grant slot. Same 429 + Retry-After contract as a
    full lane."""


class DeadlineUnmeetable(SchedulerSaturated):
    """The request carried an end-to-end deadline the scheduler cannot
    meet at admission time (estimated queue wait already exceeds it):
    rejected with 429 instead of admitting doomed work."""

    def __init__(
        self, message: str, lane: str, retry_after: float,
        deadline_s: float, estimated_wait: float,
    ):
        super().__init__(message, lane, retry_after)
        self.deadline_s = deadline_s
        self.estimated_wait = estimated_wait


def parse_lane_spec(spec: str) -> list[tuple[str, int]]:
    """"interactive:64,batch:256" → [(name, depth), ...] in priority
    order; malformed entries raise so a typo'd deployment fails loud."""
    lanes: list[tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, depth_s = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"bad lane entry {part!r} in {spec!r}")
        try:
            depth = int(depth_s) if depth_s else 64
        except ValueError as exc:
            raise ValueError(f"bad lane depth in {part!r}") from exc
        if depth <= 0:
            raise ValueError(f"lane depth must be > 0 in {part!r}")
        lanes.append((name, depth))
    if not lanes:
        raise ValueError(f"no lanes in spec {spec!r}")
    return lanes


def parse_tenant_weights(spec: str) -> dict[str, float]:
    """"a=3,b=1" → {"a": 3.0, "b": 1.0}; unlisted tenants weigh 1."""
    weights: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        tenant, _, value = part.partition("=")
        try:
            weight = float(value)
        except ValueError as exc:
            raise ValueError(f"bad tenant weight {part!r}") from exc
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0 in {part!r}")
        weights[tenant.strip()] = weight
    return weights


@dataclasses.dataclass
class Ticket:
    """One admitted request's place in the control plane."""

    ticket_id: str
    tenant: str
    lane: str
    cost: float
    trace_id: Optional[str]
    submitted_at: float
    granted_at: Optional[float] = None
    released_at: Optional[float] = None
    state: str = "queued"  # queued | granted | cancelled | released
    _granted: asyncio.Event = dataclasses.field(
        default_factory=asyncio.Event, repr=False
    )

    async def granted(self) -> None:
        await self._granted.wait()

    @property
    def queue_wait_seconds(self) -> Optional[float]:
        if self.granted_at is None:
            return None
        return self.granted_at - self.submitted_at


class _Lane:
    """One priority class: per-tenant FIFOs + DRR bookkeeping."""

    def __init__(self, name: str, max_depth: int):
        self.name = name
        self.max_depth = max_depth
        self.queues: dict[str, collections.deque[Ticket]] = {}
        self.rotation: collections.deque[str] = collections.deque()
        self.deficit: dict[str, float] = {}

    def depth(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def push(self, ticket: Ticket) -> None:
        queue = self.queues.get(ticket.tenant)
        if queue is None:
            queue = collections.deque()
            self.queues[ticket.tenant] = queue
        if not queue and ticket.tenant not in self.rotation:
            self.rotation.append(ticket.tenant)
            self.deficit.setdefault(ticket.tenant, 0.0)
        queue.append(ticket)

    def _drop_tenant(self, tenant: str) -> None:
        """A tenant's queue drained: leave the rotation and forfeit any
        leftover deficit (an idle tenant must not bank credit)."""
        if tenant in self.rotation:
            self.rotation.remove(tenant)
        self.deficit[tenant] = 0.0
        self.queues.pop(tenant, None)

    def _serve(self, tenant: str) -> Ticket:
        queue = self.queues[tenant]
        ticket = queue.popleft()
        self.deficit[tenant] -= ticket.cost
        if not queue:
            self._drop_tenant(tenant)
        return ticket

    def pop_next(
        self, quantum: float, weight_of: Callable[[str], float]
    ) -> Optional[Ticket]:
        """Deficit-round-robin pop of the next ticket; None when empty.

        The rotation head keeps serving while its banked deficit covers
        its head request (the classic DRR burst). When it can't, it
        moves to the back and — instead of looping rotations one at a
        time, which would strand large-cost requests behind a small
        quantum — the number of whole rotations until SOME tenant's
        deficit covers its head cost is computed in closed form; every
        deficit advances by exactly that many rotations' replenishment
        (quantum x weight each), which is bit-for-bit the state classic
        DRR would reach, just without the walk."""
        if not self.rotation:
            return None
        head = self.rotation[0]
        if self.deficit[head] >= self.queues[head][0].cost - 1e-12:
            return self._serve(head)
        # head's burst is over: to the back, as DRR's visit order does
        self.rotation.rotate(-1)
        # Visit k of tenant t replenishes it for the k-th time; t can
        # first serve on visit ceil(need / (quantum x weight)) — at
        # least 1, since every visit replenishes even a tenant whose
        # bank already covers its head. The winner is the earliest
        # (visit, position) pair; at serve time classic DRR has
        # replenished positions ≤ winner `k` times and positions after
        # it `k - 1` times. Advancing deficits by exactly those counts
        # reaches the same state without walking the rotations.
        best: Optional[tuple[int, int, str]] = None
        for pos, tenant in enumerate(self.rotation):
            need = self.queues[tenant][0].cost - self.deficit[tenant]
            per_round = quantum * max(weight_of(tenant), 1e-9)
            rounds = max(1, math.ceil(need / per_round - 1e-12))
            if best is None or (rounds, pos) < best[:2]:
                best = (rounds, pos, tenant)
        rounds, pos, winner = best
        for p, tenant in enumerate(self.rotation):
            visits = rounds if p <= pos else rounds - 1
            if visits:
                self.deficit[tenant] += visits * quantum * weight_of(tenant)
        self.rotation.rotate(-pos)  # winner to the head; burst continues
        return self._serve(winner)

    def remove(self, ticket: Ticket) -> bool:
        queue = self.queues.get(ticket.tenant)
        if queue is None or ticket not in queue:
            return False
        queue.remove(ticket)
        if not queue:
            self._drop_tenant(ticket.tenant)
        return True

    def tenants_snapshot(self) -> dict[str, dict[str, float]]:
        return {
            tenant: {
                "queued": len(queue),
                "deficit": round(self.deficit.get(tenant, 0.0), 6),
            }
            for tenant, queue in self.queues.items()
            if queue
        }


class AdmissionQueue:
    def __init__(
        self,
        lanes: Optional[Iterable[tuple[str, int]]] = None,
        max_active: Optional[int] = None,
        tenant_weights: Optional[dict[str, float]] = None,
        quantum: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        lane_spec = (
            list(lanes)
            if lanes is not None
            else parse_lane_spec(constants.SCHED_LANES)
        )
        self.lanes: dict[str, _Lane] = {
            name: _Lane(name, depth) for name, depth in lane_spec
        }
        self.lane_order = [name for name, _ in lane_spec]
        self.max_active = (
            max_active if max_active is not None else constants.SCHED_MAX_ACTIVE
        )
        self.quantum = quantum if quantum is not None else constants.SCHED_QUANTUM
        self.tenant_weights = dict(
            tenant_weights
            if tenant_weights is not None
            else parse_tenant_weights(constants.SCHED_TENANT_WEIGHTS)
        )
        self.clock = clock
        self.state = RUNNING
        self.active: dict[str, Ticket] = {}
        # Optional per-grant queue-wait feed (the brownout controller's
        # leading overload indicator); must never raise into _pump.
        self.wait_sink: Optional[Callable[[float], None]] = None
        self._seq = 0
        # EWMAs feeding the Retry-After estimate and the status view.
        self._service_ewma: Optional[float] = None
        self._wait_ewma: Optional[float] = None
        self.totals = {
            "admitted": 0,
            "granted": 0,
            "released": 0,
            "rejected_full": 0,
            "rejected_draining": 0,
            "cancelled": 0,
        }

    # --- weights ----------------------------------------------------------

    def weight(self, tenant: str) -> float:
        return self.tenant_weights.get(tenant, 1.0)

    def set_weight(self, tenant: str, weight: float) -> None:
        if weight <= 0:
            raise ValueError("tenant weight must be > 0")
        self.tenant_weights[tenant] = float(weight)

    # --- admission --------------------------------------------------------

    def submit(
        self,
        tenant: str,
        lane: Optional[str] = None,
        cost: float = 1.0,
        trace_id: Optional[str] = None,
    ) -> Ticket:
        """Admit one request; raises AdmissionClosed while draining and
        SchedulerSaturated when the lane is full. The returned ticket's
        `granted()` resolves once a slot is assigned."""
        lane_name = lane or constants.SCHED_DEFAULT_LANE
        lane_state = self.lanes.get(lane_name)
        if lane_state is None:
            # unknown lane → lowest-priority lane, never a hard error —
            # but say so: a typo'd lane silently waiting behind every
            # other class is otherwise undiagnosable (the effective
            # lane is also echoed in the queue response and the ticket)
            log(
                f"scheduler: unknown lane {lane_name!r} from tenant "
                f"{tenant!r}; routed to {self.lane_order[-1]!r}"
            )
            lane_name = self.lane_order[-1]
            lane_state = self.lanes[lane_name]
        if self.state == DRAINING:
            self.totals["rejected_draining"] += 1
            instruments.sched_admissions_total().inc(
                lane=lane_name, tenant=tenant, outcome="rejected_draining"
            )
            raise AdmissionClosed(
                "scheduler is draining; admission closed",
                retry_after=self.estimate_retry_after(lane_name),
            )
        if lane_state.depth() >= lane_state.max_depth:
            self.totals["rejected_full"] += 1
            instruments.sched_admissions_total().inc(
                lane=lane_name, tenant=tenant, outcome="rejected_full"
            )
            raise SchedulerSaturated(
                f"lane {lane_name!r} is full "
                f"({lane_state.max_depth} queued); retry later",
                lane=lane_name,
                retry_after=self.estimate_retry_after(lane_name),
            )
        self._seq += 1
        ticket = Ticket(
            ticket_id=f"t{self._seq}",
            tenant=tenant,
            lane=lane_name,
            cost=max(float(cost), 1e-9),
            trace_id=trace_id,
            submitted_at=self.clock(),
        )
        lane_state.push(ticket)
        self.totals["admitted"] += 1
        instruments.sched_admissions_total().inc(
            lane=lane_name, tenant=tenant, outcome="admitted"
        )
        get_event_bus().publish(
            "sched_admitted",
            ticket_id=ticket.ticket_id,
            tenant=tenant,
            lane=lane_name,
            cost=ticket.cost,
            depth=lane_state.depth(),
        )
        self._pump()
        return ticket

    def cancel(self, ticket: Ticket) -> bool:
        """Withdraw a queued ticket (grant-wait timeout / client gone /
        the DELETE ticket route). A ticket already granted cannot be
        cancelled — release it."""
        if ticket.state != "queued":
            return False
        lane_state = self.lanes.get(ticket.lane)
        if lane_state is None or not lane_state.remove(ticket):
            return False
        ticket.state = "cancelled"
        self.totals["cancelled"] += 1
        instruments.sched_admissions_total().inc(
            lane=ticket.lane, tenant=ticket.tenant, outcome="cancelled"
        )
        # wake a request parked on granted(): it re-checks the state
        # and unwinds as cancelled instead of waiting out the grant
        # timeout (the DELETE route's whole point)
        ticket._granted.set()
        return True

    def find_ticket(self, ticket_id: str) -> Optional[Ticket]:
        """Locate a QUEUED ticket by id (granted/released tickets are
        not findable here — cancellation of granted work goes through
        the job-level cancel seam)."""
        for lane_state in self.lanes.values():
            for queue in lane_state.queues.values():
                for ticket in queue:
                    if ticket.ticket_id == ticket_id:
                        return ticket
        return None

    def cancel_ticket(self, ticket_id: str) -> bool:
        """Pre-admission abandon over HTTP: withdraw one queued ticket
        by id (DELETE /distributed/queue/{ticket_id})."""
        ticket = self.find_ticket(ticket_id)
        if ticket is None:
            return False
        return self.cancel(ticket)

    # --- granting ---------------------------------------------------------

    def _pump(self) -> None:
        """Grant queued tickets into free slots: strict lane priority,
        DRR across tenants within a lane. PAUSED stops granting;
        DRAINING only stops admission, so queued work keeps granting."""
        if self.state == PAUSED:
            return
        while len(self.active) < self.max_active:
            ticket = None
            for lane_name in self.lane_order:
                ticket = self.lanes[lane_name].pop_next(self.quantum, self.weight)
                if ticket is not None:
                    break
            if ticket is None:
                return
            now = self.clock()
            ticket.granted_at = now
            ticket.state = "granted"
            self.active[ticket.ticket_id] = ticket
            self.totals["granted"] += 1
            wait = max(now - ticket.submitted_at, 0.0)
            self._wait_ewma = (
                wait
                if self._wait_ewma is None
                else 0.8 * self._wait_ewma + 0.2 * wait
            )
            if self.wait_sink is not None:
                try:
                    self.wait_sink(wait)
                except Exception:  # noqa: BLE001 - observability only
                    pass
            instruments.sched_grants_total().inc(
                lane=ticket.lane, tenant=ticket.tenant
            )
            instruments.sched_wait_seconds().observe(
                wait, lane=ticket.lane, tenant=ticket.tenant
            )
            get_event_bus().publish(
                "sched_granted",
                ticket_id=ticket.ticket_id,
                tenant=ticket.tenant,
                lane=ticket.lane,
                queue_wait_seconds=wait,
            )
            ticket._granted.set()

    def release(self, ticket: Ticket) -> None:
        """The granted request finished (or failed): free its slot."""
        if self.active.pop(ticket.ticket_id, None) is None:
            return
        ticket.state = "released"
        ticket.released_at = self.clock()
        if ticket.granted_at is not None:
            service = max(ticket.released_at - ticket.granted_at, 0.0)
            self._service_ewma = (
                service
                if self._service_ewma is None
                else 0.8 * self._service_ewma + 0.2 * service
            )
        self.totals["released"] += 1
        self._pump()

    # --- control ----------------------------------------------------------

    def pause(self) -> None:
        if self.state != PAUSED:
            log("scheduler paused: grants withheld, admission open")
        self.state = PAUSED

    def resume(self) -> None:
        if self.state != RUNNING:
            log("scheduler resumed")
        self.state = RUNNING
        self._pump()

    def drain(self) -> None:
        if self.state != DRAINING:
            log("scheduler draining: admission closed, queued work completing")
        self.state = DRAINING
        self._pump()

    def reprioritize(self, ticket_id: str, lane: str) -> bool:
        """Move one queued ticket to another lane (front-of-class
        escalation or demotion); False when not found / not queued."""
        if lane not in self.lanes:
            raise ValueError(f"unknown lane {lane!r}")
        for lane_state in self.lanes.values():
            for queue in lane_state.queues.values():
                for ticket in queue:
                    if ticket.ticket_id == ticket_id:
                        lane_state.remove(ticket)
                        ticket.lane = lane
                        self.lanes[lane].push(ticket)
                        self._pump()
                        return True
        return False

    # --- exported state ----------------------------------------------------

    def export_state(self) -> dict:
        """The aggregates worth carrying over a master restart (the
        durable control plane samples them into every snapshot,
        durability/manager.py): tenant DRR
        deficits (fair-share position), live tenant weights (operator
        retunes via /distributed/scheduler/reprioritize), and the
        admission totals. Queued TICKETS are deliberately absent — they
        wrap asyncio futures of HTTP requests that died with the old
        process; their clients retry against the restarted master."""
        return {
            "tenant_weights": dict(self.tenant_weights),
            "deficits": {
                name: {t: round(d, 9) for t, d in lane.deficit.items()}
                for name, lane in self.lanes.items()
            },
            "totals": dict(self.totals),
        }

    def restore_state(self, state: dict) -> None:
        """Best-effort inverse of export_state onto a fresh queue:
        unknown lanes/keys are skipped (lane specs may change across
        restarts), bad values are ignored — restoring advisory
        aggregates must never be able to wedge admission."""
        for tenant, weight in (state.get("tenant_weights") or {}).items():
            try:
                if float(weight) > 0:
                    self.tenant_weights[str(tenant)] = float(weight)
            except (TypeError, ValueError):
                continue
        for lane_name, deficits in (state.get("deficits") or {}).items():
            lane = self.lanes.get(str(lane_name))
            if lane is None or not isinstance(deficits, dict):
                continue
            for tenant, deficit in deficits.items():
                try:
                    lane.deficit[str(tenant)] = float(deficit)
                except (TypeError, ValueError):
                    continue
        for key, value in (state.get("totals") or {}).items():
            if key in self.totals:
                try:
                    self.totals[key] = int(value)
                except (TypeError, ValueError):
                    continue

    # --- observability ----------------------------------------------------

    def estimate_retry_after(self, lane: str) -> float:
        """Seconds a rejected client should wait: the lane's queued
        cost over the grant rate, bounded to something polite."""
        service = self._service_ewma if self._service_ewma else 1.0
        depth = self.lanes[lane].depth() if lane in self.lanes else 0
        estimate = service * (depth + 1) / max(self.max_active, 1)
        return float(min(max(round(estimate), 1), 60))

    def estimate_wait(self, lane: str) -> float:
        """Estimated queue wait for a request admitted to `lane` NOW —
        the deadline-admission gate's input. Unlike estimate_retry_after
        this is unclamped and may be 0 (empty queue, free slot: no
        wait), so short deadlines pass on an idle scheduler."""
        if len(self.active) < self.max_active and self.queued() == 0:
            return 0.0
        service = self._service_ewma if self._service_ewma else 1.0
        depth = self.lanes[lane].depth() if lane in self.lanes else 0
        backlog = depth + max(0, len(self.active) - self.max_active + 1)
        estimate = service * backlog / max(self.max_active, 1)
        if self._wait_ewma is not None:
            estimate = max(estimate, self._wait_ewma)
        return float(estimate)

    def queued(self) -> int:
        return sum(lane.depth() for lane in self.lanes.values())

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "max_active": self.max_active,
            "active": len(self.active),
            "active_tickets": [
                {
                    "ticket_id": t.ticket_id,
                    "tenant": t.tenant,
                    "lane": t.lane,
                    "cost": t.cost,
                }
                for t in self.active.values()
            ],
            "queued": self.queued(),
            "lanes": [
                {
                    "name": name,
                    "priority": idx,
                    "depth": self.lanes[name].depth(),
                    "max_depth": self.lanes[name].max_depth,
                    "tenants": self.lanes[name].tenants_snapshot(),
                }
                for idx, name in enumerate(self.lane_order)
            ],
            "tenant_weights": dict(self.tenant_weights),
            "quantum": self.quantum,
            "wait_ewma_seconds": self._wait_ewma,
            "service_ewma_seconds": self._service_ewma,
            "totals": dict(self.totals),
        }
