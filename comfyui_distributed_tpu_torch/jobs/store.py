"""The JobStore: lock-guarded registry of in-flight distributed jobs.

The port's own copy of the operations of comfyui_distributed_tpu/jobs/
store.py that the elastic loops and the routes call, with the same
semantics:

- a job is created by the master's loop (`init_tile_job`); a worker's
  pull or submit that arrives first parks on a per-job creation future
  up to a grace period, never a poll loop;
- a pull pops one task id, and a grant (`pull_tasks`) as many as the
  placement policy sizes for the worker (scheduler/placement.py:
  `batch_size` from its speed EWMA and advertised capacity, 1 without a
  policy); the policy may deny a slow or suspect worker the job's tail
  (`may_pull`: the pull reads as drained, outcome "trimmed"). An EMPTY
  pull still heartbeats, since a worker draining the tail is alive;
- every completion's pull-to-submit service time (measured from the
  later of its assignment and the worker's previous submit, to ANY job;
  a flush's interval split evenly over its tiles) feeds
  cdt_worker_tile_seconds and the `latency_sink` (the server fans it out
  to the placement policy, the watchdog and the tile-latency SLO);
- completions are idempotent: the first result wins and duplicates (a
  requeued-then-recovered worker's late submission) are dropped;
- the timeout scan snapshots under the lock and probes stale workers
  outside it (a worker busy on a tile is given grace); their tiles go
  back to the queue, and a tile that exhausts its attempt budget is
  quarantined instead, the workers charged for it pardoned through the
  `poison_pardon` hook (the breaker's `pardon`) outside the lock;
- the breaker's quarantine of a worker (resilience/__init__.py::
  bind_quarantine_requeue) requeues its in-flight tiles of every job at
  once (`requeue_worker_tasks`), charged as attempts like a timeout;
- every refill of a job's pending queue (creation, a timeout or
  quarantine requeue, a release, a lifted preemption, speculation)
  calls the `grant_notifier` with the job and the count (the server
  wires the placement policy's `notify_grants`: push grants), outside
  any wait and never failing the mutation;
- the stall watchdog's speculative requeue (`speculate_in_flight`)
  enqueues copies of in-flight tiles without revoking them: the first
  result wins, and the loser's measured time is `speculation` waste;
- preemption (scheduler/preempt.py drives `request_preemption`,
  `clear_preemption` and `preempt_victims`): a flagged job's pulls read
  as drained (outcome "preempted") until the flags lift; the
  coordinator hears of every creation, cleanup and cancellation;
- cancellation refunds every pending and in-flight tile; later pulls
  read as drained and later submissions drop;
- a collector job gathers workers' image envelopes in a queue; an
  envelope that arrives before the orchestration announced its job
  parks on the creation signal up to the grace, then creates the job
  itself. The master's collector removes its job once it has drained it
  (`cleanup_collector`); its counts move to `finished`, its id to a
  bounded set of its own (tile jobs do not evict it), and an envelope
  for it that arrives later is dropped as late, not queued on a job
  created anew. (The JAX package never calls `cleanup_collector`: there
  every collector job and its queue outlive their prompt.)

A job's adapter plan and its admission lane and tenant, noted by the
orchestration before the master creates the job (`note_job_adapters`,
`note_job_priority`), are stamped onto it at creation;
tiles served by the master's tile cache settle atomically with creation
(`init_tile_job(cache_settled=)`) or later (`settle_cached`), complete
without ever entering the pull set, and each settle tells the
`settle_sink` (the scheduler's admission-gap accounting).

A fault plan (resilience/faults.py; the server passes the process's
injector) is consulted as in the JAX store: store:pull:<id> once a pull
RPC, store:submit:<id> once a submitted tile, and store:heartbeat:<id>
wherever a heartbeat is recorded (a `drop` there swallows the beat).

Every state transition emits one typed record into the optional
`journal_sink` (durability/manager.py::DurabilityManager.record) under
the store lock, at the point it commits and before it is acknowledged:
`job_init`, `pull` (a grant's first task, then one record for the rest
of it), `submit` (the first result only: a duplicate journals nothing),
`cache_settle`, `worker_done`, `cleanup`, `cancel` (after which the
job's late submissions, releases and requeues journal nothing),
`requeue` (reason timeout, quarantine or released), `tile_quarantine`
and `speculate`; the records and their fields are the JAX store's. A
sink failure propagates: nothing is acknowledged that was not made
durable. `on_worker_seen` (not journaled) hears of every recorded
heartbeat, so a recovered master resumes admission when a worker shows
life. Port-only paths journal nothing, as the JAX store has no such
transition: `drop_late`, the route's answer for a finished job.

Left out: fencing epochs (ROADMAP Queue 1 step 7g), preemption
checkpoints (their take, retain and resume), and the cross-job tier and
its multi-job grants (with their fault site and `pull` record in
`pull_tasks_any`).

Every accepted completion is recorded with its participant
(`TileJob.completions`); on cleanup a job's record moves to
`finished`, which keeps the last FINISHED_KEPT jobs of both kinds.

Telemetry, as in the JAX store: pulls count by outcome
(task|empty|cancelled) and submissions by outcome
(accepted|duplicate|cancelled) in cdt_store_pulls_total and
cdt_store_submits_total, every recorded heartbeat (pulls and submits
heartbeat too) in cdt_store_heartbeats_total, requeues by reason
(timeout|quarantine|speculative|released), cancellations, refunds,
quarantines and cache settles in their counters; a created job
publishes `job_ready`, a cleaned-up one `job_complete` and a cancelled
one `job_cancelled` on the event bus; and the usage meter
learns each job's tenant, lane and adapter plan at creation, the
measured assignment time of a failed delivery attempt (`poison_retry`
waste) and a lost speculative race (`speculation` waste); preemption
requests count in cdt_preempt_total and pardons in
cdt_poison_pardons_total.
`stats_unlocked` serves the scrape-time gauges.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Awaitable, Callable, Optional

from ..telemetry import instruments
from ..utils.exceptions import JobQueueError
from ..utils.logging import debug_log, log
from .models import CollectorJob, ImageJob, TileJob

FINISHED_KEPT = 64
# ids of cleaned-up collector jobs kept to recognise a late envelope: ids
# only, so many more than FINISHED_KEPT's records
CLEANED_COLLECTORS_KEPT = 4096
# deadlines noted for jobs not created yet (job ids arrive from the network)
PENDING_DEADLINES_KEPT = 512
# workers whose last submit time is kept (cross-job service times)
WORKER_LAST_SUBMIT_KEPT = 1024


def _note_usage(record: Callable[[Any], None]) -> None:
    """Hand the usage meter to `record` while metering is on (CDT_USAGE).
    Advisory: metering must never fail a store mutation."""
    from ..utils.constants import USAGE_ENABLED

    if not USAGE_ENABLED:
        return
    try:
        from ..telemetry.usage import get_usage_meter

        record(get_usage_meter())
    except Exception as exc:  # noqa: BLE001 - observability only
        debug_log(f"usage note failed: {exc}")


class JobStore:
    def __init__(self, fault_injector: Any = None, max_attempts: Optional[int] = None,
                 poison_policy: Optional[str] = None) -> None:
        from ..utils import constants

        self.lock = asyncio.Lock()
        self.collectors: dict[str, CollectorJob] = {}
        self.tile_jobs: dict[str, TileJob] = {}
        # resilience/faults.py's FaultInjector (None = no plan): consulted
        # at store:pull:<id>, store:submit:<id> and store:heartbeat:<id>
        self.fault_injector = fault_injector
        self.max_attempts = constants.TILE_MAX_ATTEMPTS if max_attempts is None else max_attempts
        self.poison_policy = constants.POISON_POLICY if poison_policy is None else poison_policy
        # job_id → deadline seconds noted by the orchestration before the
        # master's init_tile_job runs; bounded, popped at init
        self._pending_deadlines: dict[str, float] = {}
        # job_id → the resolved adapter plan (wire form), noted likewise
        self._pending_adapters: dict[str, list] = {}
        # job_id → [(loop, future)] waiters parked until creation
        self._tile_waiters: dict[str, list[tuple[Any, Any]]] = {}
        self._collector_waiters: dict[str, list[tuple[Any, Any]]] = {}
        # job_id → the record of a cleaned-up job, oldest evicted first:
        # {"total", "cached", "adapters", "completions", "duplicates",
        # "received_bytes", "finished_workers"} of a tile job, {"received", "received_bytes",
        # "finished_workers", "late"} of a collector job
        self.finished: dict[str, dict[str, Any]] = {}
        # ids of cleaned-up collector jobs, oldest evicted first (an
        # ordered set): an envelope for one of them is late
        self._cleaned_collectors: dict[str, None] = {}
        # job_id → (lane, tenant) noted likewise, stamped at init
        self._pending_priorities: dict[str, tuple[str, str]] = {}
        # worker_id → monotonic time of its last submit to ANY job: a
        # tile's service time starts no earlier (bounded, oldest evicted)
        self._worker_last_submit: dict[str, float] = {}
        # the scheduler's seams, wired by the server (None = off):
        # placement (PlacementPolicy: may_pull, batch_size, set_capacity),
        # the (worker_id, seconds) latency sink, the (tenant, tiles)
        # settle sink, the preemption coordinator, and the poison pardon
        # called with the worker ids a quarantined tile charged
        self.placement: Any = None
        self.latency_sink: Optional[Callable[[str, float], None]] = None
        self.settle_sink: Optional[Callable[[str, int], None]] = None
        self.preempt_policy: Any = None
        self.poison_pardon: Optional[Callable[[list[str]], None]] = None
        self._poison_notices: list[tuple[str, list[int], list[str]]] = []
        # worker_id → advertised chip count (a pull's or heartbeat's
        # `devices`), bounded like the placement policy's table
        self.worker_capacity: dict[str, int] = {}
        # push grants: called with (job_id, task count) on every refill of
        # a pending queue; must not block (None = off)
        self.grant_notifier: Optional[Callable[[str, int], None]] = None
        # the write-ahead seam: called with one typed record a committed
        # transition, before it is acknowledged (None = no journal)
        self.journal_sink: Optional[Callable[[dict[str, Any]], None]] = None
        # called with the worker id of every recorded heartbeat (not
        # journaled; None = off)
        self.on_worker_seen: Optional[Callable[[str], None]] = None

    def _journal(self, record: dict[str, Any]) -> None:
        sink = self.journal_sink
        if sink is not None:
            sink(record)

    def _notify_grants(self, job_id: str, count: int) -> None:
        notifier = self.grant_notifier
        if notifier is not None and count > 0:
            try:
                notifier(job_id, int(count))
            except Exception as exc:  # noqa: BLE001 - a push is advisory
                debug_log(f"grant notifier failed for {job_id}: {exc}")

    def note_worker_capacity(self, worker_id: str, devices: Any) -> None:
        """Record a worker's advertised chip count and hand it to the
        placement policy. `devices` is an untrusted RPC field that
        multiplies grant caps: clamped to MAX_WORKER_DEVICES; a malformed
        value is ignored (capacity never fails a work RPC)."""
        from ..scheduler.placement import MAX_TRACKED_WORKERS, MAX_WORKER_DEVICES

        try:
            devices = max(1, min(int(devices), MAX_WORKER_DEVICES))
        except (TypeError, ValueError):
            return
        if worker_id in self.worker_capacity:
            self.worker_capacity.pop(worker_id)  # to the end: oldest advertised evicts first
        elif len(self.worker_capacity) >= MAX_TRACKED_WORKERS:
            self.worker_capacity.pop(next(iter(self.worker_capacity)))
        self.worker_capacity[worker_id] = devices
        placement = self.placement
        if placement is None:
            return
        try:
            # against the policy's own state: a worker it forgot must
            # land again
            if placement.capacity(worker_id) != devices:
                placement.set_capacity(worker_id, devices)
        except Exception as exc:  # noqa: BLE001 - placement is advisory
            debug_log(f"placement set_capacity({worker_id}) failed: {exc}")

    def _note_worker_submit_locked(self, worker_id: str, job: TileJob, now: float
                                   ) -> Optional[float]:
        """The worker's previous submit mark, the later of its per-job and
        cross-job marks, then both advanced to `now`. Caller holds
        self.lock."""
        prev_job = job.last_submit.get(worker_id)
        prev_any = self._worker_last_submit.pop(worker_id, None)
        job.last_submit[worker_id] = now
        while len(self._worker_last_submit) >= WORKER_LAST_SUBMIT_KEPT:
            self._worker_last_submit.pop(next(iter(self._worker_last_submit)))
        self._worker_last_submit[worker_id] = now
        marks = [m for m in (prev_job, prev_any) if m is not None]
        return max(marks) if marks else None

    # --- fault injection ------------------------------------------------

    async def _fault(self, op: str, worker_id: str) -> None:
        """Sleep or raise FaultInjected where the active fault plan targets
        `store:<op>:<worker_id>`."""
        if self.fault_injector is not None:
            await self.fault_injector.check(f"store:{op}:{worker_id}")

    def _heartbeat_dropped(self, worker_id: str) -> bool:
        """True when a `drop@store:heartbeat:<id>` fault swallows this beat
        (the worker thinks it beat; the master never saw it)."""
        if self.fault_injector is None:
            return False
        action = self.fault_injector.hit(f"store:heartbeat:{worker_id}")
        return action is not None and action.kind == "drop"

    def _record_heartbeat(self, job: TileJob, worker_id: str) -> None:
        """A heartbeat of `worker_id` on `job`, counted, unless a fault plan
        drops it. Caller holds self.lock."""
        if self._heartbeat_dropped(worker_id):
            return
        job.heartbeat(worker_id)
        instruments.store_heartbeats_total().inc(worker_id=worker_id)
        seen = self.on_worker_seen
        if seen is not None:
            try:
                seen(worker_id)
            except Exception as exc:  # noqa: BLE001 - liveness is advisory
                debug_log(f"on_worker_seen({worker_id}) failed: {exc}")

    # --- creation signalling ----------------------------------------------

    @staticmethod
    def _wake(waiters: list[tuple[Any, Any]]) -> None:
        """Resolve parked creation futures on their own loops."""

        def resolve(fut):
            if not fut.done():
                fut.set_result(True)

        for loop, fut in waiters:
            try:
                loop.call_soon_threadsafe(resolve, fut)
            except RuntimeError:
                pass  # the waiter's loop already closed; its wait timed out

    async def _park_until_created(self, waiters: dict[str, list[tuple[Any, Any]]],
                                  registry: dict[str, Any], job_id: str,
                                  grace_seconds: float) -> Any:
        """registry[job_id] as soon as it exists, parking on its creation
        signal up to `grace_seconds`; None if still absent at the
        deadline."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        async with self.lock:
            job = registry.get(job_id)
            if job is not None or grace_seconds <= 0:
                return job
            waiters.setdefault(job_id, []).append((loop, fut))
        try:
            try:
                await asyncio.wait_for(fut, grace_seconds)
            except asyncio.TimeoutError:
                pass
        finally:
            async with self.lock:
                pending = waiters.get(job_id)
                if pending is not None and (loop, fut) in pending:
                    pending.remove((loop, fut))
                    if not pending:
                        del waiters[job_id]
        async with self.lock:
            return registry.get(job_id)

    async def wait_for_tile_job(self, job_id: str, grace_seconds: float) -> Optional[TileJob]:
        """The job as soon as it exists, parking on its creation signal up
        to `grace_seconds`; None if still absent at the deadline."""
        return await self._park_until_created(self._tile_waiters, self.tile_jobs, job_id,
                                              grace_seconds)

    # --- collector jobs ---------------------------------------------------

    def _collector_locked(self, job_id: str) -> CollectorJob:
        job = self.collectors.get(job_id)
        if job is None:
            job = CollectorJob(job_id=job_id)
            self.collectors[job_id] = job
            self._wake(self._collector_waiters.pop(job_id, []))
        return job

    async def ensure_collector(self, job_id: str) -> CollectorJob:
        async with self.lock:
            return self._collector_locked(job_id)

    async def wait_for_collector(self, job_id: str,
                                 grace_seconds: float) -> Optional[CollectorJob]:
        """Result-submission side: wait up to the grace for the
        orchestration to create the job, then create it here (the master
        may still be validating its own prompt). Parks on the creation
        signal, not a poll loop. None, at once, for a job already cleaned
        up: an envelope for it is late."""
        async with self.lock:
            if job_id in self._cleaned_collectors and job_id not in self.collectors:
                return None
        job = await self._park_until_created(self._collector_waiters, self.collectors, job_id,
                                             grace_seconds)
        if job is not None:
            return job
        async with self.lock:
            if job_id in self._cleaned_collectors:
                return None  # cleaned up while this envelope waited
            return self._collector_locked(job_id)

    async def put_collector_result(self, job_id: str, item: dict[str, Any],
                                   received_bytes: int = 0) -> bool:
        """Queue one envelope for the master's collector; counts it for its
        worker, and an `is_last` envelope marks the worker finished. False
        for a job already cleaned up: the envelope is late, counted in the
        job's finished record while it is kept, and dropped, and no job is
        created anew."""
        worker_id = str(item.get("worker_id", ""))
        async with self.lock:
            job = self.collectors.get(job_id)
            if job is None and job_id in self._cleaned_collectors:
                record = self.finished.get(job_id)
                if record is not None:
                    record["late"] = record.get("late", 0) + 1
                debug_log(f"collector {job_id}: dropped a late envelope from {worker_id}")
                return False
            if job is None:
                job = self._collector_locked(job_id)
            job.received[worker_id] = job.received.get(worker_id, 0) + 1
            job.received_bytes += int(received_bytes)
            # queued before the worker reads as finished: a drain that sees
            # every worker finished and the queue empty has every item
            job.queue.put_nowait(item)
            if item.get("is_last"):
                job.finished_workers.add(worker_id)
        return True

    async def cleanup_collector(self, job_id: str) -> None:
        """Remove a drained collector job; its counts move to `finished`."""
        async with self.lock:
            job = self.collectors.pop(job_id, None)
            if job is None:
                return
            self._cleaned_collectors.pop(job_id, None)
            while len(self._cleaned_collectors) >= CLEANED_COLLECTORS_KEPT:
                self._cleaned_collectors.pop(next(iter(self._cleaned_collectors)))
            self._cleaned_collectors[job_id] = None
            self._remember_finished_locked(job_id, {
                "received": dict(job.received),
                "received_bytes": job.received_bytes,
                "finished_workers": sorted(job.finished_workers),
                "late": 0,
            })

    def _remember_finished_locked(self, job_id: str, record: dict[str, Any]) -> None:
        """Keep a cleaned-up job's record, evicting the oldest past
        FINISHED_KEPT. Caller holds self.lock."""
        self.finished.pop(job_id, None)
        while len(self.finished) >= FINISHED_KEPT:
            self.finished.pop(next(iter(self.finished)))
        self.finished[job_id] = record

    # --- tile jobs ----------------------------------------------------------

    def note_job_deadline(self, job_id: str, deadline_s: Any) -> None:
        """Record a deadline (seconds from now) for a job not created yet;
        malformed or non-positive values are ignored, the table bounded."""
        try:
            deadline_s = float(deadline_s)
        except (TypeError, ValueError):
            return
        if deadline_s <= 0:
            return
        self._pending_deadlines.pop(job_id, None)
        while len(self._pending_deadlines) >= PENDING_DEADLINES_KEPT:
            self._pending_deadlines.pop(next(iter(self._pending_deadlines)))
        self._pending_deadlines[job_id] = deadline_s

    def note_job_priority(self, job_id: str, lane: Any, tenant: Any) -> None:
        """Record the admission lane and tenant of a job not created yet,
        as note_job_deadline does; init stamps them onto the job."""
        lane = str(lane) if lane else ""
        tenant = str(tenant) if tenant else "default"
        self._pending_priorities.pop(job_id, None)
        while len(self._pending_priorities) >= PENDING_DEADLINES_KEPT:
            self._pending_priorities.pop(next(iter(self._pending_priorities)))
        self._pending_priorities[job_id] = (lane, tenant)

    def note_job_adapters(self, job_id: str, adapters: Any) -> None:
        """Record a resolved adapter plan (wire form) for a job not created
        yet, as note_job_deadline does. A malformed plan is dropped here
        (the route validated it; this guards direct callers), so a bad
        record never reaches a worker."""
        from ..adapters.registry import AdapterError, specs_from_wire, specs_to_wire

        try:
            specs = specs_from_wire(adapters)
        except AdapterError as exc:
            debug_log(f"note_job_adapters({job_id}) rejected: {exc}")
            return
        self._pending_adapters.pop(job_id, None)
        if not specs:
            return
        while len(self._pending_adapters) >= PENDING_DEADLINES_KEPT:
            self._pending_adapters.pop(next(iter(self._pending_adapters)))
        self._pending_adapters[job_id] = specs_to_wire(specs)

    def take_job_adapters(self, job_id: str) -> list:
        """Pop a job's noted adapter plan: the master's local path (no
        worker took part, so no tile job is made) wears it itself."""
        return list(self._pending_adapters.pop(job_id, []))

    async def peek_job_adapters(self, job_id: str) -> list:
        """A job's adapter plan without taking it: the job's own once it
        exists, else the pending note. The master reads it before
        init_tile_job (it needs the operands and the cache key first);
        init still pops the note atomically with creation."""
        async with self.lock:
            job = self.tile_jobs.get(job_id)
            if job is not None:
                return list(job.adapters)
            return list(self._pending_adapters.get(job_id, []))

    async def init_tile_job(self, job_id: str, task_ids: list[int], batched: bool = True,
                            deadline_s: Optional[float] = None, kind: str = "tile",
                            cache_settled: Optional[list[int]] = None,
                            adapters: Optional[list] = None, lane: Optional[str] = None,
                            tenant: Optional[str] = None) -> TileJob:
        """Create the job: a TileJob of tile indices, or with kind "image"
        an ImageJob of frame indices (dynamic mode). `cache_settled`
        settles those tiles from the tile cache under the same lock hold,
        so no puller ever sees them pending; `adapters`, `lane` and
        `tenant` (else the noted ones) ride the job. A job that exists is
        returned as it is (a settle for it goes through settle_cached).
        The preemption coordinator hears of the new job after it is
        created."""
        from ..utils.constants import JOB_DEADLINE_DEFAULT_SECONDS

        async with self.lock:
            if job_id in self.tile_jobs:
                return self.tile_jobs[job_id]
            if deadline_s is None:
                deadline_s = self._pending_deadlines.pop(job_id, None)
            if deadline_s is None and JOB_DEADLINE_DEFAULT_SECONDS > 0:
                deadline_s = JOB_DEADLINE_DEFAULT_SECONDS
            noted_adapters = self._pending_adapters.pop(job_id, [])
            noted_lane, noted_tenant = self._pending_priorities.pop(job_id, ("", "default"))
            cls = TileJob if kind == "tile" else ImageJob
            job = cls(job_id=job_id, total_tasks=len(task_ids), batched=batched)
            job.adapters = list(noted_adapters if adapters is None else adapters)
            job.lane = str(lane) if lane is not None else noted_lane
            job.tenant = (str(tenant) if tenant is not None else noted_tenant) or "default"
            if deadline_s is not None and deadline_s > 0:
                job.deadline_s = float(deadline_s)
                job.deadline_at = time.monotonic() + float(deadline_s)
            self._journal({"type": "job_init", "job": job_id, "kind": kind, "batched": batched,
                           "tasks": [int(t) for t in task_ids], "deadline_s": job.deadline_s,
                           "lane": job.lane, "tenant": job.tenant, "adapters": job.adapters})
            for tid in task_ids:
                job.pending.put_nowait(tid)
            self.tile_jobs[job_id] = job
            settled_at_init: list[int] = []
            if cache_settled:
                settled_at_init = self._settle_cached_locked(job, cache_settled)
            self._wake(self._tile_waiters.pop(job_id, []))
        # outside the lock: lifecycle signals and attribution, not state
        from ..telemetry.events import get_event_bus

        get_event_bus().publish("job_ready", job_id=job_id, tasks=len(task_ids))
        if settled_at_init:
            instruments.cache_settled_total().inc(len(settled_at_init))
            self._note_settle_sink(job.tenant, len(settled_at_init))
        adapter_plan = "+".join(f"{a.get('content_hash', '')}:{float(a.get('strength', 1.0)):g}"
                                for a in job.adapters)

        def note(meter) -> None:
            meter.note_job_attrs(job_id, job.tenant, job.lane)
            if adapter_plan:
                meter.note_job_adapter(job_id, adapter_plan)

        _note_usage(note)
        self._notify_grants(job_id, len(task_ids) - len(settled_at_init))
        # a premium-lane arrival may flag running lower-lane work; after
        # the creation committed (the coordinator takes the lock itself),
        # and advisory: a broken policy never fails a creation
        policy = self.preempt_policy
        if policy is not None:
            try:
                await policy.on_job_init(job_id)
            except Exception as exc:  # noqa: BLE001 - preemption is advisory
                debug_log(f"preempt on_job_init({job_id}) failed: {exc}")
        return job

    async def settle_cached(self, job_id: str, task_ids: list[int]) -> list[int]:
        """Settle tiles whose results came from the tile cache: they
        complete without entering the pull set (payload None; the master
        blends the cached pixels itself). Returns the ids that settled: a
        tile already completed or quarantined is left out, and the caller
        must not blend its cached copy on top."""
        job = await self.get_tile_job(job_id)
        if job is None:
            raise JobQueueError(f"no such job {job_id!r}")
        async with self.lock:
            settled = self._settle_cached_locked(job, task_ids)
        if settled:
            instruments.cache_settled_total().inc(len(settled))
            self._note_settle_sink(job.tenant, len(settled))
        return settled

    def _note_settle_sink(self, tenant: str, count: int) -> None:
        if self.settle_sink is None:
            return
        try:
            self.settle_sink(tenant, count)
        except Exception as exc:  # noqa: BLE001 - accounting is advisory
            debug_log(f"jobs: settle sink failed: {exc}")

    def _settle_cached_locked(self, job: TileJob, task_ids: list[int]) -> list[int]:
        """The settle, under self.lock (settle_cached, and init_tile_job's
        settle at creation)."""
        if job.cancelled:
            return []
        settled = [int(t) for t in task_ids
                   if int(t) not in job.completed and int(t) not in job.quarantined_tiles]
        if not settled:
            return []
        self._journal({"type": "cache_settle", "job": job.job_id, "tasks": settled})
        for tid in settled:
            job.completed[tid] = None
            job.cached_tiles.add(tid)
        # asyncio.Queue has no removal: drain, then put the rest back (no
        # puller interleaves under the lock)
        gone = set(settled)
        survivors = []
        while True:
            try:
                tid = job.pending.get_nowait()
            except asyncio.QueueEmpty:
                break
            if tid not in gone:
                survivors.append(tid)
        for tid in survivors:
            job.pending.put_nowait(tid)
        return settled

    async def cached_tiles(self, job_id: str) -> list[int]:
        """The job's tiles settled from the tile cache, sorted."""
        job = await self.get_tile_job(job_id)
        if job is None:
            return []
        async with self.lock:
            return sorted(job.cached_tiles)

    async def get_tile_job(self, job_id: str) -> Optional[TileJob]:
        async with self.lock:
            return self.tile_jobs.get(job_id)

    def _may_pull(self, job: TileJob, worker_id: str) -> bool:
        """The placement policy's tail trimming; advisory: a policy error
        lets the pull through."""
        placement = self.placement
        if placement is None:
            return True
        try:
            return bool(placement.may_pull(worker_id, job.pending.qsize()))
        except Exception as exc:  # noqa: BLE001 - placement is advisory
            debug_log(f"placement may_pull({worker_id}) failed: {exc}")
            return True

    async def _answer_drained(self, job: TileJob, worker_id: str, outcome: str) -> None:
        """A pull that reads as drained: heartbeat, count its outcome."""
        async with self.lock:
            self._record_heartbeat(job, worker_id)
        instruments.store_pulls_total().inc(worker_id=worker_id, outcome=outcome)

    async def pull_task(self, job_id: str, worker_id: str, timeout: float = 0.1) -> Optional[int]:
        """Pop the next pending task id for a worker (None = drained).
        Records the assignment and a heartbeat; an empty pull heartbeats
        too. A cancelled job, a preempted one, and a pull the placement
        policy trims all read as drained. The fault site store:pull:<id>
        is consulted once a pull RPC (`pull_tasks` comes through here)."""
        await self._fault("pull", worker_id)
        job = await self.get_tile_job(job_id)
        if job is None:
            raise JobQueueError(f"no such job {job_id!r}")
        if job.deadline_expired() and not job.cancelled:
            # the overdue job expires the moment anyone asks it for work
            await self.cancel_job(job_id, reason="deadline")
        if job.cancelled:
            await self._answer_drained(job, worker_id, "cancelled")
            return None
        if job.preempt_requested:
            # a preempted job answers as a drained one until the flags
            # lift; its workers learn why from the `preempt` field
            await self._answer_drained(job, worker_id, "preempted")
            return None
        if not self._may_pull(job, worker_id):
            await self._answer_drained(job, worker_id, "trimmed")
            return None
        try:
            task_id = await asyncio.wait_for(job.pending.get(), timeout)
            # skip stale copies of tiles quarantined since they were queued
            while task_id in job.quarantined_tiles:
                task_id = job.pending.get_nowait()
        except (asyncio.TimeoutError, asyncio.QueueEmpty):
            await self._answer_drained(job, worker_id, "empty")
            return None
        async with self.lock:
            self._record_heartbeat(job, worker_id)
            if job.cancelled:
                # raced the cancel: the task is part of the refund (and
                # journals nothing after the cancel record)
                instruments.store_pulls_total().inc(worker_id=worker_id, outcome="cancelled")
                return None
            self._journal({"type": "pull", "job": job_id, "worker": worker_id,
                           "tasks": [int(task_id)]})
            job.assigned.setdefault(worker_id, set()).add(task_id)
            job.assigned_at[(worker_id, task_id)] = time.monotonic()
        instruments.store_pulls_total().inc(worker_id=worker_id, outcome="task")
        return task_id

    async def pull_tasks(self, job_id: str, worker_id: str, timeout: float = 0.1,
                         limit: Optional[int] = None) -> list[int]:
        """A grant: the first task waits up to `timeout` (exactly
        `pull_task`), more pending tasks are claimed without waiting, up to
        the placement policy's batch size for this worker (and `limit`).
        Without a policy a grant is one task."""
        first = await self.pull_task(job_id, worker_id, timeout)
        if first is None:
            return []
        tasks = [first]
        job = await self.get_tile_job(job_id)
        size = 1
        if self.placement is not None and job is not None:
            try:
                size = int(self.placement.batch_size(worker_id, job.pending.qsize() + 1))
            except Exception as exc:  # noqa: BLE001 - placement is advisory
                debug_log(f"placement batch_size({worker_id}) failed: {exc}")
        if limit is not None:
            size = min(size, int(limit))
        if job is not None and size > 1:
            async with self.lock:
                extra: list[int] = []
                while len(tasks) < size and not job.cancelled:
                    try:
                        task_id = job.pending.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if task_id in job.quarantined_tiles:
                        continue  # a stale speculated copy of poison
                    job.assigned.setdefault(worker_id, set()).add(task_id)
                    job.assigned_at[(worker_id, task_id)] = time.monotonic()
                    instruments.store_pulls_total().inc(worker_id=worker_id, outcome="task")
                    tasks.append(task_id)
                    extra.append(int(task_id))
                if extra:
                    # one record for the rest of the grant, under the lock
                    # its claims were made in
                    self._journal({"type": "pull", "job": job_id, "worker": worker_id,
                                   "tasks": extra})
        return tasks

    # --- preemption (scheduler/preempt.py drives these) ---------------------

    def _lane_rank(self, lane: str) -> int:
        """A lane's priority rank (lower = more urgent), from the
        preemption coordinator; unknown lanes rank last."""
        policy = self.preempt_policy
        if policy is not None:
            try:
                return int(policy.lane_rank(lane))
            except Exception:  # noqa: BLE001 - advisory ranking
                pass
        return 1 << 20

    async def request_preemption(self, job_ids: list[str], reason: str = "manual") -> list[str]:
        """Flag jobs for preemption: their pulls read as drained and every
        pull or heartbeat answer carries `preempt: true`. Returns the jobs
        newly flagged."""
        flagged: list[str] = []
        async with self.lock:
            for job_id in sorted(str(j) for j in job_ids):
                job = self.tile_jobs.get(job_id)
                if job is None or job.cancelled or job.preempt_requested:
                    continue
                job.preempt_requested = True
                job.preempt_reason = str(reason)
                flagged.append(job_id)
        if flagged:
            instruments.preempt_total().inc(len(flagged), reason=str(reason))
            from ..telemetry.events import get_event_bus

            get_event_bus().publish("preempt_requested", job_ids=flagged, reason=str(reason))
            log(f"preemption requested ({reason}) for job(s) {', '.join(flagged)}")
        return flagged

    async def clear_preemption(self, job_ids: list[str]) -> list[str]:
        """Lift preemption flags: the jobs are pullable again."""
        cleared: list[str] = []
        refill: list[tuple[str, int]] = []
        async with self.lock:
            for job_id in sorted(str(j) for j in job_ids):
                job = self.tile_jobs.get(job_id)
                if job is None or not job.preempt_requested:
                    continue
                job.preempt_requested = False
                job.preempt_reason = ""
                cleared.append(job_id)
                if job.pending.qsize():
                    refill.append((job_id, job.pending.qsize()))
        for job_id, pending in refill:
            # the job is pullable again: parked workers learn it now
            self._notify_grants(job_id, pending)
        if cleared:
            from ..telemetry.events import get_event_bus

            get_event_bus().publish("preempt_cleared", job_ids=cleared)
        return cleared

    async def preempt_victims(self, premium_rank: int, include_flagged: bool = False
                              ) -> list[str]:
        """Jobs that should yield to an arrival of rank `premium_rank`:
        active, ranked strictly lower, with outstanding work, oldest
        first. `include_flagged` lists jobs already flagged too (the
        coordinator records them as a second premium's claims)."""
        async with self.lock:
            return [
                job.job_id
                for job in sorted(self.tile_jobs.values(), key=lambda j: (j.created_at, j.job_id))
                if not job.cancelled
                and (include_flagged or not job.preempt_requested)
                and self._lane_rank(job.lane) > premium_rank
                and (job.pending.qsize() > 0
                     or any(t not in job.completed for tasks in job.assigned.values()
                            for t in tasks))
            ]

    async def submit_result(self, job_id: str, worker_id: str, task_id: int, payload: Any,
                            service_seconds: Optional[float] = None) -> bool:
        """Record one completed task; False if it is a duplicate (already
        done: first result wins) or the job was cancelled. Its service
        time (`service_seconds`, else measured from the later of its
        assignment and the worker's previous submit) is observed in
        cdt_worker_tile_seconds and handed to the latency sink, a
        duplicate's too: the losing worker did the work. The fault site
        store:submit:<id> is consulted once a tile, a flushed one's too."""
        await self._fault("submit", worker_id)
        job = await self.get_tile_job(job_id)
        if job is None:
            raise JobQueueError(f"no such job {job_id!r}")
        now = time.monotonic()
        async with self.lock:
            self._record_heartbeat(job, worker_id)
            if job.cancelled:
                instruments.store_submits_total().inc(worker_id=worker_id, outcome="cancelled")
                return False
            job.assigned.get(worker_id, set()).discard(task_id)
            started = job.assigned_at.pop((worker_id, task_id), None)
            prev_done = self._note_worker_submit_locked(worker_id, job, now)
            duplicate = task_id in job.completed
            if duplicate:
                job.duplicates += 1
            else:
                # the winner alone is journaled, at the instant it wins
                self._journal({"type": "submit", "job": job_id, "worker": worker_id,
                               "task": int(task_id), "payload": payload})
                job.completed[task_id] = payload
                job.completions.append((int(task_id), worker_id))
                # a late copy finishing after its tile was quarantined
                # settles it for real
                job.quarantined_tiles.discard(task_id)
        elapsed: Optional[float] = None
        if service_seconds is not None:
            elapsed = service_seconds
        elif started is not None:
            elapsed = now - (started if prev_done is None else max(started, prev_done))
        if elapsed is not None:
            instruments.worker_tile_seconds().observe(elapsed, worker_id=worker_id)
            sink = self.latency_sink
            if sink is not None:
                try:
                    sink(worker_id, elapsed)
                except Exception as exc:  # noqa: BLE001 - observability only
                    debug_log(f"latency sink failed for {worker_id}: {exc}")
        if duplicate:
            debug_log(f"duplicate result for {job_id}:{task_id} from {worker_id}")
            if elapsed is not None and elapsed > 0 and task_id in job.speculated:
                # the losing side of a speculative race: measured work
                # on a tile already won
                _note_usage(lambda meter: meter.note_waste("master", "speculation", elapsed,
                                                           job_id=job_id))
            instruments.store_submits_total().inc(worker_id=worker_id, outcome="duplicate")
            return False
        instruments.store_submits_total().inc(worker_id=worker_id, outcome="accepted")
        await job.results.put((task_id, payload))
        return True

    async def submit_flush(self, job_id: str, worker_id: str, grouped: dict[int, Any],
                           received_bytes: int = 0) -> int:
        """Record several tiles that travelled in one submit request;
        returns how many were accepted. `received_bytes` counts the
        request's tile payloads. Each tile's service time is the flush
        interval (since the worker's previous submit to any job, or its
        earliest assignment in the flush) divided evenly: the arrival gaps
        within one request would read as near-zero latencies."""
        job = await self.get_tile_job(job_id)
        if job is None:
            raise JobQueueError(f"no such job {job_id!r}")
        now = time.monotonic()
        async with self.lock:
            job.received_bytes += int(received_bytes)
            marks = [m for m in (job.last_submit.get(worker_id),
                                 self._worker_last_submit.get(worker_id)) if m is not None]
            starteds = [s for s in (job.assigned_at.get((worker_id, int(t))) for t in grouped)
                        if s is not None]
        share: Optional[float] = None
        if starteds:
            base = min(starteds)
            if marks:
                base = max(base, max(marks))
            share = max(now - base, 1e-6) / len(grouped)
        accepted = 0
        for task_id, payload in grouped.items():
            if await self.submit_result(job_id, worker_id, int(task_id), payload,
                                        service_seconds=share):
                accepted += 1
        return accepted

    async def mark_worker_done(self, job_id: str, worker_id: str) -> None:
        job = await self.get_tile_job(job_id)
        if job is None:
            return
        async with self.lock:
            if worker_id not in job.finished_workers and not job.cancelled:
                self._journal({"type": "worker_done", "job": job_id, "worker": worker_id})
            job.finished_workers.add(worker_id)

    async def heartbeat(self, job_id: str, worker_id: str) -> bool:
        job = await self.get_tile_job(job_id)
        if job is None:
            return False
        async with self.lock:
            self._record_heartbeat(job, worker_id)
        return True

    async def remaining(self, job_id: str) -> int:
        job = await self.get_tile_job(job_id)
        return 0 if job is None else job.pending.qsize()

    async def is_complete(self, job_id: str) -> bool:
        job = await self.get_tile_job(job_id)
        if job is None:
            return False
        async with self.lock:
            # quarantined tiles are settled (degraded), not outstanding
            return len(job.completed) + len(job.quarantined_tiles) >= job.total_tasks

    async def job_lifecycle(self, job_id: str) -> Optional[dict[str, Any]]:
        """Consistent lifecycle snapshot: terminal flags, quarantined
        tiles, the remaining deadline, attempts per tile."""
        job = await self.get_tile_job(job_id)
        if job is None:
            return None
        async with self.lock:
            return {
                "cancelled": job.cancelled,
                "cancel_reason": job.cancel_reason,
                "quarantined": sorted(job.quarantined_tiles),
                "deadline_s": job.deadline_s,
                "deadline_remaining": job.deadline_remaining(),
                "attempts": {int(t): int(n) for t, n in sorted(job.attempts.items())},
            }

    async def cleanup_tile_job(self, job_id: str) -> None:
        async with self.lock:
            job = self.tile_jobs.pop(job_id, None)
            if job is None:
                return
            self._journal({"type": "cleanup", "job": job_id})
            self._remember_finished_locked(job_id, {
                "total": job.total_tasks,
                "cached": sorted(job.cached_tiles),
                "adapters": list(job.adapters),
                "completions": list(job.completions),
                "duplicates": job.duplicates,
                "received_bytes": job.received_bytes,
                "finished_workers": sorted(job.finished_workers),
            })
        from ..telemetry.events import get_event_bus

        # workers parked on the grant signal stop waiting at once
        get_event_bus().publish("job_complete", job_id=job_id)
        await self._preempt_settled(job_id)

    async def _preempt_settled(self, job_id: str) -> None:
        """A settled (finished or cancelled) premium job lifts the
        preemption flags it raised; advisory."""
        policy = self.preempt_policy
        if policy is not None:
            try:
                await policy.on_job_settled(job_id)
            except Exception as exc:  # noqa: BLE001 - preemption is advisory
                debug_log(f"preempt on_job_settled({job_id}) failed: {exc}")

    def drop_late(self, job_id: str, n_tiles: int, finished_worker: Optional[str] = None
                  ) -> bool:
        """Count a submission for a job already cleaned up as `n_tiles`
        dropped duplicates, and a late final flush's worker among the
        record's finished workers (a worker that parked on its grant
        signal shipped its tiles first and flushes last); False if the
        job is not among the finished."""
        record = self.finished.get(job_id)
        if record is None:
            return False
        record["duplicates"] += int(n_tiles)
        if finished_worker is not None:
            record["finished_workers"] = sorted(set(record["finished_workers"])
                                                | {finished_worker})
        return True

    # --- lifecycle: cancel + deadline sweep ---------------------------------

    async def cancel_job(self, job_id: str, reason: str = "client") -> Optional[dict[str, Any]]:
        """Terminal cancellation: drain the pending queue and revoke every
        in-flight assignment under one lock hold. Returns the refund
        accounting (None = no such job; idempotent on repeat)."""
        job = await self.get_tile_job(job_id)
        if job is None:
            return None
        async with self.lock:
            if job.cancelled:
                return {"job_id": job_id, "reason": job.cancel_reason, "already_cancelled": True,
                        "pending_refunded": 0, "in_flight_refunded": 0, "workers": []}
            # before any refund is acknowledged: replaying the record
            # refunds everything itself
            self._journal({"type": "cancel", "job": job_id, "reason": str(reason)})
            job.cancelled = True
            job.cancel_reason = str(reason)
            pending_refunded = 0
            while True:
                try:
                    job.pending.get_nowait()
                except asyncio.QueueEmpty:
                    break
                pending_refunded += 1
            in_flight: dict[str, list[int]] = {}
            for wid, tasks in sorted(job.assigned.items()):
                incomplete = sorted(t for t in tasks if t not in job.completed)
                if incomplete:
                    in_flight[wid] = incomplete
            job.assigned.clear()
            job.assigned_at.clear()
            # a preemption flag does not outlive the terminal state
            job.preempt_requested = False
            in_flight_refunded = sum(len(v) for v in in_flight.values())
        instruments.jobs_cancelled_total().inc(reason=str(reason))
        if pending_refunded or in_flight_refunded:
            instruments.cancel_refunded_tiles_total().inc(pending_refunded, kind="pending")
            instruments.cancel_refunded_tiles_total().inc(in_flight_refunded, kind="in_flight")
        from ..telemetry.events import get_event_bus

        get_event_bus().publish("job_cancelled", job_id=job_id, reason=str(reason),
                                pending_refunded=pending_refunded,
                                in_flight_refunded=in_flight_refunded,
                                workers=sorted(in_flight))
        log(f"job {job_id} cancelled ({reason}): refunded {pending_refunded} pending + "
            f"{in_flight_refunded} in-flight tile(s) across {len(in_flight)} worker(s)")
        await self._preempt_settled(job_id)
        return {"job_id": job_id, "reason": str(reason), "already_cancelled": False,
                "pending_refunded": pending_refunded, "in_flight_refunded": in_flight_refunded,
                "workers": sorted(in_flight)}

    async def sweep_deadlines(self) -> list[str]:
        """Expire every job whose deadline has passed; returns the ids
        this sweep expired."""
        now = time.monotonic()
        async with self.lock:
            overdue = [jid for jid, job in self.tile_jobs.items()
                       if not job.cancelled and job.deadline_expired(now)]
        expired = []
        for job_id in overdue:
            result = await self.cancel_job(job_id, reason="deadline")
            if result is not None and not result["already_cancelled"]:
                expired.append(job_id)
        return expired

    # --- timeout / requeue --------------------------------------------------

    async def requeue_timed_out(self, job_id: str, timeout_seconds: float,
                                probe_busy: Optional[Callable[[str], Awaitable[bool]]] = None
                                ) -> list[int]:
        """Requeue tasks of workers whose heartbeat is older than
        `timeout_seconds`. A stale worker that `probe_busy` finds busy
        gets a fresh heartbeat instead (busy-probe grace); a probe that
        raises is retried once."""
        job = await self.get_tile_job(job_id)
        if job is None:
            return []
        now = time.monotonic()
        async with self.lock:
            stale = [wid for wid, beat in job.worker_status.items()
                     if now - beat > timeout_seconds and wid not in job.finished_workers
                     and job.assigned.get(wid)]
        requeued: list[int] = []
        for wid in stale:
            busy = False
            if probe_busy is not None:
                for attempt in range(2):
                    try:
                        busy = await probe_busy(wid)
                        break
                    except Exception as exc:  # noqa: BLE001 - a probe is best effort
                        log(f"busy-probe for stale worker {wid} failed "
                            f"(attempt {attempt + 1}/2): {exc}")
            async with self.lock:
                if busy:
                    job.heartbeat(wid)
                    debug_log(f"worker {wid} busy on probe; heartbeat grace")
                    continue
                requeued.extend(self._requeue_worker_locked(job, wid))
            self._flush_poison_notices()
        return requeued

    def _requeue_worker_locked(self, job: TileJob, worker_id: str,
                               reason: str = "timeout") -> list[int]:
        """Put a worker's incomplete tasks back on the queue, each charged
        one failed delivery attempt (`reason`: the worker went silent,
        "timeout", or the breaker quarantined it, "quarantine"; a release
        or a speculative copy requeues elsewhere, uncharged); a task at
        the attempt budget is quarantined instead, and the workers its
        attempts charged are noted for a pardon (`_flush_poison_notices`,
        after the lock). Returns the incomplete tasks. Caller holds
        self.lock."""
        if job.cancelled:
            return []
        tasks = job.assigned.pop(worker_id, set())
        attempt_waste = 0.0
        now = time.monotonic()
        for tid in tasks:
            assigned_at = job.assigned_at.pop((worker_id, tid), None)
            if assigned_at is not None and tid not in job.completed:
                # a failed delivery attempt: the assignment window is
                # measured fleet time that produced nothing
                attempt_waste += max(0.0, now - assigned_at)
        if attempt_waste > 0:
            job_id = job.job_id
            _note_usage(lambda meter: meter.note_waste("master", "poison_retry", attempt_waste,
                                                       job_id=job_id))
        incomplete = sorted(t for t in tasks if t not in job.completed)
        if not incomplete:
            return incomplete
        self._journal({"type": "requeue", "job": job.job_id, "worker": worker_id,
                       "tasks": incomplete, "reason": reason})
        poisoned = []
        for tid in incomplete:
            job.attempts[tid] = job.attempts.get(tid, 0) + 1
            job.attempt_workers.setdefault(tid, []).append(worker_id)
            if job.attempts[tid] >= max(1, self.max_attempts):
                poisoned.append(tid)
        if poisoned:
            # after the requeue record, as the live store orders them
            self._journal({"type": "tile_quarantine", "job": job.job_id,
                           "tasks": [int(t) for t in poisoned]})
            job.quarantined_tiles.update(poisoned)
            victims = sorted({w for t in poisoned for w in job.attempt_workers.get(t, [])})
            self._poison_notices.append((job.job_id, poisoned, victims))
            instruments.poison_quarantined_tiles_total().inc(len(poisoned))
            log(f"POISON: tile(s) {poisoned} on job {job.job_id} exhausted {self.max_attempts} "
                f"attempt(s); quarantined out of the pull set (policy={self.poison_policy})")
        requeued = [t for t in incomplete if t not in poisoned]
        for tid in requeued:
            job.pending.put_nowait(tid)
        instruments.store_requeued_tasks_total().inc(len(incomplete), worker_id=worker_id,
                                                     reason=reason)
        if requeued:
            # non-blocking (the lock is held): the requeued tiles are the
            # grants parked workers should race the master's fallback for
            self._notify_grants(job.job_id, len(requeued))
            log(f"requeued {len(requeued)} task(s) from worker {worker_id} on job {job.job_id}")
        return incomplete

    def _flush_poison_notices(self) -> None:
        """A quarantine's side effects, outside the store lock: the
        `tile_quarantined` event and the pardon hook (a breaker transition
        fires listeners that may call back into this store)."""
        notices, self._poison_notices = self._poison_notices, []
        from ..telemetry.events import get_event_bus

        for job_id, tiles, victims in notices:
            get_event_bus().publish("tile_quarantined", job_id=job_id,
                                    task_ids=[int(t) for t in tiles], pardoned_workers=victims)
            pardon = self.poison_pardon
            if pardon is not None and victims:
                try:
                    pardon(victims)
                    instruments.poison_pardons_total().inc(len(victims))
                except Exception as exc:  # noqa: BLE001 - pardon is advisory
                    debug_log(f"poison pardon for {victims} failed: {exc}")

    async def requeue_worker_tasks(self, worker_id: str, job_id: Optional[str] = None
                                   ) -> dict[str, list[int]]:
        """Requeue a worker's incomplete tasks at once, with no staleness
        check: the breaker's quarantine path. Every active job, or only
        `job_id`. Returns {job_id: [task ids]} of the jobs it touched."""
        out: dict[str, list[int]] = {}
        async with self.lock:
            if job_id is not None:
                jobs = [j] if (j := self.tile_jobs.get(job_id)) else []
            else:
                jobs = list(self.tile_jobs.values())
            for job in jobs:
                incomplete = self._requeue_worker_locked(job, worker_id, reason="quarantine")
                if incomplete:
                    out[job.job_id] = incomplete
        self._flush_poison_notices()
        return out

    async def release_tasks(self, job_id: str, worker_id: str, task_ids: list[int]) -> list[int]:
        """Hand back claimed-but-unprocessed tasks (an interrupted worker's
        grant) so they requeue now; only tasks assigned to this worker and
        not completed go back."""
        job = await self.get_tile_job(job_id)
        if job is None or job.cancelled:
            return []
        released: list[int] = []
        async with self.lock:
            if job.cancelled:
                return []
            assigned = job.assigned.get(worker_id, set())
            claimable = [tid for tid in sorted(int(t) for t in task_ids)
                         if tid in assigned and tid not in job.completed]
            if claimable:
                self._journal({"type": "requeue", "job": job_id, "worker": worker_id,
                               "tasks": claimable, "reason": "released"})
            for tid in claimable:
                assigned.discard(tid)
                job.assigned_at.pop((worker_id, tid), None)
                job.pending.put_nowait(tid)
                released.append(tid)
        if released:
            instruments.store_requeued_tasks_total().inc(len(released), worker_id=worker_id,
                                                         reason="released")
            self._notify_grants(job_id, len(released))
            log(f"worker {worker_id} returned {len(released)} task(s) on job {job_id}: {released}")
        return released

    async def speculate_in_flight(self, job_id: str) -> list[int]:
        """The stall watchdog's recovery (MapReduce's backup tasks):
        enqueue COPIES of every in-flight incomplete task without revoking
        the original assignment. The first submission wins and the other
        drops as a duplicate; a tile's noise comes from its global index,
        so both give the same pixels. Each task is speculated once."""
        job = await self.get_tile_job(job_id)
        if job is None:
            return []
        per_worker: dict[str, list[int]] = {}
        async with self.lock:
            if job.cancelled:
                return []
            for wid, tasks in sorted(job.assigned.items()):
                for tid in sorted(tasks):
                    if tid in job.completed or tid in job.speculated:
                        continue
                    per_worker.setdefault(wid, []).append(tid)
            flat = sorted(t for tids in per_worker.values() for t in tids)
            if flat:
                self._journal({"type": "speculate", "job": job_id, "tasks": flat})
            for tids in per_worker.values():
                for tid in tids:
                    job.speculated.add(tid)
                    job.pending.put_nowait(tid)
        speculated = sorted(t for tids in per_worker.values() for t in tids)
        if speculated:
            for wid, tids in per_worker.items():
                instruments.store_requeued_tasks_total().inc(len(tids), worker_id=wid,
                                                             reason="speculative")
            from ..telemetry.events import get_event_bus

            get_event_bus().publish("speculative_requeue", job_id=job_id, task_ids=speculated)
            self._notify_grants(job_id, len(speculated))
            log(f"speculatively re-enqueued {len(speculated)} in-flight task(s) on job "
                f"{job_id}: {speculated}")
        return speculated

    # --- observability --------------------------------------------------------

    @staticmethod
    def tile_job_stats(job: TileJob) -> dict[str, int]:
        """Live pending and in-flight counts of one job: the one
        definition the scrape and the watchdog share."""
        in_flight = sum(len([t for t in list(tasks) if t not in job.completed])
                        for tasks in list(job.assigned.values()))
        return {"pending": job.pending.qsize(), "in_flight": in_flight}

    def stats_unlocked(self) -> dict[str, int]:
        """Best-effort live counts WITHOUT the asyncio lock, for the sync
        scrape-time collectors (iteration over snapshots; the numbers may
        be one mutation stale)."""
        tile_jobs = list(self.tile_jobs.values())
        per_job = [self.tile_job_stats(job) for job in tile_jobs]
        return {
            "tile_jobs": len(tile_jobs),
            "collectors": len(self.collectors),
            "queue_depth": sum(j["pending"] for j in per_job),
            "in_flight": sum(j["in_flight"] for j in per_job),
        }

    async def stats(self) -> dict[str, int]:
        """The same counts, taken under the lock."""
        async with self.lock:
            return self.stats_unlocked()
