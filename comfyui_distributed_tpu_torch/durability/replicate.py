"""Journal replication: the active master's WAL as a live stream, and
the standby replica that tails it (the port's own copy of
comfyui_distributed_tpu/durability/replicate.py).

The durable control plane made a dead master *recoverable* (snapshot +
WAL replay); this module makes it *replaceable without restart*: a
warm standby holds an up-to-date copy of the journaled state at all
times, so takeover is a promotion (prepare_for_restart + materialize —
the SAME transform disk recovery applies, minus the disk), not a boot.

Two halves, both transport-neutral (the JAX package's
api/replication_routes.py and api/standby.py put them on a WebSocket,
which the port brings with ROADMAP Queue 1 step 7g; the chaos harness
and DurabilityManager.adopt wire them directly):

- **source side** — ``ReplicationSubscription``: a bounded record
  buffer the ``DurabilityManager`` tees every journaled record into,
  created *under the manager lock* together with a serialization of
  the current shadow state, so the (snapshot, tail) pair a subscriber
  receives is exactly consistent (no record is ever missed or applied
  twice — frames at or below the snapshot's lsn are deduplicated by
  the replica). Overflow marks the subscription **lost** instead of
  dropping interior records: a hole would silently desync the replica,
  so the standby re-syncs from a fresh snapshot frame instead;
- **standby side** — ``StandbyReplica``: applies frames through the
  same pure ``state.apply_record`` machine the snapshot shadow and
  disk replay use (three consumers, one state machine — consistency by
  construction), tracks replication lag in records (source head lsn −
  applied lsn) and seconds (staleness of the newest applied frame),
  and performs the promotion transform into a live JobStore.

Determinism: replication and promotion are a pure function of the
frame sequence. The only clock here is injected and used for *lag
observability*, never for state.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Optional

from ..utils.constants import STANDBY_BUFFER_RECORDS
from ..utils.logging import log
from . import state as state_mod
from .recovery import RecoveryReport


class ReplicationSubscription:
    """One standby connection's view of the active master's journal.

    Created by ``DurabilityManager.subscribe_replica`` under the
    manager lock: ``snapshot_state`` is the shadow state at attach time
    and every record journaled after that instant is offered, in lsn
    order. Thread-safe: the source offers from the journal seam, the
    consumer drains from its own thread/loop."""

    def __init__(
        self,
        snapshot_state: dict[str, Any],
        head_lsn: int,
        epoch: int = 0,
        maxlen: Optional[int] = None,
    ) -> None:
        self.snapshot_state = snapshot_state
        self.head_lsn = int(head_lsn)
        self.epoch = int(epoch)
        self._maxlen = maxlen if maxlen is not None else STANDBY_BUFFER_RECORDS
        self._records: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._event = threading.Event()
        self.lost = False
        self.closed = False

    def offer(self, record: dict[str, Any]) -> None:
        """Source side: enqueue one journaled record (already carrying
        its lsn). On overflow the subscription is marked LOST and the
        buffer cleared — suffix integrity over completeness, exactly
        the journal's own write-behind rule."""
        with self._lock:
            if self.closed or self.lost:
                return
            if len(self._records) >= self._maxlen:
                self.lost = True
                self._records.clear()
            else:
                self._records.append(record)
        self._event.set()

    def pop(self, max_items: int = 256) -> list[dict[str, Any]]:
        """Consumer side: drain up to ``max_items`` buffered records in
        lsn order; clears the wakeup flag when the buffer empties."""
        out: list[dict[str, Any]] = []
        with self._lock:
            while self._records and len(out) < max_items:
                out.append(self._records.popleft())
            if not self._records:
                self._event.clear()
        return out

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until records are buffered (or lost/closed); False on
        timeout. Safe to call off-loop (the WS route wraps it in
        ``run_blocking``)."""
        return self._event.wait(timeout)

    def close(self) -> None:
        with self._lock:
            self.closed = True
            self._records.clear()
        self._event.set()


class StandbyReplica:
    """The standby's in-memory copy of the active master's journaled
    state, plus lag accounting and the promotion transform."""

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self.clock = clock
        self._lock = threading.Lock()
        self._state = state_mod.new_state()
        self._synced = False
        self.source_epoch = 0
        self._source_head_lsn = 0
        self._last_frame_at: Optional[float] = None
        self.applied_records = 0
        self.resyncs = 0

    # --- stream consumption ----------------------------------------------

    def reset(
        self, snapshot_state: dict[str, Any], head_lsn: int, epoch: int = 0
    ) -> None:
        """Adopt a full snapshot frame (initial sync, or re-sync after
        a lost stream). The state is cloned so the caller's buffer is
        never shared."""
        with self._lock:
            if self._synced:
                self.resyncs += 1
            self._state = state_mod.clone(snapshot_state)
            self._synced = True
            self.source_epoch = max(self.source_epoch, int(epoch))
            self._source_head_lsn = max(self._source_head_lsn, int(head_lsn))
            self._last_frame_at = self.clock()

    def apply(self, record: dict[str, Any]) -> bool:
        """Apply one replicated record; returns False when the frame is
        at or below the replica's lsn (the snapshot already covers it —
        the attach-time dedup rule)."""
        with self._lock:
            lsn = int(record.get("lsn", 0))
            if lsn and lsn <= int(self._state.get("last_lsn", 0)):
                return False
            state_mod.apply_record(self._state, record)
            self.applied_records += 1
            self._source_head_lsn = max(self._source_head_lsn, lsn)
            self._last_frame_at = self.clock()
            return True

    def note_head(self, head_lsn: int, epoch: int = 0) -> None:
        """Source heartbeat frame: advances the head the lag is
        measured against even when no records flow."""
        with self._lock:
            self._source_head_lsn = max(self._source_head_lsn, int(head_lsn))
            if epoch:
                self.source_epoch = max(self.source_epoch, int(epoch))

    # --- lag --------------------------------------------------------------

    @property
    def synced(self) -> bool:
        return self._synced

    def last_lsn(self) -> int:
        with self._lock:
            return int(self._state.get("last_lsn", 0))

    def lag_records(self) -> int:
        with self._lock:
            return max(
                0, self._source_head_lsn - int(self._state.get("last_lsn", 0))
            )

    def lag_seconds(self) -> Optional[float]:
        """Staleness of the newest applied frame (None before the first
        sync). Zero-lag streams still age between appends — consumers
        should read this together with ``lag_records``."""
        with self._lock:
            if self._last_frame_at is None:
                return None
            return max(0.0, self.clock() - self._last_frame_at)

    def status(self) -> dict[str, Any]:
        with self._lock:
            last_lsn = int(self._state.get("last_lsn", 0))
            lag_rec = max(0, self._source_head_lsn - last_lsn)
            lag_sec = (
                max(0.0, self.clock() - self._last_frame_at)
                if self._last_frame_at is not None
                else None
            )
            return {
                "synced": self._synced,
                "source_epoch": self.source_epoch,
                "source_head_lsn": self._source_head_lsn,
                "applied_lsn": last_lsn,
                "applied_records": self.applied_records,
                "lag_records": lag_rec,
                "lag_seconds": lag_sec,
                "resyncs": self.resyncs,
                "jobs_tracked": len(self._state.get("jobs", {})),
            }

    # --- promotion --------------------------------------------------------

    def promoted_state(self) -> tuple[dict[str, Any], RecoveryReport]:
        """The promotion transform, pure: clone the replicated state,
        run ``prepare_for_restart`` (in-flight grants revoked to
        pending for bit-identical recompute, durable worker payloads
        kept), and return (prepared state, report). The caller
        materializes it into a store and hands the state to its
        ``DurabilityManager.adopt``."""
        with self._lock:
            prepared = state_mod.clone(self._state)
        report = RecoveryReport()
        report.performed = True
        report.snapshot_lsn = 0
        report.replayed_records = self.applied_records
        report.last_lsn = int(prepared.get("last_lsn", 0))
        stats = state_mod.prepare_for_restart(prepared)
        report.tasks_requeued = stats["tasks_requeued"]
        report.tasks_restored = stats["tasks_restored"]
        report.jobs_cancelled = stats.get("jobs_cancelled", 0)
        return prepared, report

    def promote(self, store: Any, scheduler: Any = None) -> tuple[
        dict[str, Any], RecoveryReport
    ]:
        """Materialize the prepared state into a live JobStore (and
        restore scheduler aggregates) — disk recovery's sequence with
        the replica standing in for (snapshot + WAL tail). The caller
        (``DurabilityManager.adopt``) pauses admission when jobs were
        recovered, exactly like a restart."""
        prepared, report = self.promoted_state()
        jobs = state_mod.materialize(prepared)
        report.jobs_recovered = len(jobs)
        for job_id in sorted(jobs):
            store.tile_jobs[job_id] = jobs[job_id]
        scheduler_state = prepared.get("scheduler") or {}
        if scheduler is not None and scheduler_state:
            try:
                scheduler.restore_state(scheduler_state)
                report.scheduler_restored = True
            except Exception as exc:  # noqa: BLE001 - aggregates advisory
                log(f"promotion: scheduler state restore failed: {exc}")
        log(
            f"promotion: standby took over {report.jobs_recovered} job(s) "
            f"at lsn {report.last_lsn}; {report.tasks_requeued} tile(s) "
            f"requeued, {report.tasks_restored} durable result(s) restored"
        )
        return prepared, report
