"""DurabilityManager: the one object a DistributedServer owns (the port's
own copy of comfyui_distributed_tpu/durability/manager.py).

Couples the WAL (journal.py), the snapshot shadow (state.py +
snapshot.py), and restart recovery (recovery.py), and is the
``journal_sink`` the JobStore emits typed mutation records into:

    JobStore transition
        → manager.record(rec)          (BEFORE the store acknowledges)
            → journal.append           (framed, CRC'd, fsync policy)
            → apply_record(shadow)     (snapshot stays definitionally
                                        consistent with replay)
            → every CDT_SNAPSHOT_EVERY appends: snapshot + prune

Enabled by setting ``CDT_JOURNAL_DIR``; without it the server runs
exactly as before (no sink, no files, no overhead). Scheduler
aggregates (tenant deficits/weights, placement EWMAs) are sampled into
each snapshot via the scheduler's export hook rather than journaled
per-mutation — see durability/snapshot.py for the trade-off.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Optional

from ..telemetry import instruments
from ..utils.constants import _env_int
from ..utils.logging import log
from . import recovery as recovery_mod
from . import snapshot as snapshot_mod
from . import state as state_mod
from .journal import Journal
from .lease import FencedOut, Lease
from .recovery import RecoveryReport
from .replicate import ReplicationSubscription

DEFAULT_SNAPSHOT_EVERY = 256


def journal_dir_from_env() -> Optional[str]:
    """CDT_JOURNAL_DIR resolution; empty/unset = durability off."""
    raw = os.environ.get("CDT_JOURNAL_DIR", "").strip()
    return raw or None


class DurabilityManager:
    def __init__(
        self,
        directory: str,
        snapshot_every: Optional[int] = None,
        segment_bytes: Optional[int] = None,
        fsync_every: Optional[int] = None,
        scheduler: Any = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.directory = directory
        self.snapshot_every = (
            snapshot_every
            if snapshot_every is not None
            else _env_int("CDT_SNAPSHOT_EVERY", DEFAULT_SNAPSHOT_EVERY)
        )
        self._segment_bytes = segment_bytes
        self._fsync_every = fsync_every
        self.scheduler = scheduler
        self.clock = clock
        self._lock = threading.Lock()
        self._state = state_mod.new_state()
        self._journal: Optional[Journal] = None
        self._appends = 0
        self._appends_since_snapshot = 0
        self._last_snapshot_at: Optional[float] = None
        self._last_snapshot_lsn = 0
        self.report = RecoveryReport()
        self._paused_for_recovery = False
        # Single-flight background snapshot writer: periodic snapshots
        # triggered from the journal seam (which runs on the serving
        # loop) must not pay the write+fsync+prune there.
        self._snapshot_thread: Optional[threading.Thread] = None
        # High-availability layer (optional): the epoch lease fencing
        # this process's right to append, and the live replication
        # subscriptions every journaled record is teed into (see
        # durability/lease.py and durability/replicate.py).
        self.lease: Optional[Lease] = None
        self._replicas: list[ReplicationSubscription] = []
        self.failovers = 0  # promotions performed by THIS process
        # Optional per-append latency feed (seconds) — the brownout
        # controller's journal-saturation signal. Called OUTSIDE the
        # manager lock; must never raise into the journal seam.
        self.append_latency_sink: Optional[Callable[[float], None]] = None

    # --- lifecycle --------------------------------------------------------

    def recover(self, store: Any, scheduler: Any = None) -> RecoveryReport:
        """Run crash recovery into ``store`` (must not be serving yet),
        adopt the recovered state as the snapshot shadow, open the
        journal for appends, and checkpoint immediately so the WAL tail
        the dead process left behind is compacted away."""
        if scheduler is not None:
            self.scheduler = scheduler
        state, report = recovery_mod.recover(
            self.directory, store, scheduler=self.scheduler
        )
        with self._lock:
            self._state = state
            self.report = report
            self._journal = self._open_journal(int(state["last_lsn"]) + 1)
            if report.jobs_recovered:
                self._paused_for_recovery = recovery_mod.pause_after_recovery(
                    self.scheduler
                )
            self._snapshot_locked()
        instruments.recovery_replayed_records().set(report.replayed_records)
        instruments.recovery_requeued_tasks().set(report.tasks_requeued)
        return report

    def _open_journal(self, next_lsn: int) -> Journal:
        return Journal(
            self.directory,
            next_lsn=next_lsn,
            segment_bytes=self._segment_bytes,
            fsync_every=self._fsync_every,
        )

    def close(self) -> None:
        snapshot_thread = self._snapshot_thread
        if snapshot_thread is not None and snapshot_thread.is_alive():
            snapshot_thread.join(timeout=60)
        with self._lock:
            replicas, self._replicas = self._replicas, []
            if self._journal is not None:
                self._journal.close()
                self._journal = None
        for sub in replicas:
            sub.close()

    # --- the journal seam (JobStore.journal_sink) -------------------------

    def record(self, rec: dict) -> None:
        """Append one typed mutation record; called by the JobStore
        BEFORE it acknowledges the transition. A journal failure
        propagates — WAL semantics forbid acknowledging state that was
        not made durable.

        Fencing: when a lease is attached, every append first checks
        ``Lease.held()`` (local-clock cheap within ttl/4, a file
        re-read beyond). A deposed master — its lease taken by a
        promoted standby — raises ``FencedOut`` here, BEFORE any bytes
        land, so a zombie process cannot journal (and therefore cannot
        acknowledge) state after takeover."""
        lease = self.lease
        if lease is not None and not lease.held():
            raise FencedOut(
                f"journal append refused: this process no longer holds "
                f"the master lease for {self.directory} (a standby "
                "promoted itself); the mutation was NOT journaled"
            )
        append_started = time.monotonic()
        with self._lock:
            if self._journal is None:
                self._journal = self._open_journal(int(self._state["last_lsn"]) + 1)
            try:
                lsn = self._journal.append(rec)
            except (TypeError, ValueError):
                if rec.get("payload") is None:
                    raise
                # non-JSON payload (in-memory tensors): journal the
                # transition as volatile; recovery recomputes the tile.
                # (The failed attempt wrote nothing — serialization
                # happens before any bytes land — and lsn gaps are
                # legal in replay.)
                rec = {**rec, "payload": None}
                lsn = self._journal.append(rec)
            sequenced = {**rec, "lsn": lsn}
            state_mod.apply_record(self._state, sequenced)
            self._tee_replicas_locked(sequenced)
            self._appends += 1
            self._appends_since_snapshot += 1
            if self._appends_since_snapshot >= self.snapshot_every:
                self._snapshot_locked(asynchronous=True)
        sink = self.append_latency_sink
        if sink is not None:
            try:
                sink(time.monotonic() - append_started)
            except Exception:  # noqa: BLE001 - observability only
                pass

    # --- replication (durability/replicate.py) ----------------------------

    def subscribe_replica(self) -> ReplicationSubscription:
        """Attach one standby: under the manager lock, serialize the
        current shadow state and register the record tee — the
        (snapshot, tail) pair the subscriber sees is exactly
        consistent by construction (no record between the snapshot
        serialization and the first teed frame)."""
        with self._lock:
            sub = ReplicationSubscription(
                snapshot_state=state_mod.clone(self._state),
                head_lsn=int(self._state["last_lsn"]),
                epoch=self.epoch,
            )
            self._replicas.append(sub)
        return sub

    def unsubscribe_replica(self, sub: ReplicationSubscription) -> None:
        sub.close()
        with self._lock:
            if sub in self._replicas:
                self._replicas.remove(sub)

    def _tee_replicas_locked(self, record: dict) -> None:
        """Caller holds self._lock. Offers never block or raise; a lost
        subscription stays registered (its consumer notices and
        re-syncs or disconnects)."""
        for sub in self._replicas:
            sub.offer(record)

    @property
    def epoch(self) -> int:
        return self.lease.epoch if self.lease is not None else 0

    @property
    def role(self) -> str:
        return "active"

    def head_lsn(self) -> int:
        with self._lock:
            return int(self._state["last_lsn"])

    # --- promotion (standby → active) -------------------------------------

    def adopt(
        self,
        store: Any,
        replica: Any,
        scheduler: Any = None,
        lease: Optional[Lease] = None,
    ) -> RecoveryReport:
        """Standby promotion: the replica's replicated state becomes
        this manager's shadow (the mirror of ``recover``, with the
        replication stream standing in for snapshot + WAL tail).
        Materializes live jobs into ``store``, opens the journal for
        appends at the replicated head, snapshots immediately, and
        holds admission paused until a worker re-registers — the
        ``prepare_for_restart`` semantics reused end to end, so the
        promoted standby requeues in-flight tiles and completes the
        job bit-identically."""
        if scheduler is not None:
            self.scheduler = scheduler
        if lease is not None:
            self.lease = lease
        state, report = replica.promote(store, scheduler=self.scheduler)
        with self._lock:
            self._state = state
            self.report = report
            self.failovers += 1
            if self._journal is not None:
                self._journal.close()
            self._journal = self._open_journal(int(state["last_lsn"]) + 1)
            if report.jobs_recovered:
                self._paused_for_recovery = recovery_mod.pause_after_recovery(
                    self.scheduler
                )
            self._snapshot_locked()
        instruments.recovery_replayed_records().set(report.replayed_records)
        instruments.recovery_requeued_tasks().set(report.tasks_requeued)
        instruments.failover_total().inc(role="standby")
        return report

    # --- snapshots --------------------------------------------------------

    def _snapshot_locked(self, asynchronous: bool = False) -> None:
        """Caller holds self._lock. Synchronous for recovery/close
        (ordering matters there); the periodic path hands the
        write+fsync+prune to a single-flight daemon thread — only the
        state serialization (a json.dumps) stays on the caller, so the
        serving loop never waits on a slow filesystem."""
        if self.scheduler is not None:
            try:
                self._state["scheduler"] = self.scheduler.export_state()
            except Exception as exc:  # noqa: BLE001 - aggregates advisory
                log(f"durability: scheduler export failed: {exc}")
        self._appends_since_snapshot = 0
        if not asynchronous:
            snapshot_mod.write_snapshot(self.directory, self._state)
            self._note_snapshot_locked(int(self._state["last_lsn"]))
            return
        if self._snapshot_thread is not None and self._snapshot_thread.is_alive():
            return  # single flight; the next interval retries
        import json as _json

        blob = (
            _json.dumps(self._state, separators=(",", ":"), sort_keys=True)
            + "\n"
        ).encode("utf-8")
        lsn = int(self._state["last_lsn"])
        self._snapshot_thread = threading.Thread(
            target=self._snapshot_body,
            args=(blob, lsn),
            name="cdt-snapshot-writer",
            daemon=True,
        )
        self._snapshot_thread.start()

    def _note_snapshot_locked(self, lsn: int) -> None:
        self._last_snapshot_at = self.clock()
        self._last_snapshot_lsn = lsn
        if self._journal is not None:
            self._journal.prune(lsn)
        instruments.snapshots_total().inc()

    def _snapshot_body(self, blob: bytes, lsn: int) -> None:
        from ..utils.fsio import atomic_write_bytes

        try:
            path = snapshot_mod.snapshot_path(self.directory, lsn)
            atomic_write_bytes(path, blob)
            snapshot_mod.prune_snapshots(self.directory, path, lsn)
            with self._lock:
                self._note_snapshot_locked(lsn)
        except Exception as exc:  # noqa: BLE001 - surfaced, next interval retries
            log(f"durability: background snapshot at lsn {lsn} failed: {exc}")

    def snapshot_now(self) -> None:
        with self._lock:
            self._snapshot_locked()

    def flush_snapshots(self) -> None:
        """Block until any in-flight background snapshot has landed
        (tests and pre-shutdown hooks)."""
        snapshot_thread = self._snapshot_thread
        if snapshot_thread is not None and snapshot_thread.is_alive():
            snapshot_thread.join(timeout=60)

    # --- post-recovery admission hold -------------------------------------

    def note_worker_activity(self, worker_id: str) -> None:
        """First worker heartbeat after a recovery that restored jobs:
        the fleet is alive again, release the admission lanes."""
        if worker_id == "master" or not self._admission_held():
            return
        with self._lock:
            if not self._paused_for_recovery:
                return
            self._paused_for_recovery = False
        scheduler = self.scheduler
        if scheduler is not None:
            try:
                scheduler.resume()
                log(
                    f"durability: worker {worker_id} re-registered; "
                    "admission lanes resumed"
                )
            except Exception as exc:  # noqa: BLE001 - advisory
                log(f"durability: post-recovery resume failed: {exc}")

    # --- observability ----------------------------------------------------

    def collect_metrics(self) -> None:
        """Scrape-time hook (instruments.bind_server_collectors)."""
        with self._lock:
            last = self._last_snapshot_at
        if last is not None:
            instruments.snapshot_age_seconds().set(max(self.clock() - last, 0.0))

    def _admission_held(self) -> bool:
        """The post-recovery hold, reconciled against reality: an
        operator who resumed the scheduler by hand (runbook §4f) must
        not keep seeing a stale PAUSED banner — and the later worker
        heartbeat must not re-resume over their head."""
        if not self._paused_for_recovery:
            return False
        scheduler = self.scheduler
        if scheduler is not None:
            try:
                if scheduler.queue.state != "paused":
                    self._paused_for_recovery = False
            except Exception:  # noqa: BLE001 - reporting only
                pass
        return self._paused_for_recovery

    def status(self) -> dict[str, Any]:
        with self._lock:
            journal_status = (
                self._journal.status() if self._journal is not None else None
            )
            snapshot_age = (
                max(self.clock() - self._last_snapshot_at, 0.0)
                if self._last_snapshot_at is not None
                else None
            )
            return {
                "enabled": True,
                "role": self.role,
                "epoch": self.epoch,
                "journal_dir": self.directory,
                "journal": journal_status,
                "appends": self._appends,
                "snapshot_every": self.snapshot_every,
                "last_snapshot_lsn": self._last_snapshot_lsn,
                "snapshot_age_seconds": snapshot_age,
                "admission_held": self._admission_held(),
                "recovery": self.report.as_json(),
                "jobs_tracked": len(self._state["jobs"]),
                "replication": {
                    "standbys": len(self._replicas),
                    "lost": sum(1 for s in self._replicas if s.lost),
                },
                "failovers": self.failovers,
            }
