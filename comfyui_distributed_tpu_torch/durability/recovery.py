"""Crash recovery: snapshot + WAL tail → a live, resumable master (the
port's own copy of comfyui_distributed_tpu/durability/recovery.py).

The restart sequence (docs/durability.md has the diagram):

1. **load** the newest snapshot (None on first boot); a version
   mismatch aborts loudly (``SnapshotVersionMismatch``);
2. **replay** the journal tail — every record with lsn beyond the
   snapshot — through the same ``apply_record`` the snapshot shadow
   used, truncating a torn final frame and refusing CRC corruption
   anywhere else (``JournalCorruption``);
3. **prepare** the state for a new process: in-flight tiles revoked to
   pending (the old master's workers re-register via heartbeat),
   volatile completions demoted for bit-identical recompute, durable
   worker payloads kept for re-blend;
4. **materialize** live job objects into the JobStore and hand the
   scheduler its exported aggregates back, with admission lanes held
   PAUSED until a worker shows life (the manager resumes on the first
   post-recovery heartbeat).

Replay is a pure function of the on-disk bytes: running it twice
yields identical states (test-enforced), so a recovery interrupted by
a second crash simply runs again.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..utils.logging import log
from . import journal as journal_mod
from . import snapshot as snapshot_mod
from . import state as state_mod


@dataclasses.dataclass
class RecoveryReport:
    """What recovery found and did; served by /distributed/durability."""

    performed: bool = False
    snapshot_lsn: int = 0
    replayed_records: int = 0
    last_lsn: int = 0
    truncated_bytes: int = 0
    jobs_recovered: int = 0
    jobs_cancelled: int = 0
    tasks_requeued: int = 0
    tasks_restored: int = 0
    scheduler_restored: bool = False

    def as_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def recover_state(directory: str) -> tuple[dict[str, Any], RecoveryReport]:
    """Pure read side: (recovered-but-unprepared state, report).
    Torn-tail truncation is the only write this performs."""
    report = RecoveryReport()
    state = snapshot_mod.load_latest_snapshot(directory)
    if state is None:
        state = state_mod.new_state()
    else:
        report.snapshot_lsn = int(state.get("last_lsn", 0))
    replay = journal_mod.replay_journal(directory, after_lsn=report.snapshot_lsn)
    report.replayed_records = state_mod.replay_into(state, replay.records)
    report.truncated_bytes = replay.truncated_bytes
    report.last_lsn = max(int(state.get("last_lsn", 0)), replay.last_lsn)
    state["last_lsn"] = report.last_lsn
    report.performed = bool(
        report.snapshot_lsn or report.replayed_records or report.last_lsn
    )
    return state, report


def recover(
    directory: str,
    store: Any,
    scheduler: Any = None,
) -> tuple[dict[str, Any], RecoveryReport]:
    """Full recovery into a live JobStore (and scheduler): returns the
    PREPARED state (the manager adopts it as its snapshot shadow) and
    the report. The caller must not be serving traffic yet."""
    state, report = recover_state(directory)
    stats = state_mod.prepare_for_restart(state)
    report.tasks_requeued = stats["tasks_requeued"]
    report.tasks_restored = stats["tasks_restored"]
    report.jobs_cancelled = stats.get("jobs_cancelled", 0)
    jobs = state_mod.materialize(state)
    report.jobs_recovered = len(jobs)
    for job_id in sorted(jobs):
        store.tile_jobs[job_id] = jobs[job_id]
    scheduler_state = state.get("scheduler") or {}
    if scheduler is not None and scheduler_state:
        try:
            scheduler.restore_state(scheduler_state)
            report.scheduler_restored = True
        except Exception as exc:  # noqa: BLE001 - aggregates are advisory
            log(f"recovery: scheduler state restore failed: {exc}")
    if report.performed:
        log(
            f"recovery: {report.jobs_recovered} job(s) restored from "
            f"snapshot lsn {report.snapshot_lsn} + "
            f"{report.replayed_records} journal record(s); "
            f"{report.tasks_requeued} tile(s) requeued, "
            f"{report.tasks_restored} durable result(s) restored"
        )
    return state, report


def verify_idempotent_replay(directory: str) -> bool:
    """Replay the same on-disk state twice and compare: the invariant
    tier-1 enforces and operators can check from a REPL."""
    import json as _json

    first, _ = recover_state(directory)
    second, _ = recover_state(directory)
    return _json.dumps(first, sort_keys=True) == _json.dumps(second, sort_keys=True)


def pause_after_recovery(scheduler: Optional[Any]) -> bool:
    """Hold admission lanes until a worker re-registers (the manager
    resumes on the first post-recovery heartbeat). Returns whether a
    pause actually happened."""
    if scheduler is None:
        return False
    try:
        scheduler.pause()
        return True
    except Exception as exc:  # noqa: BLE001 - advisory
        log(f"recovery: scheduler pause failed: {exc}")
        return False
