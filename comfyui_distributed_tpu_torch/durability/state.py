"""The journaled control-plane state machine (the port's own copy of
comfyui_distributed_tpu/durability/state.py; `materialize` builds the
port's jobs/models.py jobs).

One pure ``apply_record`` shared by two consumers keeps them
definitionally consistent:

- the **snapshot shadow** — the DurabilityManager applies every record
  it journals to an in-memory copy of this state, so a snapshot is a
  serialization of exactly what the journal would replay to;
- **recovery replay** — restart applies the WAL tail to the state
  loaded from the newest snapshot.

The state is plain JSON-able data (dicts/lists/strings/ints) so a
snapshot round-trips losslessly; task ids inside ``completed`` are
string-keyed for the same reason and normalized at materialize time.

Record vocabulary (emitted by ``JobStore`` — docs/durability.md):

    job_init        {job, kind, batched, tasks, deadline_s?}
    pull            {job, worker, tasks}
    submit          {job, worker, task, payload}   payload null = volatile
    requeue         {job, worker, tasks, reason}   failure-class reasons
                    (timeout|quarantine) charge each task's attempt
                    counter — the poison budget replays exactly
    tile_quarantine {job, tasks}                   tasks leave the pull
                    set for good (settled degraded)
    cache_settle    {job, tasks}                   tasks completed from
                    the content-addressed tile cache (payload volatile:
                    the canvas pixels live in the master's cache, so a
                    restarted master recomputes OR re-settles from the
                    cache — both bit-identical by the key contract)
    cancel          {job, reason}                  terminal: pending
                    drained, assignments revoked, later records no-op
    speculate       {job, tasks}
    worker_done     {job, worker}
    cleanup         {job}

``prepare_for_restart`` is the recovery-time transform: in-flight
assignments are revoked back to pending (the workers holding them died
with — or were orphaned by — the old master), and completions whose
payload was volatile (master-local blends that lived only in the dead
process's canvas) are demoted to pending for recompute. Per-tile
determinism (noise keys folding the global tile index) makes both
recompute paths bit-identical to the uninterrupted run.
"""

from __future__ import annotations

import copy
from typing import Any

SNAPSHOT_VERSION = 1
# the participant a restored completion is listed under in
# TileJob.completions (the journal's state does not keep who completed it)
RECOVERED = "recovered"


class SnapshotVersionMismatch(Exception):
    """A snapshot written by an incompatible schema version: recovery
    must stop loudly rather than misinterpret acknowledged state."""


def new_state() -> dict[str, Any]:
    return {"version": SNAPSHOT_VERSION, "last_lsn": 0, "jobs": {}, "scheduler": {}}


def _new_job(
    kind: str, batched: bool, tasks: list[int],
    deadline_s: Any = None, lane: Any = "", tenant: Any = "default",
    adapters: Any = None,
) -> dict[str, Any]:
    try:
        deadline_s = float(deadline_s) if deadline_s else None
    except (TypeError, ValueError):
        deadline_s = None
    return {
        "kind": kind,
        "batched": bool(batched),
        "tasks": [int(t) for t in tasks],
        "pending": [int(t) for t in tasks],
        "assigned": {},  # worker -> [task ids] in claim order
        "completed": {},  # str(task id) -> payload | None
        "speculated": [],
        "finished_workers": [],
        # --- lifecycle armor ---
        "deadline_s": deadline_s,
        "cancelled": False,
        "cancel_reason": "",
        "attempts": {},     # str(task id) -> failed delivery attempts
        "quarantined": [],  # task ids settled degraded (poison)
        "cached": [],       # task ids settled from the tile cache
        # --- xjob tier: admission lane/tenant ride job_init so a
        # recovered master can rank recovered jobs for preemption
        # (checkpoints do NOT — they are volatile; recompute covers)
        "lane": str(lane or ""),
        "tenant": str(tenant or "default"),
        # --- adapter plane: the resolved wire plan rides job_init so a
        # recovered master re-serves the exact personalization from
        # job_status (content hashes included — workers re-verify)
        "adapters": list(adapters or []),
    }


def apply_record(state: dict[str, Any], record: dict[str, Any]) -> None:
    """Apply one journal record. Unknown job references are ignored
    (a record after its job's ``cleanup`` — e.g. a late release racing
    teardown — is a no-op exactly as it is in the live store)."""
    rtype = record.get("type")
    jobs = state["jobs"]
    lsn = int(record.get("lsn", 0))
    if lsn:
        state["last_lsn"] = max(int(state.get("last_lsn", 0)), lsn)
    if rtype == "job_init":
        job_id = str(record["job"])
        if job_id not in jobs:
            jobs[job_id] = _new_job(
                str(record.get("kind", "tile")),
                bool(record.get("batched", True)),
                list(record.get("tasks", [])),
                deadline_s=record.get("deadline_s"),
                lane=record.get("lane", ""),
                tenant=record.get("tenant", "default"),
                adapters=record.get("adapters", []),
            )
        return
    job = jobs.get(str(record.get("job", "")))
    if rtype == "cleanup":
        jobs.pop(str(record.get("job", "")), None)
        return
    if job is None:
        return
    if job.get("cancelled") and rtype != "cancel":
        # terminal: the live store refuses every mutation after the
        # cancel record, so replay must too (defense in depth against
        # a record that raced past the terminal state)
        return
    if rtype == "pull":
        worker = str(record["worker"])
        claimed = job["assigned"].setdefault(worker, [])
        for tid in record.get("tasks", []):
            tid = int(tid)
            if tid in job["pending"]:
                job["pending"].remove(tid)
            if tid not in claimed:
                claimed.append(tid)
    elif rtype == "submit":
        worker = str(record.get("worker", ""))
        tid = int(record["task"])
        claimed = job["assigned"].get(worker)
        if claimed and tid in claimed:
            claimed.remove(tid)
            if not claimed:
                del job["assigned"][worker]
        key = str(tid)
        if key not in job["completed"]:  # first result wins, as in the store
            job["completed"][key] = record.get("payload")
            # a speculated copy settling a poison-quarantined tile
            # drops the quarantine, exactly as the live store does —
            # the tile must count exactly once toward completion
            quarantined = job.get("quarantined")
            if quarantined and tid in quarantined:
                quarantined.remove(tid)
    elif rtype == "requeue":
        worker = str(record.get("worker", ""))
        claimed = job["assigned"].get(worker, [])
        charge = str(record.get("reason", "")) in ("timeout", "quarantine")
        attempts = job.setdefault("attempts", {})
        quarantined = job.setdefault("quarantined", [])
        for tid in record.get("tasks", []):
            tid = int(tid)
            if tid in claimed:
                claimed.remove(tid)
            if charge:
                attempts[str(tid)] = int(attempts.get(str(tid), 0)) + 1
            if (
                str(tid) not in job["completed"]
                and tid not in job["pending"]
                and tid not in quarantined
            ):
                job["pending"].append(tid)
        if worker in job["assigned"] and not job["assigned"][worker]:
            del job["assigned"][worker]
    elif rtype == "tile_quarantine":
        quarantined = job.setdefault("quarantined", [])
        for tid in record.get("tasks", []):
            tid = int(tid)
            if tid in job["pending"]:
                job["pending"] = [t for t in job["pending"] if t != tid]
            if str(tid) not in job["completed"] and tid not in quarantined:
                quarantined.append(tid)
    elif rtype == "cache_settle":
        # tiles settled straight from the tile cache: completed with a
        # VOLATILE payload (the pixels live in the master's cache, not
        # the journal) and removed from the pull set — the shadow must
        # track the live store's shrunken queue exactly
        cached = job.setdefault("cached", [])
        quarantined = job.get("quarantined") or []
        for tid in record.get("tasks", []):
            tid = int(tid)
            key = str(tid)
            if key in job["completed"] or tid in quarantined:
                continue
            job["completed"][key] = None
            if tid in job["pending"]:
                job["pending"] = [t for t in job["pending"] if t != tid]
            if tid not in cached:
                cached.append(tid)
    elif rtype == "cancel":
        # terminal: the whole refund happens here, so crash-after-cancel
        # replay reaches the same drained state the live store had
        job["cancelled"] = True
        job["cancel_reason"] = str(record.get("reason", ""))
        job["pending"] = []
        job["assigned"] = {}
    elif rtype == "speculate":
        for tid in record.get("tasks", []):
            tid = int(tid)
            if tid not in job["speculated"]:
                job["speculated"].append(tid)
            job["pending"].append(tid)  # a COPY rides next to the original
    elif rtype == "worker_done":
        worker = str(record["worker"])
        if worker not in job["finished_workers"]:
            job["finished_workers"].append(worker)
    # unknown record types are ignored: a newer master may journal
    # types an older reader doesn't know; they must not abort replay


def replay_into(state: dict[str, Any], records: list[dict[str, Any]]) -> int:
    """Apply records in order; returns how many were applied. Pure with
    respect to the inputs (records are not mutated), so applying the
    same (snapshot, records) twice yields identical states — the
    idempotence property tests/test_durability.py enforces."""
    for record in records:
        apply_record(state, record)
    return len(records)


def prepare_for_restart(state: dict[str, Any]) -> dict[str, int]:
    """Mutate a recovered state for a fresh master process; returns
    counters for the recovery report.

    - every in-flight assignment is revoked to pending (its worker's
      connection to the dead master is gone; workers re-register via
      heartbeat against the restarted process);
    - completions with a durable payload are kept (the payload will be
      re-enqueued for the new master's blender);
    - volatile completions (payload null — master-local blends) are
      demoted to pending for bit-identical recompute;
    - speculation marks are cleared so the watchdog may speculate
      afresh in the new process.

    Requeue order is sorted for determinism (recovery must not depend
    on the journal's interleaving of the dead process's races).
    """
    requeued = 0
    restored = 0
    cancelled = 0
    for job_id in sorted(state["jobs"]):
        job = state["jobs"][job_id]
        if job.get("cancelled"):
            # terminal: a restarted master has nothing to resume here —
            # the cancel already refunded everything; drop the record
            # (the dead process would have cleaned it up next).
            del state["jobs"][job_id]
            cancelled += 1
            continue
        quarantined = {int(t) for t in job.get("quarantined", [])}
        back: set[int] = set()
        for worker in sorted(job["assigned"]):
            back.update(int(t) for t in job["assigned"][worker])
        job["assigned"] = {}
        durable: dict[str, Any] = {}
        for key in sorted(job["completed"], key=int):
            payload = job["completed"][key]
            if payload is None:
                back.add(int(key))
            else:
                durable[key] = payload
                restored += 1
        job["completed"] = durable
        # quarantined tiles stay settled (degraded) across the restart:
        # re-running known poison would just crash the new fleet too
        back -= quarantined
        pending = [
            int(t)
            for t in job["pending"]
            if int(t) not in back and int(t) not in quarantined
        ]
        already = set(pending)
        additions = [
            t for t in sorted(back) if t not in already and str(t) not in durable
        ]
        job["pending"] = pending + additions
        job["speculated"] = []
        # cache-settlement marks reset with the demotion: the restarted
        # master re-consults the cache at grant time and re-settles (or
        # recomputes on a cold cache) — bit-identical either way
        job["cached"] = []
        requeued += len(additions)
    return {
        "tasks_requeued": requeued,
        "tasks_restored": restored,
        "jobs_cancelled": cancelled,
    }


def materialize(state: dict[str, Any]):
    """Build live ``TileJob``/``ImageJob`` objects from a prepared
    state: ``{job_id: job}`` ready to install into a ``JobStore``.
    Durable completed payloads are re-enqueued on ``job.results`` so
    the new master's drain loop blends them without recompute.

    The state keeps no participant per completion (its dict is the JAX
    package's), so the port's ``TileJob.completions`` lists each restored
    tile under the participant ``RECOVERED``: every completed tile is
    still listed exactly once."""
    from ..jobs.models import ImageJob, TileJob

    out = {}
    for job_id in sorted(state["jobs"]):
        spec = state["jobs"][job_id]
        cls = TileJob if spec.get("kind", "tile") == "tile" else ImageJob
        job = cls(
            job_id=job_id,
            total_tasks=len(spec["tasks"]),
            batched=bool(spec.get("batched", True)),
        )
        for tid in spec["pending"]:
            job.pending.put_nowait(int(tid))
        for key in sorted(spec["completed"], key=int):
            payload = spec["completed"][key]
            job.completed[int(key)] = payload
            job.completions.append((int(key), RECOVERED))
            job.results.put_nowait((int(key), payload))
        job.finished_workers = set(spec.get("finished_workers", []))
        # lifecycle armor: poison budgets and quarantines survive the
        # restart; a journaled deadline re-arms its FULL window (the
        # dead process's monotonic cutoff is meaningless here — the
        # recovered job gets a fresh clock, documented in
        # docs/resilience.md)
        job.attempts = {
            int(t): int(n)
            for t, n in (spec.get("attempts") or {}).items()
        }
        job.quarantined_tiles = {
            int(t) for t in spec.get("quarantined", [])
        }
        job.cached_tiles = {int(t) for t in spec.get("cached", [])}
        job.lane = str(spec.get("lane", "") or "")
        job.tenant = str(spec.get("tenant", "default") or "default")
        job.adapters = list(spec.get("adapters", []) or [])
        deadline_s = spec.get("deadline_s")
        if deadline_s:
            import time as _time

            job.deadline_s = float(deadline_s)
            job.deadline_at = _time.monotonic() + float(deadline_s)
        out[job_id] = job
    return out


def clone(state: dict[str, Any]) -> dict[str, Any]:
    return copy.deepcopy(state)
