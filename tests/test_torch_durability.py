"""The port's durable control plane (comfyui_distributed_tpu_torch/
durability/) on the scenarios of tests/test_durability.py, with the JAX
tests' assertions: WAL framing, rotation, torn-tail truncation, snapshot
compaction, recovery corner cases and the scheduler's snapshot/restore
hooks, on the port's JobStore and SchedulerControl.

Then the port held to the JAX package directly: one op sequence touching
every record type on a journaled JAX JobStore and a journaled port
JobStore gives equal records (lsn aside) and equal recovered states, and
a journal and snapshot directory written by either package recovers in
the other to the same state (a format check, not a mixed fleet). A
payload the journal cannot serialize (a CPU or CUDA tensor, a numpy
array) journals as volatile (null) before any bytes land. Runs on the
CPU.
"""

import asyncio
import json
import os
import struct

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.durability import (
    DurabilityManager,
    Journal,
    JournalCorruption,
    SnapshotVersionMismatch,
    recover_state,
    replay_journal,
)
from comfyui_distributed_tpu_torch.durability import snapshot as snapshot_mod
from comfyui_distributed_tpu_torch.durability import state as state_mod
from comfyui_distributed_tpu_torch.durability.journal import list_segments
from comfyui_distributed_tpu_torch.durability.recovery import verify_idempotent_replay
from comfyui_distributed_tpu_torch.jobs import JobStore


def run(coro):
    return asyncio.run(coro)


def _append_all(journal, records):
    return [journal.append(r) for r in records]


RECORDS = [
    {"type": "job_init", "job": "j", "kind": "tile", "batched": True,
     "tasks": [0, 1, 2, 3]},
    {"type": "pull", "job": "j", "worker": "w1", "tasks": [0]},
    {"type": "pull", "job": "j", "worker": "master", "tasks": [1]},
    {"type": "submit", "job": "j", "worker": "w1", "task": 0,
     "payload": [{"batch_idx": 0, "image": "data:png"}]},
    {"type": "submit", "job": "j", "worker": "master", "task": 1,
     "payload": None},
]


# --- journal framing / replay ---------------------------------------------


def test_journal_append_replay_roundtrip(tmp_path):
    journal = Journal(str(tmp_path), fsync_every=1)
    lsns = _append_all(journal, RECORDS)
    journal.close()
    assert lsns == [1, 2, 3, 4, 5]
    replay = replay_journal(str(tmp_path))
    assert [r["type"] for r in replay.records] == [r["type"] for r in RECORDS]
    assert replay.last_lsn == 5
    assert replay.truncated_bytes == 0


def test_journal_segment_rotation_and_replay_order(tmp_path):
    """A tiny segment budget forces rotation; replay must stitch the
    segments back in numeric order."""
    journal = Journal(str(tmp_path), segment_bytes=64, fsync_every=0)
    _append_all(journal, RECORDS)
    journal.close()
    assert len(list_segments(str(tmp_path))) > 1
    replay = replay_journal(str(tmp_path))
    assert [r["lsn"] for r in replay.records] == [1, 2, 3, 4, 5]


def test_empty_journal_dir_recovers_to_empty_state(tmp_path):
    state, report = recover_state(str(tmp_path))
    assert state["jobs"] == {}
    assert not report.performed
    assert report.replayed_records == 0
    # and a live recover into a store is a clean no-op
    store = JobStore()
    manager = DurabilityManager(str(tmp_path), fsync_every=0)
    report = manager.recover(store)
    assert store.tile_jobs == {}
    assert report.jobs_recovered == 0
    manager.close()


def test_snapshot_with_no_wal_tail(tmp_path):
    """Snapshot present, zero segments beyond it: recovery must come
    entirely from the snapshot."""
    state = state_mod.new_state()
    for i, rec in enumerate(RECORDS, start=1):
        state_mod.apply_record(state, {**rec, "lsn": i})
    snapshot_mod.write_snapshot(str(tmp_path), state)
    recovered, report = recover_state(str(tmp_path))
    assert report.snapshot_lsn == 5
    assert report.replayed_records == 0
    assert recovered["jobs"]["j"]["completed"].keys() == {"0", "1"}


def test_torn_final_record_is_truncated_not_fatal(tmp_path):
    journal = Journal(str(tmp_path), fsync_every=1)
    _append_all(journal, RECORDS)
    journal.close()
    _idx, path = list_segments(str(tmp_path))[-1]
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:  # the crash mid-append: tail sheared
        fh.truncate(size - 3)
    replay = replay_journal(str(tmp_path))
    # the torn record is gone, everything before it survives...
    assert [r["lsn"] for r in replay.records] == [1, 2, 3, 4]
    assert replay.truncated_bytes > 0
    # ...and the file was physically truncated back to the good prefix,
    # so a SECOND replay sees a clean tail
    again = replay_journal(str(tmp_path))
    assert again.truncated_bytes == 0
    assert [r["lsn"] for r in again.records] == [1, 2, 3, 4]


def test_crc_corrupted_final_record_is_torn_tail(tmp_path):
    """Bit rot in the last frame (length intact, payload garbage) is
    indistinguishable from a torn append: truncate, don't abort."""
    journal = Journal(str(tmp_path), fsync_every=1)
    _append_all(journal, RECORDS)
    journal.close()
    _idx, path = list_segments(str(tmp_path))[-1]
    with open(path, "r+b") as fh:
        fh.seek(-2, os.SEEK_END)
        fh.write(b"\xff")
    replay = replay_journal(str(tmp_path))
    assert [r["lsn"] for r in replay.records] == [1, 2, 3, 4]


def test_crc_corrupted_mid_segment_record_fails_loudly(tmp_path):
    """A broken record that is NOT the tail is acknowledged state gone
    bad: recovery must raise, never silently skip."""
    journal = Journal(str(tmp_path), fsync_every=1)
    _append_all(journal, RECORDS)
    journal.close()
    _idx, path = list_segments(str(tmp_path))[-1]
    with open(path, "r+b") as fh:
        data = fh.read()
        # corrupt one payload byte of the SECOND frame
        length = struct.unpack_from(">I", data, 0)[0]
        second_payload = 8 + length + 8
        fh.seek(second_payload + 2)
        fh.write(b"\xff")
    with pytest.raises(JournalCorruption):
        replay_journal(str(tmp_path))


def test_snapshot_version_mismatch_fails_loudly(tmp_path):
    bogus = {"version": 999, "last_lsn": 7, "jobs": {}, "scheduler": {}}
    with open(snapshot_mod.snapshot_path(str(tmp_path), 7), "w") as fh:
        json.dump(bogus, fh)
    with pytest.raises(SnapshotVersionMismatch):
        snapshot_mod.load_latest_snapshot(str(tmp_path))
    with pytest.raises(SnapshotVersionMismatch):
        recover_state(str(tmp_path))


def test_replay_is_idempotent(tmp_path):
    journal = Journal(str(tmp_path), fsync_every=0)
    _append_all(journal, RECORDS)
    journal.close()
    assert verify_idempotent_replay(str(tmp_path))
    first, _ = recover_state(str(tmp_path))
    second, _ = recover_state(str(tmp_path))
    assert json.dumps(first, sort_keys=True) == json.dumps(second, sort_keys=True)


def test_write_behind_failure_halts_journal_no_midstream_hole(tmp_path):
    """Once a write-behind frame fails, later frames must be DISCARDED
    (suffix loss — the documented contract) and every subsequent
    append must raise the sticky error. Writing past the failed frame
    would punch an undetectable mid-stream hole in acknowledged
    state."""
    journal = Journal(str(tmp_path), fsync_every=0)
    journal.append(RECORDS[0])
    real_write = journal._write_frame
    calls = {"n": 0}

    def flaky_write(frame, lsn):
        calls["n"] += 1
        if lsn == 2:
            raise OSError(28, "No space left on device")
        real_write(frame, lsn)

    journal._write_frame = flaky_write
    journal.append(RECORDS[1])  # lsn 2: fails on the writer thread
    journal.append(RECORDS[2])  # lsn 3: must be discarded, not written
    journal.sync()  # barrier: the writer has processed everything
    with pytest.raises(OSError, match="No space left"):
        journal.append(RECORDS[3])  # sticky: the journal is dead
    with pytest.raises(OSError, match="No space left"):
        journal.close()
    # on disk: ONLY the pre-failure prefix — no frame after the hole
    replay = replay_journal(str(tmp_path))
    assert [r["lsn"] for r in replay.records] == [1]


# --- snapshot compaction ---------------------------------------------------


def test_snapshot_prunes_superseded_segments_and_snapshots(tmp_path):
    """Every CDT_SNAPSHOT_EVERY appends the manager checkpoints and
    retires covered segments + older snapshots."""
    manager = DurabilityManager(
        str(tmp_path), snapshot_every=2, segment_bytes=64, fsync_every=0
    )
    for rec in RECORDS:
        manager.record(rec)
        # periodic snapshots write on a background thread (single
        # flight); flush after each record so both intervals land
        manager.flush_snapshots()
    manager.close()
    snapshots = snapshot_mod.list_snapshots(str(tmp_path))
    assert len(snapshots) == 1  # older snapshots pruned
    assert snapshots[-1][0] == 4  # last checkpoint at append 4
    # closed segments covered by the snapshot were deleted; replay of
    # what remains plus the snapshot reconstructs everything
    state, report = recover_state(str(tmp_path))
    assert state["jobs"]["j"]["completed"].keys() == {"0", "1"}
    assert report.last_lsn == 5


# --- recovery into a live store --------------------------------------------


def _journaled_store(tmp_path, **manager_kwargs):
    manager = DurabilityManager(str(tmp_path), fsync_every=0, **manager_kwargs)
    store = JobStore()
    store.journal_sink = manager.record
    return manager, store


def test_recovery_requeues_in_flight_and_restores_durable(tmp_path):
    manager, store = _journaled_store(tmp_path)

    async def phase_one():
        await store.init_tile_job("j", [0, 1, 2, 3])
        t0 = await store.pull_task("j", "w1")
        await store.pull_task("j", "w1")  # stays in flight
        await store.submit_result(
            "j", "w1", t0, [{"batch_idx": 0, "image": "data:png"}]
        )
        t2 = await store.pull_task("j", "master")
        await store.submit_result("j", "master", t2, None)  # volatile

    run(phase_one())
    manager.close()

    store2 = JobStore()
    manager2 = DurabilityManager(str(tmp_path), fsync_every=0)
    report = manager2.recover(store2)
    job = store2.tile_jobs["j"]
    assert report.jobs_recovered == 1
    assert report.tasks_restored == 1  # w1's durable payload
    assert report.tasks_requeued == 2  # the in-flight tile + the volatile one
    # durable result re-enqueued for the new master's blender
    assert job.results.qsize() == 1
    assert job.completed == {0: [{"batch_idx": 0, "image": "data:png"}]}
    # nothing is assigned any more; the requeued tiles are claimable
    assert job.assigned == {}
    assert job.pending.qsize() == 3  # tiles 1, 2 requeued + 3 never pulled
    manager2.close()


def test_recovered_job_completes_through_normal_store_ops(tmp_path):
    """After recovery the store behaves exactly like a live one: the
    requeued tiles pull, duplicate late submits drop, is_complete
    flips when the durable + recomputed sets meet."""
    manager, store = _journaled_store(tmp_path)

    async def phase_one():
        await store.init_tile_job("j", [0, 1, 2])
        t0 = await store.pull_task("j", "w1")
        await store.submit_result(
            "j", "w1", t0, [{"batch_idx": 0, "image": "data:png"}]
        )
        await store.pull_task("j", "w1")  # in flight at the crash

    run(phase_one())
    manager.close()

    store2 = JobStore()
    manager2 = DurabilityManager(str(tmp_path), fsync_every=0)
    manager2.recover(store2)
    store2.journal_sink = manager2.record

    async def phase_two():
        while True:
            task = await store2.pull_task("j", "master", timeout=0.05)
            if task is None:
                break
            assert await store2.submit_result("j", "master", task, None)
        # the dead worker's zombie submit for tile 0 drops as duplicate
        assert await store2.submit_result("j", "w1", 0, "stale") is False
        assert await store2.is_complete("j")

    run(phase_two())
    manager2.close()


def test_non_json_payload_journals_as_volatile(tmp_path):
    """A payload the journal can't serialize (in-memory tensors on the
    collector path) demotes to volatile: the transition is durable, the
    payload recomputes on recovery."""
    manager, store = _journaled_store(tmp_path)

    async def phase_one():
        await store.init_tile_job("j", [0])
        t0 = await store.pull_task("j", "w1")
        await store.submit_result("j", "w1", t0, object())  # not JSON-able

    run(phase_one())
    manager.close()
    state, _report = recover_state(str(tmp_path))
    assert state["jobs"]["j"]["completed"] == {"0": None}
    store2 = JobStore()
    manager2 = DurabilityManager(str(tmp_path), fsync_every=0)
    report = manager2.recover(store2)
    assert report.tasks_requeued == 1  # demoted for recompute
    assert store2.tile_jobs["j"].pending.qsize() == 1
    manager2.close()


# --- scheduler snapshot/restore hooks --------------------------------------


def test_scheduler_state_survives_restart(tmp_path):
    from comfyui_distributed_tpu_torch.scheduler import SchedulerControl

    control = SchedulerControl()
    control.queue.set_weight("tenant-a", 3.0)
    control.queue.lanes[control.queue.lane_order[0]].deficit["tenant-a"] = 1.5
    for _ in range(4):
        control.placement.record_latency("w1", 0.5)
        control.placement.record_latency("w2", 0.05)

    manager = DurabilityManager(
        str(tmp_path), fsync_every=0, scheduler=control
    )
    store = JobStore()
    store.journal_sink = manager.record

    async def mutate():
        await store.init_tile_job("j", [0, 1])
        await store.pull_task("j", "w1")

    run(mutate())
    manager.snapshot_now()
    manager.close()

    fresh = SchedulerControl()
    store2 = JobStore()
    manager2 = DurabilityManager(str(tmp_path), fsync_every=0, scheduler=fresh)
    report = manager2.recover(store2)
    assert report.scheduler_restored
    assert fresh.queue.tenant_weights["tenant-a"] == 3.0
    assert fresh.queue.lanes[fresh.queue.lane_order[0]].deficit["tenant-a"] == 1.5
    # the placement speed model came back: w1 still reads slow
    assert fresh.placement.speed_ratio("w1") < 1.0
    assert fresh.placement.speed_ratio("w2") > 1.0
    # a job was recovered → admission lanes held PAUSED until a worker
    # re-registers via heartbeat
    assert fresh.queue.state == "paused"
    manager2.note_worker_activity("master")  # master liveness ≠ fleet liveness
    assert fresh.queue.state == "paused"
    manager2.note_worker_activity("w1")
    assert fresh.queue.state == "running"
    manager2.close()


def test_manual_scheduler_resume_clears_admission_hold(tmp_path):
    """Runbook §4f step 2: an operator resuming the scheduler by hand
    (no workers left to heartbeat) must clear the reported hold — the
    durability route must not keep showing a stale PAUSED banner."""
    from comfyui_distributed_tpu_torch.scheduler import SchedulerControl

    manager, store = _journaled_store(tmp_path)
    run(store.init_tile_job("j", [0]))
    run(store.pull_task("j", "w1"))
    manager.close()

    fresh = SchedulerControl()
    store2 = JobStore()
    manager2 = DurabilityManager(str(tmp_path), fsync_every=0, scheduler=fresh)
    manager2.recover(store2)
    assert manager2.status()["admission_held"] is True
    fresh.resume()  # POST /distributed/scheduler/resume
    assert manager2.status()["admission_held"] is False
    # and the next worker heartbeat must not act on the stale flag
    manager2.note_worker_activity("w1")
    assert fresh.queue.state == "running"
    manager2.close()


def test_store_heartbeat_triggers_admission_resume(tmp_path):
    """The wiring the server uses: JobStore.on_worker_seen fires on a
    recorded heartbeat and releases the post-recovery admission hold."""
    from comfyui_distributed_tpu_torch.scheduler import SchedulerControl

    manager, store = _journaled_store(tmp_path)
    run(store.init_tile_job("j", [0, 1]))
    run(store.pull_task("j", "w1"))
    manager.close()

    fresh = SchedulerControl()
    store2 = JobStore()
    manager2 = DurabilityManager(str(tmp_path), fsync_every=0, scheduler=fresh)
    manager2.recover(store2)
    store2.journal_sink = manager2.record
    store2.on_worker_seen = manager2.note_worker_activity
    assert fresh.queue.state == "paused"
    run(store2.heartbeat("j", "w7"))
    assert fresh.queue.state == "running"
    manager2.close()


# --- status / metrics -------------------------------------------------------


def test_manager_status_shape(tmp_path):
    manager, store = _journaled_store(tmp_path, snapshot_every=2)
    run(store.init_tile_job("j", [0]))
    run(store.pull_task("j", "w1"))
    manager.flush_snapshots()  # the periodic snapshot lands off-thread
    status = manager.status()
    assert status["enabled"] is True
    assert status["appends"] == 2
    assert status["journal"]["next_lsn"] == 3
    assert status["last_snapshot_lsn"] == 2
    assert status["snapshot_age_seconds"] is not None
    assert status["recovery"]["performed"] is False
    assert status["jobs_tracked"] == 1
    manager.close()


def test_cache_settle_replays_as_volatile_completion(tmp_path):
    """A `cache_settle` record replays as a volatile completion:
    recovery demotes the settled tiles back to pending (payload None —
    the pixels lived only in the dead master's canvas), so the
    restarted master re-consults the cache and re-settles or
    recomputes — bit-identical either way (docs/caching.md)."""
    manager, store = _journaled_store(tmp_path)

    async def phase_one():
        await store.init_tile_job("j", [0, 1, 2])
        settled = await store.settle_cached("j", [0, 2])
        assert settled == [0, 2]
        t1 = await store.pull_task("j", "w1")
        await store.submit_result(
            "j", "w1", t1, [{"batch_idx": 0, "image": "data:png"}]
        )

    run(phase_one())
    manager.close()

    store2 = JobStore()
    manager2 = DurabilityManager(str(tmp_path), fsync_every=0)
    report = manager2.recover(store2)
    job = store2.tile_jobs["j"]
    assert report.tasks_restored == 1          # w1's durable payload
    assert report.tasks_requeued == 2          # both cache-settled tiles
    assert job.completed == {1: [{"batch_idx": 0, "image": "data:png"}]}
    assert job.cached_tiles == set()           # restart clears the mark
    assert job.pending.qsize() == 2
    manager2.close()

    # the restarted master re-settles from the cache through the
    # normal store op, bringing the job back to complete
    store2.journal_sink = manager2.record

    async def phase_two():
        assert await store2.settle_cached("j", [0, 2]) == [0, 2]
        assert await store2.is_complete("j")

    run(phase_two())


def test_cache_settle_shrinks_shadow_pull_set(tmp_path):
    """Within one epoch (no restart) a replayed cache_settle keeps the
    settled tiles OUT of the shadow pending set — apply_record's view
    matches the live store's shrunken queue."""
    from comfyui_distributed_tpu_torch.durability.state import (
        new_state,
        replay_into,
    )

    state = new_state()
    replay_into(
        state,
        [
            {"type": "job_init", "job": "j", "kind": "tile",
             "batched": True, "tasks": [0, 1, 2]},
            {"type": "cache_settle", "job": "j", "tasks": [0, 2]},
        ],
    )
    job = state["jobs"]["j"]
    assert job["pending"] == [1]
    assert set(job["cached"]) == {0, 2}
    assert job["completed"]["0"] is None and job["completed"]["2"] is None


# --- the port held to the JAX package --------------------------------------

POLL = 0.02
DURABLE = [{"batch_idx": 0, "image": "data:image/png;base64,AAAA"}]


class _Grants:
    """Placement stub for both stores: every pull allowed, two-tile
    grants (so a grant journals its first task, then the rest)."""

    def may_pull(self, worker_id, pending):
        return True

    def batch_size(self, worker_id, pending):
        return 2


async def _every_record_type(store, opaque):
    """One op sequence that makes every record type the stores journal,
    and the transitions that journal nothing (a duplicate, a second
    worker_done, the cancelled job's late submit and release)."""
    store.placement = _Grants()
    store.note_job_priority("j", "bulk", "tenant-a")
    await store.init_tile_job("j", list(range(8)), deadline_s=600.0)
    await store.settle_cached("j", [7])
    first = await store.pull_tasks("j", "w1", timeout=POLL)
    await store.submit_result("j", "w1", first[0], DURABLE)
    await store.submit_result("j", "w2", first[0], "late duplicate")
    await store.release_tasks("j", "w1", [first[1]])
    mine = await store.pull_tasks("j", "master", timeout=POLL)
    await store.submit_result("j", "master", mine[0], None)
    await store.submit_result("j", "master", mine[1], opaque)
    await store.pull_tasks("j", "w2", timeout=POLL)
    await store.speculate_in_flight("j")
    store.tile_jobs["j"].worker_status["w2"] -= 100.0
    await store.requeue_timed_out("j", 10.0)
    await store.mark_worker_done("j", "w1")
    await store.mark_worker_done("j", "w1")
    await store.heartbeat("j", "w1")
    # poison: w3 is quarantined twice holding tile 0 of "k" (max_attempts 2)
    await store.init_tile_job("k", [0])
    for _ in range(2):
        await store.pull_task("k", "w3", timeout=POLL)
        await store.requeue_worker_tasks("w3")
    # a cancel mid-job, then a late submit and release that journal nothing
    await store.init_tile_job("c", [0, 1, 2])
    held = await store.pull_tasks("c", "w1", timeout=POLL)
    await store.cancel_job("c", reason="client")
    await store.submit_result("c", "w1", held[0], DURABLE)
    await store.release_tasks("c", "w1", held)
    await store.cleanup_tile_job("c")
    # a deadline that expires, swept
    await store.init_tile_job("d", [0], deadline_s=0.001)
    await asyncio.sleep(0.01)
    await store.sweep_deadlines()


def _journaled_run(store_cls, manager_cls, directory, opaque):
    manager = manager_cls(str(directory), fsync_every=1, snapshot_every=5)
    store = store_cls(max_attempts=2)
    store.journal_sink = manager.record
    asyncio.run(_every_record_type(store, opaque))
    manager.flush_snapshots()
    manager.close()


@pytest.fixture(scope="module")
def both_journals(tmp_path_factory):
    from comfyui_distributed_tpu.durability import DurabilityManager as JaxManager
    from comfyui_distributed_tpu.jobs import JobStore as JaxJobStore

    dirs = {"jax": tmp_path_factory.mktemp("jax-wal"), "port": tmp_path_factory.mktemp("port-wal")}
    _journaled_run(JaxJobStore, JaxManager, dirs["jax"], np.ones((2, 2), np.float32))
    _journaled_run(JobStore, DurabilityManager, dirs["port"], torch.ones(2, 2))
    return dirs


def _records(directory):
    from comfyui_distributed_tpu.durability import replay_journal as jax_replay

    records = jax_replay(str(directory)).records
    return [{k: v for k, v in r.items() if k != "lsn"} for r in records]


def test_both_stores_journal_the_same_records(both_journals):
    jax_records, port_records = (_records(both_journals[side]) for side in ("jax", "port"))
    assert port_records == jax_records
    kinds = {r["type"] for r in port_records}
    assert kinds == {"job_init", "pull", "submit", "cache_settle", "worker_done", "cleanup",
                     "cancel", "requeue", "tile_quarantine", "speculate"}
    submits = [r for r in port_records if r["type"] == "submit"]
    # the duplicate and the cancelled job's late submit journal nothing;
    # the master's two payloads are volatile
    assert [(r["job"], r["worker"], r["payload"]) for r in submits] == [
        ("j", "w1", DURABLE), ("j", "master", None), ("j", "master", None)]
    assert sorted(r["reason"] for r in port_records if r["type"] == "requeue") == [
        "quarantine", "quarantine", "released", "timeout"]
    assert [r["reason"] for r in port_records if r["type"] == "cancel"] == ["client", "deadline"]
    # a two-tile grant journals its first task, then the rest
    pulls = [r["tasks"] for r in port_records if r["type"] == "pull" and r["job"] == "j"]
    assert [len(t) for t in pulls] == [1, 1, 1, 1, 1, 1]


def _state_json(recover, directory) -> str:
    state, _report = recover(str(directory))
    return json.dumps(state, sort_keys=True)


@pytest.mark.parametrize("written_by", ["jax", "port"])
def test_each_package_recovers_either_journal_to_the_same_state(both_journals, written_by):
    from comfyui_distributed_tpu.durability import recover_state as jax_recover

    directory = both_journals[written_by]
    assert snapshot_mod.list_snapshots(str(directory)), "no snapshot was written"
    port_state = _state_json(recover_state, directory)
    assert port_state == _state_json(jax_recover, directory)
    # and both packages' journals recover to one state
    assert port_state == _state_json(recover_state, both_journals["jax"])
    state = json.loads(port_state)
    assert sorted(state["jobs"]) == ["d", "j", "k"]
    assert state["jobs"]["k"]["quarantined"] == [0]
    assert state["jobs"]["d"]["cancelled"] is True


def _live(job) -> dict:
    """What a recovered job holds, comparable across the packages."""
    pending = []
    while not job.pending.empty():
        pending.append(job.pending.get_nowait())
    return {"total": job.total_tasks, "pending": pending, "completed": dict(job.completed),
            "attempts": dict(job.attempts), "quarantined": sorted(job.quarantined_tiles),
            "cached": sorted(job.cached_tiles), "lane": job.lane, "tenant": job.tenant,
            "finished": sorted(job.finished_workers), "deadline_s": job.deadline_s,
            "results": job.results.qsize()}


@pytest.mark.parametrize("written_by", ["jax", "port"])
def test_each_package_recovers_either_journal_into_a_live_store(both_journals, written_by,
                                                                tmp_path):
    """Recovery into a live store of each package, from a copy of either
    package's directory (recovery compacts and appends)."""
    import shutil

    from comfyui_distributed_tpu.durability import DurabilityManager as JaxManager
    from comfyui_distributed_tpu.jobs import JobStore as JaxJobStore

    live, reports = {}, {}
    for side, store_cls, manager_cls in (("jax", JaxJobStore, JaxManager),
                                         ("port", JobStore, DurabilityManager)):
        directory = tmp_path / side
        shutil.copytree(both_journals[written_by], directory)
        store = store_cls()
        manager = manager_cls(str(directory), fsync_every=1)
        reports[side] = manager.recover(store).as_json()
        manager.close()
        live[side] = {job_id: _live(job) for job_id, job in sorted(store.tile_jobs.items())}
    assert live["port"] == live["jax"]
    assert reports["port"] == reports["jax"]
    assert reports["port"]["jobs_recovered"] == 2 and reports["port"]["jobs_cancelled"] == 1
    assert live["port"]["j"]["completed"] == {0: DURABLE}


def test_a_recovered_completion_is_listed_under_the_recovered_participant(tmp_path):
    manager, store = _journaled_store(tmp_path)

    async def phase_one():
        await store.init_tile_job("j", [0, 1])
        await store.pull_task("j", "w1")
        await store.submit_result("j", "w1", 0, DURABLE)

    run(phase_one())
    manager.close()
    store2 = JobStore()
    manager2 = DurabilityManager(str(tmp_path), fsync_every=0)
    manager2.recover(store2)
    assert store2.tile_jobs["j"].completions == [(0, state_mod.RECOVERED)]
    manager2.close()


@pytest.mark.parametrize("payload", [
    pytest.param(lambda: torch.ones(2, 3), id="cpu-tensor"),
    pytest.param(lambda: np.ones((2, 3), np.float32), id="numpy-array"),
    pytest.param(lambda: [{"batch_idx": 0, "image": torch.zeros(1)}], id="tensor-in-envelope"),
    pytest.param(lambda: torch.ones(2, 3, device="cuda"), id="cuda-tensor",
                 marks=[pytest.mark.cuda,
                        pytest.mark.skipif(not torch.cuda.is_available(),
                                           reason="needs an NVIDIA GPU for a CUDA tensor")]),
])
def test_a_tensor_payload_journals_as_volatile_before_any_bytes_land(tmp_path, payload):
    manager = DurabilityManager(str(tmp_path), fsync_every=1)
    manager.record({"type": "job_init", "job": "j", "tasks": [0]})
    manager.record({"type": "pull", "job": "j", "worker": "master", "tasks": [0]})
    _idx, path = list_segments(str(tmp_path))[-1]
    before = os.path.getsize(path)
    manager.record({"type": "submit", "job": "j", "worker": "master", "task": 0,
                    "payload": payload()})
    manager.close()
    records = replay_journal(str(tmp_path)).records
    assert [r["lsn"] for r in records] == [1, 2, 3]
    assert records[-1]["payload"] is None
    # exactly one frame landed for the submit: the volatile one
    frame = json.dumps(records[-1], separators=(",", ":"), sort_keys=True).encode()
    assert os.path.getsize(path) == before + 8 + len(frame)
