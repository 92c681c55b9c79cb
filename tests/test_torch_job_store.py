"""The port's JobStore against the JAX package's: one scripted sequence
(init 6 tiles, pulls by two workers, a duplicate submit, a heartbeat, a
busy-probe grace, a timed-out requeue, release_tasks, cancel) must give
the same grants, results and lifecycle on both. Plus what only the
port's store keeps: the per-tile participant record.
"""

import asyncio
import time

import pytest

from comfyui_distributed_tpu.jobs import JobStore as JaxJobStore
from comfyui_distributed_tpu_torch.jobs import JobStore
from comfyui_distributed_tpu_torch.utils.exceptions import JobQueueError

POLL = 0.02


async def _script(store):
    """Every observable answer of the store, in order."""
    out = []
    step = out.append
    job = await store.init_tile_job("j", list(range(6)))
    step(("init", job.total_tasks, store.tile_jobs["j"].pending.qsize()))
    step(("pull w1", await store.pull_task("j", "w1", timeout=POLL)))
    step(("pull w2", await store.pull_task("j", "w2", timeout=POLL)))
    step(("pull w1", await store.pull_task("j", "w1", timeout=POLL)))
    step(("submit w1 0", await store.submit_result("j", "w1", 0, "r0")))
    step(("duplicate w2 0", await store.submit_result("j", "w2", 0, "r0-late")))
    step(("heartbeat w2", await store.heartbeat("j", "w2")))
    step(("heartbeat unknown", await store.heartbeat("nope", "w2")))
    # both workers go stale; the probe finds w2 busy (grace), w1 dead
    for wid in ("w1", "w2"):
        job.worker_status[wid] -= 100.0
    probed = []

    async def probe_busy(worker_id):
        probed.append(worker_id)
        return worker_id == "w2"

    step(("requeue", await store.requeue_timed_out("j", 10.0, probe_busy)))
    step(("probed", sorted(probed)))
    step(("w2 beat refreshed", time.monotonic() - job.worker_status["w2"] < 10.0))
    step(("remaining", await store.remaining("j")))
    step(("pull w2", await store.pull_task("j", "w2", timeout=POLL)))
    step(("release w2", await store.release_tasks("j", "w2", [1, 3, 5])))
    step(("release again", await store.release_tasks("j", "w2", [1])))
    step(("pulls", [await store.pull_task("j", "w1", timeout=POLL) for _ in range(2)]))
    step(("flush", await store.submit_flush("j", "w1", {4: "r4", 5: "r5"})))
    step(("complete", await store.is_complete("j")))
    step(("lifecycle", await store.job_lifecycle("j")))
    await store.mark_worker_done("j", "w1")
    step(("finished", sorted(job.finished_workers)))
    step(("cancel", await store.cancel_job("j", reason="client")))
    step(("cancel again", await store.cancel_job("j")))
    step(("pull after cancel", await store.pull_task("j", "w1", timeout=POLL)))
    step(("submit after cancel", await store.submit_result("j", "w1", 2, "r2")))
    step(("release after cancel", await store.release_tasks("j", "w2", [2])))
    step(("lifecycle", await store.job_lifecycle("j")))
    results = []
    while not job.results.empty():
        results.append(job.results.get_nowait())
    step(("results", results))
    step(("completed", dict(sorted(job.completed.items()))))
    await store.cleanup_tile_job("j")
    step(("after cleanup", await store.get_tile_job("j"), await store.remaining("j")))
    return out


def test_store_sequence_matches_the_jax_store():
    jax_out = asyncio.run(_script(JaxJobStore()))
    port_out = asyncio.run(_script(JobStore()))
    assert [name for name, *_ in port_out] == [name for name, *_ in jax_out]
    for jax_step, port_step in zip(jax_out, port_out):
        assert port_step == jax_step
    # the script exercised what it claims to
    answers = {name: answer for name, answer, *_ in port_out}
    assert answers["duplicate w2 0"] is False and answers["requeue"] == [2]
    assert answers["release w2"] == [1, 3]


def _sequence_with_poison(store_cls):
    async def run():
        store = store_cls(max_attempts=2)
        job = await store.init_tile_job("p", [0])
        seen = []
        for _ in range(2):
            tid = await store.pull_task("p", "w", timeout=POLL)
            job.worker_status["w"] -= 100.0
            seen.append((tid, await store.requeue_timed_out("p", 1.0)))
        seen.append(await store.job_lifecycle("p"))
        seen.append(await store.is_complete("p"))
        seen.append(await store.pull_task("p", "m", timeout=POLL))
        return seen

    return asyncio.run(run())


def test_attempt_budget_quarantines_like_the_jax_store():
    port = _sequence_with_poison(JobStore)
    assert port == _sequence_with_poison(JaxJobStore)
    assert port[2]["quarantined"] == [0]


def test_deadlines_expire_like_the_jax_store():
    async def run(store_cls):
        store = store_cls()
        store.note_job_deadline("d", 0.05)
        store.note_job_deadline("bad", "soon")
        job = await store.init_tile_job("d", [0, 1, 2])
        first = await store.pull_task("d", "w", timeout=POLL)
        await asyncio.sleep(0.08)
        expired = await store.sweep_deadlines()
        return first, expired, await store.job_lifecycle("d"), job.deadline_s

    port, jax_ = asyncio.run(run(JobStore)), asyncio.run(run(JaxJobStore))
    for p, j in zip(port[:2] + port[3:], jax_[:2] + jax_[3:]):
        assert p == j
    for key in ("cancelled", "cancel_reason", "quarantined", "deadline_s", "deadline_remaining"):
        assert port[2][key] == jax_[2][key]
    assert port[1] == ["d"] and port[2]["cancel_reason"] == "deadline"


def test_store_records_each_tiles_participant_and_archives_it():
    async def run():
        store = JobStore()
        await store.init_tile_job("a", [0, 1, 2])
        for wid in ("w1", "master", "w1"):
            tid = await store.pull_task("a", wid, timeout=POLL)
            await store.submit_flush("a", wid, {tid: None}, received_bytes=10)
        await store.submit_result("a", "master", 0, None)  # a late duplicate
        await store.mark_worker_done("a", "w1")
        await store.cleanup_tile_job("a")
        with pytest.raises(JobQueueError):
            await store.pull_task("a", "w1")
        return store.finished["a"]

    record = asyncio.run(run())
    assert record == {
        "total": 3,
        "cached": [],
        "adapters": [],
        "completions": [(0, "w1"), (1, "master"), (2, "w1")],
        "duplicates": 1,
        "received_bytes": 30,
        "finished_workers": ["w1"],
    }


def test_a_pull_before_the_job_exists_parks_until_init():
    async def run():
        store = JobStore()

        async def late_init():
            await asyncio.sleep(0.05)
            await store.init_tile_job("late", [7])

        waiter = asyncio.ensure_future(store.wait_for_tile_job("late", 5.0))
        await late_init()
        job = await asyncio.wait_for(waiter, 5.0)
        missing = await store.wait_for_tile_job("never", 0.05)
        return job.total_tasks, missing, store._tile_waiters

    assert asyncio.run(run()) == (1, None, {})
