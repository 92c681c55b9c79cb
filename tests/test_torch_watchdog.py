"""The port's watchdog, its store seams and the poison pardon held to the
JAX package's, decision for decision, on the CPU (scenarios after the
JAX package's tests/test_telemetry_watchdog.py):

- stragglers flagged at k x the rolling median with their breaker
  pushed to suspect, unflagged on recovery, bounded under worker churn;
- stalls after the quiet window, the timer reset by progress, and the
  speculative requeue through each package's own store: once a task,
  first result wins, the loser's time charged to `speculation` waste;
- the deadline sweep the watchdog drives;
- a poison quarantine pardons the workers its attempts charged, through
  the server's hook into the breaker.
"""

import asyncio
import threading

import pytest

from comfyui_distributed_tpu.jobs.store import JobStore as JaxJobStore
from comfyui_distributed_tpu.resilience.health import HealthRegistry as JaxHealth
from comfyui_distributed_tpu.telemetry import metrics as jmetrics
from comfyui_distributed_tpu.telemetry import usage as jusage
from comfyui_distributed_tpu.telemetry.watchdog import Watchdog as JaxWatchdog
from comfyui_distributed_tpu_torch.jobs.store import JobStore as PortJobStore
from comfyui_distributed_tpu_torch.resilience.health import HealthRegistry as PortHealth
from comfyui_distributed_tpu_torch.telemetry import metrics as tmetrics
from comfyui_distributed_tpu_torch.telemetry import usage as tusage
from comfyui_distributed_tpu_torch.telemetry.watchdog import Watchdog as PortWatchdog

SIDES = {
    "jax": (JaxJobStore, JaxHealth, JaxWatchdog, jmetrics, jusage),
    "port": (PortJobStore, PortHealth, PortWatchdog, tmetrics, tusage),
}


@pytest.fixture(autouse=True)
def fresh_telemetry(monkeypatch):
    for metrics, usage in ((jmetrics, jusage), (tmetrics, tusage)):
        monkeypatch.setattr(metrics, "_registry", None)
        usage._reset_usage_meter_for_tests()


class SteppingClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def both(scenario):
    return tuple(scenario(*SIDES[side]) for side in ("jax", "port"))


def _exposition(metrics, *prefixes):
    return [line for line in metrics.get_metrics_registry().render().splitlines()
            if line.startswith(prefixes)]


def _stragglers(store_cls, health_cls, watchdog_cls, metrics, _usage):
    health = health_cls()
    wd = watchdog_cls(health=health, clock=SteppingClock(), straggler_factor=4.0,
                      min_samples=3, window=8)
    wd.max_workers = 6
    out = [("empty", wd.check_stragglers())]
    feeds = [("fast1", [0.01] * 5), ("fast2", [0.012] * 5), ("slowish", [0.03] * 5),
             ("laggard", [0.1] * 5), ("two", [9.0] * 2)]
    for wid, values in feeds:
        for value in values:
            wd.record_latency(wid, value)
        out.append((wid, wd.check_stragglers(), health.state(wid).value))
    for _ in range(8):  # the laggard recovers: its window fills with fast tiles
        wd.record_latency("laggard", 0.01)
    out.append(("recovered", wd.check_stragglers(), sorted(wd._current_stragglers)))
    for i in range(10):  # worker-id churn evicts the oldest windows
        wd.record_latency(f"churn{i}", 0.01)
    out.append(("churn", list(wd._latencies), list(wd.stragglers_flagged)))
    out.append(("metrics", _exposition(metrics, "cdt_watchdog_stragglers_total",
                                       "cdt_worker_breaker")))
    return out


def test_stragglers_are_flagged_as_the_jax_watchdog_flags_them():
    jax_out, port_out = both(_stragglers)
    assert port_out == jax_out
    assert port_out[4][1:] == (["laggard"], "suspect")
    assert port_out[3][1:] == ([], "healthy")  # 3x the median is under k = 4


def _stalls(store_cls, health_cls, watchdog_cls, metrics, usage):
    """A job with tiles in flight goes quiet: the watchdog's pass (on this
    thread, as on its own) speculates through the store on the store's
    loop (another thread), as the server wires it."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def call(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(10)

    try:
        store = store_cls()
        call(store.init_tile_job("job-w", [0, 1, 2]))
        call(store.init_tile_job("done", [0]))
        call(store.pull_task("done", "w1", timeout=0.01))
        call(store.submit_result("done", "w1", 0, None))
        for wid in ("w1", "w2", "w2"):
            call(store.pull_task("job-w", wid, timeout=0.01))
        call(store.submit_result("job-w", "w2", 1, None))
        clock = SteppingClock()
        wd = watchdog_cls(store=store, clock=clock, stall_seconds=5.0,
                          speculate=lambda job_id: call(store.speculate_in_flight(job_id)))
        out = [("baseline", wd.check_stalls())]
        clock.now += 4.0
        call(store.submit_result("job-w", "w1", 0, None))  # progress
        out.append(("progress", wd.check_stalls()))
        clock.now += 4.9
        out.append(("quiet", wd.check_stalls()))
        clock.now += 0.2
        out.append(("stalled", wd.check_stalls(), dict(wd.speculated)))
        job = store.tile_jobs["job-w"]
        out.append(("queue", job.pending.qsize(), sorted(job.speculated),
                    call(store.speculate_in_flight("job-w"))))
        # the master takes the speculated copy and wins; the holder's late
        # submission drops as a duplicate and its time is waste
        task = call(store.pull_task("job-w", "master", timeout=0.01))
        out.append(("race", task, call(store.submit_result("job-w", "master", task, None)),
                    call(store.submit_result("job-w", "w2", task, None))))
        out.append(("waste", sorted(usage.get_usage_meter().totals()["waste_ns"])))
        clock.now += 20.0
        out.append(("again", wd.check_stalls(), wd.check_stalls(), dict(wd.speculated)))
        out.append(("tracked", sorted(wd._progress)))
        out.append(("metrics", _exposition(metrics, "cdt_watchdog_stalls_total",
                                           "cdt_store_requeued_tasks_total",
                                           "cdt_store_submits_total")))
        return out
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)


def test_stalls_speculate_through_each_store_as_the_jax_watchdog():
    jax_out, port_out = both(_stalls)
    assert port_out == jax_out
    stalled = port_out[3]
    assert stalled[1] == ["job-w"] and stalled[2] == {"job-w": [2]}
    assert port_out[4][3] == []  # a task is speculated once
    assert port_out[5][2:] == (True, False)  # first result wins
    assert port_out[6][1] == ["speculation"]


def _deadlines(store_cls, health_cls, watchdog_cls, metrics, _usage):
    async def run():
        store = store_cls()
        wd = watchdog_cls(store=store)
        await store.init_tile_job("soon", [0, 1], deadline_s=0.01)
        await store.init_tile_job("later", [0], deadline_s=3600.0)
        await asyncio.sleep(0.05)
        return await store.sweep_deadlines(), wd.store is store, sorted(
            (j, job.cancelled, job.cancel_reason) for j, job in store.tile_jobs.items())

    return asyncio.run(run())


def test_the_deadline_sweep_expires_overdue_jobs_as_the_jax_store():
    jax_out, port_out = both(_deadlines)
    assert port_out == jax_out
    assert port_out[0] == ["soon"]


def _pardon(store_cls, health_cls, watchdog_cls, metrics, _usage):
    """Two workers crash on the same tile; the tile exhausts its attempt
    budget, is quarantined, and both workers' breakers are pardoned
    through the hook (the server wires it to the breaker's `pardon`)."""

    async def run():
        health = health_cls(failure_threshold=2, suspect_threshold=1, cooldown_seconds=60.0)
        store = store_cls(max_attempts=2)
        store.poison_pardon = lambda wids: [health.pardon(w) for w in wids]
        await store.init_tile_job("job-p", [0])
        out = []
        for wid in ("w1", "w2"):
            task = await store.pull_task("job-p", wid, timeout=0.01)
            health.record_failure(wid)
            health.record_failure(wid)  # quarantined
            await asyncio.sleep(0.02)
            requeued = await store.requeue_timed_out("job-p", 0.01)
            out.append((wid, task, requeued, health.state(wid).value))
        job = store.tile_jobs["job-p"]
        out.append(("quarantined", sorted(job.quarantined_tiles), dict(job.attempts),
                    {w: health.state(w).value for w in ("w1", "w2")}))
        out.append(("metrics", _exposition(metrics, "cdt_poison_pardons_total",
                                           "cdt_poison_quarantined_tiles_total")))
        return out

    return asyncio.run(run())


def test_a_poison_tile_pardons_the_workers_it_charged_as_the_jax_store():
    jax_out, port_out = both(_pardon)
    assert port_out == jax_out
    assert port_out[2][1] == [0] and port_out[2][3] == {"w1": "healthy", "w2": "healthy"}
