"""Straggler & stall watchdog: tail-latency detection that ACTS.

The port's own copy of comfyui_distributed_tpu/telemetry/watchdog.py.
The circuit breaker reacts to transport failures and the telemetry
makes latency visible, but a worker that silently slows to 10x the
median latency fails neither transport nor heartbeat. This monitor
closes that loop, MapReduce's speculative execution on the elastic
tile queue:

- **stragglers** — per-worker pull→submit tile latencies (fed by
  `JobStore.submit_result` through ``latency_sink``, mirrored into the
  ``cdt_worker_tile_seconds`` histogram) are kept in rolling windows; a
  worker whose rolling MEDIAN exceeds ``straggler_factor`` x the global
  rolling median (with at least ``min_samples`` completions) is flagged
  and pushed into the `HealthRegistry` as SUSPECT (`mark_suspect`), so
  dispatch-side policy and the control panel see it immediately;
- **stalls** — a tile job whose completion count stops moving for
  ``stall_seconds`` while tasks are still in flight is stalled (a
  straggler or silent loss is sitting on the tail); the watchdog
  **speculatively re-enqueues** the in-flight tail tiles through the
  existing requeue path (`JobStore.speculate_in_flight`). First result
  wins: duplicate submissions are already dropped by the store, and
  per-tile noise keys fold the global tile index, so whichever
  participant finishes first produces the bit-identical tile.

Everything is deterministic-testable: the clock is injectable, `step()`
runs one detection pass synchronously (tests drive it under a fake
stepping clock), and `start()`/`stop()` wrap the same step in a daemon
thread (`DistributedServer.start`); the thread waits on an event that
`stop()` sets, so a stop never sleeps out an interval. Tuning knobs
are the ``CDT_WATCHDOG_*`` env vars (utils/constants.py); verdicts are
published on the event bus (``straggler_detected`` / ``stall_detected``
/ ``speculative_requeue``) and counted by the ``cdt_watchdog_*``
instruments.
"""

from __future__ import annotations

import collections
import statistics
import threading
import time
from typing import Any, Callable, Optional

from ..utils import constants
from ..utils.logging import debug_log, log
from . import instruments
from .events import get_event_bus


class Watchdog:
    """Background straggler/stall monitor over one JobStore.

    `store` and `health` are optional so unit tests can drive the
    latency logic alone; `speculate` overrides how a stalled job's
    in-flight tail is re-enqueued (the default round-trips through the
    server loop, the only place JobStore asyncio state may be touched).
    """

    def __init__(
        self,
        store: Any = None,
        health: Any = None,
        clock: Callable[[], float] = time.monotonic,
        straggler_factor: float | None = None,
        min_samples: int | None = None,
        stall_seconds: float | None = None,
        interval: float | None = None,
        window: int | None = None,
        speculate: Optional[Callable[[str], list]] = None,
    ) -> None:
        self.store = store
        self.health = health
        self.clock = clock
        self.straggler_factor = (
            straggler_factor
            if straggler_factor is not None
            else constants.WATCHDOG_STRAGGLER_FACTOR
        )
        self.min_samples = (
            min_samples if min_samples is not None else constants.WATCHDOG_MIN_SAMPLES
        )
        self.stall_seconds = (
            stall_seconds
            if stall_seconds is not None
            else constants.WATCHDOG_STALL_SECONDS
        )
        self.interval = (
            interval if interval is not None else constants.WATCHDOG_INTERVAL_SECONDS
        )
        self.window = window if window is not None else constants.WATCHDOG_LATENCY_WINDOW
        self._speculate = speculate or self._speculate_via_server_loop

        self._lock = threading.Lock()
        # worker_id → rolling latency window; LRU-bounded so worker-id
        # churn (ephemeral pods, hostile ids on the open RPC surface)
        # can't grow the dict — the same storm the metrics registry
        # caps with CDT_METRIC_MAX_SERIES.
        self.max_workers = 256
        self._latencies: "collections.OrderedDict[str, collections.deque]" = (
            collections.OrderedDict()
        )
        # job_id → ((completed, pending, in_flight), last-change time)
        self._progress: dict[str, tuple[tuple[int, int, int], float]] = {}
        self._current_stragglers: set[str] = set()
        # Verdict history (tests and chip_smoke.py read these);
        # bounded — a weeks-long master with a flapping straggler must
        # not grow these (the cdt_watchdog_*_total counters carry the
        # unbounded tallies).
        self.stragglers_flagged: collections.deque = collections.deque(maxlen=256)
        self.stalls_detected: collections.deque = collections.deque(maxlen=256)
        self.speculated: dict[str, list[int]] = {}
        self._max_speculated_jobs = 64

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- inputs -----------------------------------------------------------

    def record_latency(self, worker_id: str, seconds: float) -> None:
        """One completed tile's pull→submit latency (JobStore's
        ``latency_sink``; callable from any thread)."""
        with self._lock:
            window = self._latencies.get(worker_id)
            if window is None:
                window = collections.deque(maxlen=self.window)
                self._latencies[worker_id] = window
                while len(self._latencies) > self.max_workers:
                    evicted, _ = self._latencies.popitem(last=False)
                    self._current_stragglers.discard(evicted)
            else:
                self._latencies.move_to_end(worker_id)
            window.append(float(seconds))

    # --- detection --------------------------------------------------------

    def check_stragglers(self) -> list[str]:
        """Flag workers whose rolling-median tile latency exceeds
        k x the global rolling median; returns the NEWLY flagged ids.
        A worker whose median falls back under the bar is silently
        unflagged here (its breaker state recovers through its own
        successes, not through the watchdog)."""
        with self._lock:
            snapshot = {w: list(d) for w, d in self._latencies.items()}
        all_latencies = [v for window in snapshot.values() for v in window]
        if not all_latencies:
            return []
        global_median = statistics.median(all_latencies)
        if global_median <= 0:
            return []
        newly_flagged: list[str] = []
        for worker_id, window in sorted(snapshot.items()):
            if len(window) < self.min_samples:
                continue
            worker_median = statistics.median(window)
            if worker_median > self.straggler_factor * global_median:
                if worker_id in self._current_stragglers:
                    continue
                self._current_stragglers.add(worker_id)
                self.stragglers_flagged.append(worker_id)
                newly_flagged.append(worker_id)
                instruments.watchdog_stragglers_total().inc(worker_id=worker_id)
                get_event_bus().publish(
                    "straggler_detected",
                    worker_id=worker_id,
                    median_seconds=worker_median,
                    global_median_seconds=global_median,
                    factor=self.straggler_factor,
                )
                log(
                    f"watchdog: worker {worker_id} is a straggler "
                    f"(median {worker_median:.3f}s vs global "
                    f"{global_median:.3f}s, k={self.straggler_factor:g}); "
                    "marking suspect"
                )
                if self.health is not None:
                    try:
                        self.health.mark_suspect(worker_id)
                    except Exception as exc:  # noqa: BLE001 - observability only
                        debug_log(f"watchdog mark_suspect({worker_id}): {exc}")
            else:
                self._current_stragglers.discard(worker_id)
        return newly_flagged

    def check_stalls(self) -> list[str]:
        """Detect jobs with in-flight tasks but no completion progress
        for `stall_seconds`; speculatively re-enqueue their in-flight
        tail. Returns the job ids that stalled THIS pass."""
        if self.store is None:
            return []
        now = self.clock()
        stalled: list[str] = []
        # best-effort unlocked iteration, same contract as
        # JobStore.stats_unlocked: counts may be one mutation stale
        jobs = dict(self.store.tile_jobs)
        for job_id in list(self._progress):
            if job_id not in jobs:
                del self._progress[job_id]
        for job_id, job in jobs.items():
            completed = len(job.completed)
            if completed >= job.total_tasks:
                self._progress.pop(job_id, None)
                continue
            stats = self.store.tile_job_stats(job)
            snap = (completed, stats["pending"], stats["in_flight"])
            prev = self._progress.get(job_id)
            if prev is None or prev[0] != snap:
                self._progress[job_id] = (snap, now)
                continue
            if now - prev[1] < self.stall_seconds:
                continue
            # quiet for the whole window: restart the timer either way
            self._progress[job_id] = (snap, now)
            if stats["in_flight"] <= 0:
                continue  # nothing to speculate; heartbeat timeout owns this
            stalled.append(job_id)
            self.stalls_detected.append(job_id)
            instruments.watchdog_stalls_total().inc()
            get_event_bus().publish(
                "stall_detected",
                job_id=job_id,
                quiet_seconds=now - prev[1],
                in_flight=stats["in_flight"],
            )
            try:
                task_ids = list(self._speculate(job_id))
            except Exception as exc:  # noqa: BLE001 - recovery is best effort
                log(f"watchdog: speculative requeue for {job_id} failed: {exc}")
                continue
            if task_ids:
                self.speculated.setdefault(job_id, []).extend(task_ids)
                while len(self.speculated) > self._max_speculated_jobs:
                    self.speculated.pop(next(iter(self.speculated)))
                log(
                    f"watchdog: job {job_id} stalled "
                    f"{now - prev[1]:.1f}s; speculatively re-enqueued "
                    f"{len(task_ids)} in-flight tile(s)"
                )
        return stalled

    def check_deadlines(self) -> list[str]:
        """Drive the store's deadline sweep: jobs whose end-to-end
        deadline passed are cancelled (reason="deadline") even when no
        pull traffic is left to trigger the lazy path. Returns the job
        ids expired by this pass."""
        store = self.store
        if store is None or not hasattr(store, "sweep_deadlines"):
            return []
        # cheap unlocked guard: don't round-trip the server loop unless
        # some live job actually carries a deadline
        if not any(
            getattr(job, "deadline_at", None) is not None
            for job in dict(store.tile_jobs).values()
        ):
            return []
        try:
            from ..utils.async_helpers import run_async_in_server_loop

            return run_async_in_server_loop(store.sweep_deadlines(), timeout=30)
        except Exception as exc:  # noqa: BLE001 - sweep is best effort
            debug_log(f"watchdog deadline sweep failed: {exc}")
            return []

    def step(self) -> dict[str, list]:
        """One synchronous detection pass (the thread loop body; tests
        call it directly under a fake clock)."""
        return {
            "stragglers": self.check_stragglers(),
            "stalls": self.check_stalls(),
            "deadlines": self.check_deadlines(),
        }

    # --- default speculation path -----------------------------------------

    def _speculate_via_server_loop(self, job_id: str) -> list[int]:
        from ..utils.async_helpers import run_async_in_server_loop

        return run_async_in_server_loop(
            self.store.speculate_in_flight(job_id), timeout=30
        )

    # --- thread lifecycle -------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(self.interval):
                try:
                    self.step()
                except Exception as exc:  # noqa: BLE001 - monitor must survive
                    debug_log(f"watchdog step failed: {exc}")

        self._thread = threading.Thread(target=run, name="cdt-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # final pass so verdicts for work that completed between the
        # last tick and shutdown are still recorded
        try:
            self.check_stragglers()
        except Exception as exc:  # noqa: BLE001
            debug_log(f"watchdog final pass failed: {exc}")
