"""Cost-aware work placement: who pulls how much, and who sits out.

The port's own copy of comfyui_distributed_tpu/scheduler/placement.py.
The elastic tile queue is pull-based — workers claim work at their own
pace — which self-balances in the mean but wastes the tail: a slow or
suspect worker that claims one of the last tiles holds the whole job's
latency hostage (the straggler problem the watchdog *detects* after
the fact). This policy closes the loop *before* assignment:

- **throughput weights** — an EWMA over each worker's pull→submit tile
  latencies (the same stream the watchdog consumes; the JobStore's
  ``latency_sink`` fans out to both). A worker's *speed* is 1/EWMA,
  normalized against the fleet mean, so weights are self-calibrating
  across models and tile sizes;
- **size-aware batches** — ``batch_size`` scales a worker's pull batch
  with its relative speed (base x speed, clamped to
  [1, CDT_SCHED_MAX_PULL_BATCH]), replacing the fixed per-pull split:
  fast workers amortize RPC overhead over more tiles, slow workers
  stay at 1 so a requeue never orphans a big batch. A worker runs
  the tiles of a grant one after another (the tile pipeline is K = 1);
- **push grants** — ``notify_grants`` announces every refill of a
  job's pending queue as a ``grant_available`` event, so workers parked
  on /distributed/events pull at once (graph/usdu_elastic.py:
  GrantSignal);
- **tail trimming** — inside the last ``CDT_SCHED_TAIL_TILES`` pending
  tiles, workers that are SUSPECT/QUARANTINED in the health registry
  or slower than ``CDT_SCHED_TRIM_RATIO`` x the mean speed are denied
  pulls (their pull reads as drained), steering the job's tail to fast
  healthy participants. Exempt ids (the master) are never denied —
  someone must always be able to finish the job.

Thread-safe: ``record_latency`` arrives from the store's sink on
arbitrary threads; decisions run on the server loop.

Determinism: placement changes WHO computes a tile, never the result —
a tile's noise is drawn from its global index, so the output does not
depend on the assignment.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ..utils import constants

# Sanity ceiling on a worker's advertised chip count. The field rides
# an untrusted client RPC and multiplies the server-side grant cap
# (batch_size clamps to max_batch x capacity), so without a bound one
# bogus worker could be granted an entire job's queue in one pull.
# Real hosts top out well below this.
MAX_WORKER_DEVICES = 64

# Bound on distinct worker ids whose capacity is tracked (and persisted
# via export_state): capacity arrives on unauthenticated heartbeats, so
# a client cycling worker ids must not grow master memory or durability
# snapshots without limit. Far above any real fleet.
MAX_TRACKED_WORKERS = 1024


class PlacementPolicy:
    def __init__(
        self,
        health: Any = None,
        alpha: float | None = None,
        min_samples: int | None = None,
        base_batch: int | None = None,
        max_batch: int | None = None,
        tail_tiles: int | None = None,
        trim_ratio: float | None = None,
        exempt: tuple[str, ...] = ("master",),
        task_cost_flops: float | None = None,
    ) -> None:
        self.health = health
        self.alpha = alpha if alpha is not None else constants.SCHED_EWMA_ALPHA
        self.min_samples = (
            min_samples if min_samples is not None else constants.SCHED_MIN_SAMPLES
        )
        self.base_batch = (
            base_batch if base_batch is not None else constants.SCHED_BASE_PULL_BATCH
        )
        self.max_batch = (
            max_batch if max_batch is not None else constants.SCHED_MAX_PULL_BATCH
        )
        self.tail_tiles = (
            tail_tiles if tail_tiles is not None else constants.SCHED_TAIL_TILES
        )
        self.trim_ratio = (
            trim_ratio if trim_ratio is not None else constants.SCHED_TRIM_RATIO
        )
        self.exempt = frozenset(exempt)
        # One task's estimated FLOPs: informational in the snapshot
        # (the caller's estimate; None when it gave none).
        self.task_cost_flops = task_cost_flops
        self._lock = threading.Lock()
        self._ewma: dict[str, float] = {}
        self._samples: dict[str, int] = {}
        self._trimmed: dict[str, int] = {}
        # advertised chip counts (worker mesh data-axis width), fed by
        # the pull/heartbeat RPCs through JobStore.note_worker_capacity
        self._capacity: dict[str, int] = {}
        # Departed-worker seam: called (outside the lock) with every
        # worker id this policy forgets or evicts, so downstream
        # consumers keyed by worker id (the fleet registry's per-worker
        # series) drop their state in the same breath.
        self.on_forget: Optional[Any] = None

    # --- inputs -----------------------------------------------------------

    def record_latency(self, worker_id: str, seconds: float) -> None:
        """One completed task's pull→submit latency (JobStore sink)."""
        seconds = max(float(seconds), 1e-6)
        with self._lock:
            prev = self._ewma.get(worker_id)
            self._ewma[worker_id] = (
                seconds
                if prev is None
                else (1.0 - self.alpha) * prev + self.alpha * seconds
            )
            self._samples[worker_id] = self._samples.get(worker_id, 0) + 1

    def set_capacity(self, worker_id: str, devices: int) -> None:
        """Advertised grant capacity (chip count) for a worker — the
        data-axis width of its local mesh, carried on every pull and
        heartbeat. Scales the pull-batch ceiling and the cold-start
        grant size so a 4-chip worker pulls ~4x the tiles of a 1-chip
        worker at equal per-chip speed. Clamped to MAX_WORKER_DEVICES:
        the value originates in a client RPC and multiplies server-side
        grant caps, so it must never be unbounded."""
        devices = max(1, min(int(devices), MAX_WORKER_DEVICES))
        stale = None
        with self._lock:
            if (
                worker_id not in self._capacity
                and len(self._capacity) >= MAX_TRACKED_WORKERS
            ):
                # evict a worker with no latency history first (likely
                # garbage ids), else the oldest-tracked one
                stale = next(
                    (w for w in self._capacity if w not in self._ewma),
                    next(iter(self._capacity)),
                )
                self._capacity.pop(stale)
            self._capacity[worker_id] = devices
        if stale is not None:
            self._notify_forget(stale)

    def capacity(self, worker_id: str) -> int:
        with self._lock:
            return self._capacity.get(worker_id, 1)

    def forget(self, worker_id: str) -> None:
        with self._lock:
            self._ewma.pop(worker_id, None)
            self._samples.pop(worker_id, None)
            self._trimmed.pop(worker_id, None)
            self._capacity.pop(worker_id, None)
        self._notify_forget(worker_id)

    def _notify_forget(self, worker_id: str) -> None:
        hook = self.on_forget
        if hook is None:
            return
        try:
            hook(worker_id)
        except Exception:  # noqa: BLE001 - advisory fan-out only
            pass

    # --- model ------------------------------------------------------------

    def _speeds_locked(self) -> dict[str, float]:
        """worker → tiles/sec for workers with enough samples."""
        return {
            wid: 1.0 / ewma
            for wid, ewma in self._ewma.items()
            if self._samples.get(wid, 0) >= self.min_samples and ewma > 0
        }

    @staticmethod
    def _fleet_ratio(speeds: dict[str, float], worker_id: str) -> float:
        """``speeds[worker_id]`` relative to the fleet mean; 1.0 while
        this worker (or the fleet) lacks samples — unknown workers are
        assumed average, so cold-start behavior is exactly the old
        uniform pull."""
        mine = speeds.get(worker_id)
        if mine is None or not speeds:
            return 1.0
        mean = sum(speeds.values()) / len(speeds)
        if mean <= 0:
            return 1.0
        return mine / mean

    def speed_ratio(self, worker_id: str) -> float:
        """This worker's throughput relative to the fleet mean."""
        with self._lock:
            speeds = self._speeds_locked()
        return self._fleet_ratio(speeds, worker_id)

    def per_chip_ratio(self, worker_id: str) -> float:
        """Measured speed per advertised chip, normalized against the
        fleet's per-chip mean. This is the capacity-neutral quality
        signal: a 4-chip worker's amortized per-tile latency is ~4x
        smaller than an equal-chip 1-chip worker's, so raw throughput
        ratios would double-count capacity once `batch_size` multiplies
        by it — and the job tail (grants of one tile) runs on ONE chip,
        so tail trimming must compare chips, not fleets."""
        with self._lock:
            speeds = self._speeds_locked()
            caps = dict(self._capacity)
        per_chip = {
            wid: speed / max(1, caps.get(wid, 1))
            for wid, speed in speeds.items()
        }
        return self._fleet_ratio(per_chip, worker_id)

    # --- decisions --------------------------------------------------------

    def batch_size(self, worker_id: str, remaining: int) -> int:
        """How many tasks this worker's pull may claim at once.

        Sizes are aligned DOWN to a power of two, as the JAX
        package's are (there a grant lands on a compiled tile-batch
        shape; here a worker runs the grant's tiles one after another,
        so the alignment only keeps grants equal to the JAX master's).

        Advertised capacity multiplies both the sized grant and its
        ceiling: a D-chip worker's per-chip speed ratio x base_batch x
        D, clamped to max_batch x D — so a 4-chip worker pulls 4x the
        tiles of an equal-per-chip-speed 1-chip worker from its very
        first grant (the capacity is advertised before any latency
        sample exists), and the measured per-chip ratio then corrects
        for actual chip quality without double-counting capacity.
        """
        if remaining <= 0:
            return 1
        if remaining <= self.tail_tiles:
            return 1  # tail tiles are precious: no batch hoarding
        cap = self.capacity(worker_id)
        ratio = self.per_chip_ratio(worker_id)
        size = max(
            1,
            min(
                int(round(ratio * self.base_batch * cap)),
                self.max_batch * cap,
            ),
        )
        aligned = 1
        while aligned * 2 <= size:
            aligned *= 2
        return min(aligned, remaining)

    def _health_state(self, worker_id: str) -> Optional[str]:
        if self.health is None:
            return None
        try:
            state = self.health.state(worker_id)
        except Exception:  # noqa: BLE001 - advisory only
            return None
        return getattr(state, "value", state)

    def may_pull(self, worker_id: str, remaining: int) -> bool:
        """False = this pull reads as drained (the worker finishes its
        in-flight work and exits). Only ever False in the job tail, and
        never for exempt participants."""
        if worker_id in self.exempt:
            return True
        if remaining <= 0 or remaining > self.tail_tiles:
            return True
        state = self._health_state(worker_id)
        if state in ("suspect", "quarantined", "probing"):
            self._note_trim(worker_id)
            return False
        # per-chip, not throughput: a tail grant is one tile on one
        # chip, so chip quality decides who should run it (a slow
        # 4-chip worker must not hide behind its aggregate throughput)
        if self.per_chip_ratio(worker_id) < self.trim_ratio:
            self._note_trim(worker_id)
            return False
        return True

    def _note_trim(self, worker_id: str) -> None:
        with self._lock:
            self._trimmed[worker_id] = self._trimmed.get(worker_id, 0) + 1

    # --- exported state ----------------------------------------------------

    def export_state(self) -> dict:
        """Per-worker speed model (EWMA + sample counts) for the
        control-plane snapshot: a restarted master places work with
        learned weights immediately instead of re-learning the fleet
        from uniform cold start."""
        with self._lock:
            return {
                "ewma": {w: round(v, 9) for w, v in self._ewma.items()},
                "samples": dict(self._samples),
                "capacity": dict(self._capacity),
            }

    def restore_state(self, state: dict) -> None:
        with self._lock:
            for worker_id, value in (state.get("ewma") or {}).items():
                try:
                    if float(value) > 0:
                        self._ewma[str(worker_id)] = float(value)
                except (TypeError, ValueError):
                    continue
            for worker_id, count in (state.get("samples") or {}).items():
                try:
                    self._samples[str(worker_id)] = int(count)
                except (TypeError, ValueError):
                    continue
            for worker_id, devices in (state.get("capacity") or {}).items():
                if len(self._capacity) >= MAX_TRACKED_WORKERS:
                    break
                try:
                    self._capacity[str(worker_id)] = max(
                        1, min(int(devices), MAX_WORKER_DEVICES)
                    )
                except (TypeError, ValueError):
                    continue

    # --- observability ----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            ewma = dict(self._ewma)
            samples = dict(self._samples)
            trimmed = dict(self._trimmed)
            capacity = dict(self._capacity)
            speeds = self._speeds_locked()
        mean = sum(speeds.values()) / len(speeds) if speeds else 0.0
        return {
            "workers": {
                wid: {
                    "ewma_tile_seconds": (
                        round(ewma[wid], 6) if wid in ewma else None
                    ),
                    "samples": samples.get(wid, 0),
                    "speed_ratio": (
                        round(speeds[wid] / mean, 4)
                        if wid in speeds and mean > 0
                        else None
                    ),
                    "tail_trims": trimmed.get(wid, 0),
                    "devices": capacity.get(wid, 1),
                }
                for wid in sorted(set(ewma) | set(capacity))
            },
            "base_batch": self.base_batch,
            "max_batch": self.max_batch,
            "tail_tiles": self.tail_tiles,
            "trim_ratio": self.trim_ratio,
            "task_cost_flops": self.task_cost_flops,
        }

    def weights(self) -> dict[str, float]:
        """worker → speed ratio (mean-normalized); status endpoints."""
        with self._lock:
            speeds = self._speeds_locked()
        if not speeds:
            return {}
        mean = sum(speeds.values()) / len(speeds)
        return {wid: round(s / mean, 4) for wid, s in sorted(speeds.items())}

    # --- push-mode grants (CDT_PUSH_GRANTS) -------------------------------

    def notify_grants(self, job_id: str, count: int) -> None:
        """Announce that `count` tasks just became pullable on `job_id`: a
        `grant_available` event on the process bus, counted in
        cdt_push_grants_total. The JobStore fires it on every refill of a
        job's pending queue (creation, a timeout or quarantine requeue, a
        release, a lifted preemption, speculation). Never blocks: the bus
        is lock-light and a no-op without subscribers; a count of 0 is
        ignored."""
        from ..telemetry import instruments
        from ..telemetry.events import get_event_bus

        count = max(0, int(count))
        if count == 0:
            return
        instruments.push_grants_total().inc(count)
        get_event_bus().publish("grant_available", job_id=job_id, tasks=count)
