"""Brownout: progressive load shedding above the admission lanes.

The port's own copy of comfyui_distributed_tpu/scheduler/brownout.py.
A master with CDT_JOURNAL_DIR feeds its journal window from the
DurabilityManager's appends (api/server.py), under the threshold
CDT_SHED_JOURNAL_P95; without a journal the window stays unfed and
reads 0, as on a JAX master without one. The failure the controller
prevents: under sustained overload the admission queue keeps accepting
work into every lane, queue waits climb unboundedly, the journal fsync path saturates, and the master
tips over for EVERYONE — premium tenants included. The brownout
controller watches two leading indicators —

- **queue-wait p95**: seconds recently-granted requests spent queued
  (fed by ``AdmissionQueue`` on every grant);
- **journal-append p95**: seconds recent write-ahead appends took
  (fed by the ``DurabilityManager`` when journaling is enabled);

— and, when either crosses its threshold, sheds one more
lowest-priority lane: requests for shed lanes are rejected at
admission with HTTP 429 + Retry-After (``cdt_shed_total``), *before*
they consume queue depth, grant slots, or journal bandwidth. The top
(premium) lane is never shed — brownout degrades the cheap lanes to
keep the premium lane's grant latency bounded. Levels step at most
once per ``CDT_SHED_COOLDOWN`` and step back down once BOTH signals
fall under half their thresholds (hysteresis, so a noisy boundary
doesn't flap admission).

Everything is injectable (clock, thresholds, window) so tests drive
the whole ladder on a fake timeline.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional, Sequence

from ..telemetry import instruments
from ..telemetry.events import get_event_bus
from ..utils import constants
from ..utils.logging import log

def _p95(samples: Sequence[float]) -> float:
    if not samples:
        return 0.0
    ordered = sorted(samples)
    index = min(len(ordered) - 1, max(0, int(0.95 * len(ordered))))
    return ordered[index]


class BrownoutController:
    """Progressive lane shedding driven by wait/journal p95 windows.

    ``lane_order`` is the admission queue's strict priority order
    (highest first); level k sheds the k LOWEST-priority lanes. The
    controller is called from the server loop (admission path) and fed
    from the loop (grants) plus the journal seam — a lock keeps the
    windows coherent for the occasional off-loop feeder.
    """

    def __init__(
        self,
        lane_order: Sequence[str],
        wait_p95_threshold: Optional[float] = None,
        journal_p95_threshold: Optional[float] = None,
        window: Optional[int] = None,
        cooldown: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.lane_order = list(lane_order)
        self.wait_p95_threshold = (
            wait_p95_threshold
            if wait_p95_threshold is not None
            else constants.SHED_WAIT_P95_SECONDS
        )
        self.journal_p95_threshold = (
            journal_p95_threshold
            if journal_p95_threshold is not None
            else constants.SHED_JOURNAL_P95_SECONDS
        )
        window = window if window is not None else constants.SHED_WINDOW_SAMPLES
        self.cooldown = (
            cooldown if cooldown is not None else constants.SHED_COOLDOWN_SECONDS
        )
        self.clock = clock
        self._lock = threading.Lock()
        self._waits: collections.deque = collections.deque(maxlen=max(1, window))
        self._journal: collections.deque = collections.deque(
            maxlen=max(1, window)
        )
        self.level = 0
        self._last_step = -float("inf")
        # monotonic time of the newest sample on either window: when a
        # shed system goes quiet (shedding IS why no samples arrive),
        # the stale p95 must not latch the level forever
        self._last_signal: Optional[float] = None
        self.shed_counts: dict[str, int] = {}
        # Step-level eviction seam (CDT_PREEMPT_BROWNOUT_LEVEL): fired
        # with (level, shed_lanes) on EVERY level change — a rise lets
        # the preemption coordinator evict RUNNING work from shed
        # lanes, and a drop lets it LIFT the brownout flags it raised
        # so the evicted work resumes. Advisory; must never raise into
        # the admission path.
        self.preempt_hook: Optional[Callable[[int, list[str]], None]] = None

    # --- signal feeds -----------------------------------------------------

    def note_queue_wait(self, seconds: float) -> None:
        """One granted request's queue wait (AdmissionQueue.wait_sink)."""
        with self._lock:
            self._waits.append(float(seconds))
            self._last_signal = self.clock()

    def note_journal_append(self, seconds: float) -> None:
        """One write-ahead append's latency (DurabilityManager sink)."""
        with self._lock:
            self._journal.append(float(seconds))
            self._last_signal = self.clock()

    # --- the ladder -------------------------------------------------------

    def signals(self) -> dict:
        with self._lock:
            wait_p95 = _p95(self._waits)
            journal_p95 = _p95(self._journal)
        return {"wait_p95": wait_p95, "journal_p95": journal_p95}

    def evaluate(self) -> int:
        """Recompute the shed level (hysteresis + cooldown); returns
        the current level. Cheap enough to run on every admission."""
        sig = self.signals()
        now = self.clock()
        overloaded = (
            sig["wait_p95"] > self.wait_p95_threshold
            or sig["journal_p95"] > self.journal_p95_threshold
        )
        recovered = (
            sig["wait_p95"] < self.wait_p95_threshold / 2.0
            and sig["journal_p95"] < self.journal_p95_threshold / 2.0
        )
        # Signal starvation while shedding: the windows only refresh on
        # grants/appends, and shedding is exactly what stops those. If
        # nothing has fed the controller for 2x the cooldown, the stale
        # overload reading must decay (and its samples drop) so shed
        # clients get a probe chance — persistent overload will simply
        # re-shed on the next real samples.
        with self._lock:
            starved = (
                self.level > 0
                and self._last_signal is not None
                and now - self._last_signal > 2.0 * self.cooldown
            )
            if starved:
                self._waits.clear()
                self._journal.clear()
                self._last_signal = now
        if starved:
            overloaded = False
            recovered = True
            sig = {"wait_p95": 0.0, "journal_p95": 0.0}
        max_level = max(0, len(self.lane_order) - 1)
        step = 0
        if overloaded and self.level < max_level:
            step = 1
        elif recovered and self.level > 0:
            step = -1
        if step and now - self._last_step >= self.cooldown:
            self.level += step
            self._last_step = now
            instruments.brownout_level().set(self.level)
            get_event_bus().publish(
                "brownout_level",
                level=self.level,
                direction="up" if step > 0 else "down",
                wait_p95=round(sig["wait_p95"], 4),
                journal_p95=round(sig["journal_p95"], 4),
                shed_lanes=self.shed_lanes(),
            )
            log(
                f"brownout level {'raised' if step > 0 else 'lowered'} to "
                f"{self.level} (wait p95 {sig['wait_p95']:.2f}s, journal "
                f"p95 {sig['journal_p95']:.3f}s); shedding "
                f"{self.shed_lanes() or 'nothing'}"
            )
            if self.preempt_hook is not None:
                try:
                    self.preempt_hook(self.level, self.shed_lanes())
                except Exception:  # noqa: BLE001 - eviction is advisory
                    pass
        return self.level

    def shed_lanes(self) -> list[str]:
        if self.level <= 0:
            return []
        return self.lane_order[-self.level:]

    def should_shed(self, lane: str) -> bool:
        """Admission-path gate: evaluate the ladder, then answer
        whether this lane is currently shed. The premium (first) lane
        never sheds, whatever the level."""
        level = self.evaluate()
        if level <= 0 or lane == self.lane_order[0]:
            return False
        return lane in self.lane_order[-level:]

    def record_shed(self, lane: str) -> None:
        """One rejected admission (the caller answered 429)."""
        self.shed_counts[lane] = self.shed_counts.get(lane, 0) + 1
        instruments.shed_total().inc(lane=lane)
        get_event_bus().publish("shed", lane=lane, level=self.level)

    # --- observability ----------------------------------------------------

    def snapshot(self) -> dict:
        sig = self.signals()
        return {
            "level": self.level,
            "shed_lanes": self.shed_lanes(),
            "shed_counts": dict(self.shed_counts),
            "wait_p95_seconds": round(sig["wait_p95"], 4),
            "journal_p95_seconds": round(sig["journal_p95"], 4),
            "wait_p95_threshold": self.wait_p95_threshold,
            "journal_p95_threshold": self.journal_p95_threshold,
            "cooldown_seconds": self.cooldown,
        }
