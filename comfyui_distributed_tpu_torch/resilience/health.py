"""Per-worker health state machine and circuit breaker.

The port's own copy of comfyui_distributed_tpu/resilience/health.py::

            consecutive failures            cooldown elapsed
    HEALTHY ---------> SUSPECT ---------> QUARANTINED ---------> PROBING
       ^  ^              |    (threshold)      ^                  |   |
       |  '--success-----'                     '----probe fails---'   |
       |                                                              |
       '-------------------- RECOVERED <--------- probe succeeds -----'
                 (next success)

- HEALTHY, SUSPECT and RECOVERED workers are dispatchable.
- A QUARANTINED worker receives nothing until its cooldown elapses;
  `try_half_open` then admits exactly one probe (PROBING): the `/prompt`
  busy probe of worker selection. Its success re-admits the worker
  (RECOVERED), its failure re-opens the circuit with a fresh cooldown.
- Transition listeners run outside the registry's lock. Every
  transition counts in cdt_worker_breaker_transitions_total and is
  published on the event bus as ``health_transition``.

The thresholds are CDT_CIRCUIT_SUSPECT_AFTER, CDT_CIRCUIT_FAILURES and
CDT_CIRCUIT_COOLDOWN (utils/constants.py); the clock is injectable.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable, Optional

from ..utils import constants
from ..utils.logging import debug_log, log


class WorkerState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    QUARANTINED = "quarantined"
    PROBING = "probing"
    RECOVERED = "recovered"


_DISPATCHABLE = frozenset({WorkerState.HEALTHY, WorkerState.SUSPECT, WorkerState.RECOVERED})

TransitionListener = Callable[[str, WorkerState, WorkerState], None]


@dataclasses.dataclass
class WorkerHealth:
    worker_id: str
    state: WorkerState = WorkerState.HEALTHY
    consecutive_failures: int = 0
    total_failures: int = 0
    total_successes: int = 0
    last_failure: Optional[float] = None
    last_success: Optional[float] = None
    quarantined_at: Optional[float] = None
    probing_since: Optional[float] = None


class HealthRegistry:
    """Thread-safe circuit breaker over worker ids (dispatch runs on the
    server loop, the collector and elastic masters on threads)."""

    def __init__(self, failure_threshold: int | None = None,
                 suspect_threshold: int | None = None,
                 cooldown_seconds: float | None = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.failure_threshold = (failure_threshold if failure_threshold is not None
                                  else constants.CIRCUIT_FAILURE_THRESHOLD)
        self.suspect_threshold = (suspect_threshold if suspect_threshold is not None
                                  else constants.CIRCUIT_SUSPECT_THRESHOLD)
        self.cooldown_seconds = (cooldown_seconds if cooldown_seconds is not None
                                 else constants.CIRCUIT_COOLDOWN_SECONDS)
        self._clock = clock
        self._lock = threading.Lock()
        self._workers: dict[str, WorkerHealth] = {}
        self._listeners: list[TransitionListener] = []

    # --- listeners -------------------------------------------------------

    def add_listener(self, listener: TransitionListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def remove_listener(self, listener: TransitionListener) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def _fire(self, worker_id: str, old: WorkerState, new: WorkerState) -> None:
        """Count and publish the transition, then call the listeners,
        all outside the lock; listener errors are logged, never
        propagated into the transport path."""
        if old is new:
            return
        from ..telemetry import instruments
        from ..telemetry.events import get_event_bus

        instruments.breaker_transitions_total().inc(
            worker_id=worker_id, from_state=old.value, to_state=new.value)
        get_event_bus().publish("health_transition", worker_id=worker_id,
                                from_state=old.value, to_state=new.value)
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener(worker_id, old, new)
            except Exception as exc:  # noqa: BLE001 - observability only
                debug_log(f"health listener failed for {worker_id}: {exc}")

    # --- queries ---------------------------------------------------------

    def _ensure(self, worker_id: str) -> WorkerHealth:
        health = self._workers.get(worker_id)
        if health is None:
            health = self._workers[worker_id] = WorkerHealth(worker_id=worker_id)
        return health

    def state(self, worker_id: str) -> WorkerState:
        with self._lock:
            health = self._workers.get(worker_id)
            return health.state if health else WorkerState.HEALTHY

    def allow(self, worker_id: str) -> bool:
        """May this worker receive a prompt now? (PROBING is reserved for
        the one half-open probe.)"""
        return self.state(worker_id) in _DISPATCHABLE

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {wid: {"state": h.state.value,
                          "consecutive_failures": h.consecutive_failures,
                          "total_failures": h.total_failures,
                          "total_successes": h.total_successes,
                          "quarantined_at": h.quarantined_at}
                    for wid, h in self._workers.items()}

    # --- transitions -----------------------------------------------------

    def record_success(self, worker_id: str) -> WorkerState:
        with self._lock:
            health = self._ensure(worker_id)
            old = health.state
            health.consecutive_failures = 0
            health.total_successes += 1
            health.last_success = self._clock()
            if old in (WorkerState.PROBING, WorkerState.QUARANTINED):
                health.state = WorkerState.RECOVERED
                health.quarantined_at = None
            else:
                health.state = WorkerState.HEALTHY
            health.probing_since = None
            new = health.state
        if old in (WorkerState.PROBING, WorkerState.QUARANTINED):
            log(f"worker {worker_id} recovered; circuit closed")
        self._fire(worker_id, old, new)
        return new

    def record_failure(self, worker_id: str) -> WorkerState:
        with self._lock:
            health = self._ensure(worker_id)
            old = health.state
            health.consecutive_failures += 1
            health.total_failures += 1
            health.last_failure = self._clock()
            if old is WorkerState.PROBING:
                # the half-open probe failed: a fresh cooldown
                health.state = WorkerState.QUARANTINED
                health.quarantined_at = self._clock()
                health.probing_since = None
            elif health.consecutive_failures >= self.failure_threshold:
                health.state = WorkerState.QUARANTINED
                if health.quarantined_at is None:
                    health.quarantined_at = self._clock()
            elif (health.consecutive_failures >= self.suspect_threshold
                  and old is not WorkerState.QUARANTINED):
                health.state = WorkerState.SUSPECT
            new = health.state
            failures = health.consecutive_failures
        if new is WorkerState.QUARANTINED and old is not WorkerState.QUARANTINED:
            log(f"worker {worker_id} quarantined after {failures} consecutive failure(s); "
                f"circuit open for {self.cooldown_seconds:.0f}s")
        self._fire(worker_id, old, new)
        return new

    def mark_suspect(self, worker_id: str) -> WorkerState:
        """Degradation seen from outside (the watchdog's straggler
        verdict): a HEALTHY or RECOVERED worker becomes SUSPECT, its
        failure counters untouched (latency is not a transport failure
        and must not count toward quarantine). QUARANTINED and PROBING
        workers are left alone; a SUSPECT one is a no-op."""
        with self._lock:
            health = self._ensure(worker_id)
            old = health.state
            if old in (WorkerState.HEALTHY, WorkerState.RECOVERED):
                health.state = WorkerState.SUSPECT
            new = health.state
        if new is WorkerState.SUSPECT and old is not WorkerState.SUSPECT:
            log(f"worker {worker_id} marked suspect (watchdog straggler)")
        self._fire(worker_id, old, new)
        return new

    def pardon(self, worker_id: str) -> WorkerState:
        """Exonerate a worker whose failures traced to a poison tile (the
        payload was at fault, not the worker): its failure streak clears
        and it is HEALTHY at once, no cooldown, no probe; totals stay.
        The store's poison quarantine drives this through the server's
        `poison_pardon` hook, so one bad payload cannot quarantine
        worker after worker."""
        with self._lock:
            health = self._workers.get(worker_id)
            if health is None:
                return WorkerState.HEALTHY
            old = health.state
            health.consecutive_failures = 0
            health.quarantined_at = None
            health.probing_since = None
            health.state = WorkerState.HEALTHY
            new = health.state
        if old is not new:
            log(f"worker {worker_id} pardoned (poison tile); circuit closed")
        self._fire(worker_id, old, new)
        return new

    def try_half_open(self, worker_id: str) -> bool:
        """If quarantined and cooled down, move to PROBING and return True:
        the caller owns the one probe. A probe lease older than a cooldown
        is reclaimed, so a prober cancelled before recording its outcome
        cannot leave the worker in PROBING for good."""
        now = self._clock()
        with self._lock:
            health = self._workers.get(worker_id)
            if health is None:
                return False
            if health.state is WorkerState.PROBING:
                if health.probing_since is None or now - health.probing_since < self.cooldown_seconds:
                    return False
                health.probing_since = now
                debug_log(f"worker {worker_id}: stale probe lease reclaimed")
                return True
            if health.state is not WorkerState.QUARANTINED:
                return False
            if (health.quarantined_at is not None
                    and now - health.quarantined_at < self.cooldown_seconds):
                return False
            old = health.state
            health.state = WorkerState.PROBING
            health.probing_since = now
        debug_log(f"worker {worker_id} half-open: probing")
        self._fire(worker_id, old, WorkerState.PROBING)
        return True


_registry: HealthRegistry | None = None
_registry_lock = threading.Lock()


def get_health_registry() -> HealthRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = HealthRegistry()
        return _registry


def reset_health_registry() -> None:
    """Drop the process's registry (tests)."""
    global _registry
    with _registry_lock:
        _registry = None
