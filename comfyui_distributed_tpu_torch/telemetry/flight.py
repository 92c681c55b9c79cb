"""The flight recorder: the black box an incident bundle reads.

The port's own copy of comfyui_distributed_tpu/telemetry/flight.py. By
the time an alert fires, the bus frames before it went to the connected
subscribers only and the spans may have aged out of the tracer's
retention. The recorder keeps the last window of every event in memory,
all the time, so the incident manager (telemetry/incidents.py) can take
a snapshot after a trigger that still holds what came before it.

- A synchronous `EventBus` tap (`EventBus.add_tap`) receives every
  published event inline, on the publishing thread, and appends it to a
  bounded drop-oldest ring. `span_close` frames go to a ring of their
  own, so a flood of metric deltas cannot evict the span history.
- Each ring is a `collections.deque(maxlen=...)` under its own lock,
  with plain-int append and drop counters. `cdt_flight_dropped_total
  {stream}` mirrors the drops at scrape time
  (telemetry/instruments.py); the tap itself never touches a metric,
  which would publish again from inside the publish.
- The cost: with the recorder installed the bus never takes its
  zero-listener fast path, so every metric mutation and span close
  builds one event dict and appends it to a ring. CDT_FLIGHT=0 refuses
  that cost.
- `dump()` is the bundle's `flight` section: both rings and the
  accounting needed to read them (how much history the rings dropped).

The recorder is process-global (`get_flight_recorder()`), made and
installed on first use; after a test resets the event bus, the next
`get_flight_recorder()` taps the new bus.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Optional

from ..utils import constants

SPAN_STREAM = "spans"
EVENT_STREAM = "events"


class FlightRing:
    """A bounded drop-oldest ring with append and drop counts, safe to
    append to from any thread (the tap runs on publishing threads)."""

    def __init__(self, capacity: int) -> None:
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._buf: collections.deque = collections.deque(maxlen=self.capacity)
        self.appended = 0
        self.dropped = 0

    def append(self, item: Any) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(item)
            self.appended += 1

    def snapshot(self) -> list:
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


class FlightRecorder:
    """Tails the process event bus (every type) into bounded rings."""

    def __init__(self, event_capacity: Optional[int] = None,
                 span_capacity: Optional[int] = None,
                 clock: Callable[[], float] = time.time) -> None:
        self._clock = clock
        self.events = FlightRing(event_capacity if event_capacity is not None
                                 else constants.FLIGHT_EVENT_CAPACITY)
        self.spans = FlightRing(span_capacity if span_capacity is not None
                                else constants.FLIGHT_SPAN_CAPACITY)
        self.started_at = clock()
        self._remove_tap: Optional[Callable[[], None]] = None
        self._tapped_bus: Any = None
        # per-stream drops already mirrored into the scrape counter: kept
        # here, not in a collector, so two servers in one process share
        # the mark and a drop counts once
        self.scrape_mirrored: dict[str, int] = {}

    # --- bus wiring -------------------------------------------------------

    def install(self, bus: Any = None) -> None:
        """Tap `bus` (default: the current global bus). Idempotent per
        bus; after a bus reset the tap moves to the new bus."""
        from .events import get_event_bus

        bus = bus if bus is not None else get_event_bus()
        if bus is self._tapped_bus:
            return
        self.uninstall()
        self._remove_tap = bus.add_tap(self._tap, name="flight")
        self._tapped_bus = bus

    def uninstall(self) -> None:
        remove, self._remove_tap = self._remove_tap, None
        self._tapped_bus = None
        if remove is not None:
            remove()

    @property
    def installed(self) -> bool:
        return self._remove_tap is not None

    def _tap(self, event: dict[str, Any]) -> None:
        """Runs inline on the publishing thread: one ring append, no
        metric, no lock but the ring's."""
        if event.get("type") == "span_close":
            self.spans.append(event)
        else:
            self.events.append(event)

    # --- surfaces ---------------------------------------------------------

    def drop_totals(self) -> dict[str, int]:
        return {EVENT_STREAM: self.events.dropped, SPAN_STREAM: self.spans.dropped}

    def status(self) -> dict[str, Any]:
        """The accounting summary the incidents route serves."""
        return {
            "installed": self.installed,
            "capacity": {EVENT_STREAM: self.events.capacity, SPAN_STREAM: self.spans.capacity},
            "retained": {EVENT_STREAM: len(self.events), SPAN_STREAM: len(self.spans)},
            "appended": {EVENT_STREAM: self.events.appended, SPAN_STREAM: self.spans.appended},
            "dropped": self.drop_totals(),
        }

    def dump(self) -> dict[str, Any]:
        """The bundle's `flight` section: both rings and how much each
        appended and dropped before the capture."""
        return {
            "captured_at": self._clock(),
            "started_at": self.started_at,
            "events": self.events.snapshot(),
            "spans": self.spans.snapshot(),
            "appended": {EVENT_STREAM: self.events.appended, SPAN_STREAM: self.spans.appended},
            "dropped": self.drop_totals(),
        }


# --- the global recorder ----------------------------------------------------

_recorder: FlightRecorder | None = None
_recorder_lock = threading.Lock()


def get_flight_recorder() -> Optional[FlightRecorder]:
    """The process-global recorder, made on first call and installed on
    the CURRENT event bus; None when CDT_FLIGHT=0."""
    if not constants.FLIGHT_ENABLED:
        return None
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        _recorder.install()
        return _recorder


def peek_flight_recorder() -> Optional[FlightRecorder]:
    """The recorder if one exists; never makes one or moves its tap (the
    scrape reads its accounting only)."""
    return _recorder


def reset_flight_recorder() -> None:
    """Drop the global recorder (tests); the next get makes a new one."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            _recorder.uninstall()
        _recorder = None
