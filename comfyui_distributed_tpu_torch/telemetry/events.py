"""Live observability event bus: push-based events for subscribers.

The port's own copy of comfyui_distributed_tpu/telemetry/events.py: a
process-global, thread-safe `EventBus` that fans out

- ``metric_delta``       — every Counter/Gauge/Histogram mutation
                           (forwarded from telemetry.metrics),
- ``span_open`` / ``span_close`` — span lifecycle (telemetry.tracing),
- ``health_transition``  — circuit-breaker state changes
                           (resilience.health),
- ``job_ready`` / ``job_complete`` / ``job_cancelled`` — the JobStore's
                           lifecycle,
- ``grant_available``    — tasks that became pullable (the placement
                           policy's push grants),

to asyncio subscribers, each holding a bounded queue on its own event
loop (the `/distributed/events` WebSocket stream of
api/telemetry_routes.py holds one per client), and to synchronous taps.

Design constraints:

- **zero cost without listeners**: `publish` is one lock-free
  listener check when nobody is on (no queue subscriber AND no
  synchronous tap), so the metric and span hot paths pay nothing in
  normal operation;
- **publishers never block**: events are handed to subscriber loops
  via `call_soon_threadsafe`; a slow consumer's queue drops its OLDEST
  events (the consumer learns via the subscription's `dropped` count)
  instead of backpressuring the pipeline;
- **no feedback loops**: the forwarding hooks are reentrancy-guarded,
  so an event-bus internal that increments a metric can never recurse
  into another publish.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any, Iterable, Optional

from ..utils.constants import EVENT_QUEUE_SIZE


class Subscription:
    """One consumer's bounded event queue, bound to the asyncio loop
    that called `EventBus.subscribe`. `get()` awaits the next event;
    `dropped` counts events discarded because the queue was full."""

    __slots__ = ("loop", "queue", "types", "dropped", "closed", "name")

    def __init__(
        self,
        loop: asyncio.AbstractEventLoop,
        maxsize: int,
        types: Optional[frozenset[str]],
        name: str = "subscriber",
    ) -> None:
        self.loop = loop
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self.types = types
        self.dropped = 0
        self.closed = False
        self.name = name

    def wants(self, event_type: str) -> bool:
        return self.types is None or event_type in self.types

    def _offer(self, event: dict[str, Any]) -> None:
        """Runs ON the subscriber's loop: drop-oldest on overflow."""
        if self.closed:
            return
        while self.queue.full():
            try:
                self.queue.get_nowait()
                self.dropped += 1
            except asyncio.QueueEmpty:  # pragma: no cover - race guard
                break
        self.queue.put_nowait(event)

    async def get(self) -> dict[str, Any]:
        return await self.queue.get()


class EventBus:
    """Thread-safe pub/sub fan-out with per-subscriber bounded queues."""

    def __init__(self, clock=time.time) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._subs: list[Subscription] = []
        # Synchronous taps: (name, callable) pairs invoked INLINE in
        # publish (no queue, no loop hop) — a tap must be cheap and
        # never raise.
        self._taps: list[tuple[str, Any]] = []
        self._seq = 0
        self._sub_seq = 0
        self.published = 0  # plain ints: bus internals must not publish

    @property
    def subscriber_count(self) -> int:
        # unlocked read of a list length: the no-subscriber fast path
        # must not contend with the publish path
        return len(self._subs)

    @property
    def has_listeners(self) -> bool:
        """True when ANYTHING (queue subscriber or synchronous tap)
        would see a published event — the forwarding hooks' fast-path
        check, so metric/span hot paths stay free with nobody on."""
        return bool(self._subs) or bool(self._taps)

    def subscribe(
        self,
        types: Optional[Iterable[str]] = None,
        maxsize: Optional[int] = None,
        loop: Optional[asyncio.AbstractEventLoop] = None,
        name: str = "subscriber",
    ) -> Subscription:
        """Register a consumer on the CURRENT running loop (or `loop`).
        `types` filters bus-side so unwanted events never hit the
        queue; None subscribes to everything. `name` labels the
        subscription in `stats()`; a
        bus-unique `#n` suffix is appended so two consumers with the
        same name (two panel tabs from one IP) never alias each
        other's depth/drop series."""
        loop = loop or asyncio.get_running_loop()
        with self._lock:
            self._sub_seq += 1
            sub = Subscription(
                loop,
                maxsize if maxsize is not None else EVENT_QUEUE_SIZE,
                frozenset(types) if types is not None else None,
                name=f"{name}#{self._sub_seq}",
            )
            self._subs.append(sub)
        return sub

    def add_tap(self, fn, name: str = "tap"):
        """Install a synchronous tap called with every published event
        dict, from the PUBLISHING thread. Returns a zero-arg remove
        callable. Tap errors are swallowed (a broken observer must not
        break the pipeline it observes)."""
        entry = (name, fn)
        with self._lock:
            self._taps.append(entry)

        def remove() -> None:
            with self._lock:
                if entry in self._taps:
                    self._taps.remove(entry)

        return remove

    def stats(self) -> dict[str, Any]:
        """Per-consumer accounting: every queue subscriber's depth + cumulative
        drops, and the installed synchronous taps. Queue depth is a
        best-effort cross-thread read (qsize is a plain len)."""
        with self._lock:
            subs = list(self._subs)
            taps = list(self._taps)
        return {
            "published": self.published,
            "subscribers": [
                {
                    "name": sub.name,
                    "types": sorted(sub.types) if sub.types is not None else "all",
                    "queue_depth": sub.queue.qsize(),
                    "dropped": sub.dropped,
                }
                for sub in subs
            ],
            "taps": [name for name, _fn in taps],
        }

    def unsubscribe(self, sub: Subscription) -> None:
        sub.closed = True
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def publish(self, event_type: str, **data: Any) -> None:
        """Fan one event out to every matching subscriber (queued) and
        tap (inline); callable from any thread; never raises, never
        blocks."""
        if not self._subs and not self._taps:
            return
        with self._lock:
            self._seq += 1
            event = {
                "type": event_type,
                "seq": self._seq,
                "ts": self._clock(),
                "data": data,
            }
            targets = [s for s in self._subs if s.wants(event_type)]
            taps = list(self._taps)
            if targets or taps:
                self.published += 1
        for _name, tap in taps:
            try:
                tap(event)
            except Exception:  # noqa: BLE001 - taps must not break publish
                pass
        dead: list[Subscription] = []
        for sub in targets:
            try:
                sub.loop.call_soon_threadsafe(sub._offer, event)
            except RuntimeError:
                dead.append(sub)  # loop closed under the subscriber
        for sub in dead:
            self.unsubscribe(sub)


# --- forwarding hooks (metrics / spans → bus) ------------------------------

_suppress = threading.local()


def _forward_metric(kind, name, labelnames, labelvalues, value) -> None:
    """telemetry.metrics mutation listener → ``metric_delta`` events.
    `value` is the increment for counters, the new value for gauges,
    and the observation for histograms."""
    bus = get_event_bus()
    if not bus.has_listeners or getattr(_suppress, "active", False):
        return
    _suppress.active = True
    try:
        bus.publish(
            "metric_delta",
            metric=name,
            kind=kind,
            labels=dict(zip(labelnames, labelvalues)),
            value=value,
        )
    finally:
        _suppress.active = False


def _forward_span(phase: str, span) -> None:
    """telemetry.tracing span listener → span_open / span_close."""
    bus = get_event_bus()
    if not bus.has_listeners or getattr(_suppress, "active", False):
        return
    _suppress.active = True
    try:
        payload = {
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "name": span.name,
            "start": span.start,
            "attrs": dict(span.attrs),
        }
        if phase == "close":
            payload["end"] = span.end
            payload["duration"] = span.duration
            payload["status"] = span.status
        bus.publish(f"span_{phase}", **payload)
    finally:
        _suppress.active = False


def install_forwarding() -> None:
    """Idempotently wire the metrics registry and tracer mutation hooks
    into the bus (module import of telemetry.events does this once).
    The hooks survive registry/tracer resets — they always resolve the
    CURRENT global bus."""
    from . import metrics, tracing

    metrics.set_mutation_listener(_forward_metric)
    tracing.set_span_listener(_forward_span)


# --- global bus ------------------------------------------------------------

_bus: EventBus | None = None
_bus_lock = threading.Lock()


def get_event_bus() -> EventBus:
    # Lock-free fast path: this runs on EVERY metric mutation and span
    # open/close via the forwarding hooks, so the instrumented hot
    # paths must not serialize on a global mutex (module-global reads
    # are atomic; the lock only guards one-time creation).
    global _bus
    bus = _bus
    if bus is not None:
        return bus
    with _bus_lock:
        if _bus is None:
            _bus = EventBus()
        return _bus


def reset_event_bus() -> None:
    """Drop the global bus (tests); forwarding hooks re-resolve."""
    global _bus
    with _bus_lock:
        _bus = None


install_forwarding()
