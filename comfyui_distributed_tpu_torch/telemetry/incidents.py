"""Incident debug bundles: captured on a trigger, bounded, self-describing.

The port's own copy of comfyui_distributed_tpu/telemetry/incidents.py.
When a burn-rate alert fires (telemetry/slo.py), a poison tile is
quarantined, a job runs past its deadline or an operator asks, the
`IncidentManager` takes a snapshot of what the master knows into ONE
atomically written JSON bundle under ``CDT_INCIDENT_DIR``:

- the flight recorder's event and span rings (telemetry/flight.py): the
  window of history from BEFORE the trigger;
- the implicated execution's trace spans (the tracer's retention);
- the fleet registry's and the usage aggregator's history around the
  trigger (``CDT_INCIDENT_WINDOW`` seconds);
- the SLO engine's rules and transitions;
- the breaker states, the placement weights and the scheduler's state;
- the resolved ``CDT_*`` knobs (utils/knob_registry.py: the knobs the
  port reads);
- the job store's counts.

The port has no journal yet (ROADMAP.md, Queue 1 step 7f), so no
bundle has a ``durability`` section; the JAX manager leaves it out on a
master without one too.

- **Off the serving loop**: `trigger()` is a debounce check and a queue
  put; gathering, serializing and the fsync run on a single-flight
  writer thread, so an alert storm never stalls an await point.
- **Trigger-keyed debounce and a global rate limit**: a re-firing alert
  inside ``CDT_INCIDENT_DEBOUNCE`` captures nothing, and any two
  automatic captures are at least ``CDT_INCIDENT_MIN_INTERVAL`` apart
  (both windows are reserved when the request is queued).
- **Bounded retention**: the oldest bundles go past ``CDT_INCIDENT_MAX``
  files or ``CDT_INCIDENT_MAX_MB`` in all.
- **Atomic writes**: `utils/fsio.atomic_write_bytes`, so a reader (or a
  crash) never sees a torn bundle.

Surfaces: ``GET /distributed/incidents`` (and ``/{id}``, ``POST
.../capture``) in api/incident_routes.py, and an ``incident_captured``
event on the bus.
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import re
import threading
import time
from typing import Any, Callable, Optional

from ..utils import constants
from ..utils.fsio import atomic_write_bytes
from ..utils.logging import debug_log, log

BUNDLE_SCHEMA_VERSION = 1

# The trigger vocabulary, the JAX package's.
TRIGGER_ALERT = "alert_fired"
TRIGGER_POISON = "tile_quarantined"
TRIGGER_DEADLINE = "job_deadline"
TRIGGER_FAILOVER = "failover"
TRIGGER_MANUAL = "manual"

BUNDLE_PREFIX = "incident-"
BUNDLE_SUFFIX = ".json"
# seq pads to 4 digits but keeps growing past 9999 ('{:04d}' widens),
# so the grammar accepts 4+ — a long-lived master's bundle 10000 must
# stay fetchable and schema-valid
_BUNDLE_ID_RE = re.compile(r"incident-\d{13}-\d{4,}-[a-z0-9_]+")
_KIND_SAFE_RE = re.compile(r"[^a-z0-9_]+")

# Debounce map bound: trigger keys ride unauthenticated event payloads
# (job ids), so the map must not grow without bound.
MAX_DEBOUNCE_KEYS = 256

# Bound on trace spans copied into a bundle (a 20k-span trace would
# dominate the size budget; the newest spans carry the incident).
MAX_TRACE_SPANS = 4000


class CaptureRequest:
    __slots__ = ("kind", "key", "context", "ts", "manual")

    def __init__(self, kind, key, context, ts, manual):
        self.kind = kind
        self.key = key
        self.context = context
        self.ts = ts
        self.manual = manual


class IncidentManager:
    """Trigger-driven debug-bundle capture with bounded retention."""

    def __init__(
        self,
        directory: str,
        *,
        clock: Callable[[], float] = time.time,
        debounce_s: Optional[float] = None,
        min_interval_s: Optional[float] = None,
        max_bundles: Optional[int] = None,
        max_bytes: Optional[float] = None,
        window_s: Optional[float] = None,
    ) -> None:
        self.directory = directory
        self.clock = clock
        self.debounce_s = (
            debounce_s if debounce_s is not None
            else constants.INCIDENT_DEBOUNCE_SECONDS
        )
        self.min_interval_s = (
            min_interval_s if min_interval_s is not None
            else constants.INCIDENT_MIN_INTERVAL_SECONDS
        )
        self.max_bundles = (
            max_bundles if max_bundles is not None
            else constants.INCIDENT_MAX_BUNDLES
        )
        # max_bytes is taken literally in BYTES when passed (tests pin
        # small budgets); the knob is operator-facing megabytes
        self.max_bytes = (
            int(max_bytes)
            if max_bytes is not None
            else int(constants.INCIDENT_MAX_MB * 1024 * 1024)
        )
        self.window_s = (
            window_s if window_s is not None
            else constants.INCIDENT_WINDOW_SECONDS
        )
        # Named zero-arg callables, each producing one JSON-able bundle
        # section; a failing source degrades to {"error": ...}, never
        # the whole capture. `bind_server` wires the standard set.
        self.sources: dict[str, Callable[[], Any]] = {}
        # the device an automatic profiler capture records (bind_server
        # sets the server's; None: the card when there is one)
        self.device: Optional[str] = None
        self._lock = threading.Lock()
        self._debounce: dict[str, float] = {}
        self._last_capture_ts: Optional[float] = None
        self._seq = 0
        self._queue: "queue_mod.Queue[Optional[CaptureRequest]]" = (
            queue_mod.Queue(maxsize=4)
        )
        self._inflight = 0
        # serializes bundle builds: the writer thread AND a manual
        # capture_now (run off-loop by the route) go through it —
        # single-flight
        self._capture_lock = threading.Lock()
        self._writer: Optional[threading.Thread] = None
        self._remove_tap: Optional[Callable[[], None]] = None
        self._closed = False
        self.counters = {
            "captured": 0,
            "debounced": 0,
            "rate_limited": 0,
            "overflow": 0,
            "errors": 0,
        }

    # --- wiring -----------------------------------------------------------

    def bind_server(self, server: Any) -> None:
        """Attach the standard master-side sources (every read is a
        thread-safe snapshot on the owning structure); the server's
        device picks the automatic capture's activities."""
        from ..resilience.health import get_health_registry

        self.device = getattr(server, "device", None)

        label = f"{'worker' if server.is_worker else 'master'}:{server.port}"
        self.sources["server"] = lambda: {"label": label, "pid": os.getpid()}
        self.sources["store"] = server.job_store.stats_unlocked
        scheduler = getattr(server, "scheduler", None)
        if scheduler is not None:
            self.sources["placement"] = scheduler.placement.snapshot
            self.sources["scheduler"] = lambda: {
                "state": scheduler.queue.state,
                "totals": dict(scheduler.queue.totals),
                "brownout": scheduler.brownout.signals(),
            }
        self.sources["health"] = lambda: get_health_registry().snapshot()
        fleet = getattr(server, "fleet", None)
        if fleet is not None:
            self.sources["fleet"] = (
                lambda: fleet.status(since_s=self.window_s)
            )
            usage = getattr(fleet, "usage", None)
            if usage is not None:
                # chip-time attribution at capture time: per-tenant
                # burn + waste breakdown + the conservation identity —
                # "who was burning the fleet when this fired"
                self.sources["usage"] = (
                    lambda: usage.status(since_s=self.window_s)
                )
        slo = getattr(server, "slo", None)
        if slo is not None:
            self.sources["slo"] = slo.status
        durability = getattr(server, "durability", None)
        if durability is not None:
            self.sources["durability"] = durability.status

    def start(self, bus: Any = None) -> None:
        """Start the writer thread and install the trigger tap on the
        event bus (alert_fired / tile_quarantined / deadline cancel /
        failover become automatic captures; the port publishes the first
        two, and nothing of it publishes the others yet)."""
        self._closed = False
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, name="cdt-incident-writer",
                daemon=True,
            )
            self._writer.start()
        if self._remove_tap is None:
            from .events import get_event_bus

            bus = bus if bus is not None else get_event_bus()
            self._remove_tap = bus.add_tap(self._bus_tap, name="incidents")

    def stop(self) -> None:
        remove, self._remove_tap = self._remove_tap, None
        if remove is not None:
            remove()
        self._closed = True
        writer, self._writer = self._writer, None
        if writer is not None and writer.is_alive():
            self._queue.put(None)
            writer.join(timeout=10)

    # --- triggers ---------------------------------------------------------

    def _bus_tap(self, event: dict[str, Any]) -> None:
        """Synchronous bus tap: map trigger-class events onto capture
        requests. Must stay cheap — a debounce check and a queue put."""
        etype = event.get("type")
        data = event.get("data") or {}
        if etype == "alert_fired":
            self.trigger(TRIGGER_ALERT, key=str(data.get("slo", "")), context=data)
        elif etype == "tile_quarantined":
            self.trigger(
                TRIGGER_POISON, key=str(data.get("job_id", "")), context=data
            )
        elif etype == "job_cancelled" and data.get("reason") == "deadline":
            self.trigger(
                TRIGGER_DEADLINE, key=str(data.get("job_id", "")), context=data
            )
        elif etype == "failover":
            self.trigger(
                TRIGGER_FAILOVER, key=str(data.get("epoch", "")), context=data
            )

    def trigger(
        self,
        kind: str,
        key: str = "",
        context: Optional[dict] = None,
        manual: bool = False,
    ) -> str:
        """Request a capture; returns the disposition:
        ``queued | debounced | rate_limited | overflow | closed``.
        Never blocks, never raises — safe from the serving loop, bus
        taps and test threads alike. Debounce + rate-limit
        windows are reserved HERE (not at write time) so a trigger
        storm racing the writer cannot enqueue duplicates; manual
        captures bypass both windows but still serialize through the
        single-flight writer."""
        if self._closed:
            return "closed"
        now = self.clock()
        debounce_key = f"{kind}:{key}"
        with self._lock:
            if not manual:
                last_any = self._last_capture_ts
                if (
                    last_any is not None
                    and now - last_any < self.min_interval_s
                ):
                    self.counters["rate_limited"] += 1
                    return "rate_limited"
                last = self._debounce.get(debounce_key)
                if last is not None and now - last < self.debounce_s:
                    # touch: a key still actively firing moves to the
                    # dict's end (window timestamp unchanged), so the
                    # bounded map evicts idle keys first, never one
                    # that is mid-storm
                    self._debounce.pop(debounce_key)
                    self._debounce[debounce_key] = last
                    self.counters["debounced"] += 1
                    return "debounced"
            prev_key_ts = self._debounce.pop(debounce_key, None)
            prev_any_ts = self._last_capture_ts
            while len(self._debounce) >= MAX_DEBOUNCE_KEYS:
                # least-recently-RESERVED first: the pop-reinsert above
                # keeps live keys at the dict's end, so a key-churn
                # storm evicts stale keys, never a just-reserved one
                self._debounce.pop(next(iter(self._debounce)))
            self._debounce[debounce_key] = now
            self._last_capture_ts = now
            self._inflight += 1
        request = CaptureRequest(kind, key, dict(context or {}), now, manual)
        try:
            self._queue.put_nowait(request)
        except queue_mod.Full:
            with self._lock:
                self.counters["overflow"] += 1
                self._inflight -= 1
                # roll the reservations back: NO capture happened, so
                # the next trigger of this key must not read as
                # debounced/rate-limited against a phantom one
                if self._debounce.get(debounce_key) == now:
                    if prev_key_ts is not None:
                        self._debounce[debounce_key] = prev_key_ts
                    else:
                        self._debounce.pop(debounce_key, None)
                if self._last_capture_ts == now:
                    self._last_capture_ts = prev_any_ts
            return "overflow"
        return "queued"

    def capture_now(
        self, kind: str = TRIGGER_MANUAL, key: str = "",
        context: Optional[dict] = None,
    ) -> dict[str, Any]:
        """Synchronous capture on the CALLING thread (the manual-POST
        route runs this off the loop). Serialized with the writer thread
        through the capture lock; bypasses debounce/rate-limit but
        records into both windows."""
        now = self.clock()
        debounce_key = f"{kind}:{key}"
        with self._lock:
            # same bounded-map discipline as trigger(): manual keys
            # arrive on an unauthenticated POST and must not grow the
            # debounce map without limit
            self._debounce.pop(debounce_key, None)
            while len(self._debounce) >= MAX_DEBOUNCE_KEYS:
                self._debounce.pop(next(iter(self._debounce)))
            self._debounce[debounce_key] = now
            self._last_capture_ts = now
        request = CaptureRequest(kind, key, dict(context or {}), now, True)
        try:
            return self._capture(request)
        except Exception:
            self._rollback_reservation(request)
            raise

    # --- the writer -------------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            request = self._queue.get()
            if request is None:
                return
            try:
                self._capture(request)
            except Exception as exc:  # noqa: BLE001 - writer survives
                with self._lock:
                    self.counters["errors"] += 1
                # a capture that produced NO bundle must not hold its
                # windows: the incident that most needs forensics
                # would otherwise read as debounced for the full
                # window while nothing is on disk
                self._rollback_reservation(request)
                debug_log(f"incident capture failed: {exc}")
            finally:
                with self._lock:
                    if self._inflight > 0:
                        self._inflight -= 1

    def _rollback_reservation(self, request: CaptureRequest) -> None:
        """Release the debounce + rate-limit windows a FAILED capture
        reserved (only if no newer reservation replaced them)."""
        debounce_key = f"{request.kind}:{request.key}"
        with self._lock:
            if self._debounce.get(debounce_key) == request.ts:
                self._debounce.pop(debounce_key, None)
            if self._last_capture_ts == request.ts:
                self._last_capture_ts = None

    def flush(self, timeout: float = 10.0) -> bool:
        """Barrier for tests: wait until every queued capture has been
        written (or the timeout passes)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                idle = self._inflight == 0 and self._queue.empty()
            if idle:
                return True
            time.sleep(0.01)
        return False

    def _capture(self, request: CaptureRequest) -> dict[str, Any]:
        from . import instruments

        started = time.perf_counter()
        with self._capture_lock:
            with self._lock:
                self._seq += 1
                seq = self._seq
            bundle = self._build_bundle(request, seq)
            path = os.path.join(self.directory, bundle["id"] + BUNDLE_SUFFIX)
            payload = json.dumps(
                bundle, sort_keys=True, default=str
            ).encode("utf-8")
            atomic_write_bytes(path, payload)
            self._prune()
        elapsed = time.perf_counter() - started
        with self._lock:
            self.counters["captured"] += 1
        try:
            instruments.incidents_total().inc(trigger=request.kind)
            instruments.incident_capture_seconds().observe(elapsed)
        except Exception:  # noqa: BLE001 - accounting is best effort
            pass
        from .events import get_event_bus

        try:
            get_event_bus().publish(
                "incident_captured",
                id=bundle["id"],
                trigger=request.kind,
                key=request.key,
                path=path,
                bytes=len(payload),
            )
        except Exception:  # noqa: BLE001 - push side is best effort
            pass
        log(
            f"incident bundle {bundle['id']} captured "
            f"({request.kind}:{request.key}, {len(payload)} bytes, "
            f"{elapsed * 1000:.1f} ms)"
        )
        return {"id": bundle["id"], "path": path, "bytes": len(payload)}

    def _build_bundle(
        self, request: CaptureRequest, seq: int
    ) -> dict[str, Any]:
        kind_safe = _KIND_SAFE_RE.sub("_", request.kind.lower()) or "unknown"
        bundle: dict[str, Any] = {
            "schema": BUNDLE_SCHEMA_VERSION,
            "id": f"incident-{int(request.ts * 1000):013d}-{seq:04d}-{kind_safe}",
            "captured_at": self.clock(),
            "trigger": {
                "kind": request.kind,
                "key": request.key,
                "ts": request.ts,
                "manual": request.manual,
                "context": request.context,
            },
            "flight": self._flight_section(),
            "trace": self._trace_section(request.context),
            "knobs": resolved_knobs(),
            "counters": dict(self.counters),
        }
        for name, source in self.sources.items():
            try:
                bundle[name] = source()
            except Exception as exc:  # noqa: BLE001 - degrade per section
                bundle[name] = {"error": f"{type(exc).__name__}: {exc}"}
        profile = self._profile_section(kind_safe)
        if profile is not None:
            bundle["profile"] = profile
        return bundle

    def _profile_section(self, kind_safe: str) -> Optional[dict[str, Any]]:
        """The automatic capture riding the incident (CDT_PROFILE_AUTO): a
        short bounded torch.profiler capture on the writer thread, so the
        bundle points at a device-level view of the bad moment. Requires
        CDT_PROFILE_DIR; a busy profiler (an operator's capture in
        flight) degrades to the refusal record, never an error."""
        if not constants.PROFILE_AUTO_ENABLED:
            return None
        try:
            from .profiling import get_profiler_capture

            capture = get_profiler_capture()
            if capture is None:
                return {"error": "CDT_PROFILE_AUTO set without CDT_PROFILE_DIR"}
            started = capture.start(duration_s=constants.PROFILE_AUTO_SECONDS,
                                    tag=f"auto-{kind_safe}", device=self.device)
            if not started.get("started"):
                return {"skipped": started.get("reason", "unavailable")}
            time.sleep(constants.PROFILE_AUTO_SECONDS)
            stopped = capture.stop()
            return {"started": started, "stopped": stopped}
        except Exception as exc:  # noqa: BLE001 - degrade per section
            return {"error": f"{type(exc).__name__}: {exc}"}

    def _flight_section(self) -> dict[str, Any]:
        from .flight import peek_flight_recorder

        recorder = peek_flight_recorder()
        if recorder is None:
            return {"enabled": False, "events": [], "spans": [],
                    "dropped": {"events": 0, "spans": 0}}
        dump = recorder.dump()
        dump["enabled"] = True
        return dump

    def _trace_section(self, context: dict) -> Optional[dict[str, Any]]:
        """The implicated execution's spans: the context's trace id
        when the trigger named one, else the most recently active
        trace (bounded copy)."""
        from .tracing import get_tracer

        tracer = get_tracer()
        trace_id = context.get("trace_id")
        if not trace_id:
            ids = tracer.trace_ids()
            trace_id = ids[-1] if ids else None
        if not trace_id:
            return None
        spans = tracer.spans(str(trace_id))
        truncated = max(0, len(spans) - MAX_TRACE_SPANS)
        if truncated:
            spans = spans[-MAX_TRACE_SPANS:]
        return {
            "trace_id": str(trace_id),
            "spans": spans,
            "truncated_spans": truncated,
        }

    # --- retention / listing ----------------------------------------------

    def _bundle_files(self) -> list[tuple[str, str]]:
        """(name, path) pairs, oldest first — names embed a zero-padded
        millisecond stamp + sequence, so lexical order IS capture
        order (never readdir order)."""
        try:
            names = sorted(os.listdir(self.directory))
        except FileNotFoundError:
            return []
        return [
            (name, os.path.join(self.directory, name))
            for name in names
            if name.startswith(BUNDLE_PREFIX) and name.endswith(BUNDLE_SUFFIX)
        ]

    def _prune(self) -> None:
        files = self._bundle_files()
        sizes: dict[str, int] = {}
        for _name, path in files:
            try:
                sizes[path] = os.path.getsize(path)
            except OSError:
                sizes[path] = 0
        total = sum(sizes.values())
        # prune-oldest, but NEVER the newest bundle — the capture that
        # just happened must survive even a pathological byte budget
        while len(files) > 1 and (
            len(files) > self.max_bundles
            or (self.max_bytes > 0 and total > self.max_bytes)
        ):
            _name, oldest = files.pop(0)
            total -= sizes.get(oldest, 0)
            try:
                os.remove(oldest)
            except OSError as exc:
                debug_log(f"incident prune of {oldest} failed: {exc}")

    def list_bundles(self) -> list[dict[str, Any]]:
        """Newest-first listing without opening the files: id, trigger
        kind (from the filename), capture timestamp, size."""
        out = []
        for name, path in reversed(self._bundle_files()):
            bundle_id = name[: -len(BUNDLE_SUFFIX)]
            parts = bundle_id.split("-", 3)
            ts_ms = 0
            kind = "unknown"
            if len(parts) == 4:
                try:
                    ts_ms = int(parts[1])
                except ValueError:
                    ts_ms = 0
                kind = parts[3]
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            out.append(
                {
                    "id": bundle_id,
                    "trigger": kind,
                    "ts": ts_ms / 1000.0,
                    "bytes": size,
                }
            )
        return out

    def read_bundle(self, bundle_id: str) -> Optional[dict[str, Any]]:
        """Load one bundle by id; None for unknown/invalid ids (the id
        grammar is validated so a hostile id can never traverse out of
        the incident directory)."""
        if not _BUNDLE_ID_RE.fullmatch(bundle_id):
            return None
        path = os.path.join(self.directory, bundle_id + BUNDLE_SUFFIX)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, json.JSONDecodeError):
            return None

    def status(self) -> dict[str, Any]:
        with self._lock:
            counters = dict(self.counters)
            inflight = self._inflight
        return {
            "directory": self.directory,
            "debounce_s": self.debounce_s,
            "min_interval_s": self.min_interval_s,
            "max_bundles": self.max_bundles,
            "max_bytes": self.max_bytes,
            "counters": counters,
            "inflight": inflight,
        }


# --- knob snapshot -----------------------------------------------------------


def resolved_knobs() -> dict[str, dict[str, Any]]:
    """Every registered CDT_* knob with its RESOLVED value: the env
    value when set, the registry's rendered default otherwise — the
    bundle answers "what was this process actually configured as"
    without shipping the whole environ (no secrets beyond CDT_*)."""
    from ..utils.knob_registry import KNOBS

    out: dict[str, dict[str, Any]] = {}
    for knob in KNOBS:
        raw = os.environ.get(knob.name)
        out[knob.name] = {
            "value": raw if raw is not None else knob.default,
            "set": raw is not None,
        }
    return out


# --- bundle schema validation ------------------------------------------------

# Minimal JSON-schema-style description of a bundle; validate_bundle
# enforces it.
BUNDLE_SCHEMA: dict[str, Any] = {
    "schema": int,
    "id": str,
    "captured_at": (int, float),
    "trigger": {
        "kind": str,
        "key": str,
        "ts": (int, float),
        "manual": bool,
        "context": dict,
    },
    "flight": {
        "events": list,
        "spans": list,
        "dropped": dict,
    },
    "knobs": dict,
    "counters": dict,
}


def _check(node: Any, spec: Any, path: str, problems: list[str]) -> None:
    if isinstance(spec, dict):
        if not isinstance(node, dict):
            problems.append(f"{path}: expected object, got {type(node).__name__}")
            return
        for key, sub in spec.items():
            if key not in node:
                problems.append(f"{path}.{key}: missing")
            else:
                _check(node[key], sub, f"{path}.{key}", problems)
    else:
        if not isinstance(node, spec):
            expected = (
                "/".join(t.__name__ for t in spec)
                if isinstance(spec, tuple)
                else spec.__name__
            )
            problems.append(
                f"{path}: expected {expected}, got {type(node).__name__}"
            )


def validate_bundle(bundle: Any) -> list[str]:
    """Structural validation against BUNDLE_SCHEMA; returns problems
    (empty = valid). Also checks the id grammar and schema version."""
    problems: list[str] = []
    if not isinstance(bundle, dict):
        return [f"bundle: expected object, got {type(bundle).__name__}"]
    _check(bundle, BUNDLE_SCHEMA, "bundle", problems)
    schema = bundle.get("schema")
    if isinstance(schema, int) and schema != BUNDLE_SCHEMA_VERSION:
        problems.append(
            f"bundle.schema: version {schema} != supported "
            f"{BUNDLE_SCHEMA_VERSION}"
        )
    bundle_id = bundle.get("id")
    if isinstance(bundle_id, str) and not _BUNDLE_ID_RE.fullmatch(bundle_id):
        problems.append(f"bundle.id: {bundle_id!r} does not match the grammar")
    return problems
