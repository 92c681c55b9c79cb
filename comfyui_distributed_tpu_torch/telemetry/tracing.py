"""Span-based tracing keyed by the ``exec_*`` trace ids.

The port's own copy of comfyui_distributed_tpu/telemetry/tracing.py.
One execution produces a TREE of spans (queue → dispatch → tile pull →
sampler → blend) that `/distributed/trace/{trace_id}` serves as JSON.

Design:

- a span is {trace_id, span_id, parent_id, name, start, end, attrs,
  events, status}; times come from an injectable monotonic clock so
  tests are deterministic on the CPU;
- the CURRENT span lives in a contextvar. Contexts are per-thread, so
  a compute thread joins a trace by calling `tracer.activate(trace_id)`
  (the server's executor thread does this with the PromptJob's trace
  id, the tile pipeline's threads with their caller's);
- master→worker propagation is one HTTP header, `X-CDT-Trace-Id`,
  carried by /prompt dispatch and by every tile-pull/submit RPC
  (graph/usdu_elastic.HTTPWorkClient); the receiving route re-attaches
  its spans to the propagated id so the whole distributed execution is
  ONE connected tree;
- a span created with no explicit parent and no active span parents to
  the trace's root span (if any): server-side RPC spans connect to
  the orchestration root without shipping span ids over the wire;
- storage is bounded: at most `max_traces` traces (least recently
  active evicted) of at most `max_spans_per_trace` spans each;
- `write_jsonl` exports one span per line for offline analysis.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import threading
import time
import uuid
from typing import Any, Callable, Iterator, Optional

TRACE_HEADER = "X-CDT-Trace-Id"

# (trace_id, span_id) of the active span; span_id None = trace joined
# via activate() but no span open yet.
_current: contextvars.ContextVar[Optional[tuple[str, Optional[str]]]] = (
    contextvars.ContextVar("cdt_current_span", default=None)
)

# Span lifecycle listener: the live event bus (telemetry/events.py)
# installs one callback that forwards span open/close as stream events.
_span_listener: Optional[Callable[[str, "Span"], None]] = None


def set_span_listener(fn: Optional[Callable[[str, "Span"], None]]) -> None:
    """Install the (phase, span) lifecycle callback (phase is "open" or
    "close"); None uninstalls. Errors are swallowed."""
    global _span_listener
    _span_listener = fn


def _notify_span(phase: str, span: "Span") -> None:
    listener = _span_listener
    if listener is not None:
        try:
            listener(phase, span)
        except Exception:  # noqa: BLE001 - telemetry must not break tracing
            pass


class Span:
    __slots__ = (
        "trace_id", "span_id", "parent_id", "name",
        "start", "end", "attrs", "events", "status",
    )

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        name: str,
        start: float,
        attrs: Optional[dict[str, Any]] = None,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.attrs: dict[str, Any] = dict(attrs or {})
        self.events: list[dict[str, Any]] = []
        self.status = "ok"

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def to_dict(self) -> dict[str, Any]:
        # attrs/events are COPIED: callers serialize outside the tracer
        # lock while instrumented code may still be annotating the span
        # (e.g. pull_span.attrs["tile_idx"] = ... after the span ended).
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "duration": self.duration,
            "attrs": dict(self.attrs),
            "events": [dict(e) for e in self.events],
            "status": self.status,
        }


class Tracer:
    """Thread-safe bounded span store + context management."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        max_traces: int = 256,
        max_spans_per_trace: int = 20000,
    ) -> None:
        self._clock = clock
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, list[Span]]" = (
            collections.OrderedDict()
        )
        self._roots: dict[str, str] = {}  # trace_id -> root span_id
        # span_id -> Span per trace: O(1) event attachment (trace_info
        # fires per log line; scanning 20k spans under the lock won't do)
        self._by_id: dict[str, dict[str, Span]] = {}

    # --- bookkeeping ------------------------------------------------------

    def _store(self, span: Span) -> None:
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                spans = []
                self._traces[span.trace_id] = spans
                self._by_id[span.trace_id] = {}
                self._roots.setdefault(span.trace_id, span.span_id)
                while len(self._traces) > self.max_traces:
                    evicted, _ = self._traces.popitem(last=False)
                    self._roots.pop(evicted, None)
                    self._by_id.pop(evicted, None)
            else:
                # LRU, not insertion order: a long execution keeps
                # appending spans, so it stays most-recent and a burst
                # of short traces (or hostile trace-id headers on the
                # open RPC surface) evicts idle history instead of the
                # in-flight tree.
                self._traces.move_to_end(span.trace_id)
            if len(spans) < self.max_spans_per_trace:
                spans.append(span)
                self._by_id[span.trace_id][span.span_id] = span

    def root_span_id(self, trace_id: str) -> Optional[str]:
        with self._lock:
            return self._roots.get(trace_id)

    # --- context ----------------------------------------------------------

    def activate(self, trace_id: str) -> contextvars.Token:
        """Join `trace_id` in the current context (thread); new spans
        with no active parent attach to the trace's root. Returns a
        token for `deactivate`."""
        return _current.set((trace_id, None))

    def deactivate(self, token: contextvars.Token) -> None:
        _current.reset(token)

    def current_trace_id(self) -> Optional[str]:
        state = _current.get()
        return state[0] if state else None

    def current_span_id(self) -> Optional[str]:
        state = _current.get()
        return state[1] if state else None

    # --- span lifecycle ---------------------------------------------------

    def start_span(
        self,
        name: str,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        attrs: Optional[dict[str, Any]] = None,
    ) -> Span:
        """Manual span start (no context mutation); pair with
        `end_span`. Parent resolution: explicit parent_id → active span
        (same trace) → the trace's root span."""
        state = _current.get()
        if trace_id is None:
            if state is None:
                trace_id = f"trace_{uuid.uuid4().hex[:12]}"
            else:
                trace_id = state[0]
        if parent_id is None:
            if state is not None and state[0] == trace_id and state[1] is not None:
                parent_id = state[1]
            else:
                root = self.root_span_id(trace_id)
                parent_id = root  # None for the first span of a trace
        span = Span(
            trace_id=trace_id,
            span_id=uuid.uuid4().hex[:16],
            parent_id=parent_id,
            name=name,
            start=self._clock(),
            attrs=attrs,
        )
        self._store(span)
        _notify_span("open", span)
        return span

    def end_span(self, span: Span, status: str = "ok") -> None:
        if span.end is None:
            span.end = self._clock()
            # preserve a status the body set explicitly (e.g. a span
            # whose failure is swallowed by a best-effort except arm)
            if span.status == "ok":
                span.status = status
            _notify_span("close", span)

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        **attrs: Any,
    ) -> Iterator[Span]:
        """Context-managed span that becomes the active span for
        nesting; exceptions mark the span status 'error' and re-raise."""
        span = self.start_span(name, trace_id, parent_id, attrs)
        token = _current.set((span.trace_id, span.span_id))
        try:
            yield span
        except BaseException as exc:
            span.attrs.setdefault("error", f"{type(exc).__name__}: {exc}")
            self.end_span(span, status="error")
            raise
        else:
            self.end_span(span)
        finally:
            _current.reset(token)

    def event(self, name: str, **attrs: Any) -> None:
        """Attach a point-in-time event to the active span, falling
        back to the active trace's root span; no-op outside a trace."""
        state = _current.get()
        if state is None:
            return
        trace_id, span_id = state
        target = span_id or self.root_span_id(trace_id)
        if target is None:
            return
        with self._lock:
            span = self._by_id.get(trace_id, {}).get(target)
        if span is not None and len(span.events) < 1000:
            span.events.append({"name": name, "ts": self._clock(), "attrs": attrs})

    # --- export -----------------------------------------------------------

    def trace_ids(self) -> list[str]:
        with self._lock:
            return list(self._traces)

    def spans(self, trace_id: str) -> list[dict[str, Any]]:
        with self._lock:
            return [s.to_dict() for s in self._traces.get(trace_id, [])]

    def tree(
        self,
        trace_id: str,
        spans: Optional[list[dict[str, Any]]] = None,
    ) -> list[dict[str, Any]]:
        """Span forest for one trace: each node is the span dict plus
        'children', ordered by start time. Spans whose parent is
        missing (evicted / foreign) surface as extra roots. Pass an
        already-fetched `spans` list to avoid re-copying a large trace
        under the lock (and to keep the tree consistent with it)."""
        if spans is None:
            spans = self.spans(trace_id)
        nodes = {s["span_id"]: {**s, "children": []} for s in spans}
        roots: list[dict[str, Any]] = []
        for node in nodes.values():
            parent = nodes.get(node["parent_id"]) if node["parent_id"] else None
            if parent is not None and parent is not node:
                parent["children"].append(node)
            else:
                roots.append(node)
        def sort_rec(items: list[dict[str, Any]]) -> None:
            items.sort(key=lambda n: (n["start"], n["span_id"]))
            for item in items:
                sort_rec(item["children"])
        sort_rec(roots)
        return roots

    def write_jsonl(self, trace_id: str, path: str) -> int:
        """Export one span per line; returns the number written."""
        spans = self.spans(trace_id)
        with open(path, "w", encoding="utf-8") as fh:
            for span in spans:
                fh.write(json.dumps(span, sort_keys=True) + "\n")
        return len(spans)

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._roots.clear()
            self._by_id.clear()


# --- global tracer --------------------------------------------------------

_tracer: Tracer | None = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _tracer
    with _tracer_lock:
        if _tracer is None:
            _tracer = Tracer()
        return _tracer


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Install a specific tracer (a test's fake clock)."""
    global _tracer
    with _tracer_lock:
        _tracer = tracer


def reset_tracer() -> None:
    """Drop the global tracer (tests)."""
    set_tracer(None)


def current_trace_id() -> Optional[str]:
    """Module-level convenience for transport code building headers."""
    state = _current.get()
    return state[0] if state else None
