"""Per-execution trace ids and trace-tagged log lines.

The port's own copy of comfyui_distributed_tpu/utils/trace_logger.py.
Every distributed queue execution gets a trace id `exec_<ms>_<uuid6>`
threaded from the entry point through orchestration, dispatch and
collection: one id finds a job across master and worker logs, and keys
its span tree (telemetry/tracing.py, /distributed/trace/{trace_id}).
`trace_info` / `trace_debug` also attach their message as a span event
on that trace, so the log lines land inside the structured timeline.
"""

from __future__ import annotations

import time
import uuid

from .logging import debug_log, log


def generate_trace_id(node_hint: str | None = None) -> str:
    base = f"exec_{int(time.time() * 1000)}_{uuid.uuid4().hex[:6]}"
    return f"{base}_{node_hint}" if node_hint else base


def _span_event(trace_id: str, message: str, level: str) -> None:
    """Mirror the log line as an event on the trace's span tree (the
    active span if this context is inside one, else the root)."""
    from ..telemetry import get_tracer

    tracer = get_tracer()
    if tracer.root_span_id(trace_id) is None:
        return  # no spans for this trace yet; stay log-only
    if tracer.current_trace_id() == trace_id:
        tracer.event("log", message=message, level=level)
    else:
        token = tracer.activate(trace_id)
        try:
            tracer.event("log", message=message, level=level)
        finally:
            tracer.deactivate(token)


def trace_info(trace_id: str, message: str) -> None:
    log(f"[exec:{trace_id}] {message}")
    _span_event(trace_id, message, "info")


def trace_debug(trace_id: str, message: str) -> None:
    debug_log(f"[exec:{trace_id}] {message}")
    _span_event(trace_id, message, "debug")
