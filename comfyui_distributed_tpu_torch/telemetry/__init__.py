"""Telemetry core: metrics, tracing, live events, runtime, the transfer
ledger and the usage meter.

The port's own copy of the observability layer of
comfyui_distributed_tpu/telemetry/ (each module says what of its
original it holds):

- `metrics`: zero-dependency Counter/Gauge/Histogram registry with
  Prometheus text exposition (cardinality-capped per metric), served
  by `/distributed/metrics`;
- `tracing`: span trees keyed by the ``exec_*`` trace ids, propagated
  master→worker via the ``X-CDT-Trace-Id`` header and served by
  `/distributed/trace/{trace_id}`;
- `instruments`: every metric name and label vocabulary the port
  counts, plus `bind_server_collectors` for live-state gauges;
- `events`: the event bus (metric deltas, span open/close, health
  transitions, job lifecycle);
- `runtime`: the card's memory and host RSS on the scrape;
- `profiling`: the transfer ledger (device-execute time, transfer
  bytes, host buckets, the host-tax ratio);
- `usage`: chip-time attribution per dispatch with exact integer
  conservation, and the master's `UsageAggregator`;
- `watchdog`: stragglers, stalls with speculative requeue, the deadline
  sweep;
- `timeseries`, `slo`, `fleet`: the master's fleet plane (bounded
  series, burn-rate SLO alerts, worker snapshots and rollups, the
  monitor thread);
- `flight`, `incidents`: the incident plane (the always-on flight
  recorder on the bus, the master's incident bundles), and
  `profiling.ProfilerCapture`, the on-demand torch.profiler capture.

The durable control plane's families (the journal, snapshots, recovery,
failovers) are registered here too, and counted by durability/. Not
ported yet: the standby's replication-lag gauges (ROADMAP.md, Queue 1
step 7g). All clocks are injectable so tests run deterministically on
the CPU.
"""

from __future__ import annotations

from .instruments import BREAKER_STATE_CODES, bind_server_collectors
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_metrics_registry,
    reset_metrics_registry,
)
from .tracing import (
    TRACE_HEADER,
    Span,
    Tracer,
    current_trace_id,
    get_tracer,
    reset_tracer,
    set_tracer,
)
from .events import EventBus, get_event_bus, reset_event_bus
from .profiling import (
    ProfilerCapture,
    TransferLedger,
    get_profiler_capture,
    get_transfer_ledger,
    ledger_if_enabled,
)
from .usage import UsageAggregator, UsageMeter, get_usage_meter
from .timeseries import SeriesStore
from .slo import SLOEngine, SLOSpec
from .fleet import FleetMonitor, FleetRegistry, local_snapshot
from .watchdog import Watchdog
from .flight import (
    FlightRecorder,
    get_flight_recorder,
    peek_flight_recorder,
    reset_flight_recorder,
)
from .incidents import IncidentManager

__all__ = [
    "BREAKER_STATE_CODES",
    "Counter",
    "EventBus",
    "FleetMonitor",
    "FleetRegistry",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "IncidentManager",
    "MetricsRegistry",
    "ProfilerCapture",
    "SLOEngine",
    "SLOSpec",
    "SeriesStore",
    "Span",
    "TRACE_HEADER",
    "Tracer",
    "TransferLedger",
    "UsageAggregator",
    "UsageMeter",
    "Watchdog",
    "bind_server_collectors",
    "current_trace_id",
    "get_event_bus",
    "get_flight_recorder",
    "get_metrics_registry",
    "get_profiler_capture",
    "get_tracer",
    "get_transfer_ledger",
    "get_usage_meter",
    "ledger_if_enabled",
    "local_snapshot",
    "peek_flight_recorder",
    "reset_event_bus",
    "reset_flight_recorder",
    "reset_metrics_registry",
    "reset_tracer",
    "set_tracer",
]
