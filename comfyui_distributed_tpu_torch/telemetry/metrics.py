"""Zero-dependency metrics registry with Prometheus text exposition.

The port's own copy of comfyui_distributed_tpu/telemetry/metrics.py,
line for line, so that both render the same operations as the same
bytes: three instrument kinds (Counter, Gauge, Histogram with explicit
buckets) registered by name in a `MetricsRegistry` and rendered in the
Prometheus text exposition format (version 0.0.4) by
`/distributed/metrics` (api/telemetry_routes.py).

Conventions (held by tests/test_torch_telemetry.py):

- every metric name starts with ``cdt_`` and is snake_case;
- counters end in ``_total``; histograms measuring time end in
  ``_seconds``;
- label values are free-form strings (worker ids, stage names); label
  NAMES come from a small fixed vocabulary per instrument.

The registry is thread-safe (instruments are updated from the server
loop, the executor thread and the tile pipeline's threads concurrently)
and process-global via `get_metrics_registry()`; tests reset it with
`reset_metrics_registry()`.

Gauges that mirror live state (queue depth, breaker states) are filled
at scrape time by *collector* callbacks registered with
`register_collector`: the scrape pulls from the JobStore and the health
registry instead of every mutation pushing a gauge update.
"""

from __future__ import annotations

import bisect
import math
import os
import re
import threading
from typing import Callable, Iterable, Optional, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Label value every series beyond a metric's cardinality cap collapses
# into (one synthetic series per metric, not one per hostile value).
OVERFLOW_LABEL_VALUE = "_overflow"

# Distinct label sets allowed per metric before overflow collapsing
# kicks in. Worker ids / stage names are small vocabularies in healthy
# operation; the cap exists so a worker-id churn storm (or a hostile
# caller spraying ids at an RPC surface) can't grow the registry — and
# every Prometheus scrape — without bound.
DEFAULT_MAX_SERIES = 128


def _env_max_series() -> int:
    try:
        value = int(os.environ.get("CDT_METRIC_MAX_SERIES", DEFAULT_MAX_SERIES))
    except (TypeError, ValueError):
        return DEFAULT_MAX_SERIES
    return value if value > 0 else DEFAULT_MAX_SERIES


# Mutation listener: the live event bus (telemetry/events.py) installs
# one callback here that forwards every Counter/Gauge/Histogram update
# as a `metric_delta` event. Kept as a plain module global so the hot
# path pays a single None-check when nothing is listening.
_mutation_listener: Optional[Callable] = None


def set_mutation_listener(fn: Optional[Callable]) -> None:
    """Install the (kind, name, labelnames, labelvalues, value) mutation
    callback; None uninstalls. Listener errors are swallowed — pushing
    telemetry must never break the instrumented path."""
    global _mutation_listener
    _mutation_listener = fn

# Default latency buckets: 1ms .. 60s, roughly log-spaced — wide enough
# for both sub-ms store ops and multi-second dispatch/tile timings.
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _format_labels(labelnames: Sequence[str], labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{name}="{_escape_label_value(value)}"'
        for name, value in zip(labelnames, labelvalues)
    )
    return "{" + inner + "}"


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


class _Metric:
    """Shared base: name/help/labelnames validation + labelled children."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        max_series: Optional[int] = None,
        on_overflow: Optional[Callable[[str], None]] = None,
    ):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for label in labelnames:
            if not _LABEL_RE.match(label):
                raise ValueError(f"invalid label name {label!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series if max_series is not None else _env_max_series()
        self._on_overflow = on_overflow
        self._overflow_logged = False
        self._lock = threading.Lock()

    def _key(self, labels: dict[str, str]) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(sorted(labels))}"
            )
        return tuple(str(labels[name]) for name in self.labelnames)

    def _bounded_key(
        self, key: tuple[str, ...], container: dict
    ) -> tuple[str, ...]:
        """Cap distinct label sets per metric: a NEW series beyond
        `max_series` collapses into the `_overflow` series instead of
        growing the registry (caller holds self._lock)."""
        if not self.labelnames or key in container or len(container) < self.max_series:
            return key
        if self._on_overflow is not None:
            try:
                self._on_overflow(self.name)
            except Exception:  # noqa: BLE001 - accounting must not break writes
                pass
        if not self._overflow_logged:
            self._overflow_logged = True
            try:
                from ..utils.logging import log

                log(
                    f"metric {self.name} hit its series cap "
                    f"({self.max_series}); further label sets collapse "
                    f"into {OVERFLOW_LABEL_VALUE!r} "
                    "(cdt_metric_series_overflow_total counts them)"
                )
            except Exception:  # noqa: BLE001 - logging is best effort
                pass
        return (OVERFLOW_LABEL_VALUE,) * len(self.labelnames)

    def _notify(self, labelvalues: tuple[str, ...], value: float) -> None:
        """Forward one mutation to the event-bus listener (no-op when
        none installed); called OUTSIDE the metric lock."""
        listener = _mutation_listener
        if listener is not None:
            try:
                listener(self.kind, self.name, self.labelnames, labelvalues, value)
            except Exception:  # noqa: BLE001 - telemetry must not break writes
                pass

    def samples(self) -> Iterable[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def header(self) -> list[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help, labelnames=(), **kwargs):
        super().__init__(name, help, labelnames, **kwargs)
        self._values: dict[tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            key = self._bounded_key(key, self._values)
            self._values[key] = self._values.get(key, 0.0) + amount
        self._notify(key, amount)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def samples(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        for key, value in items:
            yield (
                f"{self.name}{_format_labels(self.labelnames, key)} "
                f"{_format_value(value)}"
            )


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help, labelnames=(), **kwargs):
        super().__init__(name, help, labelnames, **kwargs)
        self._values: dict[tuple[str, ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            key = self._bounded_key(key, self._values)
            self._values[key] = float(value)
        self._notify(key, float(value))

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            key = self._bounded_key(key, self._values)
            value = self._values.get(key, 0.0) + amount
            self._values[key] = value
        self._notify(key, value)

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def clear(self) -> None:
        """Drop all labelled series (collectors re-fill at scrape)."""
        with self._lock:
            self._values.clear()

    def remove(self, **labels: str) -> None:
        """Drop one labelled series (a stopped server's gauges must not
        linger in the scrape)."""
        key = self._key(labels)
        with self._lock:
            self._values.pop(key, None)

    def samples(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        for key, value in items:
            yield (
                f"{self.name}{_format_labels(self.labelnames, key)} "
                f"{_format_value(value)}"
            )


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self, name, help, labelnames=(), buckets=DEFAULT_TIME_BUCKETS, **kwargs
    ):
        super().__init__(name, help, labelnames, **kwargs)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self.bounds = tuple(bounds)
        # per label-key: [bucket counts...], sum, count
        self._series: dict[tuple[str, ...], list] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        value = float(value)
        with self._lock:
            key = self._bounded_key(key, self._series)
            series = self._series.get(key)
            if series is None:
                series = [[0] * len(self.bounds), 0.0, 0]
                self._series[key] = series
            idx = bisect.bisect_left(self.bounds, value)
            if idx < len(self.bounds):
                series[0][idx] += 1
            series[1] += value
            series[2] += 1
        self._notify(key, value)

    def count(self, **labels: str) -> int:
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            return series[2] if series else 0

    def series_snapshot(self) -> dict[tuple[str, ...], dict]:
        """Per-label-set bucket state: ``{labelvalues: {buckets, sum,
        count}}`` (buckets are per-bound counts, not cumulative), for
        readers that derive sums or quantiles without re-parsing the
        text exposition."""
        with self._lock:
            return {
                key: {
                    "buckets": list(counts),
                    "sum": total,
                    "count": count,
                }
                for key, (counts, total, count) in self._series.items()
            }

    def samples(self) -> Iterable[str]:
        with self._lock:
            items = sorted(
                (key, (list(counts), total, count))
                for key, (counts, total, count) in self._series.items()
            )
        for key, (counts, total, count) in items:
            cumulative = 0
            for bound, bucket_count in zip(self.bounds, counts):
                cumulative += bucket_count
                labels = _format_labels(
                    self.labelnames + ("le",), key + (_format_value(bound),)
                )
                yield f"{self.name}_bucket{labels} {cumulative}"
            labels = _format_labels(self.labelnames + ("le",), key + ("+Inf",))
            yield f"{self.name}_bucket{labels} {count}"
            plain = _format_labels(self.labelnames, key)
            yield f"{self.name}_sum{plain} {_format_value(total)}"
            yield f"{self.name}_count{plain} {count}"


def histogram_quantile(
    bounds: Sequence[float], counts: Sequence[int], total: int, q: float
) -> Optional[float]:
    """Quantile estimate from per-bound (non-cumulative) bucket counts:
    the smallest bucket bound whose cumulative count reaches rank
    ``ceil(q * total)``. Observations above every bound clamp to the
    top bound."""
    if total <= 0:
        return None
    q = min(1.0, max(0.0, float(q)))
    rank = max(1, math.ceil(q * total))
    cumulative = 0
    for bound, count in zip(bounds, counts):
        cumulative += count
        if cumulative >= rank:
            return float(bound)
    return float(bounds[-1]) if bounds else None


class MetricsRegistry:
    """Name-indexed instrument registry + scrape-time collectors."""

    OVERFLOW_COUNTER_NAME = "cdt_metric_series_overflow_total"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []
        # Warning counter for cardinality-cap hits; created eagerly so
        # it exists (at 0 series) before any storm, and with a cap
        # bounded by metric-name count (and no on_overflow: the
        # accounting metric must not recurse into itself).
        self._overflow_counter = Counter(
            self.OVERFLOW_COUNTER_NAME,
            "Mutations collapsed into a metric's _overflow series "
            "because the per-metric label-set cap was hit",
            ("metric",),
            max_series=4096,
        )
        self._metrics[self.OVERFLOW_COUNTER_NAME] = self._overflow_counter

    def _record_overflow(self, name: str) -> None:
        self._overflow_counter.inc(metric=name)

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered with a different "
                        "type or label set"
                    )
                return existing
            kwargs.setdefault("on_overflow", self._record_overflow)
            metric = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str, labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str, labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    # --- collectors -------------------------------------------------------

    def register_collector(self, fn: Callable[[], None]) -> Callable[[], None]:
        """Register a scrape-time callback that refreshes live-state
        gauges; returns an unregister callable."""
        with self._lock:
            self._collectors.append(fn)

        def unregister() -> None:
            with self._lock:
                if fn in self._collectors:
                    self._collectors.remove(fn)

        return unregister

    # --- exposition -------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition (0.0.4). Collector errors are
        swallowed per collector: one broken data source must not take
        the whole scrape down."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 - scrape survives collectors
                pass
        with self._lock:
            metrics = [self._metrics[name] for name in sorted(self._metrics)]
        lines: list[str] = []
        for metric in metrics:
            lines.extend(metric.header())
            lines.extend(metric.samples())
        return "\n".join(lines) + "\n"


# --- global registry ------------------------------------------------------

_registry: MetricsRegistry | None = None
_registry_lock = threading.Lock()


def get_metrics_registry() -> MetricsRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry


def reset_metrics_registry() -> None:
    """Drop the global registry (tests)."""
    global _registry
    with _registry_lock:
        _registry = None
