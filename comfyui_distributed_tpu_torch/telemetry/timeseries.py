"""Bounded in-process time series: two-tier ring-buffer retention.

The port's own copy of comfyui_distributed_tpu/telemetry/timeseries.py.
The Prometheus surface (`/distributed/metrics`) is a *point-in-time*
scrape — it answers "what is the value now", never "what happened over
the last hour". The fleet observability plane needs history: queue-wait
p95 five minutes ago, a worker's tiles/sec trend, how long an SLO burn
has been running. An external TSDB would give us that, but this stack
is zero-dep by construction, so this module is the in-process
equivalent: a `SeriesStore` of named, labelled series, each retained in
two downsampling tiers —

- **raw tier**: one bucket per ``raw_step`` seconds (default 10 s),
  ``raw_points`` buckets deep (default 360 → one hour);
- **rollup tier**: one bucket per ``rollup_step`` seconds (default
  5 min), ``rollup_points`` buckets deep (default 288 → one day).

Every bucket aggregates the samples that landed in its step:
``{t, last, min, max, sum, count}`` — enough to reconstruct rates from
cumulative counters (``last`` deltas), envelopes from gauges
(min/max), and means. Windows recent enough for the raw tier come from
it; older windows fall back to the rollup tier, so a query never pays
more resolution than retention kept.

Cardinality is capped exactly like the metrics registry: at most
``CDT_METRIC_MAX_SERIES`` distinct label sets per series name; samples
for NEW label sets beyond the cap are dropped and counted in
``overflows`` (one worker-id churn storm must not grow master memory —
the same bound `telemetry/metrics.py` enforces on the scrape).

Thread-safe; the clock is injectable so tests drive windows and
retention deterministically. Consumed by `telemetry/fleet.py`
(FleetRegistry) and `telemetry/slo.py` (burn-rate windows).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from .metrics import _env_max_series

# Two-tier retention defaults: 1 h of 10 s raw points, 24 h of 5 min
# rollups. Fixed constants (not knobs): they bound memory at ~a few KB
# per series either way, and the fleet route reports the tier it
# answered from.
RAW_STEP_SECONDS = 10.0
RAW_POINTS = 360
ROLLUP_STEP_SECONDS = 300.0
ROLLUP_POINTS = 288


class _Tier:
    """One downsampling tier: a bounded list of step-aligned buckets."""

    __slots__ = ("step", "maxlen", "buckets")

    def __init__(self, step: float, maxlen: int) -> None:
        self.step = float(step)
        self.maxlen = int(maxlen)
        # list of dict buckets, oldest first; appended in time order
        self.buckets: list[dict[str, float]] = []

    def record(self, ts: float, value: float) -> None:
        t0 = (ts // self.step) * self.step
        if self.buckets and self.buckets[-1]["t"] == t0:
            b = self.buckets[-1]
            b["last"] = value
            b["min"] = min(b["min"], value)
            b["max"] = max(b["max"], value)
            b["sum"] += value
            b["count"] += 1
            return
        if self.buckets and self.buckets[-1]["t"] > t0:
            # clock went backwards across a bucket boundary (test clocks,
            # NTP steps): fold into the newest bucket rather than
            # corrupting time order
            self.record(self.buckets[-1]["t"], value)
            return
        self.buckets.append(
            {"t": t0, "last": value, "min": value, "max": value,
             "sum": value, "count": 1}
        )
        if len(self.buckets) > self.maxlen:
            del self.buckets[: len(self.buckets) - self.maxlen]

    def window(self, since_ts: float) -> list[dict[str, float]]:
        return [dict(b) for b in self.buckets if b["t"] >= since_ts]

    def value_at_or_before(self, ts: float) -> Optional[dict[str, float]]:
        """Newest bucket whose step started at or before `ts`."""
        found = None
        for b in self.buckets:
            if b["t"] <= ts:
                found = b
            else:
                break
        return dict(found) if found is not None else None

    def oldest(self) -> Optional[dict[str, float]]:
        return dict(self.buckets[0]) if self.buckets else None

    def latest(self) -> Optional[dict[str, float]]:
        return dict(self.buckets[-1]) if self.buckets else None


class _Series:
    __slots__ = ("raw", "rollup")

    def __init__(
        self, raw_step: float, raw_points: int,
        rollup_step: float, rollup_points: int,
    ) -> None:
        self.raw = _Tier(raw_step, raw_points)
        self.rollup = _Tier(rollup_step, rollup_points)

    def record(self, ts: float, value: float) -> None:
        self.raw.record(ts, value)
        self.rollup.record(ts, value)


class SeriesStore:
    """Named, labelled, two-tier retained series. All mutation and
    query methods are safe to call from any thread."""

    def __init__(
        self,
        raw_step: float = RAW_STEP_SECONDS,
        raw_points: int = RAW_POINTS,
        rollup_step: float = ROLLUP_STEP_SECONDS,
        rollup_points: int = ROLLUP_POINTS,
        max_series: Optional[int] = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.raw_step = float(raw_step)
        self.raw_points = int(raw_points)
        self.rollup_step = float(rollup_step)
        self.rollup_points = int(rollup_points)
        # same cap the metrics registry applies per metric name
        self.max_series = (
            max_series if max_series is not None else _env_max_series()
        )
        self.clock = clock
        self._lock = threading.Lock()
        # name -> {labels_tuple -> _Series}; labels_tuple is sorted
        # (key, value) pairs so label order never splits a series
        self._series: dict[str, dict[tuple, _Series]] = {}
        self.overflows = 0

    @staticmethod
    def _key(labels: dict[str, Any]) -> tuple:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    # --- writes -----------------------------------------------------------

    def record(
        self, name: str, value: float, ts: Optional[float] = None,
        **labels: Any,
    ) -> bool:
        """Record one sample; returns False when the per-name series cap
        rejected a NEW label set (established series always record)."""
        ts = self.clock() if ts is None else float(ts)
        key = self._key(labels)
        with self._lock:
            by_label = self._series.setdefault(name, {})
            series = by_label.get(key)
            if series is None:
                if len(by_label) >= self.max_series:
                    self.overflows += 1
                    return False
                series = _Series(
                    self.raw_step, self.raw_points,
                    self.rollup_step, self.rollup_points,
                )
                by_label[key] = series
            series.record(ts, float(value))
        return True

    # --- queries ----------------------------------------------------------

    def _get(self, name: str, labels: dict[str, Any]) -> Optional[_Series]:
        return self._series.get(name, {}).get(self._key(labels))

    def latest(self, name: str, **labels: Any) -> Optional[float]:
        with self._lock:
            series = self._get(name, labels)
            if series is None:
                return None
            b = series.raw.latest() or series.rollup.latest()
            return b["last"] if b else None

    def window(
        self, name: str, since_s: float, **labels: Any
    ) -> list[dict[str, float]]:
        """Buckets covering the last `since_s` seconds, oldest first.
        Served from the raw tier while it still covers the window,
        otherwise from the rollup tier (each bucket carries its own
        timestamp, so consumers see the resolution change)."""
        now = self.clock()
        since_ts = now - max(0.0, float(since_s))
        with self._lock:
            series = self._get(name, labels)
            if series is None:
                return []
            oldest_raw = series.raw.oldest()
            if oldest_raw is not None and oldest_raw["t"] <= since_ts:
                return series.raw.window(since_ts)
            # raw tier doesn't reach back far enough: rollup tier
            points = series.rollup.window(since_ts)
            return points if points else series.raw.window(since_ts)

    def delta(self, name: str, window_s: float, **labels: Any) -> float:
        """Cumulative-counter delta over the last `window_s` seconds:
        newest ``last`` minus the value at the window start (or the
        oldest retained value when history is shorter than the window).
        0.0 for unknown series."""
        now = self.clock()
        with self._lock:
            series = self._get(name, labels)
            if series is None:
                return 0.0
            newest = series.raw.latest() or series.rollup.latest()
            if newest is None:
                return 0.0
            start_ts = now - float(window_s)
            base = series.raw.value_at_or_before(start_ts)
            if base is None:
                # The raw tier doesn't reach back to the window start.
                # A rollup bucket may only serve as the base when it
                # covers history already EVICTED from raw — a rollup
                # bucket overlapping raw coverage (its 5 min span can
                # contain `now` itself) carries a `last` contaminated
                # by samples newer than the window start, which would
                # zero the delta. Otherwise: delta over the available
                # history (oldest raw bucket).
                oldest_raw = series.raw.oldest()
                roll = series.rollup.value_at_or_before(start_ts)
                if roll is not None and (
                    oldest_raw is None
                    or roll["t"] + self.rollup_step <= oldest_raw["t"]
                ):
                    base = roll
                else:
                    base = oldest_raw or series.rollup.oldest()
            if base is None or base["t"] > newest["t"]:
                return 0.0
            if base is newest or base["t"] == newest["t"]:
                return 0.0
            return newest["last"] - base["last"]

    # --- lifecycle / accounting -------------------------------------------

    def label_values(self, name: str, label: str) -> list[str]:
        with self._lock:
            out = set()
            for key in self._series.get(name, {}):
                for k, v in key:
                    if k == label:
                        out.add(v)
            return sorted(out)

    def evict_label(self, label: str, value: str) -> int:
        """Drop every series (any name) carrying ``label=value`` — the
        departed-worker eviction seam. Returns series dropped."""
        pair = (str(label), str(value))
        dropped = 0
        with self._lock:
            for by_label in self._series.values():
                for key in [k for k in by_label if pair in k]:
                    del by_label[key]
                    dropped += 1
        return dropped

    def series_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._series.values())

    def names(self) -> list[str]:
        with self._lock:
            return sorted(n for n, v in self._series.items() if v)

    def counts_by_name(self) -> dict[str, int]:
        with self._lock:
            return {n: len(v) for n, v in sorted(self._series.items()) if v}
