"""Declarative SLOs evaluated with multi-window burn-rate alerting.

The port's own copy of comfyui_distributed_tpu/telemetry/slo.py. Its
journal_latency SLO takes a sample a journal append on a master with
CDT_JOURNAL_DIR (api/server.py), against the target CDT_SLO_JOURNAL_P95.
The Google SRE-workbook alerting idiom, built in-process and zero-dep:
an **SLO** declares what fraction of events must be *good* (the
objective — e.g. 99.9% of admissions not shed, 95% of tiles under the
latency threshold). The **error budget** is ``1 - objective``; the
**burn rate** over a window is

    burn(W) = bad(W) / total(W) / (1 - objective)

— 1.0 means the budget is being consumed exactly at the rate that
exhausts it over the SLO period; 14.4 means fourteen times faster.

Each SLO evaluates a set of **burn rules**, each pairing a *long*
window (significance: enough budget burned to matter) with a *short*
window (recency: it is STILL burning — the alert closes promptly once
the cause stops). An alert opens when ANY rule has both windows over
its threshold (with at least ``min_events`` in the long window so an
idle system can't alert on one unlucky event), and resolves when NO
rule's short window burns, sustained for ``resolve_hold_s`` — the
hysteresis that keeps a flapping boundary from ringing the pager.

Event plumbing:

- ``note_event(name, bad=...)`` — one good/bad event (ratio SLOs);
- ``note_latency(name, seconds)`` — one latency sample, classified
  against the spec's ``threshold_s`` (latency SLOs);
- ``set_counts(name, bad, total)`` — cumulative counters sampled from
  an external source (the FleetRegistry feeds admission/shed and
  deadline-miss totals this way).

All counts land as cumulative series in a `SeriesStore`
(telemetry/timeseries.py), so windowed burn rates are plain
counter-deltas over the retained history. Transitions publish
``alert_fired`` / ``alert_resolved`` on the process event bus, surface
on ``GET /distributed/alerts``, and mirror into the
``cdt_alert_active`` gauge — one signal, three consumers (stream,
poll, scrape). The clock is injectable: tests drive the whole
fast/slow-window interplay on a fake timeline.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

from ..utils import constants
from .timeseries import SeriesStore

# Series names the engine records under (label `slo` = spec name).
BAD_SERIES = "slo_bad_total"
TOTAL_SERIES = "slo_total_total"

# Bounded transition history served by /distributed/alerts.
HISTORY_LIMIT = 256


@dataclasses.dataclass(frozen=True)
class BurnRule:
    """One (long, short) window pair with its burn-rate threshold."""

    long_s: float
    short_s: float
    burn_threshold: float


# In-process defaults, scaled from the SRE workbook's 30-day idiom to a
# serving process's horizon: the fast rule pages on acute burn (5 min
# significance, 1 min recency), the slow rule on sustained burn (1 h
# significance, 5 min recency).
DEFAULT_RULES = (
    BurnRule(long_s=300.0, short_s=60.0, burn_threshold=14.4),
    BurnRule(long_s=3600.0, short_s=300.0, burn_threshold=6.0),
)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective. ``kind``:

    - ``ratio``: events arrive pre-classified (note_event/set_counts);
    - ``latency``: samples classify against ``threshold_s`` — the SLO
      reads "``objective`` of samples complete under ``threshold_s``"
      (the histogram-free way to alert on a pXX target: p95 <= T is
      exactly '>= 95% of samples under T').
    """

    name: str
    description: str
    objective: float
    kind: str = "ratio"
    threshold_s: Optional[float] = None
    rules: tuple[BurnRule, ...] = DEFAULT_RULES
    resolve_hold_s: float = 60.0
    min_events: int = 10

    def budget(self) -> float:
        return max(1e-9, 1.0 - float(self.objective))


def default_slos() -> tuple[SLOSpec, ...]:
    """The load-bearing objectives for one master (thresholds are
    knob-tunable)."""
    return (
        SLOSpec(
            name="availability",
            description="admissions not shed by brownout/saturation "
                        "(good = admitted, bad = shed or rejected-full)",
            objective=0.999,
        ),
        SLOSpec(
            name="tile_latency",
            description="tile pull-to-submit latency under the p95 target "
                        f"({constants.SLO_TILE_P95_SECONDS:g}s, "
                        "CDT_SLO_TILE_P95)",
            objective=0.95,
            kind="latency",
            threshold_s=constants.SLO_TILE_P95_SECONDS,
        ),
        SLOSpec(
            name="deadline_miss",
            description="jobs not cancelled for blowing their end-to-end "
                        "deadline (bad = deadline cancels, total = "
                        "admissions)",
            objective=0.999,
        ),
        SLOSpec(
            name="journal_latency",
            description="write-ahead journal appends under the latency "
                        f"target ({constants.SLO_JOURNAL_P95_SECONDS:g}s, "
                        "CDT_SLO_JOURNAL_P95)",
            objective=0.99,
            kind="latency",
            threshold_s=constants.SLO_JOURNAL_P95_SECONDS,
        ),
    )


class SLOEngine:
    """Burn-rate evaluation + alert state machine over a SeriesStore."""

    def __init__(
        self,
        specs: Optional[Sequence[SLOSpec]] = None,
        store: Optional[SeriesStore] = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.clock = clock
        self.store = store if store is not None else SeriesStore(clock=clock)
        self.specs: dict[str, SLOSpec] = {
            s.name: s for s in (specs if specs is not None else default_slos())
        }
        self._lock = threading.Lock()
        # cumulative (bad, total) per spec — the authoritative counters;
        # the store retains their history for windowing
        self._counts: dict[str, list[float]] = {
            name: [0.0, 0.0] for name in self.specs
        }
        # alert state per spec: active flag + timestamps driving the
        # resolve hysteresis
        self._state: dict[str, dict] = {
            name: {"active": False, "since": None, "clear_since": None}
            for name in self.specs
        }
        self.history: collections.deque = collections.deque(
            maxlen=HISTORY_LIMIT
        )

    # --- feeds ------------------------------------------------------------

    def note_event(self, name: str, bad: bool, n: int = 1) -> None:
        """n pre-classified events for a ratio SLO."""
        if name not in self.specs or n <= 0:
            return
        with self._lock:
            counts = self._counts[name]
            counts[0] += float(n) if bad else 0.0
            counts[1] += float(n)
            bad_total, total = counts
        self._record(name, bad_total, total)

    def note_latency(self, name: str, seconds: float) -> None:
        """One latency sample for a latency SLO: bad iff it exceeds the
        spec's threshold."""
        spec = self.specs.get(name)
        if spec is None or spec.threshold_s is None:
            return
        self.note_event(name, bad=float(seconds) > spec.threshold_s)

    def set_counts(self, name: str, bad: float, total: float) -> None:
        """Adopt cumulative counters maintained elsewhere (monotonic;
        regressions — a source reset — clamp to the last seen value so
        a restarted counter never produces negative window deltas)."""
        if name not in self.specs:
            return
        with self._lock:
            counts = self._counts[name]
            counts[0] = max(counts[0], float(bad))
            counts[1] = max(counts[1], float(total))
            bad_total, total_now = counts
        self._record(name, bad_total, total_now)

    def _record(self, name: str, bad_total: float, total: float) -> None:
        self.store.record(BAD_SERIES, bad_total, slo=name)
        self.store.record(TOTAL_SERIES, total, slo=name)

    # --- evaluation -------------------------------------------------------

    def _burn(self, name: str, window_s: float) -> tuple[float, float]:
        """(burn_rate, total_events) over the last `window_s`."""
        spec = self.specs[name]
        bad = self.store.delta(BAD_SERIES, window_s, slo=name)
        total = self.store.delta(TOTAL_SERIES, window_s, slo=name)
        if total <= 0:
            return 0.0, 0.0
        return (bad / total) / spec.budget(), total

    def evaluate(self, name: str) -> dict:
        """Burn rates for every rule of one spec (no state change)."""
        spec = self.specs[name]
        rules = []
        firing = False
        for rule in spec.rules:
            burn_long, total_long = self._burn(name, rule.long_s)
            burn_short, _ = self._burn(name, rule.short_s)
            rule_firing = (
                total_long >= spec.min_events
                and burn_long >= rule.burn_threshold
                and burn_short >= rule.burn_threshold
            )
            still_burning = burn_short >= rule.burn_threshold
            firing = firing or rule_firing
            rules.append(
                {
                    "long_s": rule.long_s,
                    "short_s": rule.short_s,
                    "threshold": rule.burn_threshold,
                    "burn_long": round(burn_long, 4),
                    "burn_short": round(burn_short, 4),
                    "events_long": total_long,
                    "firing": rule_firing,
                    "still_burning": still_burning,
                }
            )
        return {
            "slo": name,
            "firing": firing,
            "still_burning": any(r["still_burning"] for r in rules),
            "rules": rules,
        }

    def step(self) -> list[dict]:
        """One evaluation pass over every spec; returns the transitions
        that happened (also published on the bus + mirrored into
        cdt_alert_active). Cheap enough for a multi-second cadence."""
        transitions: list[dict] = []
        now = self.clock()
        for name, spec in self.specs.items():
            verdict = self.evaluate(name)
            with self._lock:
                state = self._state[name]
                if not state["active"]:
                    if verdict["firing"]:
                        state["active"] = True
                        state["since"] = now
                        state["clear_since"] = None
                        transitions.append(
                            self._transition("alert_fired", spec, verdict, now)
                        )
                    continue
                # active: resolve only after a SUSTAINED clear of every
                # short window (flap suppression — a boundary bouncing
                # above/below threshold keeps resetting the hold)
                if verdict["still_burning"] or verdict["firing"]:
                    state["clear_since"] = None
                    continue
                if state["clear_since"] is None:
                    state["clear_since"] = now
                if now - state["clear_since"] >= spec.resolve_hold_s:
                    state["active"] = False
                    fired_at = state["since"]
                    state["since"] = None
                    state["clear_since"] = None
                    transitions.append(
                        self._transition(
                            "alert_resolved", spec, verdict, now,
                            fired_at=fired_at,
                        )
                    )
        for transition in transitions:
            self._publish(transition)
        if transitions:
            self._refresh_gauge()
        return transitions

    def _transition(
        self, kind: str, spec: SLOSpec, verdict: dict, now: float,
        fired_at: Optional[float] = None,
    ) -> dict:
        out = {
            "type": kind,
            "slo": spec.name,
            "description": spec.description,
            "objective": spec.objective,
            "ts": now,
            "rules": verdict["rules"],
        }
        if fired_at is not None:
            out["active_seconds"] = round(now - fired_at, 3)
        self.history.append(out)
        return out

    def _publish(self, transition: dict) -> None:
        from .events import get_event_bus

        data = {k: v for k, v in transition.items() if k != "type"}
        try:
            get_event_bus().publish(transition["type"], **data)
        except Exception:  # noqa: BLE001 - alerting must not break eval
            pass

    def _refresh_gauge(self) -> None:
        from . import instruments

        try:
            gauge = instruments.alert_active()
            for name in self.specs:
                gauge.set(
                    1.0 if self._state[name]["active"] else 0.0, slo=name
                )
        except Exception:  # noqa: BLE001 - scrape mirror is best effort
            pass

    # --- surfaces ---------------------------------------------------------

    def active(self) -> dict[str, dict]:
        with self._lock:
            return {
                name: {"since": state["since"]}
                for name, state in self._state.items()
                if state["active"]
            }

    def is_active(self, name: str) -> bool:
        with self._lock:
            state = self._state.get(name)
            return bool(state and state["active"])

    def status(self) -> dict:
        """The /distributed/alerts payload: every spec's current burn
        evaluation + alert state, plus the bounded transition history."""
        specs = []
        for name, spec in self.specs.items():
            verdict = self.evaluate(name)
            with self._lock:
                state = dict(self._state[name])
            specs.append(
                {
                    "slo": name,
                    "description": spec.description,
                    "objective": spec.objective,
                    "kind": spec.kind,
                    "threshold_s": spec.threshold_s,
                    "active": state["active"],
                    "since": state["since"],
                    "rules": verdict["rules"],
                }
            )
        with self._lock:
            # copy under the lock: the monitor thread appends
            # transitions concurrently, and iterating a mutating deque
            # raises — turning the alerts route into a 500 at exactly
            # the moment an alert fires
            history = list(self.history)
        return {
            "alerts": specs,
            "active": sorted(self.active()),
            "history": history,
        }
