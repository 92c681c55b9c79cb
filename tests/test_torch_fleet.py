"""The port's fleet plane held to the JAX package's, decision for
decision, on the CPU, with injected clocks and no sleeps (scenarios
after the JAX package's tests/test_timeseries.py, tests/test_slo.py,
tests/test_fleet_registry.py and tests/api/test_usage_routes.py):

- SeriesStore: bucket aggregates, raw and rollup windows, counter
  deltas, the series cap, label eviction, a clock that steps back;
- SLOEngine: burn rates over both windows, alert firing, the min-events
  guard, the resolve hold and flap suppression, latency
  classification, counter regressions;
- FleetRegistry: the version gate, rates on the master's clock, rollups
  (sums and max envelopes), TTL and forget eviction, the worker bound
  under id churn, master-side sampling into the SLO engine;
- UsageAggregator: adoption of worker meters by delta across a counter
  reset, tenant attribution through the store's job attrs, the measured
  cost ratio, the `cdt_usage_*` scrape mirror;
- the worker's snapshot: the JAX schema and version, the port's memory
  block read through telemetry/runtime.py, `devices` 1 and a `jax`
  block of zeros.
"""

import asyncio

import pytest

from comfyui_distributed_tpu.telemetry import fleet as jfleet
from comfyui_distributed_tpu.telemetry import instruments as jinstruments
from comfyui_distributed_tpu.telemetry import metrics as jmetrics
from comfyui_distributed_tpu.telemetry import profiling as jprofiling
from comfyui_distributed_tpu.telemetry import slo as jslo
from comfyui_distributed_tpu.telemetry import timeseries as jts
from comfyui_distributed_tpu.telemetry import usage as jusage
from comfyui_distributed_tpu_torch.telemetry import fleet as tfleet
from comfyui_distributed_tpu_torch.telemetry import instruments as tinstruments
from comfyui_distributed_tpu_torch.telemetry import metrics as tmetrics
from comfyui_distributed_tpu_torch.telemetry import profiling as tprofiling
from comfyui_distributed_tpu_torch.telemetry import slo as tslo
from comfyui_distributed_tpu_torch.telemetry import timeseries as tts
from comfyui_distributed_tpu_torch.telemetry import usage as tusage

SIDES = {
    "jax": {"ts": jts, "slo": jslo, "fleet": jfleet, "usage": jusage, "metrics": jmetrics,
            "instruments": jinstruments, "profiling": jprofiling},
    "port": {"ts": tts, "slo": tslo, "fleet": tfleet, "usage": tusage, "metrics": tmetrics,
             "instruments": tinstruments, "profiling": tprofiling},
}


@pytest.fixture(autouse=True)
def fresh_telemetry(monkeypatch):
    """Fresh process-global registries, meters and transfer ledgers (the
    rollup reads this process's ledger; other tests in the process feed
    it)."""
    for side in SIDES.values():
        monkeypatch.setattr(side["metrics"], "_registry", None)
        monkeypatch.setattr(side["profiling"], "_ledger", None)
        side["usage"]._reset_usage_meter_for_tests()


class Clock:
    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def both(scenario, *args):
    return tuple(scenario(SIDES[side], *args) for side in ("jax", "port"))


def _exposition(side, *prefixes):
    return [line for line in side["metrics"].get_metrics_registry().render().splitlines()
            if line.startswith(prefixes)]


def _series(side):
    clock = Clock(1000.0)
    store = side["ts"].SeriesStore(clock=clock, max_series=3)
    out = []
    for step in range(400):
        clock.t += 5.0
        store.record("tiles", float(step), worker_id="w1")
        store.record("gauge", (step * 7) % 11, worker_id="w1", stage="sample")
        store.record("gauge", step % 5, stage="sample", worker_id="w2")  # label order
        if step % 50 == 0:
            store.record("tiles", 1.0, worker_id=f"churn{step}")
    clock.t -= 30.0  # a clock that steps back folds into the newest bucket
    store.record("tiles", 399.5, worker_id="w1")
    clock.t += 30.0
    for window in (30.0, 600.0, 3600.0, 7200.0):
        out.append((window, store.window("tiles", window, worker_id="w1"),
                    store.delta("tiles", window, worker_id="w1"),
                    store.window("gauge", window, stage="sample", worker_id="w2")))
    out.append(("counts", store.series_count(), store.counts_by_name(), store.overflows,
                sorted(store.label_values("tiles", "worker_id"))))
    out.append(("evicted", store.evict_label("worker_id", "w1"), store.series_count()))
    return out


def test_series_windows_deltas_and_caps_equal_the_jax_store():
    jax_out, port_out = both(_series)
    assert port_out == jax_out
    assert port_out[-2][3] > 0  # the cap dropped new label sets


def _slo(side):
    clock = Clock()
    engine = side["slo"].SLOEngine(clock=clock)
    out = []
    for minute in range(40):
        bad = 10 <= minute < 20 or minute in (25, 27, 29)
        for _ in range(12):
            clock.t += 5.0
            engine.note_event("availability", bad=bad)
            engine.note_latency("tile_latency", 9.0 if bad and minute % 2 else 0.5)
        engine.set_counts("deadline_miss", bad=minute // 10, total=minute * 3)
        if minute == 30:
            engine.set_counts("deadline_miss", bad=0, total=0)  # a source reset: clamped
        transitions = engine.step()
        out.append((minute, [(t["type"], t["slo"]) for t in transitions],
                    sorted(engine.active()),
                    {name: engine.evaluate(name)["rules"] for name in engine.specs}))
    status = engine.status()
    out.append(("status", [(a["slo"], a["active"], a["since"]) for a in status["alerts"]],
                status["active"], [(h["type"], h["slo"], h["ts"]) for h in status["history"]]))
    out.append(("gauges", _exposition(side, "cdt_alert_active")))
    return out


def test_burn_rates_and_alert_states_equal_the_jax_engine():
    jax_out, port_out = both(_slo)
    assert port_out == jax_out
    fired = [row for row in port_out[:40] if row[1]]
    assert ("alert_fired", "availability") in [t for row in fired for t in row[1]]
    assert ("alert_resolved", "availability") in [t for row in fired for t in row[1]]


def _snap(side, tiles=0.0, devices=1, **extra):
    out = {"v": side["fleet"].SNAPSHOT_VERSION, "tiles_total": tiles, "devices": devices}
    out.update(extra)
    return out


def _fleet(side):
    """Snapshots from two workers, a bad version, a malformed one, a
    counter reset, TTL and forget eviction, id churn past the bound, and
    the master-side sampling into the SLO engine."""

    async def run():
        from types import SimpleNamespace

        clock = Clock()
        store = side["ts"].SeriesStore(clock=clock)
        registry = side["fleet"].FleetRegistry(store=store, clock=clock, ttl=60.0,
                                               max_workers=8)
        slo = side["slo"].SLOEngine(store=store, clock=clock)
        queue = SimpleNamespace(totals={"admitted": 40, "rejected_full": 2,
                                        "rejected_draining": 1})
        brownout = SimpleNamespace(signals=lambda: {"wait_p95": 0.25, "journal_p95": 0.0},
                                   shed_counts={"background": 3})
        placement = SimpleNamespace(weights=lambda: {"w1": 1.2, "w2": 0.8})
        registry.bind_master(scheduler=SimpleNamespace(queue=queue, brownout=brownout,
                                                       placement=placement), slo=slo)
        out = [("gate", registry.note_snapshot("w1", _snap(side, tiles=10)),
                registry.note_snapshot("bad", {"v": 99}),
                registry.note_snapshot("junk", "not-a-dict"))]
        clock.t += 10.0
        registry.note_snapshot("w1", _snap(
            side, tiles=30, devices=1, inflight=1,
            stages={"sample": {"p50": 0.1, "p95": 0.5, "count": 10}},
            jax={"compiles": 0, "cache_hits": 0, "cache_misses": 0},
            mem={"hbm_peak_bytes": 100, "rss_bytes": 50}))
        registry.note_snapshot("w2", _snap(
            side, tiles=5, devices=2, inflight=2,
            stages={"sample": {"p50": 0.2, "p95": 0.9, "count": 5}},
            mem={"hbm_peak_bytes": 300, "rss_bytes": 20}))
        clock.t += 10.0
        registry.note_snapshot("w1", _snap(side, tiles=0))  # a restarted worker
        out.append(("rollup", registry.rollup(master_rate=0.5)))
        out.append(("sample", registry.sample()))
        out.append(("status", registry.status(since_s=600.0)))
        clock.t += 61.0
        registry.note_snapshot("w2", _snap(side, tiles=9))
        out.append(("swept", registry.sweep(), registry.worker_ids()))
        registry.forget_worker("w2")
        for i in range(20):  # id churn stays bounded
            registry.note_snapshot(f"churn{i}", _snap(side))
            clock.t += 0.1
        out.append(("bounded", registry.worker_ids(), store.series_count()))
        out.append(("slo", {name: slo.evaluate(name)["rules"] for name in slo.specs}))
        out.append(("metrics", _exposition(side, "cdt_fleet_")))
        return out

    return asyncio.run(run())


def test_fleet_rollups_eviction_and_sampling_equal_the_jax_registry():
    jax_out, port_out = both(_fleet)
    assert port_out == jax_out
    gate = port_out[0]
    assert gate[1:] == (True, False, False)
    rollup = port_out[1][1]
    assert rollup["devices"] == 3 and rollup["mem"]["hbm_peak_bytes"] == 300
    assert len(port_out[-3][1]) == 8  # the bound under churn


USAGE = {
    "jobs": {"job-u": {"chip_s": 3.0, "steps": 60, "tiles": 12, "waste_s": 0.25}},
    "waste_s": {"padding": 0.5, "preempt_recompute": 0.25},
    "dispatch_chip_s": 3.75, "attributed_chip_s": 3.0, "overhead_s": 0.0, "dispatches": 20,
}


def _usage(side):
    """A worker's cumulative meter adopted by delta, then the worker
    restarts (its counters fall: a fresh baseline, never a negative
    delta); the master's own dispatches beside it; tenants resolved
    through the job attrs; the cost ratio; the scrape mirror."""
    clock = Clock()
    meter = side["usage"].UsageMeter(clock=clock)
    aggregator = side["usage"].UsageAggregator(meter=meter, clock=clock, ttl=3600.0)
    meter.note_job_attrs("job-u", "tenant-u", "batch")
    meter.note_job_attrs("job-m", "tenant-m", "interactive")
    meter.note_dispatch(tier="scan", role="master", elapsed_s=0.5, chips=1,
                        slots=[{"job_id": "job-m", "kind": side["usage"].SLOT_REAL}] * 2)
    meter.note_tiles("master", "job-m", 2)
    out = [("first", aggregator.adopt("w1", USAGE), aggregator.rollup())]
    again = {**USAGE, "jobs": {"job-u": {"chip_s": 5.0, "steps": 100, "tiles": 20,
                                         "waste_s": 0.25}}, "dispatch_chip_s": 5.75,
             "attributed_chip_s": 5.0, "dispatches": 30}
    out.append(("grew", aggregator.adopt("w1", again), aggregator.rollup()["jobs"]["job-u"]))
    restarted = {**USAGE, "jobs": {"job-u": {"chip_s": 1.0, "steps": 10, "tiles": 2,
                                             "waste_s": 0.0}}, "dispatch_chip_s": 1.0,
                 "attributed_chip_s": 1.0, "dispatches": 5}
    out.append(("reset", aggregator.adopt("w1", restarted), aggregator.rollup()))
    out.append(("junk", aggregator.adopt("w2", "nope"), aggregator.adopt("w2", {"jobs": 7})))
    clock.t += 10.0
    out.append(("sample", aggregator.sample(), aggregator.cost_ratio("tenant-u"),
                aggregator.cost_ratio("tenant-m"), aggregator.cost_ratio("nobody")))
    out.append(("pairs", aggregator.pair_totals()))
    out.append(("status", aggregator.status(tenant="tenant-u")))
    aggregator.forget_worker("w1")
    out.append(("forgot", aggregator.adopt("w1", restarted), aggregator.rollup()["totals"]))
    return out


def test_usage_adoption_across_a_counter_reset_equals_the_jax_aggregator():
    jax_out, port_out = both(_usage)
    assert port_out == jax_out
    assert port_out[1][2]["chip_s"] == pytest.approx(5.0)
    # the restarted worker's 1.0 s is a fresh baseline on top, not a -4 s delta
    assert port_out[2][2]["jobs"]["job-u"]["chip_s"] == pytest.approx(6.0)


def _scrape_mirror(side):
    """The cdt_usage_* families mirror the aggregator at scrape time, by
    delta against its high-water marks, through a server's collectors."""
    from types import SimpleNamespace

    clock = Clock()
    meter = side["usage"].get_usage_meter()
    meter.note_job_attrs("job-u", "tenant-u", "batch")
    registry = side["fleet"].FleetRegistry(clock=clock)
    registry.usage.adopt("w1", USAGE)
    store = SimpleNamespace(stats_unlocked=lambda: {"tile_jobs": 0, "collectors": 0,
                                                    "queue_depth": 0, "in_flight": 0})
    server = SimpleNamespace(is_worker=False, port=1, queue_remaining=0, job_store=store,
                             fleet=registry, slo=None, scheduler=None)
    unbind = side["instruments"].bind_server_collectors(server)
    try:
        body = side["metrics"].get_metrics_registry().render()
        registry.usage.adopt("w1", {**USAGE, "dispatch_chip_s": 4.0, "jobs": {
            "job-u": {"chip_s": 3.5, "steps": 70, "tiles": 14, "waste_s": 0.25}}})
        body2 = side["metrics"].get_metrics_registry().render()
    finally:
        unbind()
    keep = ("cdt_usage_",)
    return ([line for line in body.splitlines() if line.startswith(keep)],
            [line for line in body2.splitlines() if line.startswith(keep)])


def test_the_usage_scrape_mirror_equals_the_jax_mirror():
    jax_out, port_out = both(_scrape_mirror)
    assert port_out == jax_out
    assert 'cdt_usage_chip_seconds_total{tenant="tenant-u",lane="batch"} 3.5' in port_out[1]


def test_the_worker_snapshot_has_the_jax_schema_with_the_port_s_readings():
    for side in SIDES.values():
        side["instruments"].tile_stage_seconds().observe(0.25, stage="sample", role="worker")
        side["instruments"].tiles_processed_total().inc(3, role="worker")
    jax_snap, port_snap = (SIDES[s]["fleet"].local_snapshot(role="worker")
                           for s in ("jax", "port"))
    assert set(port_snap) == set(jax_snap)
    assert port_snap["v"] == jax_snap["v"] == 3
    assert port_snap["stages"] == jax_snap["stages"]
    assert port_snap["tiles_total"] == jax_snap["tiles_total"] == 3
    assert port_snap["devices"] == 1 and port_snap["mesh"] == {}
    assert port_snap["jax"] == {"compiles": 0, "compile_time_s": 0.0, "cache_hits": 0,
                                "cache_misses": 0}
    assert set(port_snap["mem"]) == set(jax_snap["mem"])
    assert port_snap["mem"]["hbm_peak_bytes"] == 0 and port_snap["mem"]["rss_bytes"] > 0
    assert set(port_snap["usage"]) == set(jax_snap["usage"])
    assert set(port_snap["profiling"]) == set(jax_snap["profiling"])
