"""The port's flight recorder held to the JAX package's, on the CPU.

- One seeded event sequence (plain publishes, metric mutations and spans
  through the forwarding hooks) on each package's bus gives equal dumps,
  apart from timestamps and span ids: compared exactly.
- Ring capacity, drop-oldest and the append and drop accounting, at
  several capacities, equal in both packages.
- After a bus reset the global recorder taps the new bus in both.
- CDT_FLIGHT=0: no recorder in either package, and a port server built
  so installs no tap.
- The scrape mirrors the recorder's drops into cdt_flight_dropped_total
  by delta, once across two co-hosted servers, as the JAX collector does.
- A default port master and w1 each have the recorder on their bus.
"""

import types

import numpy as np
import pytest

from comfyui_distributed_tpu.telemetry import events as jevents
from comfyui_distributed_tpu.telemetry import flight as jflight
from comfyui_distributed_tpu.telemetry import instruments as jinstruments
from comfyui_distributed_tpu.telemetry import metrics as jmetrics
from comfyui_distributed_tpu.telemetry import tracing as jtracing
from comfyui_distributed_tpu.utils import constants as jconstants
from comfyui_distributed_tpu_torch.telemetry import events as tevents
from comfyui_distributed_tpu_torch.telemetry import flight as tflight
from comfyui_distributed_tpu_torch.telemetry import instruments as tinstruments
from comfyui_distributed_tpu_torch.telemetry import metrics as tmetrics
from comfyui_distributed_tpu_torch.telemetry import tracing as ttracing
from comfyui_distributed_tpu_torch.utils import constants as tconstants

from test_torch_parity import port_loop  # noqa: F401  (fixture)

SIDES = {
    "jax": (jevents, jflight, jmetrics, jtracing, jinstruments),
    "port": (tevents, tflight, tmetrics, ttracing, tinstruments),
}


@pytest.fixture(autouse=True)
def fresh_planes():
    """Fresh buses, registries, tracers and recorders on both sides, before
    and after (the port's are process-global and tests/conftest.py resets
    only the JAX package's)."""
    def reset():
        for events, flight, metrics, tracing, _ in SIDES.values():
            flight.reset_flight_recorder()
            events.reset_event_bus()
            metrics.reset_metrics_registry()
            tracing.reset_tracer()

    reset()
    yield
    reset()


def _script(events, metrics, tracing, seed: int, n: int = 120):
    """A seeded mix of bus publishes, counter/gauge/histogram mutations and
    nested spans, each reaching the bus as the package publishes it."""
    rng = np.random.default_rng(seed)
    bus = events.get_event_bus()
    reg = metrics.get_metrics_registry()
    counter = reg.counter("cdt_flight_demo_total", "Demo counter", ("worker_id",))
    gauge = reg.gauge("cdt_flight_demo_depth", "Demo gauge")
    hist = reg.histogram("cdt_flight_demo_seconds", "Demo histogram", ("stage",))
    tracer = tracing.get_tracer()
    for i in range(n):
        op = int(rng.integers(0, 5))
        if op == 0:
            bus.publish(("job_ready", "alert_fired", "grant_available")[int(rng.integers(0, 3))],
                        job_id=f"j{int(rng.integers(0, 3))}", n=i)
        elif op == 1:
            counter.inc(float(rng.integers(1, 4)), worker_id=f"w{int(rng.integers(0, 2))}")
        elif op == 2:
            gauge.set(float(rng.integers(0, 9)))
        elif op == 3:
            hist.observe(float(rng.random()), stage="sample")
        else:
            with tracer.span("outer", trace_id=f"exec_{int(rng.integers(0, 2))}", step=i):
                with tracer.span("inner", tile=int(rng.integers(0, 4))):
                    pass


def _canonical(dump: dict) -> dict:
    """The dump without its clocks and random span ids: each span id
    becomes its order of first appearance."""
    ids: dict = {}

    def canon(value):
        return None if value is None else ids.setdefault(value, len(ids))

    def strip(event):
        data = dict(event["data"])
        for key in ("start", "end", "duration"):
            data.pop(key, None)
        if "span_id" in data:
            data["span_id"] = canon(data["span_id"])
            data["parent_id"] = canon(data["parent_id"])
        return {"type": event["type"], "seq": event["seq"], "data": data}

    return {"events": [strip(e) for e in dump["events"]],
            "spans": [strip(e) for e in dump["spans"]],
            "appended": dump["appended"], "dropped": dump["dropped"]}


@pytest.mark.parametrize("seed, capacity", [(0, 4096), (1, 64), (2, 7)])
def test_one_event_sequence_gives_equal_dumps(seed, capacity):
    dumps, status = {}, {}
    for side, (events, flight, metrics, tracing, _) in SIDES.items():
        recorder = flight.FlightRecorder(event_capacity=capacity, span_capacity=capacity)
        recorder.install()
        _script(events, metrics, tracing, seed)
        dumps[side] = recorder.dump()
        status[side] = recorder.status()
        recorder.uninstall()
    assert set(dumps["port"]) == set(dumps["jax"])
    assert _canonical(dumps["port"]) == _canonical(dumps["jax"])
    assert status["port"] == status["jax"]
    port = dumps["port"]
    assert {e["type"] for e in port["spans"]} <= {"span_close"}
    assert "span_open" in {e["type"] for e in port["events"]}
    if capacity < port["appended"]["events"]:
        assert port["dropped"]["events"] == port["appended"]["events"] - capacity


@pytest.mark.parametrize("capacity, appends", [(4, 10), (0, 2), (1, 1), (3, 3), (5, 4)])
def test_ring_capacity_and_drop_accounting_equal_the_jax_ring(capacity, appends):
    rings = {side: mods[1].FlightRing(capacity) for side, mods in SIDES.items()}
    for ring in rings.values():
        for i in range(appends):
            ring.append(i)
    port, jax_ = rings["port"], rings["jax"]
    assert port.snapshot() == jax_.snapshot()
    assert (port.capacity, len(port), port.appended, port.dropped) == (
        jax_.capacity, len(jax_), jax_.appended, jax_.dropped)
    assert port.dropped == max(0, appends - max(1, capacity))


def test_the_global_recorder_taps_the_new_bus_after_a_reset():
    seen = {}
    for side, (events, flight, _metrics, _tracing, _) in SIDES.items():
        recorder = flight.get_flight_recorder()
        assert recorder is not None and recorder.installed
        assert flight.peek_flight_recorder() is recorder
        events.get_event_bus().publish("before_reset")
        events.reset_event_bus()
        assert flight.get_flight_recorder() is recorder
        assert "flight" in events.get_event_bus().stats()["taps"]
        events.get_event_bus().publish("after_reset")
        seen[side] = [e["type"] for e in recorder.events.snapshot()]
    assert seen["port"] == seen["jax"] == ["before_reset", "after_reset"]


def test_peek_never_creates():
    for _events, flight, *_ in SIDES.values():
        assert flight.peek_flight_recorder() is None
        assert flight.get_flight_recorder() is not None
        assert flight.peek_flight_recorder() is not None


def test_cdt_flight_zero_turns_the_recorder_off(monkeypatch, tmp_path):
    from comfyui_distributed_tpu_torch.api.server import DistributedServer

    monkeypatch.setattr(jconstants, "FLIGHT_ENABLED", False)
    monkeypatch.setattr(tconstants, "FLIGHT_ENABLED", False)
    for events, flight, *_ in SIDES.values():
        assert flight.get_flight_recorder() is None
        assert flight.peek_flight_recorder() is None
        assert events.get_event_bus().stats()["taps"] == []
    server = DistributedServer(port=1, is_worker=False, device="cpu",
                               config_path=str(tmp_path / "c.json"))
    server._unbind_health()  # built, never started: nothing else to stop
    assert server.flight is None
    assert tevents.get_event_bus().has_listeners is False


def _fake_server(port: int):
    return types.SimpleNamespace(
        is_worker=False, port=port, queue_remaining=0,
        job_store=types.SimpleNamespace(stats_unlocked=lambda: {
            "tile_jobs": 0, "queue_depth": 0, "in_flight": 0, "collectors": 0}))


@pytest.mark.parametrize("servers", [1, 2])
def test_the_scrape_mirrors_ring_drops_once_as_the_jax_collector(servers):
    mirrored = {}
    for side, (events, flight, metrics, _tracing, instruments) in SIDES.items():
        recorder = flight.get_flight_recorder()
        recorder.events = flight.FlightRing(2)  # a tiny ring: drops come fast
        unbinds = [instruments.bind_server_collectors(_fake_server(p))
                   for p in range(1, servers + 1)]
        try:
            for i in range(6):
                events.get_event_bus().publish("tick", n=i)
            # freeze the ring: the scrape's own gauge sets would publish more
            recorder.uninstall()
            dropped = recorder.events.dropped
            metrics.get_metrics_registry().render()
            first = instruments.flight_dropped_total().value(stream="events")
            metrics.get_metrics_registry().render()  # no double count
            second = instruments.flight_dropped_total().value(stream="events")
            mirrored[side] = (dropped, first, second)
        finally:
            for unbind in unbinds:
                unbind()
    assert mirrored["port"] == mirrored["jax"]
    dropped, first, second = mirrored["port"]
    assert dropped == first == second >= 4


def test_a_default_master_and_w1_have_the_recorder_on_their_bus(tmp_path, port_loop):
    import asyncio

    from comfyui_distributed_tpu_torch.api.server import DistributedServer

    master = DistributedServer(port=0, is_worker=False, device="cpu",
                               config_path=str(tmp_path / "c.json"))
    worker = DistributedServer(port=0, is_worker=True, device="cpu",
                               config_path=str(tmp_path / "c.json"))
    for server in (master, worker):
        asyncio.run_coroutine_threadsafe(server.start(), port_loop.loop).result(timeout=30)
    try:
        recorder = tflight.peek_flight_recorder()
        assert master.flight is recorder and worker.flight is recorder
        assert recorder.installed
        assert tevents.get_event_bus().stats()["taps"] == ["flight"]
        assert master.incidents is None and worker.incidents is None
        before = recorder.events.appended
        tinstruments.store_pulls_total().inc(worker_id="w1", outcome="task")
        assert recorder.events.appended == before + 1
        assert recorder.events.snapshot()[-1]["data"]["metric"] == "cdt_store_pulls_total"
    finally:
        for server in (master, worker):
            asyncio.run_coroutine_threadsafe(server.stop(), port_loop.loop).result(timeout=30)
