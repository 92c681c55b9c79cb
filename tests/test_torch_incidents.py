"""The port's incident manager held to the JAX package's, on the CPU.

- A seeded trigger storm on an injected clock gives the same disposition
  for every trigger in both packages (queued, debounced, rate_limited,
  overflow, closed) and the same counters: compared exactly.
- A bound port master's bundle has the JAX master's bundle keys (neither
  master journals, so neither has `durability`), the same keys in each
  section the two share, and passes both packages' `validate_bundle`.
- Retention prunes the oldest bundles by count and by bytes, never the
  newest, as the JAX manager does; ids are equal on one clock.
- The three incident routes answer the JAX routes' statuses and keys,
  disabled ones included.
- A master with CDT_INCIDENT_DIR has an IncidentManager; a worker never
  does. The port's own trigger events (alert_fired, tile_quarantined)
  capture through the bus tap.
"""

import asyncio
import json
import os
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

from comfyui_distributed_tpu.telemetry import incidents as jincidents
from comfyui_distributed_tpu_torch.telemetry import incidents as tincidents

from test_torch_parity import port_loop  # noqa: F401  (fixture)


class FakeClock:
    def __init__(self, start: float = 1000.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


def _reset_port_planes():
    from comfyui_distributed_tpu_torch.resilience import health
    from comfyui_distributed_tpu_torch.telemetry import events, flight, metrics, tracing

    flight.reset_flight_recorder()
    events.reset_event_bus()
    metrics.reset_metrics_registry()
    tracing.reset_tracer()
    health.reset_health_registry()


@pytest.fixture(autouse=True)
def fresh_port_planes():
    """The port's bus, registry, tracer and breakers are process-global
    (tests/conftest.py resets the JAX package's only)."""
    _reset_port_planes()
    yield
    _reset_port_planes()


def _managers(tmp_path, **kw):
    clock = FakeClock()
    out = {}
    for side, module in (("jax", jincidents), ("port", tincidents)):
        out[side] = module.IncidentManager(str(tmp_path / side), clock=clock, **kw)
    return out, clock


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_trigger_storm_gives_equal_dispositions(tmp_path, seed):
    """First six manual triggers with no writer running fill the 4-deep
    queue the same way in both packages (overflow is deterministic);
    then a seeded storm with the writers on, each queued capture flushed
    before the next trigger; then triggers after stop."""
    managers, clock = _managers(tmp_path, debounce_s=30.0, min_interval_s=5.0, max_bundles=100)
    dispositions = {"jax": [], "port": []}

    def fire(kind, key, manual=False):
        for side, manager in managers.items():
            dispositions[side].append(manager.trigger(kind, key=key, context={"n": 1},
                                                      manual=manual))

    for i in range(6):
        fire("manual", f"m{i}", manual=True)
    assert dispositions["port"][-2:] == ["overflow", "overflow"]
    for manager in managers.values():
        manager.start()
        assert manager.flush(30)
    rng = np.random.default_rng(seed)
    kinds = ("alert_fired", "tile_quarantined", "job_deadline", "failover")
    for _ in range(80):
        fire(kinds[int(rng.integers(0, 2))] if rng.random() < 0.8 else
             kinds[int(rng.integers(2, 4))], f"k{int(rng.integers(0, 3))}",
             manual=bool(rng.random() < 0.05))
        if dispositions["port"][-1] == "queued":
            for manager in managers.values():
                assert manager.flush(30)
        clock.advance(float(rng.choice([0.0, 1.0, 3.0, 6.0, 12.0, 31.0])))
    for manager in managers.values():
        manager.stop()
    fire("alert_fired", "late")
    assert dispositions["port"] == dispositions["jax"]
    assert set(dispositions["port"]) == {"queued", "debounced", "rate_limited", "overflow",
                                         "closed"}
    assert managers["port"].counters == managers["jax"].counters
    assert (len(managers["port"].list_bundles()) == len(managers["jax"].list_bundles())
            == dispositions["port"].count("queued"))
    assert ([b["trigger"] for b in managers["port"].list_bundles()]
            == [b["trigger"] for b in managers["jax"].list_bundles()])


def _bundle_ids(manager):
    return [b["id"] for b in manager.list_bundles()]


def test_retention_prunes_by_count_as_the_jax_manager(tmp_path):
    managers, clock = _managers(tmp_path / "count", max_bundles=3, max_bytes=0)
    for _ in range(5):
        for manager in managers.values():
            manager.capture_now(key="n")
        clock.advance(1.0)
    assert _bundle_ids(managers["port"]) == _bundle_ids(managers["jax"])
    assert len(_bundle_ids(managers["port"])) == 3
    assert _bundle_ids(managers["port"])[0].endswith("-0005-manual")


def test_retention_prunes_by_bytes_never_the_newest(tmp_path):
    kept = {}
    for side, module in (("jax", jincidents), ("port", tincidents)):
        clock = FakeClock()
        probe = module.IncidentManager(str(tmp_path / side / "probe"), clock=clock)
        size = probe.capture_now(key="n")["bytes"]
        # a budget of two and a half bundles keeps the newest two
        manager = module.IncidentManager(str(tmp_path / side / "bytes"), clock=clock,
                                         max_bundles=100, max_bytes=int(size * 2.5))
        for _ in range(4):
            manager.capture_now(key="n")
            clock.advance(1.0)
        kept[side] = _bundle_ids(manager)
        # a budget under one bundle still keeps the newest
        tiny = module.IncidentManager(str(tmp_path / side / "tiny"), clock=clock,
                                      max_bundles=100, max_bytes=10)
        tiny.capture_now(key="a")
        clock.advance(1.0)
        last = tiny.capture_now(key="b")
        assert _bundle_ids(tiny) == [last["id"]]
    assert kept["port"] == kept["jax"] and len(kept["port"]) == 2


def test_the_bus_tap_captures_the_port_s_own_trigger_events(tmp_path):
    from comfyui_distributed_tpu_torch.telemetry import events

    manager = tincidents.IncidentManager(str(tmp_path), clock=FakeClock(),
                                         min_interval_s=0.0)
    manager.start()
    try:
        bus = events.get_event_bus()
        bus.publish("alert_fired", slo="tile_latency", rules=[{"firing": True}])
        bus.publish("tile_quarantined", job_id="job-1", task_id=3)
        bus.publish("job_cancelled", job_id="job-2", reason="client")  # not a trigger
        bus.publish("incident_captured", id="x")  # the capture's own event: no re-entry
        assert manager.flush(30)
        assert sorted(b["trigger"] for b in manager.list_bundles()) == [
            "alert_fired", "tile_quarantined"]
        assert "incidents" in bus.stats()["taps"]
    finally:
        manager.stop()
    assert "incidents" not in events.get_event_bus().stats()["taps"]


def test_resolved_knobs_read_the_port_s_registry(monkeypatch):
    from comfyui_distributed_tpu_torch.utils.knob_registry import KNOBS

    monkeypatch.setenv("CDT_INCIDENT_MAX", "7")
    monkeypatch.delenv("CDT_FLIGHT", raising=False)
    knobs = tincidents.resolved_knobs()
    assert list(knobs) == [k.name for k in KNOBS]
    assert knobs["CDT_INCIDENT_MAX"] == {"value": "7", "set": True}
    assert knobs["CDT_FLIGHT"] == {"value": "1", "set": False}


# --------------------------------------------------------------------------
# a bound master of each package, and the routes
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _call(method: str, url: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    request = urllib.request.Request(url, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


@pytest.fixture
def masters(tmp_path, monkeypatch, port_loop):
    """A JAX master and a port master, each with its own CDT_INCIDENT_DIR
    (or none, with `masters(enabled=False)`), started on their own loops."""
    from comfyui_distributed_tpu.api.server import DistributedServer as JaxServer
    from comfyui_distributed_tpu.utils import config as jconfig
    from comfyui_distributed_tpu.utils.async_helpers import ServerLoopThread as JaxLoop
    from comfyui_distributed_tpu_torch.api.server import DistributedServer as PortServer

    monkeypatch.setenv("CDT_CONFIG_PATH", str(tmp_path / "jax_config.json"))
    with jconfig._cache.lock:
        jconfig._cache.path = jconfig._cache.mtime = jconfig._cache.data = None
    started = []

    def make(enabled: bool = True):
        servers = {}
        for side in ("jax", "port"):
            if enabled:
                monkeypatch.setenv("CDT_INCIDENT_DIR", str(tmp_path / f"{side}_incidents"))
            else:
                monkeypatch.delenv("CDT_INCIDENT_DIR", raising=False)
            if side == "jax":
                loop = JaxLoop()
                loop.start()
                server = JaxServer(port=_free_port(), is_worker=False)
            else:
                loop = port_loop
                server = PortServer(port=_free_port(), is_worker=False, device="cpu",
                                    config_path=str(tmp_path / "port_config.json"))
            asyncio.run_coroutine_threadsafe(server.start(), loop.loop).result(timeout=60)
            started.append((side, server, loop))
            servers[side] = server
        return servers

    yield make
    for side, server, loop in started:
        asyncio.run_coroutine_threadsafe(server.stop(), loop.loop).result(timeout=60)
        if side == "jax":
            loop.stop()


def test_a_bound_port_master_s_bundle_has_the_jax_bundle_s_keys(masters):
    servers = masters()
    bundles = {}
    for side, server in servers.items():
        assert server.incidents is not None
        result = server.incidents.capture_now(key="drill", context={"why": "parity"})
        bundles[side] = server.incidents.read_bundle(result["id"])
    port, jax_ = bundles["port"], bundles["jax"]
    assert set(port) == set(jax_)
    assert "durability" not in port
    for section in ("store", "placement", "scheduler", "health", "fleet", "usage", "slo"):
        assert "error" not in port[section], (section, port[section])
    for section in ("trigger", "flight", "store", "placement", "scheduler", "fleet", "usage",
                    "slo", "counters", "server"):
        assert set(port[section]) == set(jax_[section]), section
    assert set(port["scheduler"]["brownout"]) == set(jax_["scheduler"]["brownout"])
    assert port["trigger"] == {**jax_["trigger"], "ts": port["trigger"]["ts"]}
    assert port["server"]["label"] == f"master:{servers['port'].port}"
    assert port["flight"]["enabled"] is True
    assert tincidents.validate_bundle(port) == []
    assert jincidents.validate_bundle(port) == []
    assert set(port["knobs"]) <= set(jax_["knobs"])
    assert port["knobs"] == tincidents.resolved_knobs()


def test_the_incident_routes_answer_as_the_jax_routes(masters):
    servers = masters()
    answers = {}
    for side, server in servers.items():
        base = f"http://127.0.0.1:{server.port}/distributed/incidents"
        got = {"empty": _call("GET", base)}
        got["capture"] = _call("POST", f"{base}/capture", {"key": "ops",
                                                           "context": {"why": "drill"}})
        got["listed"] = _call("GET", base)
        got["bundle"] = _call("GET", f"{base}/{got['capture'][1]['id']}")
        got["unknown"] = _call("GET", f"{base}/incident-0000000000000-0001-ghost")
        got["hostile"] = _call("GET", f"{base}/not-an-id")
        got["no_body"] = _call("POST", f"{base}/capture")
        answers[side] = got
    for name, (status, body) in answers["port"].items():
        jax_status, jax_body = answers["jax"][name]
        assert status == jax_status, name
        assert set(body) == set(jax_body), name
    port = answers["port"]
    assert port["empty"][1]["incidents"] == [] and port["empty"][1]["flight"]["installed"]
    assert set(port["empty"][1]["manager"]) == set(answers["jax"]["empty"][1]["manager"])
    assert set(port["empty"][1]["flight"]) == set(answers["jax"]["empty"][1]["flight"])
    assert [e["id"] for e in port["listed"][1]["incidents"]] == [port["capture"][1]["id"]]
    assert port["listed"][1]["incidents"][0]["trigger"] == "manual"
    assert port["bundle"][1]["trigger"]["context"] == {"why": "drill"}
    assert port["unknown"][0] == port["hostile"][0] == 404


def test_the_disabled_incident_routes_answer_as_the_jax_routes(masters):
    servers = masters(enabled=False)
    answers = {}
    for side, server in servers.items():
        assert server.incidents is None
        base = f"http://127.0.0.1:{server.port}/distributed/incidents"
        answers[side] = [_call("GET", base), _call("POST", f"{base}/capture", {}),
                         _call("GET", f"{base}/incident-0000000000000-0001-manual")]
    assert answers["port"] == answers["jax"]
    assert [status for status, _ in answers["port"]] == [200, 400, 404]
    assert answers["port"][0][1] == {
        "enabled": False, "hint": "set CDT_INCIDENT_DIR on a master to enable incident capture"}


def test_a_worker_never_has_an_incident_manager(tmp_path, monkeypatch):
    from comfyui_distributed_tpu_torch.api.server import DistributedServer

    monkeypatch.setenv("CDT_INCIDENT_DIR", str(tmp_path / "incidents"))
    worker = DistributedServer(port=1, is_worker=True, device="cpu",
                               config_path=str(tmp_path / "c.json"))
    master = DistributedServer(port=2, is_worker=False, device="cpu",
                               config_path=str(tmp_path / "c.json"))
    for server in (worker, master):
        server._unbind_health()  # built, never started: nothing else to stop
    assert worker.incidents is None and worker.flight is not None
    assert master.incidents is not None
    assert set(master.incidents.sources) == {
        "server", "store", "placement", "scheduler", "health", "fleet", "usage", "slo"}
    assert master.incidents.directory == os.path.join(str(tmp_path), "incidents")
