"""The port's torch.profiler capture held to the JAX package's capture
manager, on the CPU.

The JAX manager runs on a stand-in for jax.profiler that writes a
64-byte trace (tests/test_profiling.py's); the port's records CPU
torch for real and writes a Chrome trace that parses.

- start, busy, stop, not_running, bad_duration, the duration cap, the
  auto-stop (its timer, and a stale timer that must not end a newer
  capture), retention by count and by bytes, the sequence resumed from
  the directory: the same dispositions and keys in both, compared
  exactly apart from paths, byte counts and elapsed times; the port's
  stop also answers the trace's export seconds (`export_s`).
- A start while another torch.profiler records in the process is
  refused with its reason and raises nothing, as the JAX manager
  answers a failing `start_trace`.
- The three profile routes answer the JAX routes' statuses and keys,
  disabled ones included; the busy start is a 409 in both.
"""

import asyncio
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from comfyui_distributed_tpu.telemetry import profiling as jprofiling
from comfyui_distributed_tpu_torch.telemetry import metrics as tmetrics
from comfyui_distributed_tpu_torch.telemetry import profiling as tprofiling

from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

# the keys the port's stop answers beyond the JAX manager's
PORT_ONLY_STOP_KEYS = {"export_s"}


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += seconds


class FakeJaxProfiler:
    """jax.profiler's start_trace/stop_trace, writing a 64-byte trace."""

    def __init__(self):
        self.stopped = 0
        self._dir = None

    def start_trace(self, path):
        self._dir = path

    def stop_trace(self):
        self.stopped += 1
        with open(os.path.join(self._dir, "trace.pb"), "wb") as fh:
            fh.write(b"x" * 64)


@pytest.fixture(autouse=True)
def fake_jax_profiler(monkeypatch):
    import jax

    fake = FakeJaxProfiler()
    monkeypatch.setattr(jax.profiler, "start_trace", fake.start_trace)
    monkeypatch.setattr(jax.profiler, "stop_trace", fake.stop_trace)
    jprofiling._reset_profiler_capture_for_tests()
    tprofiling.set_profiler_capture(None)
    yield fake
    jprofiling._reset_profiler_capture_for_tests()
    tprofiling.set_profiler_capture(None)


def _pair(tmp_path, **kw):
    clock = FakeClock()
    return {
        "jax": jprofiling.ProfilerCapture(str(tmp_path / "jax"), clock=clock, **kw),
        "port": tprofiling.ProfilerCapture(str(tmp_path / "port"), clock=clock, **kw),
    }, clock


def _same(port: dict, jax_: dict, extra: set = frozenset()):
    """Equal dispositions apart from paths, byte counts and elapsed times."""
    assert set(port) == set(jax_) | set(extra), (port, jax_)
    for key, value in jax_.items():
        if key in ("path", "bytes", "elapsed_s"):
            assert type(port[key]) is type(value) or isinstance(port[key], (int, float))
        else:
            assert port[key] == value, key


def _start(capture, **kw):
    """start() as each package takes it: the port's names the server's
    device, the CPU here."""
    if isinstance(capture, tprofiling.ProfilerCapture):
        kw["device"] = "cpu"
    return capture.start(**kw)


def _trace(capture, capture_id):
    with open(os.path.join(capture.directory, capture_id, tprofiling.TRACE_FILE)) as fh:
        return json.load(fh)


def test_start_busy_stop_and_not_running_as_the_jax_manager(tmp_path):
    pair, clock = _pair(tmp_path, max_seconds=30)
    answers = {}
    for side, capture in pair.items():
        first = _start(capture, duration_s=5.0, tag="Smoke Run!")
        busy = _start(capture, duration_s=5.0)
        torch.ones(16, 16) @ torch.ones(16, 16)
        active = capture.status()["active"]
        clock.advance(1.5)
        stopped = capture.stop()
        again = capture.stop()
        answers[side] = (first, busy, active, stopped, again, capture.captures(),
                         dict(capture.counters))
        clock.advance(-1.5)
    port, jax_ = answers["port"], answers["jax"]
    _same(port[0], jax_[0])
    assert port[0]["id"] == "trace-0001-smoke_run_" and port[0]["duration_s"] == 5.0
    assert port[1] == jax_[1] == {"started": False, "reason": "busy",
                                  "active": "trace-0001-smoke_run_"}
    _same(port[2], jax_[2])
    _same(port[3], jax_[3], PORT_ONLY_STOP_KEYS)
    assert port[3]["elapsed_s"] == jax_[3]["elapsed_s"] == 1.5
    assert port[3]["bytes"] > 0 and port[3]["export_s"] >= 0
    assert port[4] == jax_[4] == {"stopped": False, "reason": "not_running"}
    assert [c["id"] for c in port[5]] == [c["id"] for c in jax_[5]]
    assert port[6] == jax_[6] == {"started": 1, "stopped": 1, "busy": 1, "errors": 0,
                                  "auto_stopped": 0}
    trace = _trace(pair["port"], port[0]["id"])
    assert isinstance(trace["traceEvents"], list)


def test_bad_duration_and_the_cap_as_the_jax_manager(tmp_path):
    pair, _clock = _pair(tmp_path, max_seconds=2.0)
    for capture in pair.values():
        assert _start(capture, duration_s="nonsense") == {"started": False,
                                                        "reason": "bad_duration"}
        started = _start(capture, duration_s=9999.0)
        assert started["duration_s"] == 2.0
        capture.stop()
        tiny = _start(capture, duration_s=0.0)
        assert tiny["duration_s"] == 0.1
        deadline = time.monotonic() + 30
        while capture.counters["stopped"] < 2 and time.monotonic() < deadline:
            time.sleep(0.02)  # the real timer fires, and the trace is written
        assert capture.status()["active"] is None
        assert capture.counters["auto_stopped"] == 1
    assert pair["port"].counters == pair["jax"].counters


def test_auto_stop_ends_only_its_own_capture(tmp_path):
    pair, _clock = _pair(tmp_path)
    seen = {}
    for side, capture in pair.items():
        first = _start(capture, duration_s=5.0)
        capture._auto_stop(first["id"])
        second = _start(capture, duration_s=5.0)
        capture._auto_stop(first["id"])  # a stale timer does nothing
        seen[side] = (capture.counters["auto_stopped"], capture.status()["active"]["id"],
                      second["id"])
        capture.stop()
    assert seen["port"] == seen["jax"] == (1, "trace-0002-manual", "trace-0002-manual")


def test_retention_by_count_and_the_resumed_sequence(tmp_path):
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "trace-0007-old").mkdir()
        (tmp_path / side / "not-a-capture").mkdir()
    pair, _clock = _pair(tmp_path, max_captures=2, max_bytes=0)
    ids = {}
    for side, capture in pair.items():
        for _ in range(3):
            _start(capture, duration_s=1.0)
            capture.stop()
        ids[side] = [c["id"] for c in capture.captures()]
    assert ids["port"] == ids["jax"] == ["trace-0010-manual", "trace-0009-manual"]


def test_retention_by_bytes_keeps_the_newest(tmp_path):
    kept = {}
    for side, module in (("jax", jprofiling), ("port", tprofiling)):
        probe = module.ProfilerCapture(str(tmp_path / side / "probe"), clock=FakeClock())
        _start(probe, duration_s=1.0)
        size = probe.stop()["bytes"]
        capture = module.ProfilerCapture(str(tmp_path / side / "bytes"), clock=FakeClock(),
                                         max_captures=100, max_bytes=int(size * 2.5))
        for _ in range(3):
            _start(capture, duration_s=1.0)
            capture.stop()
        kept[side] = [c["id"] for c in capture.captures()]
    assert kept["port"] == kept["jax"] == ["trace-0003-manual", "trace-0002-manual"]


def test_a_start_under_another_torch_profiler_is_refused_without_raising(tmp_path):
    capture = tprofiling.ProfilerCapture(str(tmp_path))
    other = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    other.start()
    try:
        refused = capture.start(duration_s=1.0, device="cpu")
        # from another thread too: torch's own per-thread check would miss it
        answers = []
        thread = threading.Thread(
            target=lambda: answers.append(capture.start(duration_s=1.0, device="cpu")))
        thread.start()
        thread.join()
    finally:
        other.stop()
    for answer in (refused, answers[0]):
        assert answer["started"] is False
        assert "another torch.profiler" in answer["reason"]
    assert capture.counters["errors"] == 2 and capture.captures() == []
    assert capture.status()["active"] is None
    assert capture.start(duration_s=1.0, device="cpu")["started"] is True
    assert capture.stop()["stopped"] is True


def test_a_capture_on_the_card_without_cuda_is_refused(tmp_path):
    capture = tprofiling.ProfilerCapture(str(tmp_path))
    answer = capture.start(duration_s=1.0, device="cuda")
    if torch.cuda.is_available():
        capture.stop()
        pytest.skip("this host has a card")
    assert answer["started"] is False and "CUDA" in answer["reason"]
    # a CPU server's capture records the CPU alone
    assert capture.start(duration_s=1.0, device="cpu")["started"] is True
    assert capture.stop()["stopped"] is True


# --------------------------------------------------------------------------
# the routes
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _call(method: str, url: str, body=None):
    data = b"" if body is None else json.dumps(body).encode()
    request = urllib.request.Request(url, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


@pytest.fixture
def masters(tmp_path, monkeypatch, port_loop):
    from comfyui_distributed_tpu.api.server import DistributedServer as JaxServer
    from comfyui_distributed_tpu.utils import config as jconfig
    from comfyui_distributed_tpu.utils.async_helpers import ServerLoopThread as JaxLoop
    from comfyui_distributed_tpu_torch.api.server import DistributedServer as PortServer

    monkeypatch.setenv("CDT_CONFIG_PATH", str(tmp_path / "jax_config.json"))
    with jconfig._cache.lock:
        jconfig._cache.path = jconfig._cache.mtime = jconfig._cache.data = None
    tmetrics.reset_metrics_registry()
    jax_loop = JaxLoop()
    jax_loop.start()
    servers = {"jax": JaxServer(port=_free_port(), is_worker=False),
               "port": PortServer(port=_free_port(), is_worker=False, device="cpu",
                                  config_path=str(tmp_path / "port_config.json"))}
    loops = {"jax": jax_loop, "port": port_loop}
    for side, server in servers.items():
        asyncio.run_coroutine_threadsafe(server.start(), loops[side].loop).result(timeout=60)
    yield servers
    for side, server in servers.items():
        asyncio.run_coroutine_threadsafe(server.stop(), loops[side].loop).result(timeout=60)
    jax_loop.stop()


def _profile_answers(servers, monkeypatch, tmp_path, enabled: bool):
    answers = {}
    for side, server in servers.items():
        if enabled:
            monkeypatch.setenv("CDT_PROFILE_DIR", str(tmp_path / f"{side}_traces"))
        else:
            monkeypatch.delenv("CDT_PROFILE_DIR", raising=False)
        base = f"http://127.0.0.1:{server.port}/distributed/profile"
        got = {"status": _call("GET", base)}
        got["bad"] = _call("POST", f"{base}/start", {"duration_s": "a lot"})
        got["start"] = _call("POST", f"{base}/start", {"duration_s": 5.0, "tag": "drill"})
        got["busy"] = _call("POST", f"{base}/start", {})
        got["active"] = _call("GET", base)
        got["stop"] = _call("POST", f"{base}/stop")
        got["again"] = _call("POST", f"{base}/stop")
        got["listed"] = _call("GET", base)
        answers[side] = got
    return answers


def test_the_profile_routes_answer_as_the_jax_routes(masters, monkeypatch, tmp_path):
    answers = _profile_answers(masters, monkeypatch, tmp_path, enabled=True)
    port, jax_ = answers["port"], answers["jax"]
    for name, (status, body) in port.items():
        assert status == jax_[name][0], name
        extra = PORT_ONLY_STOP_KEYS if name == "stop" else set()
        assert set(body) == set(jax_[name][1]) | extra, name
    assert port["bad"][0] == 400 and port["busy"][0] == 409
    assert port["busy"][1]["reason"] == "busy"
    assert port["start"][1]["id"] == jax_["start"][1]["id"] == "trace-0001-drill"
    for name in ("status", "active", "listed"):
        assert set(port[name][1]["capture"]) == set(jax_[name][1]["capture"]), name
    assert port["active"][1]["capture"]["active"]["id"] == "trace-0001-drill"
    assert set(port["active"][1]["capture"]["active"]) == set(
        jax_["active"][1]["capture"]["active"])
    assert port["stop"][1]["stopped"] is True and port["again"][1] == jax_["again"][1]
    assert ([c["id"] for c in port["listed"][1]["captures"]]
            == [c["id"] for c in jax_["listed"][1]["captures"]] == ["trace-0001-drill"])
    # the capture's outcomes reach the scrape
    with urllib.request.urlopen(
            f"http://127.0.0.1:{masters['port'].port}/distributed/metrics", timeout=60) as resp:
        body = resp.read().decode()
    assert 'cdt_profile_captures_total{outcome="started"} 1' in body
    assert 'cdt_profile_captures_total{outcome="busy"} 1' in body


def test_the_disabled_profile_routes_answer_as_the_jax_routes(masters, monkeypatch, tmp_path):
    answers = _profile_answers(masters, monkeypatch, tmp_path, enabled=False)
    port, jax_ = answers["port"], answers["jax"]
    for name, (status, body) in port.items():
        assert status == jax_[name][0], name
        assert set(body) == set(jax_[name][1]), name
    assert port["status"][1]["enabled"] is False
    assert "CDT_PROFILE_DIR" in port["status"][1]["hint"]
    assert [port[name][0] for name in ("start", "stop")] == [400, 400]


def test_a_route_start_under_another_profiler_answers_409_with_its_reason(
        masters, monkeypatch, tmp_path):
    monkeypatch.setenv("CDT_PROFILE_DIR", str(tmp_path / "traces"))
    base = f"http://127.0.0.1:{masters['port'].port}/distributed/profile"
    other = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    other.start()
    try:
        status, body = _call("POST", f"{base}/start", {"duration_s": 1.0})
    finally:
        other.stop()
    assert status == 409 and body["started"] is False
    assert "another torch.profiler" in body["reason"]
    assert _call("GET", base)[1]["capture"]["counters"]["errors"] == 1
