"""Push grants and the breaker's quarantine requeue in the port, against
the JAX package:

- the placement policy's `notify_grants` publishes and counts as the JAX
  policy's, with the same exposition;
- both JobStores call their grant notifier at the same refills (creation,
  a release, a timeout requeue, speculation, a lifted preemption, a
  quarantine requeue) and publish `job_complete` at cleanup;
- `bind_quarantine_requeue`: the JAX package's own failure-branch tests
  (tests/test_quarantine_bind.py) run on both packages, and on real
  stores a quarantined worker's tiles requeue at once, charged as an
  attempt with reason `quarantine`, in both;
- `/distributed/events` beside the JAX route (the port's WebSocket
  client against both servers): the hello frame, the `types` filter,
  the `events_dropped` notice, the subscription released when the client
  closes, and the subscriber gauges' exposition;
- `GrantSignal` against a port server and a JAX server in the sequence
  of tests/api/test_failover_route.py::
  test_grant_signal_wakes_on_push_and_ends_on_job_complete;
- the tiny-unet elastic upscale, master + w1 over HTTP, with push grants
  on and off: the same canvas, and with push on w1's stream delivers and
  w1 parks once its tiles are shipped.
"""

import asyncio
import json
import socket
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu import resilience as jresilience
from comfyui_distributed_tpu.jobs import JobStore as JaxJobStore
from comfyui_distributed_tpu.resilience import health as jhealth
from comfyui_distributed_tpu.scheduler.placement import PlacementPolicy as JaxPlacement
from comfyui_distributed_tpu.telemetry import events as jevents
from comfyui_distributed_tpu.telemetry import metrics as jmetrics
from comfyui_distributed_tpu_torch import resilience as tresilience
from comfyui_distributed_tpu_torch.jobs import JobStore
from comfyui_distributed_tpu_torch.resilience import health as thealth
from comfyui_distributed_tpu_torch.scheduler.placement import PlacementPolicy
from comfyui_distributed_tpu_torch.telemetry import events as tevents
from comfyui_distributed_tpu_torch.telemetry import metrics as tmetrics
from comfyui_distributed_tpu_torch.utils.websocket import connect_websocket

from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

POLL = 0.02
SIDES = {
    "jax": {"metrics": jmetrics, "events": jevents, "health": jhealth,
            "resilience": jresilience, "store": JaxJobStore, "placement": JaxPlacement},
    "port": {"metrics": tmetrics, "events": tevents, "health": thealth,
             "resilience": tresilience, "store": JobStore, "placement": PlacementPolicy},
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def fresh(monkeypatch):
    """Fresh metric registries, event buses and breaker registries on
    both sides."""
    for side in SIDES.values():
        monkeypatch.setattr(side["metrics"], "_registry", None)
        monkeypatch.setattr(side["events"], "_bus", None)
        monkeypatch.setattr(side["health"], "_registry", None)


def _family_lines(text: str, *names: str) -> list[str]:
    """The exposition lines (HELP, TYPE and samples) of the families."""
    lines = []
    for line in text.splitlines():
        words = line.split(" ")
        name = words[2] if line.startswith("#") and len(words) > 2 else words[0].split("{")[0]
        if name in names:
            lines.append(line)
    return lines


def _tap(events_mod, types):
    seen = []
    events_mod.get_event_bus().add_tap(
        lambda event: seen.append((event["type"], event["data"])) if event["type"] in types
        else None, name="test")
    return seen


# --------------------------------------------------------------------------
# notify_grants and the store's refills
# --------------------------------------------------------------------------


def test_notify_grants_publishes_and_counts_as_the_jax_policy(fresh):
    out = {}
    for name, side in SIDES.items():
        seen = _tap(side["events"], {"grant_available"})
        policy = side["placement"]()
        for count in (0, 3, -2, 1):
            policy.notify_grants("job-n", count)
        out[name] = (seen, _family_lines(side["metrics"].get_metrics_registry().render(),
                                         "cdt_push_grants_total"))
    assert out["port"] == out["jax"]
    assert out["port"][0] == [("grant_available", {"job_id": "job-n", "tasks": 3}),
                              ("grant_available", {"job_id": "job-n", "tasks": 1})]
    assert "cdt_push_grants_total 4" in out["port"][1][-1]


async def _refills(store_cls, events_mod):
    """Every grant notification and job_complete event of one scripted
    sequence, with the attempts and requeue counts it leaves."""
    store = store_cls()
    notified = []
    store.grant_notifier = lambda job_id, count: notified.append((job_id, count))
    completes = _tap(events_mod, {"job_complete"})
    out = []
    job = await store.init_tile_job("j", list(range(6)))
    out.append(("init", list(notified)))
    w1 = [await store.pull_task("j", "w1", timeout=POLL) for _ in range(2)]
    out.append(("release", await store.release_tasks("j", "w1", w1[:1]), list(notified)))
    await store.pull_task("j", "w2", timeout=POLL)
    job.worker_status["w2"] -= 100.0
    out.append(("timeout", await store.requeue_timed_out("j", 10.0), list(notified)))
    await store.pull_task("j", "w3", timeout=POLL)
    out.append(("speculate", await store.speculate_in_flight("j"), list(notified)))
    await store.request_preemption(["j"], reason="manual")
    out.append(("cleared", await store.clear_preemption(["j"]), list(notified)))
    await store.pull_task("j", "w4", timeout=POLL)
    out.append(("quarantine", await store.requeue_worker_tasks("w4"), list(notified)))
    out.append(("quarantine again", await store.requeue_worker_tasks("w4", job_id="j")))
    out.append(("no such job", await store.requeue_worker_tasks("w1", job_id="nope")))
    out.append(("attempts", dict(sorted(job.attempts.items()))))
    await store.cleanup_tile_job("j")
    await store.cleanup_tile_job("j")  # gone already: no second event
    out.append(("complete", completes))
    return out


def test_the_stores_notify_at_the_same_refills_as_the_jax_store(fresh):
    jax_out = asyncio.run(_refills(JaxJobStore, jevents))
    port_out = asyncio.run(_refills(JobStore, tevents))
    assert port_out == jax_out
    steps = {step[0]: step[1:] for step in port_out}
    assert steps["init"] == ([("j", 6)],)
    assert steps["quarantine"][0] and steps["quarantine again"] == ({},)
    assert steps["complete"] == ([("job_complete", {"job_id": "j"})],)
    notified = steps["quarantine"][1]
    # creation, the release, the timeout requeue, the speculation, the
    # lifted preemption and the quarantine requeue
    assert len(notified) == 6 and all(count > 0 for _, count in notified)


def test_a_notifier_that_raises_never_fails_the_store():
    async def run():
        store = JobStore()
        store.grant_notifier = mock.Mock(side_effect=RuntimeError("bus on fire"))
        job = await store.init_tile_job("x", [0, 1])
        tid = await store.pull_task("x", "w", timeout=POLL)
        return job.total_tasks, tid, await store.release_tasks("x", "w", [tid]), \
            store.grant_notifier.call_count

    assert asyncio.run(run()) == (2, 0, [0], 2)


# --------------------------------------------------------------------------
# bind_quarantine_requeue (the JAX package's tests/test_quarantine_bind.py)
# --------------------------------------------------------------------------


class ExplodingStore:
    def __init__(self):
        self.calls = 0

    async def requeue_worker_tasks(self, worker_id, job_id=None):
        self.calls += 1
        raise RuntimeError("store on fire")


class SlowStore:
    def __init__(self):
        self.started = asyncio.Event()
        self.release = asyncio.Event()
        self.finished = False

    async def requeue_worker_tasks(self, worker_id, job_id=None):
        self.started.set()
        await self.release.wait()
        self.finished = True
        return {}


def _quarantine(side, registry, worker_id):
    for _ in range(registry.failure_threshold):
        registry.record_failure(worker_id)
    assert registry.state(worker_id) is side["health"].WorkerState.QUARANTINED


@pytest.mark.parametrize("name", list(SIDES))
def test_a_requeue_that_raises_is_logged_not_raised(name, fresh):
    side = SIDES[name]

    async def body():
        registry = side["health"].HealthRegistry(failure_threshold=1, suspect_threshold=1)
        store = ExplodingStore()
        unbind = side["resilience"].bind_quarantine_requeue(registry, store)
        try:
            with mock.patch.object(side["resilience"], "debug_log") as dbg:
                _quarantine(side, registry, "w1")
                for _ in range(10):
                    await asyncio.sleep(0)
                assert store.calls == 1
                assert any("quarantine requeue for w1 failed" in str(c.args[0])
                           for c in dbg.call_args_list), dbg.call_args_list
        finally:
            unbind()

    asyncio.run(body())


@pytest.mark.parametrize("name", list(SIDES))
def test_a_cancelled_requeue_task_is_swallowed(name, fresh):
    side = SIDES[name]

    async def body():
        registry = side["health"].HealthRegistry(failure_threshold=1, suspect_threshold=1)
        store = SlowStore()
        unbind = side["resilience"].bind_quarantine_requeue(registry, store)
        try:
            with mock.patch.object(side["resilience"], "debug_log") as dbg:
                _quarantine(side, registry, "w1")
                await asyncio.wait_for(store.started.wait(), timeout=5)
                victims = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
                assert victims
                for task in victims:
                    task.cancel()
                for _ in range(10):
                    await asyncio.sleep(0)
                assert not store.finished
                assert not any("failed" in str(c.args[0]) for c in dbg.call_args_list)
        finally:
            unbind()

    asyncio.run(body())


@pytest.mark.parametrize("name", list(SIDES))
def test_a_failed_requeue_off_the_loop_is_logged(name, fresh, monkeypatch):
    side = SIDES[name]
    registry = side["health"].HealthRegistry(failure_threshold=1, suspect_threshold=1)
    unbind = side["resilience"].bind_quarantine_requeue(registry, ExplodingStore())
    logged = []
    monkeypatch.setattr(side["resilience"], "debug_log", logged.append)
    try:
        errors = []

        def from_thread():
            try:
                _quarantine(side, registry, "w2")
            except Exception as exc:  # noqa: BLE001 - must not happen
                errors.append(exc)

        thread = threading.Thread(target=from_thread)
        thread.start()
        thread.join(timeout=10)
        assert not thread.is_alive() and not errors
        assert any("quarantine requeue for w2 failed" in m for m in logged), logged
    finally:
        unbind()


@pytest.mark.parametrize("name", list(SIDES))
def test_unbind_detaches_the_listener(name, fresh):
    side = SIDES[name]

    async def body():
        registry = side["health"].HealthRegistry(failure_threshold=1, suspect_threshold=1)
        store = ExplodingStore()
        side["resilience"].bind_quarantine_requeue(registry, store)()
        _quarantine(side, registry, "w1")
        for _ in range(10):
            await asyncio.sleep(0)
        assert store.calls == 0

    asyncio.run(body())


async def _quarantined_on_a_real_store(side):
    registry = side["health"].HealthRegistry(failure_threshold=2, suspect_threshold=1)
    store = side["store"]()
    notified = []
    store.grant_notifier = lambda job_id, count: notified.append((job_id, count))
    unbind = side["resilience"].bind_quarantine_requeue(registry, store)
    try:
        job = await store.init_tile_job("q", [0, 1, 2, 3])
        held = [await store.pull_task("q", "w1", timeout=POLL) for _ in range(2)]
        await store.pull_task("q", "w2", timeout=POLL)
        _quarantine(side, registry, "w1")
        for _ in range(20):
            await asyncio.sleep(0)
        pending = sorted(job.pending.get_nowait() for _ in range(job.pending.qsize()))
        counter = side["metrics"].get_metrics_registry().render()
        return {"held": held, "pending": pending, "assigned": sorted(job.assigned.get("w1", [])),
                "attempts": dict(sorted(job.attempts.items())), "notified": notified,
                "requeued": _family_lines(counter, "cdt_store_requeued_tasks_total")}
    finally:
        unbind()


def test_a_quarantined_workers_tiles_requeue_at_once_as_in_the_jax_store(fresh):
    out = {name: asyncio.run(_quarantined_on_a_real_store(side)) for name, side in SIDES.items()}
    assert out["port"] == out["jax"]
    assert out["port"]["held"] == [0, 1] and out["port"]["pending"] == [0, 1, 3]
    assert out["port"]["assigned"] == [] and out["port"]["attempts"] == {0: 1, 1: 1}
    assert out["port"]["notified"] == [("q", 4), ("q", 2)]
    assert ('cdt_store_requeued_tasks_total{worker_id="w1",reason="quarantine"} 2'
            in out["port"]["requeued"])


# --------------------------------------------------------------------------
# /distributed/events and GrantSignal against a JAX server
# --------------------------------------------------------------------------


@pytest.fixture
def masters(fresh, tmp_path, monkeypatch, port_loop):
    """A JAX master and a port master, each on its own loop."""
    from comfyui_distributed_tpu.api.server import DistributedServer as JaxServer
    from comfyui_distributed_tpu.utils import config as jconfig
    from comfyui_distributed_tpu.utils.async_helpers import ServerLoopThread as JaxLoop
    from comfyui_distributed_tpu_torch.api.server import DistributedServer
    from comfyui_distributed_tpu_torch.utils import config as tconfig

    monkeypatch.setenv("CDT_CONFIG_PATH", str(tmp_path / "jax_config.json"))
    with jconfig._cache.lock:
        jconfig._cache.path = jconfig._cache.mtime = jconfig._cache.data = None
    port_config = str(tmp_path / "port_config.json")
    tconfig.save_config({"master": {"host": "127.0.0.1"}, "workers": [], "settings": {}},
                        port_config)
    jax_loop = JaxLoop()
    jax_loop.start()
    servers = {"jax": (JaxServer(port=_free_port(), is_worker=False), jax_loop),
               "port": (DistributedServer(port=_free_port(), is_worker=False,
                                          config_path=port_config, device="cpu"), port_loop)}
    for server, loop in servers.values():
        asyncio.run_coroutine_threadsafe(server.start(), loop.loop).result(timeout=60)
    yield servers
    for server, loop in servers.values():
        asyncio.run_coroutine_threadsafe(server.stop(), loop.loop).result(timeout=60)
    jax_loop.stop()


def _on(loop, coro, timeout=30):
    return asyncio.run_coroutine_threadsafe(coro, loop.loop).result(timeout)


async def _stream(port: int, types: str | None, script, frames_wanted: int, timeout=10.0):
    """Open /distributed/events (with `?types=`), run `script()` (sync,
    on a thread) after the hello frame, and return the frames received
    with their `seq` and `ts` dropped."""
    query = f"?types={types}" if types else ""
    frames = []
    async with connect_websocket(f"ws://127.0.0.1:{port}/distributed/events{query}") as ws:
        frames.append(json.loads(await asyncio.wait_for(ws.receive_text(), timeout)))
        await asyncio.to_thread(script)
        while len(frames) < frames_wanted:
            frames.append(json.loads(await asyncio.wait_for(ws.receive_text(), timeout)))
    return [{k: v for k, v in frame.items() if k not in ("seq", "ts")} for frame in frames]


def test_the_event_stream_answers_as_the_jax_route(masters, monkeypatch):
    """The hello frame, the bus-side filter, a burst that overflows the
    subscriber's queue (the events_dropped notice, then the newest
    events), and the subscription released when the client closes."""
    monkeypatch.setattr(jevents, "EVENT_QUEUE_SIZE", 2)
    monkeypatch.setattr(tevents, "EVENT_QUEUE_SIZE", 2)
    out = {}
    for name, (server, loop) in masters.items():
        events_mod = SIDES[name]["events"]
        bus = events_mod.get_event_bus()

        def burst(loop=loop, bus=bus, server=server):
            def publish_all():  # one loop callback: the handler cannot drain between them
                for i in range(10):
                    bus.publish("grant_available", job_id="burst", tasks=i)
                bus.publish("job_ready", job_id="other", tasks=1)  # filtered out
            loop.loop.call_soon_threadsafe(publish_all)

        released = []
        for types in ("grant_available,job_complete", None):
            frames = _on(loop, _stream(server.port, types, burst if types else lambda: None,
                                       4 if types else 1))
            released.append(_wait_until(lambda bus=bus: bus.subscriber_count == 0, 5.0))
            hello, *rest = frames
            out.setdefault(name, []).append(
                (hello["type"], sorted(hello["data"]), hello["data"]["subscribed"],
                 hello["data"]["server"].split(":")[0], rest))
        out[name].append(released)
    assert out["port"] == out["jax"]
    (_, keys, subscribed, role, (dropped, *events)), plain, released = out["port"]
    assert keys == ["health", "server", "store", "subscribed"] and role == "master"
    assert subscribed == ["grant_available", "job_complete"] and plain[2] == "all"
    assert dropped == {"type": "events_dropped", "data": {"count": 8}}
    assert [e["data"] for e in events] == [{"job_id": "burst", "tasks": 8},
                                           {"job_id": "burst", "tasks": 9}]
    assert released == [True, True]


def test_the_subscriber_gauges_are_the_jax_exposition(masters, monkeypatch):
    """A subscriber that dropped events, scraped while its client holds
    the stream: cdt_event_subscriber_queue_depth and _dropped equal to the
    JAX master's, line for line; gone from the scrape once it closed."""
    import urllib.request

    monkeypatch.setattr(jevents, "EVENT_QUEUE_SIZE", 2)
    monkeypatch.setattr(tevents, "EVENT_QUEUE_SIZE", 2)
    families = ("cdt_event_subscriber_queue_depth", "cdt_event_subscriber_dropped")
    out = {}
    for name, (server, loop) in masters.items():
        bus = SIDES[name]["events"].get_event_bus()
        scraped = []

        def scrape(port=server.port):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/distributed/metrics",
                                        timeout=10) as resp:
                return _family_lines(resp.read().decode(), *families)

        def burst_then_scrape(loop=loop, bus=bus):
            loop.loop.call_soon_threadsafe(
                lambda: [bus.publish("grant_available", job_id="g", tasks=i) for i in range(6)])
            time.sleep(0.5)  # the handler sends what is left: depth 0
            scraped.append(scrape())

        _on(loop, _stream(server.port, "grant_available", burst_then_scrape, 4))
        deadline = time.monotonic() + 5
        while bus.subscriber_count and time.monotonic() < deadline:
            time.sleep(0.01)
        out[name] = (scraped[0], scrape())
    assert out["port"] == out["jax"]
    during, after = out["port"]
    assert 'cdt_event_subscriber_dropped{subscriber="ws:127.0.0.1#1"} 4' in during
    assert not [line for line in after if not line.startswith("#")]


def test_a_plain_get_of_the_stream_is_refused(masters):
    import urllib.error
    import urllib.request

    statuses = {}
    for name, (server, _loop) in masters.items():
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{server.port}/distributed/events",
                                   timeout=10)
            statuses[name] = 200
        except urllib.error.HTTPError as exc:
            statuses[name] = exc.code
    assert statuses["port"] == statuses["jax"] == 400


def _wait_until(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def test_the_grant_signal_wakes_on_push_and_ends_on_job_complete_as_the_jax_one(masters):
    """The JAX package's oracle sequence against each package's server:
    connected; no spurious wake on a dry queue; a release refills the
    queue and the pushed grant_available wakes the park; cleanup's
    job_complete ends the signal. The frames each side published, the
    wakes and cdt_push_grants_total agree."""
    from comfyui_distributed_tpu.graph.usdu_elastic import GrantSignal as JaxGrantSignal
    from comfyui_distributed_tpu_torch.graph.usdu_elastic import GrantSignal

    out = {}
    for name, (server, loop) in masters.items():
        side = SIDES[name]
        store = server.job_store
        assert store.grant_notifier is not None  # wired by the master's start
        published = _tap(side["events"], set(GrantSignal.EVENT_TYPES))

        async def setup(store=store):
            await store.init_tile_job("job-push", [0, 1])
            await store.pull_task("job-push", "holder", timeout=0.05)
            await store.pull_task("job-push", "holder", timeout=0.05)

        _on(loop, setup())
        signal_cls = JaxGrantSignal if name == "jax" else GrantSignal
        signal = signal_cls(lambda port=server.port: f"http://127.0.0.1:{port}", "job-push")
        signal.start()
        seen = [_wait_until(lambda: signal.connected), signal.wait_for_grant(0.2)]
        _on(loop, store.release_tasks("job-push", "holder", [0, 1]))
        seen += [signal.wait_for_grant(5.0), signal.job_complete]
        _on(loop, store.cleanup_tile_job("job-push"))
        seen.append(_wait_until(lambda: signal.job_complete))
        signal.stop()
        grants = side["metrics"].get_metrics_registry().get("cdt_push_grants_total")
        out[name] = (seen, published, grants.value(),
                     getattr(signal, "frames", None), getattr(signal, "parks", None))
    assert out["port"][:3] == out["jax"][:3]
    assert out["port"][0] == [True, False, True, False, True]
    assert out["port"][2] == 4
    frames, parks = out["port"][3], out["port"][4]
    assert frames == {"grant_available": 1, "hello": 1, "job_complete": 1}
    assert [how for _, how in parks] == ["timeout", "grant_available"]


def test_a_signal_without_a_stream_never_parks(port_loop):
    """Nothing listens at the URL: the signal never connects, and a wait
    returns at once (the pure pull loop)."""
    from comfyui_distributed_tpu_torch.graph.usdu_elastic import GrantSignal

    signal = GrantSignal(lambda: f"http://127.0.0.1:{_free_port()}", "job")
    signal.start()
    try:
        started = time.monotonic()
        assert signal.wait_for_grant(5.0) is False
        assert time.monotonic() - started < 1.0
        assert signal.summary()["connects"] == 0 and signal.parks == []
    finally:
        signal.stop()


# --------------------------------------------------------------------------
# the elastic upscale, master + w1, push on and off
# --------------------------------------------------------------------------


def test_the_elastic_upscale_with_push_on_and_off(one_torch_thread, monkeypatch):
    """The same canvas either way (within one 8-bit level: w1's tiles
    travel as PNG, and who runs which tile may differ); with push on, w1's
    signal connected and got the stream's hello, parked after its empty
    pull until a pushed frame or the timeout, and the master's bus let go
    of its stream; with push off, w1 ran the job pull-only and nothing
    subscribed."""
    import chip_smoke
    from comfyui_distributed_tpu_torch.graph import usdu_elastic
    from comfyui_distributed_tpu_torch.models import pipeline as tpl
    from comfyui_distributed_tpu_torch.utils.network import request_json
    from test_torch_chip_smoke import _tiny_workflow

    workflow = _tiny_workflow()
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    image = torch.from_numpy(np.random.default_rng(3).random((1, 64, 64, 3), dtype=np.float32))

    def both(servers):
        out = {}
        for push in (True, False):
            monkeypatch.setattr(usdu_elastic, "PUSH_GRANTS_ENABLED", push)
            subscribed = []
            bus = tevents.get_event_bus()
            remove = bus.add_tap(lambda _e: subscribed.append(bus.subscriber_count), "test")
            queued, _, _ = chip_smoke._queue(servers["base"], servers["worker_port"], workflow)
            remove()
            _, info = request_json(
                "GET", f"http://127.0.0.1:{servers['worker_port']}/distributed/system_info",
                timeout=10)
            job = servers["master"].get_job(queued["prompt_id"])
            out[push] = (job.outputs["6"][0]["images"], info["status"]["grant_signal"],
                         max(subscribed, default=0), bus.subscriber_count)
        return out

    out = chip_smoke._elastic_phase(torch, bundle, "tiny-unet", workflow, image, None, "cpu",
                                    runs=0, after=both)["after"]
    (on, signal, most, left), (off, nothing, most_off, _) = out[True], out[False]
    np.testing.assert_allclose(on.numpy(), off.numpy(), atol=1.0 / 255 + 1e-6, rtol=0)
    # w1 parks once its tiles are shipped: a pushed frame ends the park
    # (job_complete, or a grant_available or job_ready w1 saw before it
    # parked: it subscribes when the job is announced, which may be
    # before the master creates it), or, when the master's own tiles take
    # longer, the CDT_PUSH_WAIT timeout, which ends w1's pulls
    assert signal["connects"] == 1 and signal["frames"]["hello"] == 1 and signal["parks"]
    (seconds, how), *_ = signal["parks"][::-1]
    assert (how in ("job_complete", "grant_available", "job_ready") and seconds < 1.0) or (
        how == "timeout" and seconds >= 0.99)
    assert [h for _, h in signal["parks"]].count("timeout") <= 1
    assert most == 1 and left == 0
    assert nothing is None and most_off == 0
