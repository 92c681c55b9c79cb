"""Worker selection, dispatch and the circuit breaker of the port
(api/orchestration/dispatch.py, resilience/health.py) against the JAX
package's, on the same stubbed probe answers and the same events:

- select_active_workers and select_least_busy_worker give the same
  choices in the same order: round-robin over idle workers, the least
  queue otherwise, None when every worker is offline, quarantined
  workers left out;
- the breaker goes through the same states and counts after the same
  successes, failures, half-open probes and clock steps;
- a websocket rejection is not sent again over HTTP, an unreachable
  websocket falls back to HTTP, and a rejection does not count toward
  the breaker (tests/api/test_dispatch_selection.py's cases).
"""

import asyncio
import itertools

import pytest

from comfyui_distributed_tpu.api.orchestration import dispatch as jdispatch
from comfyui_distributed_tpu.resilience import health as jhealth
from comfyui_distributed_tpu.utils import exceptions as jexc
from comfyui_distributed_tpu_torch.api.orchestration import dispatch as tdispatch
from comfyui_distributed_tpu_torch.resilience import health as thealth
from comfyui_distributed_tpu_torch.utils import exceptions as texc

PACKAGES = {"jax": (jdispatch, jhealth, jexc), "torch": (tdispatch, thealth, texc)}


def _worker(wid, host, enabled=True):
    return {"id": wid, "host": host, "port": 8189, "type": "remote", "enabled": enabled}


@pytest.fixture
def both(monkeypatch):
    """Both packages' dispatch modules on one scripted probe map, fresh
    round-robin cursors and fresh breakers."""
    answers: dict[str, dict] = {}
    probes: list[str] = []

    async def fake_probe(url_base, timeout=None):
        probes.append(url_base)
        for key, value in answers.items():
            if key in url_base:
                return value
        return {"online": False, "queue_remaining": None}

    registries = {}
    for name, (dispatch, health, _) in PACKAGES.items():
        monkeypatch.setattr(dispatch, "probe_worker", fake_probe)
        monkeypatch.setattr(dispatch, "_least_busy_rr", itertools.count())
        registry = health.HealthRegistry(failure_threshold=3, suspect_threshold=2,
                                         cooldown_seconds=30.0, clock=lambda: clock[0])
        monkeypatch.setattr(dispatch, "get_health_registry", lambda r=registry: r)
        registries[name] = registry
    clock = [0.0]
    return answers, registries, clock, probes


def _ids(workers):
    return None if workers is None else (
        [w["id"] for w in workers] if isinstance(workers, list) else workers["id"])


SCENARIOS = {
    "idle round-robin": ({"host-a": (True, 0), "host-b": (True, 0), "host-c": (True, 0)}, 7),
    "least queue": ({"host-a": (True, 5), "host-b": (True, 2), "host-c": (True, 9)}, 3),
    "one idle among busy": ({"host-a": (True, 4), "host-b": (True, 0), "host-c": (False, None)},
                            3),
    "all offline": ({"host-a": (False, None)}, 2),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_least_busy_choices_equal_the_jax_packages(both, scenario):
    answers, _, _, _ = both
    script, rounds = SCENARIOS[scenario]
    for host, (online, queue) in script.items():
        answers[host] = {"online": online, "queue_remaining": queue}
    workers = [_worker("a", "host-a"), _worker("b", "host-b"), _worker("c", "host-c"),
               _worker("d", "host-d", enabled=False)]
    picks = {}
    for name, (dispatch, _, _) in PACKAGES.items():
        picks[name] = [
            (_ids(asyncio.run(dispatch.select_active_workers(workers))),
             _ids(asyncio.run(dispatch.select_least_busy_worker(workers[:3]))))
            for _ in range(rounds)]
    assert picks["torch"] == picks["jax"]
    if scenario == "idle round-robin":
        assert [p[1] for p in picks["torch"][:3]] == ["a", "b", "c"]
    if scenario == "all offline":
        assert picks["torch"][0] == ([], None)


# events: ("ok" | "fail" | "half_open" | "tick", worker id or seconds)
EVENTS = [("fail", "w"), ("fail", "w"), ("ok", "w"), ("fail", "w"), ("fail", "w"),
          ("fail", "w"), ("half_open", "w"), ("tick", 31.0), ("half_open", "w"),
          ("half_open", "w"), ("fail", "w"), ("tick", 10.0), ("half_open", "w"),
          ("tick", 25.0), ("half_open", "w"), ("ok", "w"), ("ok", "w"), ("fail", "v"),
          ("tick", 100.0), ("half_open", "v"), ("fail", "v"), ("fail", "v"), ("fail", "v"),
          ("tick", 31.0), ("half_open", "v"), ("tick", 31.0), ("half_open", "v")]


def test_breaker_states_follow_the_same_events(both):
    _, registries, clock, _ = both
    seen = {"jax": [], "torch": []}
    transitions = {"jax": [], "torch": []}
    for name, registry in registries.items():
        registry.add_listener(lambda w, old, new, n=name: transitions[n].append(
            (w, old.value, new.value)))
    for kind, arg in EVENTS:
        if kind == "tick":
            clock[0] += arg
            continue
        for name, registry in registries.items():
            if kind == "ok":
                result = registry.record_success(arg).value
            elif kind == "fail":
                result = registry.record_failure(arg).value
            else:
                result = registry.try_half_open(arg)
            snapshot = {w: {k: v for k, v in s.items()} for w, s in registry.snapshot().items()}
            seen[name].append((kind, arg, result, registry.allow(arg), snapshot))
    assert seen["torch"] == seen["jax"]
    assert transitions["torch"] == transitions["jax"]
    assert ("w", "probing", "recovered") in transitions["torch"]


def test_quarantined_workers_are_not_probed_and_refused(both):
    answers, registries, clock, probes = both
    answers["host-f"] = {"online": False, "queue_remaining": None}
    worker = _worker("f", "host-f")
    for name, (dispatch, health, exc) in PACKAGES.items():
        probes.clear()
        for _ in range(3):
            assert asyncio.run(dispatch.select_active_workers([worker])) == []
        assert registries[name].state("f") is getattr(health.WorkerState, "QUARANTINED")
        assert len(probes) == 3
        assert asyncio.run(dispatch.select_active_workers([worker])) == []
        assert len(probes) == 3  # quarantined: not probed
        with pytest.raises(exc.WorkerNotAvailableError, match="quarantined"):
            asyncio.run(dispatch.dispatch_worker_prompt(worker, {}, "p", use_websocket=False))
    clock[0] += 31.0
    answers["host-f"] = {"online": True, "queue_remaining": 0}
    for name, (dispatch, health, _) in PACKAGES.items():
        assert _ids(asyncio.run(dispatch.select_active_workers([worker]))) == ["f"]
        assert registries[name].state("f").value == "recovered"


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_a_websocket_rejection_is_not_resent_over_http(both, monkeypatch, name):
    _, registries, _, _ = both
    dispatch, _, exc = PACKAGES[name]
    http_calls = []

    async def rejecting_ws(worker, prompt, prompt_id, extra_data):
        raise exc.WorkerNotAvailableError("worker rejected prompt: bad graph", "r")

    async def unreachable_ws(worker, prompt, prompt_id, extra_data):
        raise exc.WorkerUnreachableError("no dispatch_ack received", "r")

    async def broken_ws(worker, prompt, prompt_id, extra_data):
        raise RuntimeError("handshake garbage")

    async def recording_http(worker, prompt, prompt_id, extra_data):
        http_calls.append(prompt_id)

    monkeypatch.setattr(dispatch, "_dispatch_http", recording_http)
    worker = _worker("r", "host-r")
    monkeypatch.setattr(dispatch, "_dispatch_ws", rejecting_ws)
    with pytest.raises(exc.WorkerNotAvailableError):
        asyncio.run(dispatch.dispatch_worker_prompt(worker, {}, "p1", use_websocket=True))
    assert http_calls == []
    assert registries[name].state("r").value == "healthy"
    monkeypatch.setattr(dispatch, "_dispatch_ws", unreachable_ws)
    asyncio.run(dispatch.dispatch_worker_prompt(worker, {}, "p2", use_websocket=True))
    monkeypatch.setattr(dispatch, "_dispatch_ws", broken_ws)
    asyncio.run(dispatch.dispatch_worker_prompt(worker, {}, "p3", use_websocket=True))
    assert http_calls == ["p2", "p3"]


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_rejection_answers_do_not_trip_the_breaker(both, monkeypatch, name):
    _, registries, _, _ = both
    dispatch, _, exc = PACKAGES[name]

    async def rejecting_http(worker, prompt, prompt_id, extra_data):
        raise exc.WorkerNotAvailableError("HTTP 400 bad prompt", worker.get("id"))

    monkeypatch.setattr(dispatch, "_dispatch_http", rejecting_http)
    for _ in range(5):
        with pytest.raises(exc.WorkerNotAvailableError):
            asyncio.run(dispatch.dispatch_worker_prompt(_worker("p", "host-p"), {}, "x",
                                                        use_websocket=False))
    assert registries[name].state("p").value == "healthy"
    assert registries[name].snapshot()["p"]["total_successes"] == 5


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_an_unreachable_http_dispatch_counts_as_a_failure(both, monkeypatch, name):
    _, registries, _, _ = both
    dispatch, _, exc = PACKAGES[name]

    async def unreachable_http(worker, prompt, prompt_id, extra_data):
        raise exc.WorkerUnreachableError("refused", worker.get("id"))

    monkeypatch.setattr(dispatch, "_dispatch_http", unreachable_http)
    states = []
    for _ in range(3):
        with pytest.raises(exc.WorkerUnreachableError):
            asyncio.run(dispatch.dispatch_worker_prompt(_worker("u", "host-u"), {}, "x",
                                                        use_websocket=False))
        states.append(registries[name].state("u").value)
    assert states == ["healthy", "suspect", "quarantined"]


def test_the_global_registries_start_empty_and_reset():
    registry = thealth.get_health_registry()
    assert registry is thealth.get_health_registry()
    thealth.reset_health_registry()
    assert thealth.get_health_registry() is not registry
    assert thealth.get_health_registry().state("nobody") is thealth.WorkerState.HEALTHY
