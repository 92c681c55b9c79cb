"""The port's fault plans held to the JAX package's, and its two seams.

- The same plans parse to the same rules in both packages, and every bad
  plan of tests/test_resilience_faults.py is refused by both.
- The same op sequence fires the same (kind, op, arg) list in both,
  probabilistic rules included (each rule draws from a stream seeded
  with seed * 1000003 + its index in both).
- The process-wide injector: the env round-trip and the override.
- The transport seam (utils/network.py::request_json, request_bytes) on
  a local HTTP server: connect_error raises a TRANSPORT_ERRORS member,
  http500 answers 500 and drop an empty 200 without sending, latency
  sleeps and then sends.
- The store seam: the same calls on a JAX JobStore and a port JobStore,
  each with an injector of the same plan, fire the same actions, and a
  dropped heartbeat is recorded in neither.
- A port server started under CDT_FAULT_PLAN builds its store with an
  injector; without the variable, with none.
"""

import asyncio
import http.server
import threading
import time

import numpy as np
import pytest

from comfyui_distributed_tpu.jobs import JobStore as JaxJobStore
from comfyui_distributed_tpu.resilience import faults as jfaults
from comfyui_distributed_tpu_torch.jobs import JobStore
from comfyui_distributed_tpu_torch.resilience import faults as tfaults
from comfyui_distributed_tpu_torch.utils import network
from comfyui_distributed_tpu_torch.utils.exceptions import DistributedError

PLANS = [
    "seed=42;crash@chaos:w1:pulled#2;latency(0.5)@heartbeat#1-3,7;"
    "drop@store:heartbeat:w2#*;connect_error@request_image%0.25",
    "connect_error@http:POST:/distributed/submit_tiles#1-3",
    "seed=3;latency(0.2)@request_image%0.5",
    "seed=11;latency(0.15)@store:pull:master#1-3;crash@chaos:w1:pulled#1",
    "http500@http:*:/distributed/*#2,4;drop@store:heartbeat:w[12]#*; ;crash@x",
    "",
]

# tests/test_resilience_faults.py::test_parse_rejects_bad_plans
BAD_PLANS = ["explode@foo#1", "crash@", "crash", "seed=abc", "latency(x)@foo", "crash@foo#1-x"]


@pytest.fixture(autouse=True)
def _no_process_injector(monkeypatch):
    """No test here leaves an injector installed in either package."""
    monkeypatch.delenv("CDT_FAULT_PLAN", raising=False)
    jfaults.reset_fault_injector()
    tfaults.reset_fault_injector()
    yield
    jfaults.reset_fault_injector()
    tfaults.reset_fault_injector()


def _fields(rule):
    return (rule.kind, rule.pattern, rule.arg, rule.occurrences, rule.all_matches,
            rule.probability)


@pytest.mark.parametrize("plan", PLANS)
def test_the_same_plan_parses_to_the_same_rules(plan):
    jseed, jrules = jfaults.parse_fault_plan(plan)
    tseed, trules = tfaults.parse_fault_plan(plan)
    assert tseed == jseed
    assert [_fields(r) for r in trules] == [_fields(r) for r in jrules]
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert tfaults._RULE_RE.pattern == jfaults._RULE_RE.pattern


@pytest.mark.parametrize("bad", BAD_PLANS)
def test_both_packages_refuse_each_bad_plan(bad):
    with pytest.raises(jfaults.FaultPlanError):
        jfaults.parse_fault_plan(bad)
    with pytest.raises(tfaults.FaultPlanError) as err:
        tfaults.parse_fault_plan(bad)
    assert isinstance(err.value, DistributedError) and str(err.value)


def _ops(seed: int, n: int = 400) -> list[str]:
    """A seeded op sequence over the sites both packages name."""
    names = ["store:pull:w1", "store:pull:w2", "store:pull:master", "store:heartbeat:w1",
             "store:heartbeat:w2", "store:submit:w1", "chaos:w1:pulled", "chaos:w2:pull",
             "http:POST:/distributed/request_image", "http:POST:/distributed/submit_tiles",
             "http:GET:/distributed/job_status", "http:GET:/prompt", "op", "site"]
    picks = np.random.default_rng(seed).integers(0, len(names), size=n)
    return [names[i] for i in picks]


FIRING_PLANS = PLANS[:5] + [
    "seed=9;connect_error@op%0.5;latency(0.01)@site%0.3;drop@store:*%0.7",
    "seed=1234567;crash@request_image%0.1;http500@http:*%0.4;drop@heartbeat#*",
    "crash@op:x#2,4;connect_error@store:pull#1-5,9;latency(0.2)@chaos:*#*",
]


def _action(action):
    return None if action is None else (action.kind, action.op, action.arg)


@pytest.mark.parametrize("plan", FIRING_PLANS)
def test_the_same_ops_fire_the_same_faults_in_both(plan):
    jinj, tinj = jfaults.FaultInjector(plan), tfaults.FaultInjector(plan)
    for seed in (0, 1):
        for op in _ops(seed):
            assert _action(tinj.hit(op)) == _action(jinj.hit(op)), op
    assert [_action(a) for a in tinj.fired] == [_action(a) for a in jinj.fired]
    assert tinj._counters == jinj._counters


def test_probabilistic_rules_fire_on_some_matches_only():
    plan = "seed=9;connect_error@op%0.5"
    inj = tfaults.FaultInjector(plan)
    seq = [inj.hit("op") is not None for _ in range(32)]
    assert any(seq) and not all(seq)
    jinj = jfaults.FaultInjector(plan)
    assert seq == [jinj.hit("op") is not None for _ in range(32)]


def test_check_blocking_and_check_in_both():
    for faults in (jfaults, tfaults):
        inj = faults.FaultInjector("crash@site#1;latency(0.01)@a#1;drop@b#1")
        with pytest.raises(faults.FaultInjected) as err:
            inj.check_blocking("site")
        assert (err.value.kind, err.value.op) == ("crash", "site")
        assert inj.check_blocking("site") is None  # the occurrence is consumed

        async def scenario(inj=inj):
            assert (await inj.check("a")).kind == "latency"
            assert (await inj.check("b")).kind == "drop"  # returned, not raised
            assert await inj.check("b") is None

        asyncio.run(scenario())


def test_the_process_injector_env_round_trip_and_override(monkeypatch):
    assert tfaults.get_fault_injector() is None
    monkeypatch.setenv("CDT_FAULT_PLAN", "crash@x#1")
    inj = tfaults.get_fault_injector()
    assert inj is not None and inj.rules[0].kind == "crash"
    assert tfaults.get_fault_injector() is inj  # cached for the same plan
    monkeypatch.setenv("CDT_FAULT_PLAN", "drop@x#1")
    assert tfaults.get_fault_injector() is not inj  # a new plan, a new injector
    override = tfaults.FaultInjector("drop@y#1")
    tfaults.set_fault_injector(override)
    assert tfaults.get_fault_injector() is override
    tfaults.set_fault_injector(None)  # an explicit None overrides the env too
    assert tfaults.get_fault_injector() is None
    tfaults.reset_fault_injector()
    monkeypatch.delenv("CDT_FAULT_PLAN")
    assert tfaults.get_fault_injector() is None


def test_the_resilience_package_exports_the_injector():
    from comfyui_distributed_tpu import resilience as jres
    from comfyui_distributed_tpu_torch import resilience as tres

    for name in ("FaultInjected", "FaultInjector", "get_fault_injector", "set_fault_injector",
                 "reset_fault_injector"):
        assert name in tres.__all__ and name in jres.__all__
        assert getattr(tres, name) is getattr(tfaults, name)
    assert set(tres.__all__) == set(jres.__all__)


# --- the transport seam -------------------------------------------------------


@pytest.fixture
def local_http():
    """A localhost HTTP server answering {"ok": true} to GET and POST; its
    `hits` list the (method, path) of every request it received."""
    hits = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def _answer(self):
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                self.rfile.read(length)
            hits.append((self.command, self.path))
            body = b'{"ok": true, "exec_info": {"queue_remaining": 0}}'
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        do_GET = do_POST = _answer

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", hits
    server.shutdown()
    server.server_close()


def test_the_transport_seam_injects_each_kind(local_http):
    base, hits = local_http
    tfaults.set_fault_injector(tfaults.FaultInjector(
        "connect_error@http:POST:/distributed/submit_tiles#1;"
        "http500@http:POST:/distributed/request_image#1;"
        "drop@http:GET:/distributed/job_status#1;"
        "latency(0.2)@http:GET:/prompt#1;"
        "crash@http:POST:/crash#1"))
    with pytest.raises(network.TRANSPORT_ERRORS) as err:
        network.request_json("POST", f"{base}/distributed/submit_tiles", {"tiles": []})
    assert "injected connect_error at /distributed/submit_tiles" in str(err.value)
    with pytest.raises(network.TRANSPORT_ERRORS):
        network.request_json("POST", f"{base}/crash", {})
    assert network.request_json("POST", f"{base}/distributed/request_image", {}) == (500, None)
    assert network.request_json("GET", f"{base}/distributed/job_status") == (200, {})
    assert hits == []  # none of those reached the server
    started = time.monotonic()
    assert network.request_json("GET", f"{base}/prompt")[0] == 200
    assert time.monotonic() - started >= 0.2
    assert hits == [("GET", "/prompt")]
    # every rule fired once; the second of each op goes through
    for method, path in (("POST", "/distributed/submit_tiles"),
                         ("POST", "/distributed/request_image"),
                         ("GET", "/distributed/job_status")):
        assert network.request_json(method, f"{base}{path}", {} if method == "POST" else None) \
            == (200, {"ok": True, "exec_info": {"queue_remaining": 0}})
    injector = tfaults.get_fault_injector()
    assert [(a.kind, a.op) for a in injector.fired] == [
        ("connect_error", "http:POST:/distributed/submit_tiles"),
        ("crash", "http:POST:/crash"),
        ("http500", "http:POST:/distributed/request_image"),
        ("drop", "http:GET:/distributed/job_status"),
        ("latency", "http:GET:/prompt"),
    ]


def test_the_transport_seam_of_request_bytes(local_http):
    base, hits = local_http
    tfaults.set_fault_injector(tfaults.FaultInjector(
        "http500@/upload#1;drop@/upload#2;connect_error@/upload#3"))
    status, body = network.request_bytes("POST", f"{base}/upload", b"x")
    assert status == 500 and body.startswith(b"injected fault response (500)")
    assert network.request_bytes("POST", f"{base}/upload", b"x") == (200, b"")
    with pytest.raises(network.TRANSPORT_ERRORS):
        network.request_bytes("POST", f"{base}/upload", b"x")
    assert hits == []
    assert network.request_bytes("POST", f"{base}/upload", b"x")[0] == 200
    assert hits == [("POST", "/upload")]


def test_the_transport_seam_faults_get_and_post_only(local_http):
    base, hits = local_http
    tfaults.set_fault_injector(tfaults.FaultInjector("connect_error@http:*#*"))
    with pytest.raises(network.TRANSPORT_ERRORS):
        network.request_json("GET", f"{base}/x")
    assert network.request_json("PUT", f"{base}/x", {})[0] == 501  # sent: not faulted
    assert [a.op for a in tfaults.get_fault_injector().fired] == ["http:GET:/x"]


def test_probe_worker_through_the_seam_reads_offline():
    """tests/test_resilience_faults.py::test_transport_wrap_injects_connect_error_and_500
    on the port: an injected connection error, then an injected 500, both
    read as an offline worker instead of raising."""
    tfaults.set_fault_injector(tfaults.FaultInjector(
        "connect_error@http:GET:/prompt#1;http500@http:GET:/prompt#2"))

    async def scenario():
        return (await network.probe_worker("http://127.0.0.1:9"),
                await network.probe_worker("http://127.0.0.1:9"))

    assert asyncio.run(scenario()) == ({"online": False, "queue_remaining": None},) * 2


def test_no_plan_sends_untouched(local_http):
    base, hits = local_http
    assert network.request_json("GET", f"{base}/prompt")[0] == 200
    assert hits == [("GET", "/prompt")]


# --- the store seam -------------------------------------------------------------

STORE_PLAN = ("latency(0.01)@store:pull:w1#1;drop@store:heartbeat:w1#2-3;"
              "crash@store:submit:w2#1;connect_error@store:pull:w2#2")


async def _store_script(store, faults):
    """Every answer of the store under STORE_PLAN, with the heartbeat
    records of w1 after each beat."""
    out = []
    job = await store.init_tile_job("j", list(range(4)))

    async def attempt(label, coro):
        try:
            out.append((label, await coro))
        except faults.FaultInjected as exc:
            out.append((label, "raised", exc.kind, exc.op))

    await attempt("pull w1", store.pull_task("j", "w1", timeout=0.02))  # beat 1
    seen = job.worker_status.get("w1")
    out.append(("w1 seen", seen is not None))
    await attempt("heartbeat w1", store.heartbeat("j", "w1"))  # beat 2: dropped
    out.append(("w1 beat 2 recorded", job.worker_status.get("w1") != seen))
    await attempt("heartbeat w1", store.heartbeat("j", "w1"))  # beat 3: dropped
    out.append(("w1 beat 3 recorded", job.worker_status.get("w1") != seen))
    await attempt("pull w2", store.pull_task("j", "w2", timeout=0.02))
    await attempt("pull w2", store.pull_task("j", "w2", timeout=0.02))  # raises
    await attempt("grant w2", store.pull_tasks("j", "w2", timeout=0.02))
    await attempt("submit w2", store.submit_result("j", "w2", 1, "r1"))  # raises
    await attempt("flush w2", store.submit_flush("j", "w2", {1: "r1", 2: "r2"}))
    await attempt("submit w1", store.submit_result("j", "w1", 0, "r0"))  # beat 4
    out.append(("w1 beat 4 recorded", job.worker_status.get("w1") != seen))
    await attempt("complete", store.is_complete("j"))
    return out


def test_the_store_sites_fire_alike_in_both_packages():
    jinj, tinj = jfaults.FaultInjector(STORE_PLAN), tfaults.FaultInjector(STORE_PLAN)
    jout = asyncio.run(_store_script(JaxJobStore(fault_injector=jinj), jfaults))
    tout = asyncio.run(_store_script(JobStore(fault_injector=tinj), tfaults))
    assert tout == jout
    assert [_action(a) for a in tinj.fired] == [_action(a) for a in jinj.fired]
    assert [(a.kind, a.op) for a in tinj.fired] == [
        ("latency", "store:pull:w1"), ("drop", "store:heartbeat:w1"),
        ("drop", "store:heartbeat:w1"), ("connect_error", "store:pull:w2"),
        ("crash", "store:submit:w2")]
    # dropped beats were recorded by neither; the undropped ones were
    assert ("w1 beat 2 recorded", False) in tout and ("w1 beat 3 recorded", False) in tout
    assert ("w1 beat 4 recorded", True) in tout
    assert tinj._counters == jinj._counters


def test_a_store_without_an_injector_is_untouched():
    store = JobStore()
    assert store.fault_injector is None

    async def script():
        await store.init_tile_job("j", [0])
        assert await store.pull_task("j", "w1", timeout=0.02) == 0
        assert await store.heartbeat("j", "w1")
        return await store.submit_result("j", "w1", 0, "r")

    assert asyncio.run(script()) is True


def test_a_server_under_cdt_fault_plan_has_a_store_with_an_injector(monkeypatch, tmp_path):
    from comfyui_distributed_tpu_torch.api.server import DistributedServer
    from comfyui_distributed_tpu_torch.resilience import health

    monkeypatch.setattr(health, "_registry", None)
    monkeypatch.setenv("CDT_LOG_DIR", str(tmp_path / "logs"))
    config = str(tmp_path / "c.json")
    plain = DistributedServer(port=0, is_worker=True, config_path=config, device="cpu")
    assert plain.job_store.fault_injector is None
    monkeypatch.setenv("CDT_FAULT_PLAN", "seed=5;drop@store:heartbeat:w1#*")
    faulted = DistributedServer(port=0, is_worker=True, config_path=config, device="cpu")
    injector = faulted.job_store.fault_injector
    assert injector is not None and injector is tfaults.get_fault_injector()
    assert (injector.seed, [r.kind for r in injector.rules]) == (5, ["drop"])
    for server in (plain, faulted):
        server._unbind_health()
