"""The port's scheduler routes and its control plane end to end, on the
CPU.

- Routes: the same request sequence against a port master and the JAX
  package's route modules (its job and scheduler routes on aiohttp over
  a stand-in server holding a JAX SchedulerControl, as
  tests/test_torch_control_routes.py serves the JAX routes): drain, the
  queue's 503, resume, a full lane's 429, a ticket withdrawn while queued
  (DELETE /distributed/queue/{ticket_id}: the parked request's 409),
  reprioritize and the status route get the same statuses, Retry-After
  headers and JSON keys (scenarios after the JAX package's
  tests/api/test_scheduler_routes.py).
- End to end: the tiny-unet elastic upscale, master + w1 on loopback,
  once with CDT_SCHED_BASE_PULL_BATCH at 1 (one-tile grants) and once at
  its default of 2: the default run grants two tiles at once, each run
  completes every tile once, the two images agree within one 8-bit
  level (a worker's tiles travel as PNG), w1's piggybacked snapshot is
  in the master's fleet, and the execution's trace is one tree rooted at
  the admission wait, sched.wait.
"""

import asyncio
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
from aiohttp import web

import chip_smoke
from comfyui_distributed_tpu.api import job_routes as jjob_routes
from comfyui_distributed_tpu.api import scheduler_routes as jscheduler_routes
from comfyui_distributed_tpu.jobs.store import JobStore as JaxJobStore
from comfyui_distributed_tpu.resilience import health as jhealth
from comfyui_distributed_tpu.scheduler import AdmissionQueue as JaxQueue
from comfyui_distributed_tpu.scheduler import SchedulerControl as JaxControl
from comfyui_distributed_tpu_torch.api.server import DistributedServer
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.resilience import health as thealth
from comfyui_distributed_tpu_torch.utils import constants as tconstants
from comfyui_distributed_tpu_torch.utils import image as timg

from test_torch_chip_smoke import _tiny_workflow
from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

TIMEOUT = 30
LANES = "interactive:2,batch:4"
PROMPT = {"1": {"class_type": "EmptyLatentImage",
                "inputs": {"width": 32, "height": 32, "batch_size": 1}}}


def _call(method: str, url: str, body=None) -> tuple[int, dict, object]:
    """(status, headers in lower case, JSON body), error statuses included."""
    data = None if body is None else (body if isinstance(body, bytes) else
                                      json.dumps(body).encode())
    request = urllib.request.Request(url, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(request, timeout=TIMEOUT) as resp:
            return resp.status, {k.lower(): v for k, v in resp.headers.items()}, json.loads(
                resp.read() or b"null")
    except urllib.error.HTTPError as err:
        with err:
            return err.code, {k.lower(): v for k, v in err.headers.items()}, json.loads(
                err.read() or b"null")


class _JaxServer:
    """What the JAX job and scheduler routes read of their server."""

    def __init__(self):
        self.job_store = JaxJobStore()
        self.scheduler = JaxControl(queue=JaxQueue(lanes=[("interactive", 2), ("batch", 4)]),
                                    health=jhealth.get_health_registry())
        self.queue_remaining = 0
        self.execution_context = types.SimpleNamespace(pipelines={})


@pytest.fixture
def masters(tmp_path, port_loop, monkeypatch):
    """(the port master, its URL, the JAX stand-in, its URL)."""
    monkeypatch.setattr(tconstants, "SCHED_LANES", LANES)
    monkeypatch.setattr(jhealth, "_registry", None)
    monkeypatch.setattr(thealth, "_registry", None)
    port_server = DistributedServer(port=0, is_worker=False,
                                    config_path=str(tmp_path / "port.json"), device="cpu")
    jax_server = _JaxServer()
    app = web.Application()
    for module in (jjob_routes, jscheduler_routes):
        module.register(app, jax_server)
    runner = web.AppRunner(app)

    async def boot():
        await port_server.start()
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return site._server.sockets[0].getsockname()[1]

    jax_port = asyncio.run_coroutine_threadsafe(boot(), port_loop.loop).result(timeout=TIMEOUT)
    yield (port_server, f"http://127.0.0.1:{port_server.http.port}", jax_server,
           f"http://127.0.0.1:{jax_port}", port_loop)

    async def teardown():
        await runner.cleanup()
        await port_server.stop()

    asyncio.run_coroutine_threadsafe(teardown(), port_loop.loop).result(timeout=60)


def _sequence(server, base, loop) -> list:
    """The request sequence on one master: [(step, status, Retry-After,
    the body's keys or the body)]."""
    queue = server.scheduler.queue

    def on_loop(fn):
        async def run():
            return fn()

        return asyncio.run_coroutine_threadsafe(run(), loop.loop).result(timeout=TIMEOUT)

    def answer(step, method, path, body=None, keys_only=True):
        status, headers, got = _call(method, base + path, body)
        shown = sorted(got) if keys_only and isinstance(got, dict) else got
        return (step, status, headers.get("retry-after"), shown)

    queued = {"prompt": PROMPT, "client_id": "c1", "workers": []}
    out = [answer("status", "GET", "/distributed/scheduler/status"),
           answer("drain", "POST", "/distributed/scheduler/drain", {}, keys_only=False),
           answer("queue while drained", "POST", "/distributed/queue", queued),
           answer("resume", "POST", "/distributed/scheduler/resume", {}, keys_only=False)]
    on_loop(queue.pause)
    fillers = on_loop(lambda: [queue.submit("filler", "interactive") for _ in range(2)])
    out.append(answer("full lane", "POST", "/distributed/queue", queued, keys_only=False))
    on_loop(lambda: [queue.cancel(t) for t in fillers])
    parked = {}

    def park():
        parked["answer"] = _call("POST", base + "/distributed/queue",
                                 {**queued, "tenant": "acme"})

    thread = threading.Thread(target=park)
    thread.start()
    deadline = time.monotonic() + TIMEOUT
    while not queue.lanes["interactive"].queues.get("acme"):
        assert time.monotonic() < deadline, "the request never parked"
        time.sleep(0.01)
    ticket = queue.lanes["interactive"].queues["acme"][0].ticket_id
    out.append(answer("withdraw", "DELETE", f"/distributed/queue/{ticket}", keys_only=False))
    thread.join(timeout=TIMEOUT)
    status, headers, body = parked["answer"]
    out.append(("parked", status, headers.get("retry-after"), body))
    out.append(answer("withdraw again", "DELETE", f"/distributed/queue/{ticket}"))
    moved = on_loop(lambda: queue.submit("t", "background"))  # unknown lane: the lowest
    out.append(answer("reprioritize", "POST", "/distributed/scheduler/reprioritize",
                      {"ticket_id": moved.ticket_id, "lane": "interactive", "tenant": "t",
                       "weight": 2.5}, keys_only=False))
    out.append(answer("reprioritize unknown", "POST", "/distributed/scheduler/reprioritize",
                      {"ticket_id": "t999", "lane": "interactive"}, keys_only=False))
    out.append(answer("reprioritize empty", "POST", "/distributed/scheduler/reprioritize", {}))
    out.append(answer("reprioritize bad lane", "POST", "/distributed/scheduler/reprioritize",
                      {"ticket_id": moved.ticket_id, "lane": "nope"}))
    out.append(answer("reprioritize invalid", "POST", "/distributed/scheduler/reprioritize",
                      b"{nope"))
    out.append(answer("pause", "POST", "/distributed/scheduler/pause", {}, keys_only=False))
    status, _, body = _call("GET", base + "/distributed/scheduler/status")
    out.append(("status after", status, body["state"], body["admission"]["totals"],
                body["admission"]["tenant_weights"], sorted(body["brownout"])))
    on_loop(lambda: queue.cancel(moved))
    return out


def test_the_scheduler_routes_answer_as_the_jax_routes(masters):
    port_server, port_base, jax_server, jax_base, loop = masters
    port_answers = _sequence(port_server, port_base, loop)
    jax_answers = _sequence(jax_server, jax_base, loop)
    assert port_answers == jax_answers
    steps = {row[0]: row[1:] for row in port_answers}
    assert steps["queue while drained"][:2] == (503, "1")
    assert steps["full lane"][0] == 429 and int(steps["full lane"][1]) >= 1
    assert steps["parked"][0] == 409 and steps["withdraw"][0] == 200
    assert steps["withdraw again"][0] == 404
    assert steps["reprioritize"][2]["moved"] is True
    assert [steps[k][0] for k in ("reprioritize unknown", "reprioritize empty",
                                  "reprioritize bad lane", "reprioritize invalid")] == [
        404, 400, 400, 400]


# --------------------------------------------------------------------------
# the control plane on the elastic path
# --------------------------------------------------------------------------


def _upscale(tmp, monkeypatch, base_batch: int) -> dict:
    """The tiny-unet upscale once, master + w1 in this process, with
    grants sized from `base_batch`."""
    monkeypatch.setattr(tconstants, "SCHED_BASE_PULL_BATCH", base_batch)
    monkeypatch.setattr(tconstants, "FLEET_SNAPSHOT_SECONDS", 1e-6)
    monkeypatch.setenv("CDT_DETERMINISTIC_BLEND", "1")
    workflow = _tiny_workflow()
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    in_dir, out_dir = os.path.join(tmp, "input"), os.path.join(tmp, "output")
    os.makedirs(in_dir)
    with open(os.path.join(in_dir, workflow["4"]["inputs"]["image"]), "wb") as fh:
        fh.write(timg.encode_png(np.random.default_rng(3).random((64, 64, 3), np.float32)))
    with chip_smoke._serving(tmp, {"input_dir": in_dir, "output_dir": out_dir}, "cpu",
                             {"tiny-unet": bundle}) as (master, _worker, base, worker_port):
        queued, _, _ = chip_smoke._queue(base, worker_port, workflow)
        record = master.job_store.finished[queued["job_ids"][chip_smoke.USDU_NODE]]
        _, _, trace = _call("GET", f"{base}/distributed/trace/{queued['trace_id']}")
        _, _, fleet = _call("GET", f"{base}/distributed/fleet")
        image = master.get_job(queued["prompt_id"]).outputs["6"][0]["images"]
    spans = chip_smoke._spans_of(trace["tree"])
    # the master's own grants and w1's, as the master served them
    grants = [len(s["attrs"].get("batch") or [0]) for s in spans if "tile_idx" in s["attrs"]
              and (s["name"] == "rpc.request_image"
                   or (s["name"] == "tile.pull" and s["attrs"].get("role") == "master"))]
    return {"queued": queued, "record": record, "trace": trace, "fleet": fleet,
            "image": image, "grants": grants}


def test_grants_follow_the_placement_policy_and_change_no_pixel(tmp_path, monkeypatch,
                                                                one_torch_thread):
    single = _upscale(str(tmp_path / "single"), monkeypatch, 1)
    paired = _upscale(str(tmp_path / "paired"), monkeypatch, 2)
    for run in (single, paired):
        record = run["record"]
        assert sorted(t for t, _ in record["completions"]) == list(range(record["total"]))
        assert record["duplicates"] == 0
        assert run["queued"]["scheduler"]["lane"] == "interactive"
        tree = run["trace"]["tree"]
        assert len(tree) == 1 and tree[0]["name"] == "sched.wait"
        assert tree[0]["attrs"]["ticket_id"] == run["queued"]["scheduler"]["ticket_id"]
        w1 = run["fleet"]["workers"]["w1"]["snapshot"]
        assert w1["devices"] == 1 and w1["v"] == run["fleet"]["version"]
        assert sum(run["grants"]) == record["total"]
    assert set(single["grants"]) == {1}
    assert max(paired["grants"]) == 2
    diff = (single["image"].float() - paired["image"].float()).abs().max()
    assert float(diff) <= 1.0 / 255
