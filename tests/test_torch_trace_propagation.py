"""End-to-end trace-id propagation through the port, beside the JAX
package (tests/api/test_trace_propagation.py is the JAX package's own):

the master's admission wait `sched.wait` (the root) → its
`queue_orchestration` → dispatch with the trace id (the X-CDT-Trace-Id
header over HTTP, the message's trace_id over the websocket) → the
worker's executor → the worker client's tile RPCs → collector
ingestion, as ONE connected span tree per execution.

Master and worker are real DistributedServers on loopback sockets
sharing this process, so the process-global tracer sees both sides of
every hop. The same scenario runs through the JAX package's servers;
every span name the port records is one the JAX package records.
"""

import asyncio
import json
import socket
import urllib.request

import numpy as np
import pytest

from comfyui_distributed_tpu.telemetry import metrics as jmetrics
from comfyui_distributed_tpu.telemetry import tracing as jtracing
from comfyui_distributed_tpu_torch.telemetry import metrics as tmetrics
from comfyui_distributed_tpu_torch.telemetry import tracing as ttracing

from test_torch_parity import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TRACE_ID = "exec_e2e_000_propagation"

PROMPT = {
    "1": {
        "class_type": "EmptyLatentImage",
        "inputs": {"width": 32, "height": 32, "batch_size": 1},
    }
}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _post(url: str, payload: dict, headers=None, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _package(side: str) -> dict:
    if side == "jax":
        from comfyui_distributed_tpu.api.server import DistributedServer
        from comfyui_distributed_tpu.graph.usdu_elastic import HTTPWorkClient
        from comfyui_distributed_tpu.resilience import health
        from comfyui_distributed_tpu.utils import config, image
        from comfyui_distributed_tpu.utils.async_helpers import ServerLoopThread
        tracing, metrics = jtracing, jmetrics
    else:
        from comfyui_distributed_tpu_torch.api.server import DistributedServer
        from comfyui_distributed_tpu_torch.graph.usdu_elastic import HTTPWorkClient
        from comfyui_distributed_tpu_torch.resilience import health
        from comfyui_distributed_tpu_torch.utils import config, image
        from comfyui_distributed_tpu_torch.utils.async_helpers import ServerLoopThread
        tracing, metrics = ttracing, tmetrics
    return {"server": DistributedServer, "client": HTTPWorkClient, "health": health,
            "config": config, "image": image, "loop": ServerLoopThread, "tracing": tracing,
            "metrics": metrics}


def _cluster(side: str, tmp_path, websocket: bool, monkeypatch):
    """(master, worker, loop thread) of `side`, started."""
    pkg = _package(side)
    worker_port = _free_port()
    config = {"master": {"host": "127.0.0.1"},
              "workers": [{"id": "w1", "name": "worker1", "type": "remote",
                           "host": "127.0.0.1", "port": worker_port, "enabled": True}],
              "settings": {"websocket_orchestration": websocket}}
    loop = pkg["loop"]()
    loop.start()
    if side == "jax":
        path = str(tmp_path / "jax_config.json")
        monkeypatch.setenv("CDT_CONFIG_PATH", path)
        with pkg["config"]._cache.lock:
            pkg["config"]._cache.path = pkg["config"]._cache.mtime = None
            pkg["config"]._cache.data = None
        pkg["config"].save_config(config)
        master = pkg["server"](port=_free_port(), is_worker=False)
        worker = pkg["server"](port=worker_port, is_worker=True)
    else:
        path = str(tmp_path / "port_config.json")
        pkg["config"].save_config(config, path)
        master = pkg["server"](port=_free_port(), is_worker=False, config_path=path, device="cpu")
        worker = pkg["server"](port=worker_port, is_worker=True, config_path=path, device="cpu")
    for server in (master, worker):
        asyncio.run_coroutine_threadsafe(server.start(), loop.loop).result(timeout=60)
    return pkg, master, worker, loop


def _connected_to_root(span, index, root_id):
    seen = set()
    while span is not None and span["span_id"] not in seen:
        if span["span_id"] == root_id:
            return True
        seen.add(span["span_id"])
        span = index.get(span["parent_id"]) if span["parent_id"] else None
    return False


def _propagate(side: str, tmp_path, websocket: bool, monkeypatch) -> tuple[list[dict], dict]:
    """The scenario on `side`: (the trace's spans, the trace route's answer)."""
    for module in (jmetrics, tmetrics):
        monkeypatch.setattr(module, "_registry", None)
    for module in (jtracing, ttracing):
        monkeypatch.setattr(module, "_tracer", None)
    pkg, master, worker, loop = _cluster(side, tmp_path, websocket, monkeypatch)
    monkeypatch.setattr(pkg["health"], "_registry", None)
    tracer = pkg["tracing"].get_tracer()
    base = f"http://127.0.0.1:{master.port}"
    try:
        status, result = _post(f"{base}/distributed/queue", {
            "prompt": PROMPT, "workers": ["w1"], "client_id": "e2e", "trace_id": TRACE_ID})
        assert status == 200
        assert result["trace_id"] == TRACE_ID and result["workers"] == ["w1"]
        master_job = master._history[f"{TRACE_ID}_master"]
        assert master_job.done.wait(timeout=60)
        worker_job = worker._history[f"{TRACE_ID}_w0"]
        assert worker_job.done.wait(timeout=60)
        assert worker_job.error is None
        # the dispatch carried the trace id into the worker's job
        assert worker_job.trace_id == TRACE_ID

        # the tile leg: a worker client made inside the trace → the
        # master's RPC routes
        asyncio.run_coroutine_threadsafe(master.job_store.init_tile_job("e2e-job", [0, 1]),
                                         loop.loop).result(timeout=30)
        token = tracer.activate(TRACE_ID)
        try:
            client = pkg["client"](base, "e2e-job", "w1")
            assert client.trace_id == TRACE_ID  # captured from the context
            work = client.request_tile()
            assert work is not None and work["tile_idx"] in (0, 1)
            client.heartbeat()
            if side == "port":
                second = client.request_tile()
                client.submit_tiles([{
                    "tile_idx": work["tile_idx"], "batch_idx": 0, "global_idx": 0, "x": 0,
                    "y": 0, "extracted_w": 4, "extracted_h": 4,
                    "image": pkg["image"].encode_image_data_url(np.zeros((4, 4, 3), np.float32)),
                }], False)
                client.return_tiles([second["tile_idx"]])
        finally:
            tracer.deactivate(token)

        # the collector leg: job_complete with the propagated header
        asyncio.run_coroutine_threadsafe(master.job_store.ensure_collector("e2e-collect"),
                                         loop.loop).result(timeout=30)
        status, _ = _post(f"{base}/distributed/job_complete", {
            "job_id": "e2e-collect", "worker_id": "w1", "batch_idx": 0, "is_last": True,
            "image": pkg["image"].encode_image_data_url(np.zeros((4, 4, 3), np.float32)),
        }, headers={"X-CDT-Trace-Id": TRACE_ID})
        assert status == 200
        with urllib.request.urlopen(f"{base}/distributed/trace/{TRACE_ID}", timeout=30) as resp:
            served = json.loads(resp.read())
        return tracer.spans(TRACE_ID), served
    finally:
        for server in (master, worker):
            asyncio.run_coroutine_threadsafe(server.stop(), loop.loop).result(timeout=60)
        loop.stop()


@pytest.mark.parametrize("websocket", [False, True], ids=["http", "websocket"])
def test_trace_propagates_master_to_worker_to_tile_rpcs_and_collector(tmp_path, monkeypatch,
                                                                      websocket):
    spans, served = _propagate("port", tmp_path, websocket, monkeypatch)
    names = {s["name"] for s in spans}
    assert {"sched.wait", "queue_orchestration", "probe_workers", "dispatch",
            "execute_prompt", "rpc.request_image", "rpc.submit_tiles", "rpc.return_tiles",
            "rpc.job_complete"} <= names
    # both roles executed under the SAME trace
    assert {s["attrs"].get("role") for s in spans if s["name"] == "execute_prompt"} == {
        "master", "worker"}
    index = {s["span_id"]: s for s in spans}
    # the admission wait is the trace's first span, so its root; the
    # orchestration parents into it (as in the JAX package)
    (root,) = [s for s in spans if s["parent_id"] is None]
    assert root["name"] == "sched.wait"
    assert root["attrs"]["lane"] == "interactive" and root["attrs"]["tenant"] == "default"
    (orchestration,) = [s for s in spans if s["name"] == "queue_orchestration"]
    assert orchestration["parent_id"] == root["span_id"]
    for span in spans:
        assert _connected_to_root(span, index, root["span_id"]), span["name"]
    assert served["span_count"] == len(spans) and len(served["tree"]) == 1
    assert served["tree"][0]["name"] == "sched.wait"
    pulls = [s for s in spans if s["name"] == "rpc.request_image"]
    assert any("tile_idx" in s["attrs"] for s in pulls)
    (submit,) = [s for s in spans if s["name"] == "rpc.submit_tiles"]
    assert submit["attrs"]["accepted"] == 1 and len(submit["attrs"]["tiles"]) == 1
    (released,) = [s for s in spans if s["name"] == "rpc.return_tiles"]
    assert len(released["attrs"]["released"]) == 1
    (dispatch,) = [s for s in spans if s["name"] == "dispatch"]
    assert (dispatch["attrs"]["worker_id"] == "w1"
            and dispatch["parent_id"] == orchestration["span_id"])
    logs = [e["attrs"]["message"] for e in orchestration["events"] if e["name"] == "log"]
    assert any(m.startswith("dispatched to ['w1']") for m in logs)


def test_the_port_records_the_span_names_the_jax_package_records(tmp_path, monkeypatch):
    """The same scenario over HTTP dispatch through both packages: one
    connected tree in each, rooted at the scheduler's admission wait
    (sched.wait) in both, and the same span names."""
    port_spans, _ = _propagate("port", tmp_path / "port", False, monkeypatch)
    jax_spans, jax_served = _propagate("jax", tmp_path / "jax", False, monkeypatch)
    assert len(jax_served["tree"]) == 1
    assert jax_served["tree"][0]["name"] == "sched.wait"
    port_names = {s["name"] for s in port_spans} - {"rpc.submit_tiles", "rpc.return_tiles"}
    jax_names = {s["name"] for s in jax_spans}
    assert port_names == jax_names, port_names ^ jax_names
